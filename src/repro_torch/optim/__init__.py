from repro_torch.optim.adamw import AdamW, AdamWState, global_norm
from repro_torch.optim.schedule import warmup_cosine
from repro_torch.optim import compress

__all__ = ["AdamW", "AdamWState", "global_norm", "warmup_cosine", "compress"]
