"""Yi-6B — llama-architecture GQA decoder.  [arXiv:2403.04652]

32L d_model=4096 32H (GQA kv=4) d_ff=11008 vocab=64000, head_dim 128.
"""

from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="yi-6b",
    family="dense",
    n_layers=32,
    d_model=4096,
    n_heads=32,
    n_kv_heads=4,
    head_dim=128,
    d_ff=11008,
    vocab=64000,
    qkv_bias=False,
    rope_theta=5e6,
)
