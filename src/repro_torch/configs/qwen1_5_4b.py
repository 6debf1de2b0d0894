"""Qwen1.5-4B — dense MHA (kv == heads) decoder with QKV bias.

[arch pool spec; hf:Qwen/Qwen1.5-0.5B family card]
40L d_model=2560 20H (kv=20) d_ff=6912 vocab=151936, head_dim 128.
"""

from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="qwen1.5-4b",
    family="dense",
    n_layers=40,
    d_model=2560,
    n_heads=20,
    n_kv_heads=20,
    head_dim=128,
    d_ff=6912,
    vocab=151936,
    qkv_bias=True,
    head_pad_to=32,     # MHA 20 heads -> 32 physical (masked)
    kv_head_pad_to=32,
    rope_theta=1e6,
)
