"""Qwen2-0.5B — dense GQA decoder with QKV bias.  [arXiv:2407.10671]

24L d_model=896 14H (GQA kv=2) d_ff=4864 vocab=151936, head_dim 64.
Also the ~100M-class backbone used by examples/train_100m.py (reduced).
"""

from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="qwen2-0.5b",
    family="dense",
    n_layers=24,
    d_model=896,
    n_heads=14,
    n_kv_heads=2,
    head_dim=64,
    d_ff=4864,
    vocab=151936,
    qkv_bias=True,
    head_pad_to=16,     # 14 heads tile the 16-way model axis (masked)
    rope_theta=1e6,
    tie_embeddings=True,
)
