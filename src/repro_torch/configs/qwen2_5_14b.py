"""Qwen2.5-14B — dense GQA decoder with QKV bias.

[arch pool spec; hf:Qwen/Qwen2.5-0.5B family card for the bias/GQA scheme]
48L d_model=5120 40H (GQA kv=8) d_ff=13824 vocab=152064, head_dim 128.
"""

from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="qwen2.5-14b",
    family="dense",
    n_layers=48,
    d_model=5120,
    n_heads=40,
    n_kv_heads=8,
    head_dim=128,
    d_ff=13824,
    vocab=152064,
    qkv_bias=True,
    head_pad_to=48,     # 40 heads tile the 16-way model axis as 48 (masked)
    rope_theta=1e6,
)
