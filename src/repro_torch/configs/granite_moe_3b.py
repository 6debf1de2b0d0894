"""Granite-3.0 MoE 3B (800M active) — 40 experts, top-8.

[hf:ibm-granite/granite-3.0-3b-a800m-base; pool spec primary: 40e top-8]
32L d_model=1536 24H (GQA kv=8) d_ff=512 vocab=49155, MoE every layer.
"""

from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="granite-moe-3b-a800m",
    family="moe",
    n_layers=32,
    d_model=1536,
    n_heads=24,
    n_kv_heads=8,
    head_dim=64,
    d_ff=512,
    vocab=49155,
    n_experts=40,
    moe_top_k=8,
    moe_period=1,
    expert_pad_to=48,   # 40 experts tile the 16-way model axis as 48 (3/shard)
    head_pad_to=32,     # 24 heads tile the 16-way model axis as 32 (masked)
    rope_theta=1e4,
    tie_embeddings=True,
)
