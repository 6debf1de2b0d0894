"""Phi-3.5-MoE (42B total / 6.6B active) — 16 experts, top-2.

[hf:microsoft/Phi-3.5-MoE-instruct]
32L d_model=4096 32H (GQA kv=8) d_ff=6400 vocab=32064, MoE every layer.
"""

from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="phi3.5-moe-42b-a6.6b",
    family="moe",
    n_layers=32,
    d_model=4096,
    n_heads=32,
    n_kv_heads=8,
    head_dim=128,
    d_ff=6400,
    vocab=32064,
    n_experts=16,
    moe_top_k=2,
    moe_period=1,
    rope_theta=1e4,
)
