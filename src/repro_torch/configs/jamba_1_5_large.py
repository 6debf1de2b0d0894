"""Jamba-1.5-Large (398B) — Mamba + attention 1:7 interleave, MoE 16e top-2.

[arXiv:2403.19887 / Jamba-1.5 tech report]
72L d_model=8192 64H (GQA kv=8) d_ff=24576 vocab=65536; attention at every
8th layer (1:7), MoE FFN every 2nd layer.  The long_500k cell runs on this
arch (sub-quadratic Mamba backbone; the 9 attention layers use a
sequence-sharded KV cache — DESIGN.md Section 5).
"""

from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="jamba-1.5-large-398b",
    family="hybrid",
    n_layers=72,
    d_model=8192,
    n_heads=64,
    n_kv_heads=8,
    head_dim=128,
    d_ff=24576,
    vocab=65536,
    n_experts=16,
    moe_top_k=2,
    moe_period=2,
    attn_period=8,
    mamba_d_state=16,
    mamba_d_conv=4,
    mamba_expand=2,
    rope_theta=1e6,
)
