"""Pixtral-12B — mistral-nemo decoder + (stub) pixtral-ViT patch frontend.

[hf:mistralai/Pixtral-12B-2409; unverified tier]
40L d_model=5120 32H (GQA kv=8) d_ff=14336 vocab=131072, head_dim 128.
The vision tower is a STUB per the assignment: input_specs() supplies
precomputed patch embeddings (B, num_prefix_embeds, d_model) that the
backbone consumes as a prefix.
"""

from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="pixtral-12b",
    family="vlm",
    n_layers=40,
    d_model=5120,
    n_heads=32,
    n_kv_heads=8,
    head_dim=128,
    d_ff=14336,
    vocab=131072,
    num_prefix_embeds=256,   # one 1024px image at 16x16 patches, pooled 4x
    rope_theta=1e9,
)
