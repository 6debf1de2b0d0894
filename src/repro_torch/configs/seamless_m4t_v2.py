"""SeamlessM4T-large-v2 — encoder-decoder backbone, stub audio frontend.

[arXiv:2308.11596]
24L (encoder) + 24L (decoder) d_model=1024 16H (kv=16) d_ff=8192
vocab=256206.  The speech frontend (conformer feature extractor) is a STUB:
input_specs() provides precomputed frame embeddings (B, frames, d_model).
Decode shapes lower the text-decoder step (self-attn KV cache + cross-attn
over encoder states) — enc-dec is NOT encoder-only, so decode applies.
"""

from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="seamless-m4t-large-v2",
    family="audio",
    n_layers=24,
    n_enc_layers=24,
    d_model=1024,
    n_heads=16,
    n_kv_heads=16,
    head_dim=64,
    d_ff=8192,
    vocab=256206,
    frontend_frames=1024,
    rope_theta=1e4,
)
