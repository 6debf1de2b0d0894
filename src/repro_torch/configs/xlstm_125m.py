"""xLSTM-125M — alternating mLSTM / sLSTM blocks.  [arXiv:2405.04517]

12L d_model=768 4H d_ff=0 (blocks carry their own projections)
vocab=50304.  Sub-quadratic: runs the long_500k cell with O(1)-per-token
recurrent state.
"""

from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="xlstm-125m",
    family="ssm",
    n_layers=12,
    d_model=768,
    n_heads=4,
    n_kv_heads=4,
    head_dim=192,
    d_ff=0,
    vocab=50304,
    slstm_period=2,
    slstm_offset=1,
    tie_embeddings=True,
)
