"""Model configuration: the port's copy of ``repro.models.config``.

One frozen dataclass covers every architecture of the JAX package, with
the same fields, defaults, derived properties, ``reduced()`` and
``param_count()``, so the configs under ``repro_torch/configs/`` read as
the reference's do.  Families:
  dense   — decoder-only transformer (GQA + RoPE + SwiGLU)
  moe     — dense + mixture-of-experts FFN on a layer period
  hybrid  — Mamba blocks with periodic attention layers (+ optional MoE)
  vlm     — dense backbone consuming a stub patch-embedding prefix
  audio   — encoder-decoder transformer, stub frame-embedding encoder input
  ssm     — xLSTM (alternating mLSTM / sLSTM blocks)

``head_pad_to`` / ``kv_head_pad_to`` and ``expert_pad_to`` stay fields:
they describe the reference's physical layout (dummy heads and experts
that tile its mesh), which ``convert.params_from_jax`` reads to drop
them; the port itself runs the real heads and experts only, with the
reference's init scale over the padded shapes.
"""

from __future__ import annotations

import dataclasses
from typing import Optional


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                      # dense | moe | hybrid | vlm | audio | ssm

    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int
    head_dim: Optional[int] = None   # default d_model // n_heads

    # attention details
    qkv_bias: bool = False
    rope_theta: float = 1e6
    norm_eps: float = 1e-6
    # physical head padding (EXPERIMENTS.md Section Perf, granite iter 3):
    # dummy never-contributing query heads (hard-masked before the output
    # projection, so they receive no gradients) appended per KV group so
    # the head dim tiles the model mesh axis.  0 = no padding.
    head_pad_to: int = 0
    kv_head_pad_to: int = 0

    # MoE (family moe / hybrid)
    n_experts: int = 0
    moe_top_k: int = 0
    moe_period: int = 1              # MoE FFN every `period` layers
    capacity_factor: float = 1.25
    # physical expert-tensor padding: dummy never-routed experts appended
    # so the expert dim tiles the model mesh axis (40 -> 48 for granite);
    # without it GSPMD replicates expert weights and lowers the dispatch
    # to collective-permute chains (EXPERIMENTS.md Section Perf, granite
    # iteration 2).  0 = no padding.
    expert_pad_to: int = 0

    # hybrid (jamba): one attention layer every `attn_period` layers,
    # the rest are Mamba blocks.
    attn_period: int = 0             # 0 => no mamba layers
    mamba_d_state: int = 16
    mamba_d_conv: int = 4
    mamba_expand: int = 2

    # ssm (xlstm): layer i is sLSTM if i % slstm_period == slstm_offset
    slstm_period: int = 2
    slstm_offset: int = 1
    mlstm_proj_factor: float = 2.0
    slstm_proj_factor: float = 1.3334

    # encoder-decoder (audio family)
    n_enc_layers: int = 0            # 0 => decoder-only

    # modality frontend stubs
    num_prefix_embeds: int = 0       # vlm: patch positions prepended
    frontend_frames: int = 0         # audio: encoder input length (frames)

    # training
    tie_embeddings: bool = False

    def __post_init__(self):
        if self.head_dim is None:
            object.__setattr__(self, "head_dim", self.d_model // self.n_heads)
        assert self.n_heads % self.n_kv_heads == 0, (
            self.n_heads, self.n_kv_heads)

    # ---- derived ----------------------------------------------------------
    @property
    def n_experts_phys(self) -> int:
        return max(self.n_experts, self.expert_pad_to)

    @property
    def n_kv_phys(self) -> int:
        return max(self.n_kv_heads, self.kv_head_pad_to)

    @property
    def n_heads_phys(self) -> int:
        hp = max(self.n_heads, self.head_pad_to)
        assert hp % self.n_kv_phys == 0, (hp, self.n_kv_phys)
        return hp

    @property
    def head_group(self) -> int:
        """Real query heads per real KV head."""
        return self.n_heads // self.n_kv_heads

    @property
    def is_encdec(self) -> bool:
        return self.n_enc_layers > 0

    def is_attn_layer(self, i: int) -> bool:
        """Hybrid schedule: jamba places one attention layer per period
        (at position attn_period - 1: layers 0..6 Mamba, layer 7 attention)."""
        if self.attn_period <= 0:
            return True
        return (i % self.attn_period) == (self.attn_period - 1)

    def is_moe_layer(self, i: int) -> bool:
        if self.n_experts <= 0:
            return False
        return (i % self.moe_period) == (self.moe_period - 1)

    def is_slstm_layer(self, i: int) -> bool:
        return (i % self.slstm_period) == self.slstm_offset

    @property
    def sub_quadratic(self) -> bool:
        """Eligible for the long_500k shape (DESIGN.md Section 4)."""
        return self.family in ("hybrid", "ssm")

    @property
    def has_decoder(self) -> bool:
        return True  # every assigned arch has an autoregressive decoder

    def param_count(self) -> int:
        """Analytic parameter count (embedding + blocks + head), used for
        MODEL_FLOPS = 6 N D in the roofline (dense) / active-N for MoE."""
        d, hd = self.d_model, self.head_dim
        attn = d * hd * self.n_heads + 2 * d * hd * self.n_kv_heads \
            + hd * self.n_heads * d
        if self.qkv_bias:
            attn += hd * (self.n_heads + 2 * self.n_kv_heads)
        ffn_dense = 3 * d * self.d_ff
        ffn_moe = self.n_experts * 3 * d * self.d_ff + d * self.n_experts
        mamba = self._mamba_params()
        total = self.vocab * d  # embedding
        if not self.tie_embeddings:
            total += self.vocab * d
        n_dec = self.n_layers
        for i in range(n_dec):
            if self.family == "ssm":
                total += self._xlstm_params(i)
                continue
            if self.is_attn_layer(i):
                total += attn
            else:
                total += mamba
            total += ffn_moe if self.is_moe_layer(i) else ffn_dense
            total += 2 * d  # norms
        if self.is_encdec:
            for _ in range(self.n_enc_layers):
                total += attn + ffn_dense + 2 * d
            total += self.n_layers * (attn + d)  # decoder cross-attn + norm
        return total

    def active_param_count(self) -> int:
        """Parameters touched per token (MoE: top_k of n_experts)."""
        if self.n_experts <= 0:
            return self.param_count()
        d = self.d_model
        full_ffn = self.n_experts * 3 * d * self.d_ff
        active_ffn = self.moe_top_k * 3 * d * self.d_ff
        n_moe = sum(self.is_moe_layer(i) for i in range(self.n_layers))
        return self.param_count() - n_moe * (full_ffn - active_ffn)

    def _mamba_params(self) -> int:
        d = self.d_model
        di = self.mamba_expand * d
        ds = self.mamba_d_state
        return (2 * d * di            # in_proj (x, z)
                + di * self.mamba_d_conv
                + di * (2 * ds + 1)   # B, C, dt from x
                + di + di * ds        # dt_proj bias + A
                + di * d)             # out_proj

    def _xlstm_params(self, i: int) -> int:
        d = self.d_model
        if self.is_slstm_layer(i):
            dp = int(d * self.slstm_proj_factor)
            return 4 * d * d * 1 + 2 * d * dp  # gates (4) + up/down proj
        dp = int(d * self.mlstm_proj_factor)
        return 2 * d * dp + dp * dp * 3 + dp * d

    # ---- smoke-test reduction ---------------------------------------------
    def reduced(self) -> "ModelConfig":
        """Family-preserving tiny config for CPU smoke tests."""
        scale = {
            "n_layers": min(self.n_layers, 4 if self.attn_period <= 0
                            else 2 * max(self.attn_period, 2)),
            "d_model": 64,
            "n_heads": 4,
            "n_kv_heads": min(self.n_kv_heads, 2)
            if self.n_kv_heads < self.n_heads else 4,
            "head_dim": 16,
            "d_ff": 128 if self.d_ff else 0,
            "vocab": 256,
            "n_experts": min(self.n_experts, 4),
            "moe_top_k": min(self.moe_top_k, 2),
            "n_enc_layers": min(self.n_enc_layers, 2),
            "num_prefix_embeds": min(self.num_prefix_embeds, 8),
            "frontend_frames": min(self.frontend_frames, 16),
            "mamba_d_state": min(self.mamba_d_state, 8),
        }
        return dataclasses.replace(self, **scale)


@dataclasses.dataclass(frozen=True)
class InputShape:
    """One cell of the assigned (arch x shape) matrix."""
    name: str
    seq_len: int
    global_batch: int
    kind: str          # train | prefill | decode

    @property
    def is_decode(self) -> bool:
        return self.kind == "decode"


TRAIN_4K = InputShape("train_4k", 4096, 256, "train")
PREFILL_32K = InputShape("prefill_32k", 32768, 32, "prefill")
DECODE_32K = InputShape("decode_32k", 32768, 128, "decode")
LONG_500K = InputShape("long_500k", 524288, 1, "decode")

ALL_SHAPES = (TRAIN_4K, PREFILL_32K, DECODE_32K, LONG_500K)


def shapes_for(cfg: ModelConfig):
    """The shape set an architecture actually runs: long_500k only for
    the sub-quadratic families; every arch has a decoder, so the decode
    shapes always apply."""
    out = [TRAIN_4K, PREFILL_32K, DECODE_32K]
    if cfg.sub_quadratic:
        out.append(LONG_500K)
    return tuple(out)


def skipped_shapes_for(cfg: ModelConfig):
    return tuple(s for s in ALL_SHAPES if s not in shapes_for(cfg))
