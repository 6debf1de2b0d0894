"""The port's optimizer substrate against the JAX package: AdamW, the
warmup-cosine schedule, bf16 compression with error feedback, and the
reference's own cases (tests/test_optim.py) run on the port.

Same seeded numpy inputs on both sides.  AdamW's parameters and moments
agree within 1e-6 of each tensor's max |x| (elementwise relative error is
unbounded where ``b1 * m + (1 - b1) * g`` cancels to near zero); its
``count`` is equal.  The schedule agrees within 1e-6 relative: XLA's
fused cosine differs from the C library's by a few f32 ulps.
``compress`` is bit-equal, residual included.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.optim import AdamW as JAdamW
from repro.optim import compress as jcompress
from repro.optim import global_norm as jglobal_norm
from repro.optim import warmup_cosine as jwarmup_cosine
from repro_torch.optim import AdamW, global_norm, warmup_cosine
from repro_torch.optim import compress as compress_mod

torch.set_num_threads(1)

SHAPES = {"a": (16, 8), "b": (8,), "c": (3, 4, 5), "d": (64,)}
DTYPES = {"f32": (jnp.float32, torch.float32),
          "bf16": (jnp.bfloat16, torch.bfloat16)}


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(x, np.float32)


def _close_to_max(got, want, rel):
    got, want = _np(got), _np(want)
    assert got.shape == want.shape
    err = float(np.max(np.abs(got - want)))
    assert err <= rel * float(np.max(np.abs(want))), err


@pytest.mark.parametrize("clip", [1.0, 0.0])
@pytest.mark.parametrize("moments", ["f32", "bf16"])
def test_adamw_update_equals_reference(rng, clip, moments):
    jdt, tdt = DTYPES[moments]
    jopt = JAdamW(clip_norm=clip, moment_dtype=jdt)
    topt = AdamW(clip_norm=clip, moment_dtype=tdt)
    p = {k: rng.normal(size=s).astype(np.float32) for k, s in SHAPES.items()}
    jp = {k: jnp.asarray(v) for k, v in p.items()}
    tp = {k: torch.from_numpy(v.copy()) for k, v in p.items()}
    js, ts = jopt.init(jp), topt.init(tp)
    assert all(ts.m[k].dtype == tdt for k in SHAPES)
    update = jax.jit(jopt.update)
    for i in range(5):
        g = {k: (rng.normal(size=s) * 3).astype(np.float32)
             for k, s in SHAPES.items()}
        lr = 1e-2 / (i + 1)
        jp, js = update({k: jnp.asarray(v) for k, v in g.items()}, js, jp,
                        jnp.float32(lr))
        tp2, ts = topt.update({k: torch.from_numpy(v) for k, v in g.items()},
                              ts, tp, lr)
        assert tp2 is tp                      # updated in place
        assert int(ts.count) == int(js.count) == i + 1
        for k in SHAPES:
            _close_to_max(tp[k], jp[k], 1e-6)
            _close_to_max(ts.m[k], js.m[k], 1e-6)
            _close_to_max(ts.v[k], js.v[k], 1e-6)
            assert ts.m[k].dtype == tdt


def test_adamw_reads_the_gradients_only(rng):
    g = {k: torch.from_numpy(rng.normal(size=s).astype(np.float32))
         for k, s in SHAPES.items()}
    before = {k: v.clone() for k, v in g.items()}
    params = {k: torch.zeros(s) for k, s in SHAPES.items()}
    opt = AdamW(clip_norm=0.5)
    opt.update(g, opt.init(params), params, 1e-3)
    assert all(torch.equal(g[k], before[k]) for k in g)


@pytest.mark.parametrize("peak,warmup,total", [(1.0, 10, 100),
                                               (3e-3, 5, 80),
                                               (1e-3, 5, 30),
                                               (3e-4, 100, 1000),
                                               (1e-3, 0, 7)])
def test_warmup_cosine_equals_reference(peak, warmup, total):
    kw = dict(peak_lr=peak, warmup_steps=warmup, total_steps=total)
    ref = jax.jit(lambda s: jwarmup_cosine(s, **kw))
    for s in range(2 * total + 1):
        got = warmup_cosine(s, **kw)
        assert got.dtype == torch.float32 and got.device.type == "cpu"
        want = np.float32(ref(s))
        np.testing.assert_allclose(got.item(), want, rtol=1e-6, atol=0)
        if s < warmup:
            assert np.float32(got.item()) == np.float32(
                jwarmup_cosine(s, **kw))


def test_compress_equals_reference_bit_for_bit(rng):
    g = {k: (rng.normal(size=s) * 10.0 ** rng.integers(-6, 2)).astype(
        np.float32) for k, s in SHAPES.items()}
    jres = jcompress.init_residual({k: jnp.zeros(s) for k, s in
                                    SHAPES.items()})
    tres = compress_mod.init_residual({k: torch.zeros(s) for k, s in
                                       SHAPES.items()})
    for _ in range(4):
        jq, jres = jcompress.compress({k: jnp.asarray(v) for k, v in
                                       g.items()}, jres)
        tq, tres = compress_mod.compress({k: torch.from_numpy(v) for k, v in
                                          g.items()}, tres)
        for k in SHAPES:
            assert tq[k].dtype == tres[k].dtype == torch.bfloat16
            np.testing.assert_array_equal(_np(tq[k]), _np(jq[k]))
            np.testing.assert_array_equal(_np(tres[k]), _np(jres[k]))
        g = {k: (v * 0.7 + 1e-4).astype(np.float32) for k, v in g.items()}


def test_global_norm_equals_reference(rng):
    g = {k: rng.normal(size=s).astype(np.float32) * 5
         for k, s in SHAPES.items()}
    want = float(jglobal_norm(g))
    got = global_norm({k: torch.from_numpy(v) for k, v in g.items()})
    assert got.dtype == torch.float32
    assert abs(float(got) - want) <= 1e-6 * want


# ---- the reference's cases (tests/test_optim.py), on the port ---------------

def test_adamw_converges_quadratic():
    opt = AdamW(weight_decay=0.0, clip_norm=0.0)
    params = {"w": torch.tensor([5.0, -3.0, 2.0])}
    target = torch.tensor([1.0, 2.0, -1.0])
    state = opt.init(params)
    for _ in range(400):
        g = {"w": 2 * (params["w"] - target)}
        params, state = opt.update(g, state, params, 0.05)
    np.testing.assert_allclose(params["w"].numpy(), target.numpy(),
                               atol=1e-2)


def test_grad_clip():
    opt = AdamW(clip_norm=1.0)
    params = {"w": torch.zeros(3)}
    state = opt.init(params)
    g = {"w": torch.tensor([1e6, 0.0, 0.0])}
    _, new_state = opt.update(g, state, params, 1.0)
    # post-clip first moment bounded by (1-b1) * clip_norm
    assert float(new_state.m["w"].abs().max()) <= 0.11


def test_schedule_shape():
    lrs = [float(warmup_cosine(s, peak_lr=1.0, warmup_steps=10,
                               total_steps=100)) for s in range(100)]
    assert lrs[0] < lrs[9] <= 1.0 + 1e-6          # warmup ascends
    assert abs(lrs[10] - 1.0) < 0.01              # peak
    assert lrs[-1] < 0.2                          # decays toward final_frac
    assert min(lrs[10:]) >= 0.1 - 1e-6            # floor


def test_compress_error_feedback_unbiased():
    """Error feedback: sum of compressed grads tracks sum of raw grads."""
    rng = np.random.default_rng(0)
    g_raw = [rng.normal(size=(64,)).astype(np.float32) * 1e-3
             for _ in range(50)]
    residual = compress_mod.init_residual({"w": torch.zeros(64)})
    total_c = np.zeros(64, np.float64)
    for g in g_raw:
        q, residual = compress_mod.compress({"w": torch.from_numpy(g)},
                                            residual)
        total_c += q["w"].double().numpy()
    total_raw = np.sum(np.asarray(g_raw, np.float64), axis=0)
    # residual carries the unflushed remainder
    total_c += residual["w"].double().numpy()
    np.testing.assert_allclose(total_c, total_raw, atol=5e-5)


def test_global_norm():
    t = {"a": torch.ones(4) * 3.0, "b": torch.ones(9) * 4.0}
    assert abs(float(global_norm(t)) - np.sqrt(9 * 4 + 16 * 9)) < 1e-4
