"""The port's training path against the JAX package: the Markov data,
the loss and its gradients, rematerialisation, the microbatched train
step, and the reference's integration cases (tests/test_train_
integration.py) on the port, plus the two entry points.

Inputs are seeded numpy; the reference runs under ``jax.jit`` on the CPU
from ``api.init_params(PRNGKey(0))`` of qwen2-0.5b's reduced config, and
the port from the same weights carried across by
``convert.params_from_jax`` (which drops the reference's dummy heads;
their gradient is zero, so the global norm is the same).

Tolerances: the loss within 1e-5 and every gradient tensor within 1e-5
x its max |g|; over five train steps the loss, ce and lr within 1e-6
relative at every step, and the parameters held two ways:
  * every tensor's displacement over the five steps within 1% (relative
    L2) of the reference's;
  * at least 99% of all elements within 1e-5 x max |p|.
AdamW's step is ``m_hat / (sqrt(v_hat) + eps)``, about ``sign(g)`` in
the first steps whatever |g| is, so an element whose gradient is near
zero or changes sign moves by up to ~lr on a rounding-level difference
in g, and bf16 compression or accumulation flips a rounding now and
then; the zero-initialised key biases, which stay small, show it most.
"""

import contextlib
import io
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.configs as jconfigs
from repro.data import MarkovTokens as JMarkov
from repro.models import build_model as jbuild
from repro.models import layers as jlayers
from repro.optim import AdamW as JAdamW
from repro.runtime import TrainConfig as JTrainConfig
from repro.runtime import init_opt_state as jinit_opt_state
from repro.runtime import make_train_step as jmake_train_step
import repro_torch.configs as tconfigs
from repro_torch import convert
from repro_torch.checkpoint import CheckpointManager
from repro_torch.data import MarkovTokens, Prefetcher
from repro_torch.examples import train_100m
from repro_torch.launch import train as tlaunch
from repro_torch.models import build_model
from repro_torch.models import layers as tlayers
from repro_torch.models import transformer as ttr
from repro_torch.optim import AdamW
from repro_torch.runtime import (MetricLogger, SimulatedNodeFailure,
                                 StepWatchdog, TrainConfig, init_opt_state,
                                 make_train_step, train_loop)

torch.set_num_threads(1)

ARCH = "qwen2-0.5b"
B, S = 8, 32


def _np(tree):
    return jax.tree.map(np.asarray, tree)


@pytest.fixture(scope="module")
def ref():
    """The reference's reduced model, its seeded weights, and five
    Markov batches."""
    cfg = jconfigs.get(ARCH).reduced()
    api = jbuild(cfg)
    params = api.init_params(jax.random.PRNGKey(0))
    data = JMarkov(cfg.vocab, seed=3, branch=2, n_contexts=13)
    batches = [dict(zip(("tokens", "labels"), data.batch(s, B, S)))
               for s in range(5)]
    return api, params, batches


def _port_model(params, train=True):
    cfg = tconfigs.get(ARCH).reduced()
    model = ttr.Transformer(cfg)
    model.load_state_dict(convert.params_from_jax(_np(params), cfg))
    return model.requires_grad_(train)


# ---- data ----------------------------------------------------------------

@pytest.mark.parametrize("vocab,seed,branch,n_ctx", [(97, 5, 4, 61),
                                                     (256, 3, 2, 13),
                                                     (151936, 0, 2, 13)])
def test_markov_tokens_equal_reference_bit_for_bit(vocab, seed, branch,
                                                   n_ctx):
    want = JMarkov(vocab, seed=seed, branch=branch, n_contexts=n_ctx)
    got = MarkovTokens(vocab, seed=seed, branch=branch, n_contexts=n_ctx)
    for step, b, s in ((0, 2, 8), (7, 8, 32), (22, 3, 129), (1000, 1, 1)):
        for x, y in zip(got.batch(step, b, s), want.batch(step, b, s)):
            assert x.dtype == y.dtype == np.int32
            np.testing.assert_array_equal(x, y)
    assert got.entropy_floor == want.entropy_floor


# ---- loss and gradients -----------------------------------------------------

@pytest.mark.parametrize("masked", [False, True])
def test_cross_entropy_equals_reference(rng, masked):
    logits = (rng.normal(size=(3, 7, 50)) * 4).astype(np.float32)
    labels = rng.integers(0, 50, (3, 7)).astype(np.int32)
    mask = (rng.random((3, 7)) < 0.6).astype(np.float32) if masked else None
    want = float(jlayers.cross_entropy(jnp.asarray(logits),
                                       jnp.asarray(labels),
                                       None if mask is None
                                       else jnp.asarray(mask)))
    got = tlayers.cross_entropy(
        torch.from_numpy(logits), torch.from_numpy(labels),
        None if mask is None else torch.from_numpy(mask))
    assert got.dtype == torch.float32
    assert abs(float(got) - want) <= 1e-6 * abs(want)
    if masked:   # an all-zero mask divides by 1, not 0
        zero = tlayers.cross_entropy(torch.from_numpy(logits),
                                     torch.from_numpy(labels),
                                     torch.zeros(3, 7))
        assert float(zero) == 0.0


def test_loss_and_gradients_equal_reference(ref):
    api, params, batches = ref
    cfg = tconfigs.get(ARCH).reduced()
    (jl, jaux), jg = jax.jit(jax.value_and_grad(
        lambda p, b: api.loss_fn(p, b), has_aux=True))(params, batches[0])
    model = _port_model(params)
    tapi = build_model(cfg)
    loss, aux = tapi.loss_fn(model, batches[0])
    assert abs(float(loss.detach()) - float(jl)) <= 1e-5
    assert abs(float(aux["ce"].detach()) - float(jaux["ce"])) <= 1e-5
    assert float(aux["aux"]) == float(jaux["aux"]) == 0.0
    names = [n for n, _ in model.named_parameters()]
    grads = torch.autograd.grad(loss, list(model.parameters()))
    want = convert.params_from_jax(_np(jg), cfg)
    assert sorted(want) == sorted(names)
    for n, g in zip(names, grads):
        scale = float(want[n].abs().max())
        assert float((g - want[n]).abs().max()) <= 1e-5 * scale, n
    # the reference's dummy heads get no gradient, so dropping them keeps
    # the global norm
    a = jg["blocks"]["sub0"]["attn"]
    heads = convert.real_heads(cfg.n_heads_phys, cfg.n_kv_phys,
                               cfg.n_kv_heads, cfg.head_group)
    dummy = [h for h in range(cfg.n_heads_phys) if h not in heads]
    wq = np.asarray(a["wq"]).reshape(*a["wq"].shape[:2], -1, cfg.head_dim)
    assert np.all(wq[:, :, dummy] == 0)


def test_remat_gradients_bit_equal(ref):
    _, params, batches = ref
    api = build_model(tconfigs.get(ARCH).reduced())
    model = _port_model(params)
    out = {}
    for remat in (False, True):
        loss, _ = api.loss_fn(model, batches[1], remat=remat)
        out[remat] = (loss.detach(), torch.autograd.grad(
            loss, list(model.parameters())))
    assert torch.equal(out[False][0], out[True][0])
    for a, b in zip(out[False][1], out[True][1]):
        assert torch.equal(a, b)


def test_init_params_for_training_and_serving():
    api = build_model(tconfigs.get(ARCH).reduced())
    served = api.init_params(0, device="cpu")
    trained = api.init_params(0, device="cpu", train=True)
    assert not any(p.requires_grad for p in served.parameters())
    assert all(p.requires_grad for p in trained.parameters())
    assert not served.training and trained.training
    for a, b in zip(served.parameters(), trained.parameters()):
        assert torch.equal(a, b)


# ---- the train step --------------------------------------------------------

STEP_CASES = {          # grad_accum, compress_grads, accum_dtype
    "accum1": (1, False, "f32"),
    "accum2": (2, False, "f32"),
    "accum2_compressed": (2, True, "f32"),
    "accum2_bf16": (2, False, "bf16"),
}
_DT = {"f32": (jnp.float32, torch.float32),
       "bf16": (jnp.bfloat16, torch.bfloat16)}


def _configs(accum, comp, adt):
    kw = dict(grad_accum=accum, peak_lr=3e-3, warmup_steps=2,
              total_steps=10, compress_grads=comp)
    return (JTrainConfig(accum_dtype=_DT[adt][0], **kw),
            TrainConfig(accum_dtype=_DT[adt][1], **kw))


def _assert_same_trajectory(model, jparams, start):
    """Module docstring: displacements within 1% relative L2, 99% of the
    elements within 1e-5 x max |p|."""
    cfg = tconfigs.get(ARCH).reduced()
    want = convert.params_from_jax(_np(jparams), cfg)
    pmax = max(float(w.abs().max()) for w in want.values())
    out = total = 0
    for n, p in model.named_parameters():
        got = p.detach()
        out += int(((got - want[n]).abs() > 1e-5 * pmax).sum())
        total += got.numel()
        moved, moved_ref = got - start[n], want[n] - start[n]
        assert float((moved - moved_ref).norm()) <= 1e-2 * float(
            moved_ref.norm()), n
    assert out <= 0.01 * total, (out, total)


@pytest.mark.parametrize("case", list(STEP_CASES))
def test_train_step_equals_reference(ref, case):
    api, params, batches = ref
    jt, tt = _configs(*STEP_CASES[case])
    jopt, topt = JAdamW(weight_decay=0.01), AdamW(weight_decay=0.01)
    jstep = jax.jit(jmake_train_step(api, jt, jopt))
    jp, js = params, jinit_opt_state(api, jt, jopt, params)
    tapi = build_model(tconfigs.get(ARCH).reduced())
    model = _port_model(params)
    start = {n: p.detach().clone() for n, p in model.named_parameters()}
    ts = init_opt_state(tapi, tt, topt, model)
    tstep = make_train_step(tapi, tt, topt)
    for i, batch in enumerate(batches):
        jp, js, jm = jstep(jp, js, batch)
        model, ts, tm = tstep(model, ts, batch)
        for k in ("loss", "ce", "lr"):
            np.testing.assert_allclose(float(tm[k]), float(jm[k]),
                                       rtol=1e-6, err_msg=f"{k} step {i}")
        assert int(ts[2]) == int(js[2]) == i + 1
        assert int(ts[0].count) == int(js[0].count)
    _assert_same_trajectory(model, jp, start)
    if STEP_CASES[case][1]:
        assert all(r.dtype == torch.bfloat16 for r in ts[1].values())


def test_reference_state_carried_across(ref):
    """Two reference steps, then the reference's parameters and AdamW
    state (``convert.opt_state_from_jax``) continue in the port for three
    more: the same trajectory as the reference's five."""
    api, params, batches = ref
    jt, tt = _configs(2, False, "f32")
    jopt, topt = JAdamW(weight_decay=0.01), AdamW(weight_decay=0.01)
    jstep = jax.jit(jmake_train_step(api, jt, jopt))
    jp, js = params, jinit_opt_state(api, jt, jopt, params)
    for batch in batches[:2]:
        jp, js, _ = jstep(jp, js, batch)
    cfg = tconfigs.get(ARCH).reduced()
    model = _port_model(jp)
    adam = convert.opt_state_from_jax(_np(js[0]), cfg)
    assert int(adam.count) == 2
    names = [n for n, _ in model.named_parameters()]
    assert set(adam.m) == set(adam.v) == set(names)
    ts = (adam, None, torch.tensor(int(js[2]), dtype=torch.int32))
    tstep = make_train_step(build_model(cfg), tt, topt)
    start = {n: p.detach().clone() for n, p in model.named_parameters()}
    for batch in batches[2:]:
        jp, js, jm = jstep(jp, js, batch)
        model, ts, tm = tstep(model, ts, batch)
        np.testing.assert_allclose(float(tm["loss"]), float(jm["loss"]),
                                   rtol=1e-6)
    _assert_same_trajectory(model, jp, start)
    for n in names:
        m_ref = convert.opt_state_from_jax(_np(js[0]), cfg).m[n]
        assert float((ts[0].m[n] - m_ref).abs().max()) <= 1e-3 * float(
            m_ref.abs().max()), n


def test_opt_state_from_jax_keeps_bf16_moments(ref):
    api, params, _ = ref
    cfg = tconfigs.get(ARCH).reduced()
    state = JAdamW(moment_dtype=jnp.bfloat16).init(params)
    adam = convert.opt_state_from_jax(_np(state), cfg)
    assert all(v.dtype == torch.bfloat16 for v in adam.m.values())
    assert set(adam.v) == set(_port_model(params).state_dict())


# ---- the loop: the reference's integration cases on the port ----------------

def _setup(compress=False, steps=60):
    cfg = tconfigs.get(ARCH).reduced()
    api = build_model(cfg)
    params = api.init_params(0, device="cpu", train=True)
    tcfg = TrainConfig(grad_accum=2, peak_lr=3e-3, warmup_steps=5,
                       total_steps=steps + 20, compress_grads=compress)
    opt = AdamW(weight_decay=0.01)
    opt_state = init_opt_state(api, tcfg, opt, params)
    data = MarkovTokens(cfg.vocab, seed=3, branch=2, n_contexts=13)

    def make_batch(step):
        t, l = data.batch(step, B, S)
        return {"tokens": t, "labels": l}

    return api, tcfg, opt, params, opt_state, make_batch


def _run(compress=False, num_steps=50, **kw):
    api, tcfg, opt, params, opt_state, make_batch = _setup(compress)
    logger = MetricLogger(quiet=True)
    out = train_loop(api=api, tcfg=tcfg, optimizer=opt, params=params,
                     opt_state=opt_state, make_batch=make_batch,
                     num_steps=num_steps, logger=logger, device="cpu", **kw)
    return out, logger


@pytest.mark.parametrize("compress", [False, True])
def test_loss_decreases(compress):
    """The reference's test_loss_decreases and
    test_compressed_grads_still_learn."""
    _, logger = _run(compress)
    losses = [r["loss"] for r in logger.history if "loss" in r]
    assert len(losses) == 50
    assert losses[-1] < losses[0] - 1.0, (losses[0], losses[-1])


def test_fault_injection_restart(tmp_path):
    """The reference's case, plus: the run that lost step 22 ends with
    parameters and optimizer state bit-equal to an uninterrupted run."""
    mgr = CheckpointManager(str(tmp_path), keep=2)
    crashed = {"n": 0}

    def fail_at(step):
        if step == 22 and crashed["n"] == 0:
            crashed["n"] += 1
            raise SimulatedNodeFailure("injected node loss")

    (params, opt_state, step), logger = _run(
        num_steps=30, ckpt_manager=mgr, ckpt_every=10, fail_at=fail_at)
    assert step == 30
    assert crashed["n"] == 1
    events = [r for r in logger.history if "event" in r]
    assert len(events) == 1 and events[0]["step"] == 22
    assert "SimulatedNodeFailure" in events[0]["event"]
    steps = [r["step"] for r in logger.history if "loss" in r]
    assert steps == list(range(22)) + list(range(20, 30))
    losses = {}
    for r in logger.history:
        if "loss" in r:
            losses.setdefault(r["step"], []).append(r["loss"])
    assert losses[20][0] == losses[20][1] and losses[21][0] == losses[21][1]
    assert mgr.all_steps() == [20, 30]

    (p2, o2, _), _ = _run(num_steps=30)
    for (n, a), b in zip(params.named_parameters(), p2.parameters()):
        assert torch.equal(a, b), n
    for k in o2[0].m:
        assert torch.equal(opt_state[0].m[k], o2[0].m[k])
        assert torch.equal(opt_state[0].v[k], o2[0].v[k])
    assert int(opt_state[0].count) == int(o2[0].count) == 30
    assert int(opt_state[2]) == 30


def test_restart_without_a_checkpoint_manager_raises():
    def fail_at(step):
        raise SimulatedNodeFailure("lost")

    with pytest.raises(SimulatedNodeFailure):
        _run(num_steps=3, fail_at=fail_at)


def test_loop_runs_on_the_card_unless_asked():
    api, tcfg, opt, params, opt_state, make_batch = _setup()
    kw = dict(api=api, tcfg=tcfg, optimizer=opt, params=params,
              opt_state=opt_state, make_batch=make_batch, num_steps=1)
    if torch.cuda.is_available():
        with pytest.raises(ValueError, match="the loop runs on cuda"):
            train_loop(**kw)
    else:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            train_loop(**kw)


def test_straggler_watchdog():
    w = StepWatchdog(factor=3.0, warmup=3)
    for _ in range(10):
        assert not w.observe(0.1)
    assert w.observe(1.0)      # 10x the median -> flagged
    assert w.flagged


@pytest.mark.parametrize("device", [None, "cpu"])
def test_prefetcher_determinism_and_shutdown(device):
    data = MarkovTokens(97, seed=5)

    def make(step):
        t, l = data.batch(step, 2, 8)
        return {"tokens": t, "labels": l}

    pf = Prefetcher(make, prefetch=2, device=device)
    got = [next(pf) for _ in range(4)]
    pf.close()
    assert not pf._thread.is_alive()
    assert len(pf.produce_times) >= 4
    # determinism: regenerating the same steps gives identical batches
    for step, batch in got:
        t, l = data.batch(step, 2, 8)
        if device is not None:
            assert isinstance(batch["tokens"], torch.Tensor)
            batch = {k: v.numpy() for k, v in batch.items()}
        np.testing.assert_array_equal(batch["tokens"], t)
        np.testing.assert_array_equal(batch["labels"], l)
    assert [s for s, _ in got] == [0, 1, 2, 3]


# ---- entry points ---------------------------------------------------------

def test_launch_train_on_cpu(capsys, tmp_path):
    step, losses = tlaunch.main(["--reduced", "--steps", "2", "--batch",
                                 "2", "--seq", "16", "--device", "cpu"])
    assert step == 2 and len(losses) == 2
    assert all(math.isfinite(x) for x in losses)
    assert "done: steps=2 first_loss=" in capsys.readouterr().out
    # with checkpoints: a second run resumes from the first's last one
    args = ["--reduced", "--batch", "2", "--seq", "16", "--device", "cpu",
            "--ckpt-dir", str(tmp_path), "--ckpt-every", "2"]
    tlaunch.main(args + ["--steps", "4"])
    assert CheckpointManager(str(tmp_path)).all_steps() == [2, 4]
    step, losses = tlaunch.main(args + ["--steps", "6"])
    assert step == 6 and len(losses) == 2
    assert '"event": "resumed from checkpoint"' in capsys.readouterr().err


def test_train_100m_example_on_cpu():
    with contextlib.redirect_stdout(io.StringIO()) as out:
        losses = train_100m.main(["--tiny", "--steps", "4", "--device",
                                  "cpu"])
    assert len(losses) == 4
    assert "checkpoints kept: []" in out.getvalue()
