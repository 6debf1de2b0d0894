"""The port's checkpoint substrate: the reference's cases
(tests/test_checkpoint.py, all but the mesh ones) on the port, the
snapshot of tensors the optimizer keeps writing in place, and
checkpoints read across the two packages (the same manifest and npz
layout)."""

import os
import threading

import numpy as np
import pytest
import torch

from repro.checkpoint import CheckpointManager as JManager
from repro.checkpoint import serialization as jser
from repro_torch.checkpoint import CheckpointManager, serialization
from repro_torch.optim import AdamW, AdamWState

torch.set_num_threads(1)


def _tree(rng):
    return {
        "layer": {"w": rng.normal(size=(16, 8)).astype(np.float32),
                  "b": rng.normal(size=(8,)).astype(np.float32)},
        "count": np.int32(7),
        "stack": rng.normal(size=(3, 4, 4)).astype(np.float32),
    }


def _leaves(tree):
    """Each leaf as ``(dtype name, numpy array)``; a bf16 tensor by its
    bits."""
    out = []
    for v in serialization.flatten(tree).values():
        if isinstance(v, torch.Tensor):
            name = str(v.dtype)
            v = v.view(torch.int16) if v.dtype == torch.bfloat16 else v
            out.append((name, v.numpy()))
        else:
            v = np.asarray(v)
            out.append((str(torch.from_numpy(v).dtype), v))
    return out


def _assert_same(got, want):
    assert list(serialization.flatten(got)) == list(
        serialization.flatten(want))
    for (da, a), (db, b) in zip(_leaves(got), _leaves(want)):
        assert da == db and a.shape == b.shape
        np.testing.assert_array_equal(a, b)


# ---- the reference's cases -----------------------------------------------

def test_roundtrip(tmp_path, rng):
    tree = _tree(rng)
    mgr = CheckpointManager(str(tmp_path), keep=3)
    mgr.save(10, tree, blocking=True)
    assert mgr.all_steps() == [10]
    out = mgr.restore(10, tree, device="cpu")
    assert all(isinstance(v, torch.Tensor)
               for v in serialization.flatten(out).values())
    _assert_same(out, tree)


def test_keep_n_pruning(tmp_path, rng):
    tree = _tree(rng)
    mgr = CheckpointManager(str(tmp_path), keep=2)
    for s in (1, 2, 3, 4):
        mgr.save(s, tree, blocking=True)
    assert mgr.all_steps() == [3, 4]


def test_async_save_then_wait(tmp_path, rng):
    tree = _tree(rng)
    mgr = CheckpointManager(str(tmp_path), keep=3)
    mgr.save(5, tree)          # async
    mgr.wait()
    assert mgr.latest_step() == 5


def test_no_tmp_dirs_left(tmp_path, rng):
    mgr = CheckpointManager(str(tmp_path), keep=3)
    mgr.save(1, _tree(rng), blocking=True)
    assert not [d for d in os.listdir(tmp_path) if d.startswith("tmp_")]


# ---- the port's own --------------------------------------------------------

def test_restore_runs_on_the_card_unless_asked(tmp_path, rng):
    tree = _tree(rng)
    mgr = CheckpointManager(str(tmp_path), keep=1)
    mgr.save(1, tree, blocking=True)
    assert mgr.restore_latest(tree, device="cpu")[0] == 1
    if torch.cuda.is_available():
        out = mgr.restore(1, tree)
        assert out["stack"].device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            mgr.restore(1, tree)


def test_snapshot_survives_in_place_updates(tmp_path, rng, monkeypatch):
    """A checkpoint saved at step s while the optimizer goes on writing
    the same tensors in place restores to the step-s values bit for bit:
    the writer is held until three more steps have run."""
    params = {k: torch.from_numpy(v) for k, v in
              (("w", rng.normal(size=(32, 16)).astype(np.float32)),
               ("b", rng.normal(size=(16,)).astype(np.float32)))}
    opt = AdamW(moment_dtype=torch.bfloat16)
    state = opt.init(params)

    def step():
        g = {k: torch.from_numpy(rng.normal(size=v.shape).astype(
            np.float32)) for k, v in params.items()}
        return opt.update(g, state, params, 1e-2)[1]

    state = step()
    tree = {"params": params, "opt": (state, None, torch.tensor(1))}
    want = {"params": {k: v.clone() for k, v in params.items()},
            "opt": (AdamWState(state.count.clone(),
                               {k: v.clone() for k, v in state.m.items()},
                               {k: v.clone() for k, v in state.v.items()}),
                    None, torch.tensor(1))}
    go = threading.Event()
    real = serialization.save_pytree

    def held(*a, **kw):
        assert go.wait(timeout=60)
        return real(*a, **kw)

    monkeypatch.setattr(serialization, "save_pytree", held)
    mgr = CheckpointManager(str(tmp_path), keep=2)
    mgr.save(1, tree)
    for _ in range(3):
        state = step()
    assert not torch.equal(params["w"], want["params"]["w"])
    go.set()
    mgr.wait()
    out = mgr.restore(1, tree, device="cpu")
    _assert_same(out, want)
    assert out["opt"][0].m["w"].dtype == torch.bfloat16
    assert out["opt"][1] is None


def test_writer_error_is_raised_by_wait(tmp_path, rng, monkeypatch):
    def broken(*a, **kw):
        raise OSError("disk full")

    monkeypatch.setattr(serialization, "save_pytree", broken)
    mgr = CheckpointManager(str(tmp_path), keep=2)
    mgr.save(3, _tree(rng))
    with pytest.raises(OSError, match="disk full"):
        mgr.wait()
    mgr.wait()                 # raised once
    assert mgr.all_steps() == []


def test_paths_follow_the_reference(rng):
    """Leaf paths are the reference's: sorted dict keys, tuple indices,
    a NamedTuple's fields as ``.name``, None an empty subtree."""
    import jax
    from repro.optim import AdamW as JAdamW
    p = {"w": np.zeros((2, 2), np.float32), "b": np.zeros(2, np.float32)}
    jtree = {"params": p, "opt": (JAdamW().init(p), None, np.int32(0))}
    flat, _ = jax.tree_util.tree_flatten_with_path(jtree)
    want = ["/".join(str(getattr(k, "key", getattr(k, "idx", k)))
                     for k in path) for path, _ in flat]
    tp = {k: torch.from_numpy(v) for k, v in p.items()}
    ttree = {"params": tp, "opt": (AdamW().init(tp), None,
                                   torch.tensor(0, dtype=torch.int32))}
    assert list(serialization.flatten(ttree)) == want


def test_port_checkpoint_loads_in_the_reference(tmp_path, rng):
    tree = _tree(rng)
    port_tree = {"layer": {k: torch.from_numpy(v) for k, v in
                           tree["layer"].items()},
                 "count": torch.tensor(7, dtype=torch.int32),
                 "stack": torch.from_numpy(tree["stack"])}
    serialization.save_pytree(port_tree, str(tmp_path / "d"))
    out = jser.load_pytree(str(tmp_path / "d"), tree)
    _assert_same(out, tree)
    mgr = CheckpointManager(str(tmp_path / "m"), keep=1)
    mgr.save(4, port_tree, blocking=True)
    _assert_same(JManager(str(tmp_path / "m")).restore(4, tree), tree)


def test_reference_checkpoint_loads_in_the_port(tmp_path, rng):
    tree = _tree(rng)
    jser.save_pytree(tree, str(tmp_path / "d"))
    out = serialization.load_pytree(str(tmp_path / "d"), tree)
    _assert_same(out, tree)
    JManager(str(tmp_path / "m")).save(2, tree, blocking=True)
    mgr = CheckpointManager(str(tmp_path / "m"))
    assert mgr.latest_step() == 2
    _assert_same(mgr.restore(2, tree, device="cpu"), tree)
