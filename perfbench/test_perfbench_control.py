"""The check separates sound runs from unsound ones: at a tiny size on
the CPU, the program's run is correct, the control (the reference one
precision below f32, TF32) fails a limit, and each fault a cell can have,
planted under a run, turns ``correct`` false."""

import json
import os
import subprocess
import sys

import pytest
import torch

from perfbench import check, control, harness, spec, tiny

CELLS = ["deep1b.batch128_l100", "knnlm.score128_l1024"]
SEED = 2**33 + 101
INT32_MAX = 2**31 - 1


def run(name, seed=SEED):
    return harness.run_cell(tiny.cell(name), seed, 0.01, False, "cpu", 0.0)


@pytest.mark.parametrize("name", CELLS)
def test_program_run_is_correct(name):
    line = run(name)
    checks = line["checks"]
    assert line["correct"], checks
    assert checks["sampled"]["value"] == 16 and line["failed"] == 0
    assert list(line) == ["correct", "attempted", "failed", "metrics",
                          "device", "phases", "batches", "checks"]


@pytest.mark.parametrize("name", CELLS)
def test_control_fails_a_limit(name):
    c = tiny.cell(name)
    values = control.control(c, SEED, "cpu")
    ok, table = check.verdict(values, c.workload["check"]["limits"])
    assert values["bad_answers"] == 0
    assert not ok
    assert values["dist_gap"] > c.workload["check"]["limits"][
        "dist_gap"], table


def _unchanged(knn, monkeypatch):
    """The answer buffers come back as they were made."""
    def gather(d, gid, mask, l):
        B = d.shape[1]
        return (torch.full((B, l), float("inf")),
                torch.full((B, l), INT32_MAX, dtype=torch.int32))
    monkeypatch.setattr(knn, "gather_selected", gather)


def _half_batch(knn, monkeypatch):
    """The second half of each bucket is left out (rank 0)."""
    orig = knn.knn_query_batched

    def batched(points, ids, queries, l_max, l, gen, **kw):
        l = l.clone()
        l[queries.shape[0] // 2:] = 0
        return orig(points, ids, queries, l_max, l, gen, **kw)
    monkeypatch.setattr(knn, "knn_query_batched", batched)


def _no_exchange(knn, monkeypatch):
    """The final sum over the shards is left out: shard 0's winners."""
    monkeypatch.setattr(knn, "psum", lambda x: x[0])


def _altered(knn, monkeypatch):
    """The first id of every answer is changed where it is produced."""
    orig = knn.gather_selected

    def gather(d, gid, mask, l):
        dists, ids = orig(d, gid, mask, l)
        ids = ids.clone()
        ids[:, 0] += 1
        return dists, ids
    monkeypatch.setattr(knn, "gather_selected", gather)


FAULTS = {"unchanged": _unchanged, "half_batch": _half_batch,
          "no_exchange": _no_exchange, "altered": _altered}


@pytest.mark.parametrize("fault", sorted(FAULTS))
@pytest.mark.parametrize("name", CELLS)
def test_planted_fault_is_caught(name, fault, monkeypatch):
    from repro_torch.core import knn

    FAULTS[fault](knn, monkeypatch)
    line = run(name)
    assert not line["correct"], line["checks"]


def test_command_without_a_card_prints_no_result():
    # the child sees no card, also on a host that has one
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    p = subprocess.run(
        [sys.executable, str(spec.HERE / "run.py"), "--workload",
         CELLS[0], "--seed", str(2**31 + 5), "--seconds", "1",
         "--trace", "0"], capture_output=True, text=True, timeout=300,
        cwd=spec.REPO, env=env)
    assert p.returncode != 0
    for text in p.stdout.splitlines():
        with pytest.raises(json.JSONDecodeError):
            json.loads(text)
