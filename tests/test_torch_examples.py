"""The port's three remaining examples, run at a small size on the CPU
with the checks each makes: ``quickstart`` (every answer against brute
force), ``distributed_topk_demo`` (each method's top-k against a stable
sort, and the reference demo's wire-byte model) and ``streaming_ingest``
(every answer against brute force over the live points, tombstones
never surfacing, every concurrent request resolved)."""

import contextlib
import io

import pytest
import torch

from repro_torch.examples import (distributed_topk_demo, quickstart,
                                  streaming_ingest)

torch.set_num_threads(1)


def _quiet(fn, argv):
    with contextlib.redirect_stdout(io.StringIO()) as out:
        res = fn(argv)
    return res, out.getvalue()


def test_quickstart():
    results, text = _quiet(quickstart.main, ["--points", str(8 * 512),
                                             "--device", "cpu"])
    assert [r.l for r in results] == [16, 1, 32, 7, 16]
    assert all(r.iterations > 0 and r.rounds > 0 for r in results)
    assert "match brute force — OK" in text


def test_distributed_topk_demo():
    rows, text = _quiet(distributed_topk_demo.main, [
        "--vocab", str(8 * 1000), "--batch", "4", "--ks", "8,64",
        "--reps", "1", "--device", "cpu"])
    assert [(k, m) for k, m, *_ in rows] == [
        (8, "selection"), (8, "gather"), (64, "selection"), (64, "gather")]
    for k, method, _, wire, iters in rows:
        if method == "gather":
            assert iters == 0 and wire == 8 * k * 8 * 4
        else:
            assert iters > 0
            assert wire == iters * 8 * 12 * 4 + 2 * k * 4 * 4
    assert "stable sort of the rows — OK" in text


@pytest.mark.parametrize("method,ksel,iters,want", [
    ("gather", 256, 0, 8 * 256 * 8 * 16),
    ("selection", 256, 19, 19 * 8 * 12 * 16 + 2 * 256 * 4 * 16),
])
def test_wire_byte_model_is_the_reference_demos(method, ksel, iters, want):
    assert distributed_topk_demo.wire_bytes(method, ksel, iters, 16) == want


def test_streaming_ingest():
    out, text = _quiet(streaming_ingest.main, ["--concurrent", "8",
                                               "--device", "cpu"])
    assert out["resolved"] == 8
    assert out["touched_after"] <= out["touched_before"]
    lo, hi = out["generations"]
    assert 0 < lo <= hi <= out["final_generation"]
    assert "matches brute force" in text and "explain" in text
