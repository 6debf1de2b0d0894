"""The reference's top-l against a naive numpy sort (ties to the smaller
id), its TF32 rounding, and the comparison's numbers."""

import numpy as np
import pytest
import torch

from perfbench import check
from perfbench.reference import exact_topl


def naive(q, p, l):
    d = ((q[:, None, :].astype(np.float64) - p[None].astype(np.float64))
         ** 2).sum(-1)
    ids = np.arange(p.shape[0])
    out_d, out_i = [], []
    for row in d:
        order = np.lexsort((ids, row))[:l]
        out_d.append(row[order])
        out_i.append(order)
    return np.array(out_d), np.array(out_i)


def chunks_of(p, rows):
    for r0 in range(0, len(p), rows):
        yield r0, torch.from_numpy(p[r0:r0 + rows])


@pytest.mark.parametrize("rows,l", [(7, 5), (16, 40), (64, 64), (5, 3)])
def test_top_l_matches_naive_sort_with_ties(rows, l):
    rng = np.random.default_rng(rows * 100 + l)
    # small integers: many exact ties, and duplicate points
    p = rng.integers(0, 4, (64, 3)).astype(np.float32)
    q = rng.integers(0, 4, (9, 3)).astype(np.float32)
    ref = exact_topl.scan(torch.from_numpy(q), l, chunks_of(p, rows),
                          block_bytes=8 * rows * 4)
    want_d, want_i = naive(q, p, l)
    np.testing.assert_array_equal(ref["top_i"].numpy(), want_i)
    np.testing.assert_array_equal(ref["top_d"].numpy(), want_d)
    assert ref["max_norm2"] == float((p.astype(np.float64) ** 2).sum(1)
                                     .max())


def test_top_l_pads_past_the_points_and_measures_served_ids():
    rng = np.random.default_rng(1)
    p = rng.standard_normal((10, 4)).astype(np.float32)
    q = rng.standard_normal((3, 4)).astype(np.float32)
    served = np.array([[0, 9, -1, 10], [3, 3, 4, -1], [-1, -1, -1, -1]])
    ref = exact_topl.scan(torch.from_numpy(q), 12, chunks_of(p, 4),
                          torch.from_numpy(served))
    assert np.all(ref["top_i"].numpy()[:, 10:] == exact_topl.ID_PAD)
    assert np.all(np.isinf(ref["top_d"].numpy()[:, 10:]))
    sd = ref["served_d"].numpy()
    want = ((q[0].astype(np.float64) - p[9].astype(np.float64)) ** 2).sum()
    assert sd[0, 1] == pytest.approx(want, rel=1e-15)
    assert np.isnan(sd[0, 2]) and np.isnan(sd[0, 3]) and np.isnan(sd[2]).all()
    assert sd[1, 0] == sd[1, 1]


def test_round_tf32_keeps_ten_mantissa_bits():
    x = torch.tensor([1.0, 1.0 + 2.0 ** -10, 1.0 + 2.0 ** -11,
                      1.0 + 3 * 2.0 ** -11, 1.0 + 2.0 ** -12, -3.0])
    got = exact_topl.round_tf32(x)
    want = torch.tensor([1.0, 1.0 + 2.0 ** -10, 1.0, 1.0 + 2 * 2.0 ** -10,
                         1.0, -3.0])
    assert torch.equal(got, want)


def test_control_distances_differ_from_f32():
    rng = np.random.default_rng(2)
    p = rng.standard_normal((256, 96)).astype(np.float32)
    q = rng.standard_normal((8, 96)).astype(np.float32)
    f64 = exact_topl.scan(torch.from_numpy(q), 10, chunks_of(p, 256))
    tf = exact_topl.scan(torch.from_numpy(q), 10, chunks_of(p, 256),
                         precision="tf32")
    gap = np.abs(tf["top_d"].double().numpy() - f64["top_d"].numpy()).max()
    assert 1e-5 < gap / (2 * 96 + f64["max_norm2"]) < 1e-2


def judge(served_d, served_i, ls, p, q):
    width = max(ls)
    ref = exact_topl.scan(torch.from_numpy(q), width, chunks_of(p, 16),
                          torch.from_numpy(check.served_matrix(served_i,
                                                               width)))
    return check.numbers(served_d, served_i, ls, ref, len(p),
                         (q.astype(np.float64) ** 2).sum(1))


def test_numbers_exact_answers_and_faults():
    rng = np.random.default_rng(3)
    p = rng.standard_normal((80, 8)).astype(np.float32)
    q = rng.standard_normal((4, 8)).astype(np.float32)
    d, i = naive(q, p, 6)
    served_d = [x.astype(np.float32) for x in d]
    served_i = [x.astype(np.int32) for x in i]
    ok = judge(served_d, served_i, [6] * 4, p, q)
    assert ok["bad_answers"] == 0
    assert ok["dist_gap"] < 1e-7 and ok["rank_gap"] < 1e-12
    # a wrong neighbour: its distance is not the one served, and the set
    # is not the nearest
    wrong_i = [x.copy() for x in served_i]
    wrong_i[1][0] = int(i[1][-1] + 1) % 80 if i[1][-1] + 1 not in i[1] else 79
    bad = judge(served_d, wrong_i, [6] * 4, p, q)
    assert bad["dist_gap"] > 1e-3 or bad["rank_gap"] > 1e-3
    # a sentinel, a repeated id, a short answer: malformed
    sent = [x.copy() for x in served_i]
    sent[0][2] = 2**31 - 1
    rep = [x.copy() for x in served_i]
    rep[2][1] = rep[2][0]
    short = served_i[:3] + [served_i[3][:5]]
    for ids in (sent, rep, short):
        assert judge(served_d, ids, [6] * 4, p, q)["bad_answers"] == 1


def test_verdict_holds_exact_numbers_to_zero():
    ok, table = check.verdict({"unanswered": 0, "bad_answers": 0,
                               "dist_gap": 1e-7, "rank_gap": 0.0},
                              {"dist_gap": 1e-6, "rank_gap": 1e-6})
    assert ok and table["unanswered"] == {"value": 0, "limit": 0}
    assert not check.verdict({"unanswered": 1, "dist_gap": 0.0},
                             {"dist_gap": 1.0})[0]
    assert not check.verdict({"dist_gap": 2e-6}, {"dist_gap": 1e-6})[0]
