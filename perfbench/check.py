"""The comparison that decides ``correct``.

Each sampled answer (``ids``, ``dists`` of length ``l``) is judged
against the reference's exact top-l of its query:

``unanswered``   requests of the window that never resolved or raised;
                 limit 0
``bad_answers``  sampled answers that are malformed: not ``l`` long, an
                 id outside the points (the sentinel included), an id
                 twice, a distance not finite or not ascending; limit 0
``dist_gap``     the widest gap between a served distance and the f64
                 distance of the id it names
``rank_gap``     the widest gap between the j-th smallest f64 distance
                 of the served ids and the j-th of the exact top-l: 0
                 when the served set is the exact one, small where a
                 near tie at the cut went the other way

The two gaps are shares of ``|q|^2 + max |p|^2``, the magnitude at
which the expanded distance ``|q|^2 - 2 q.p + |p|^2`` rounds.  Their
limits are the workload's (``check.limits``), set from the program's
readings and the control's (PERF.md).
"""

from __future__ import annotations

import numpy as np

EXACT = ("unanswered", "bad_answers")


def numbers(served_d, served_i, ls, ref: dict, n_points: int,
            q_norm2) -> dict:
    """The compared numbers of ``S`` sampled answers.

    ``served_d`` / ``served_i``: lists of the answers' arrays;
    ``ls``: their ranks; ``ref``: :func:`reference.exact_topl.scan`'s
    output over the same queries with ``served_ids`` from
    :func:`served_matrix`; ``q_norm2``: ``(S,)`` squared query norms.
    """
    top_d = ref["top_d"].double().cpu().numpy()
    sd64 = ref["served_d"].cpu().numpy()
    bad, dist_gap, rank_gap = 0, 0.0, 0.0
    for s, (d, i, l) in enumerate(zip(served_d, served_i, ls)):
        d = np.asarray(d, np.float64)
        i = np.asarray(i, np.int64)
        if (len(d) != l or len(i) != l or not np.all(np.isfinite(d))
                or np.any(i < 0) or np.any(i >= n_points)
                or len(np.unique(i)) != l or np.any(np.diff(d) < 0)):
            bad += 1
            continue
        scale = float(q_norm2[s]) + ref["max_norm2"]
        exact = sd64[s, :l]
        dist_gap = max(dist_gap, float(np.abs(d - exact).max()) / scale)
        gap = np.sort(exact) - top_d[s, :l]
        rank_gap = max(rank_gap, max(0.0, float(gap.max())) / scale)
    return {"bad_answers": bad, "dist_gap": dist_gap, "rank_gap": rank_gap}


def served_matrix(served_i, width: int) -> np.ndarray:
    """``(S, width)`` int64 of the served ids, -1 past each answer and
    where an id lies outside int64's use (malformed answers are judged
    by :func:`numbers`)."""
    out = np.full((len(served_i), width), -1, np.int64)
    for s, i in enumerate(served_i):
        i = np.asarray(i, np.int64)[:width]
        out[s, :len(i)] = i
    return out


def verdict(values: dict, limits: dict) -> tuple[bool, dict]:
    """``(correct, {name: {"value", "limit"}})``: the exact numbers are
    held to 0, the gaps to the workload's limits."""
    table = {}
    ok = True
    for name, value in values.items():
        limit = 0 if name in EXACT else limits[name]
        table[name] = {"value": value, "limit": limit}
        ok = ok and value <= limit
    return ok, table
