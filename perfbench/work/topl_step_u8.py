"""The uint8 distance + top-l step of one batch: ``(B, d)`` queries
against ``n`` uint8 points split over ``k`` shards, each shard's
``l_max`` smallest (value, id) pairs written.

Operations: ``2 B n d`` (a product and a sum per coordinate, rows the
batch's real rows).  Bytes: the points read once at one byte a
coordinate, the queries read once (the step is handed f32 queries), and
the ``k B l_max`` (f32 value, int32 id) results written once.  The
bound: the larger of the operations over the int8 dense tensor-core peak
(the uint8 product's own, not ``peaks.json``'s f32 rate, so that no
kernel of this step can read above its roofline) and the bytes over the
memory's peak.  The count is the step's, whatever kernels carry it out.
"""

from __future__ import annotations

# NVIDIA H100 Tensor Core GPU datasheet, SXM5 column: INT8 Tensor Core,
# 1,979 TOPS dense (3,958 with sparsity), at the 700 W limit
INT8_DENSE_OPS_PER_S = 1.979e15
QUERY_BYTES = 4


def work(n: int, d: int, k: int, b: int, l_max: int) -> tuple[float, float]:
    """``(operations, bytes)`` of one batch of ``b`` real rows."""
    ops = 2.0 * b * n * d
    nbytes = n * d * 1 + b * d * QUERY_BYTES + k * b * l_max * 8
    return ops, float(nbytes)


def bound_s(ops: float, nbytes: float, peaks: dict) -> float:
    """The least time the chip could take for the step."""
    return max(ops / INT8_DENSE_OPS_PER_S, nbytes / peaks["hbm_bytes_per_s"])


def window_bound_s(config: dict, batches, peaks: dict) -> float:
    """The step's bound summed over ``batches`` (dicts with ``n_real``)
    of a configuration file's shapes."""
    n, d = int(config["n_points"]), int(config["dim"])
    k, l_max = int(config["shards"]), int(config["service"]["l_max"])
    return sum(bound_s(*work(n, d, k, b["n_real"], l_max), peaks)
               for b in batches)
