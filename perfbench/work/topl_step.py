"""The distance + top-l step of one batch: ``(B, d)`` queries against
``n`` points split over ``k`` shards, each shard's ``l_max`` smallest
(value, id) pairs written.

Operations: ``2 B n d`` (a product and a sum per coordinate, rows the
batch's real rows).  Bytes: the points read once (``n d`` f32), the
queries read once, and the ``k B l_max`` (f32 value, int32 id) results
written once.  The count is the step's, whatever kernels carry it out:
a distance matrix that an implementation writes and reads back is its
own cost, not the step's work.
"""

from __future__ import annotations


def work(n: int, d: int, k: int, b: int, l_max: int,
         elem_bytes: int = 4) -> tuple[float, float]:
    """``(operations, bytes)`` of one batch of ``b`` real rows."""
    flops = 2.0 * b * n * d
    nbytes = (n * d * elem_bytes + b * d * elem_bytes
              + k * b * l_max * (elem_bytes + 4))
    return flops, float(nbytes)


def window_bound_s(config: dict, batches, peaks: dict) -> float:
    """The step's work bound summed over ``batches`` (dicts with
    ``n_real``) of a configuration file's shapes."""
    from perfbench.work import bound_s

    n, d = int(config["n_points"]), int(config["dim"])
    k, l_max = int(config["shards"]), int(config["service"]["l_max"])
    return sum(bound_s(*work(n, d, k, b["n_real"], l_max), peaks)
               for b in batches)
