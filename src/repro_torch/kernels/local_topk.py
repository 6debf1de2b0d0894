"""The l smallest per row, with indices: the CUDA kernel's wrapper and its
plain PyTorch version.

Port of ``repro.kernels.local_topk`` (Pallas).  The kernel is
``csrc/local_topk.cu``.  A long row is split into chunks, one block per
(row, chunk), so that enough blocks fill the card; a second launch of the
same kernel merges the chunks' partial top-l lists with their indices
carried.  Ties go to the smaller index, as ``lax.top_k`` does.
"""

from __future__ import annotations

import functools

import torch

from repro_torch.kernels import _build, _cuda, ref

COUNT = _cuda.LaunchCounter("local_topk")

BLOCKS_PER_SM = 8      # 16 KB of shared memory and 256 threads a block
MIN_CHUNK = 4096       # columns below which a row is not split


@functools.lru_cache(maxsize=None)
def sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def local_topk_plain(values: torch.Tensor, l: int):
    """``(..., m) -> ((..., l) ascending f32, (..., l) int32 indices)``.

    Where ``l > m`` the missing slots are ``(+inf, 2**31-1)``, as the
    reference dispatcher's padded kernel returns them.
    """
    m = values.shape[-1]
    if l > m:
        pad = torch.full(values.shape[:-1] + (l - m,), float("inf"),
                         dtype=torch.float32, device=values.device)
        v, i = ref.local_topk_ref(torch.cat([values.float(), pad], -1), l)
        return v, torch.where(i < m, i, torch.full_like(i, ref.INT32_MAX))
    return ref.local_topk_ref(values, l)


def launch(values: torch.Tensor, ids, l: int, chunk: int):
    """One kernel launch over ``(rows, m)`` values (and int32 ids, or None
    for column indices): ``(rows, ceil(m / chunk), l)`` partial lists."""
    rows, m = values.shape
    nchunks = -(-m // chunk)
    out_v = torch.empty((rows, nchunks, l), dtype=torch.float32,
                        device=values.device)
    out_i = torch.empty((rows, nchunks, l), dtype=torch.int32,
                        device=values.device)
    if rows and m:
        _cuda.ok("local_topk", _build.library().knn_local_topk(
            values.data_ptr(), None if ids is None else ids.data_ptr(),
            out_v.data_ptr(), out_i.data_ptr(), rows, m, l, chunk,
            _cuda.dtype_code(values), _cuda.stream_of(values)))
        COUNT.add()
    else:
        out_v.fill_(float("inf"))
        out_i.fill_(ref.INT32_MAX)
    return out_v, out_i


def merge_partials(pv: torch.Tensor, pi: torch.Tensor, l: int):
    """``(rows, chunks, w)`` partial lists with ids (``w >= l``; one
    chunk: ``w == l``, already the answer) -> ``(rows, l)``."""
    rows, nchunks, w = pv.shape
    if nchunks == 1:
        return pv[:, 0], pi[:, 0]
    width = nchunks * w
    v, i = launch(pv.reshape(rows, width), pi.reshape(rows, width), l, width)
    return v[:, 0], i[:, 0]


def local_topk_cuda(values: torch.Tensor, l: int):
    """The kernel: ``(..., m) -> ((..., l) ascending f32, (..., l) int32)``."""
    _cuda.check_cuda("local_topk", values)
    _cuda.check_l("local_topk", l)
    _cuda.dtype_code(values)
    lead, m = values.shape[:-1], values.shape[-1]
    x = values.reshape(-1, m)
    rows = x.shape[0]
    target = BLOCKS_PER_SM * sm_count(values.device.index or 0)
    nchunks = max(1, min(-(-target // max(rows, 1)), m // MIN_CHUNK))
    chunk = max(-(-m // nchunks), 1)
    pv, pi = launch(x, None, l, chunk)
    v, i = merge_partials(pv, pi, l)
    return v.reshape(lead + (l,)), i.reshape(lead + (l,))
