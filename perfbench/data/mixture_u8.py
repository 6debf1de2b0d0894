"""uint8 points and queries from a seeded mixture, made on the device:
SIFT-like descriptors, as BIGANN-1B publishes them (128-d uint8).

Parameters (the configuration's ``data.params``):

``centers``       number of mixture components
``center_scale``  each center coordinate is ``|N(0, 1)| * center_scale``
``spread``        standard deviation of a point's offset from its center,
                  per coordinate
``chunk_rows``    rows made by one call; chunk ``c`` is made from its own
                  seed, so any chunk can be made again alone

Each value is rounded to the nearest integer and clipped to [0, 255]:
many small values and norms of about 470-520 at the configuration's
parameters, as SIFT's.  Queries are further draws from the same mixture,
from their own seed.  The interface is :mod:`perfbench.data.mixture`'s,
with uint8 in place of f32; a chunk's f32 draw lives only while it is
made.
"""

from __future__ import annotations

import torch

from perfbench.data import mixture
from perfbench.seeds import sub_seed


def make_centers(d: int, params: dict, seed: int, device) -> torch.Tensor:
    g = mixture._gen(device, sub_seed(seed, "centers"))
    c = torch.randn((int(params["centers"]), d), generator=g, device=device)
    return c.abs_().mul_(float(params["center_scale"]))


def _u8(x: torch.Tensor) -> torch.Tensor:
    return x.round_().clamp_(0, 255).to(torch.uint8)


def chunk(c: int, n: int, centers: torch.Tensor, params: dict,
          seed: int) -> torch.Tensor:
    """Rows ``[c * chunk_rows, min(n, (c + 1) * chunk_rows))``, uint8."""
    rows = int(params["chunk_rows"])
    r0 = c * rows
    count = min(n, r0 + rows) - r0
    if count <= 0:
        raise IndexError(f"chunk {c} lies past n = {n}")
    return _u8(mixture._draw(count, centers, params,
                             mixture._gen(centers.device,
                                          sub_seed(seed, "points", c))))


def chunks(n: int, d: int, params: dict, seed: int, device):
    """``(first row, (rows, d) uint8)`` for every chunk, in order."""
    centers = make_centers(d, params, seed, device)
    rows = int(params["chunk_rows"])
    for c in range(-(-n // rows)):
        yield c * rows, chunk(c, n, centers, params, seed)


def points(n: int, d: int, params: dict, seed: int, device) -> torch.Tensor:
    """The whole ``(n, d)`` uint8 point set on ``device``."""
    out = torch.empty((n, d), dtype=torch.uint8, device=device)
    for r0, x in chunks(n, d, params, seed, device):
        out[r0:r0 + x.shape[0]].copy_(x)
        del x
    return out


def queries(count: int, d: int, params: dict, seed: int,
            device) -> torch.Tensor:
    """``(count, d)`` uint8 queries from the same mixture."""
    centers = make_centers(d, params, seed, device)
    return _u8(mixture._draw(count, centers, params,
                             mixture._gen(device, sub_seed(seed, "queries"))))
