"""Points and queries from a seeded mixture, made on the device.

Parameters (the configuration's ``data.params``):

``centers``       number of mixture components
``center_scale``  standard deviation of each center coordinate
``spread``        standard deviation of a point's offset from its center,
                  per coordinate
``normalize``     scale every center and every point to unit length
                  (descriptors compared by L2 on the sphere)
``chunk_rows``    rows made by one call; chunk ``c`` is made from its own
                  seed, so any chunk can be made again alone

Queries are further draws from the same mixture, from their own seed.
The stream of chunk ``c`` under ``seed`` does not depend on where the
chunk is stored, so the reference makes the same rows again chunk by
chunk (:func:`chunks`) without holding a second copy.
"""

from __future__ import annotations

import torch

from perfbench.seeds import sub_seed


def _gen(device, seed: int) -> torch.Generator:
    g = torch.Generator(device=device)
    g.manual_seed(seed)
    return g


def make_centers(d: int, params: dict, seed: int, device) -> torch.Tensor:
    g = _gen(device, sub_seed(seed, "centers"))
    c = torch.randn((int(params["centers"]), d), generator=g, device=device)
    c.mul_(float(params["center_scale"]))
    if params.get("normalize"):
        c.div_(c.norm(dim=1, keepdim=True))
    return c


def _draw(rows: int, centers: torch.Tensor, params: dict,
          g: torch.Generator) -> torch.Tensor:
    dev = centers.device
    lab = torch.randint(0, centers.shape[0], (rows,), generator=g,
                        device=dev)
    x = torch.randn((rows, centers.shape[1]), generator=g, device=dev)
    x.mul_(float(params["spread"])).add_(centers.index_select(0, lab))
    if params.get("normalize"):
        x.div_(x.norm(dim=1, keepdim=True))
    return x


def chunk(c: int, n: int, centers: torch.Tensor, params: dict,
          seed: int) -> torch.Tensor:
    """Rows ``[c * chunk_rows, min(n, (c + 1) * chunk_rows))``, f32."""
    rows = int(params["chunk_rows"])
    r0 = c * rows
    count = min(n, r0 + rows) - r0
    if count <= 0:
        raise IndexError(f"chunk {c} lies past n = {n}")
    return _draw(count, centers, params,
                 _gen(centers.device, sub_seed(seed, "points", c)))


def chunks(n: int, d: int, params: dict, seed: int, device):
    """``(first row, (rows, d) f32)`` for every chunk, in order."""
    centers = make_centers(d, params, seed, device)
    rows = int(params["chunk_rows"])
    for c in range(-(-n // rows)):
        yield c * rows, chunk(c, n, centers, params, seed)


def points(n: int, d: int, params: dict, seed: int, device) -> torch.Tensor:
    """The whole ``(n, d)`` f32 point set on ``device``."""
    out = torch.empty((n, d), dtype=torch.float32, device=device)
    for r0, x in chunks(n, d, params, seed, device):
        out[r0:r0 + x.shape[0]].copy_(x)
        del x
    return out


def queries(count: int, d: int, params: dict, seed: int,
            device) -> torch.Tensor:
    """``(count, d)`` f32 queries from the same mixture."""
    centers = make_centers(d, params, seed, device)
    return _draw(count, centers, params,
                 _gen(device, sub_seed(seed, "queries")))
