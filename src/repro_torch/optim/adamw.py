"""AdamW with global-norm clipping, updating in place.

Port of ``repro.optim.adamw``.  A tree is a dict of name -> tensor (a
model's ``named_parameters()``); the moments are dicts with the same
keys, in ``moment_dtype`` (f32 or bf16), and their arithmetic is f32
whatever they are stored in.  The order of operations is the
reference's: clip by the global norm (``+1e-9``), bias-correct with
``1 - b^count`` in f32, ``step = m_hat / (sqrt(v_hat) + eps) + wd * p``,
then ``p - lr * step``.

Unlike the reference, which returns new arrays, ``update`` writes the
parameters and the moments in place (``torch._foreach_*`` ops under
``no_grad``) and returns them; the gradients are only read.  ``count``
is a 0-dim int32 tensor on the host, so the bias corrections need no
device sync.

Under a mesh the parameters, gradients and moments are DTensors of the
same placements (the trainer redistributes each gradient to its
parameter's first), so every ``_foreach_*`` op runs shard by shard;
the global norm sums the shards' squares over the mesh.
``state_specs`` / ``state_shapes`` give the state's layout: the moments
shard exactly like their parameters (ZeRO).
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.models.sharding import P, Shape, gathered, is_dtensor


class AdamWState(NamedTuple):
    count: torch.Tensor     # 0-dim int32, host
    m: dict                 # like params, moment_dtype
    v: dict                 # like params, moment_dtype


class AdamW(NamedTuple):
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0
    # bf16 moments halve the optimizer's residency; their arithmetic
    # stays f32
    moment_dtype: torch.dtype = torch.float32

    def init(self, params: dict) -> AdamWState:
        def zeros():
            return {k: torch.zeros_like(p, dtype=self.moment_dtype,
                                        requires_grad=False)
                    for k, p in params.items()}
        return AdamWState(count=torch.zeros((), dtype=torch.int32),
                          m=zeros(), v=zeros())

    @torch.no_grad()
    def update(self, grads: dict, state: AdamWState, params: dict, lr):
        """One step at learning rate ``lr`` (a float or a 0-dim f32
        tensor): writes ``params`` and ``state``'s moments in place and
        returns ``(params, AdamWState)`` with the count advanced."""
        keys = list(params)
        g = [grads[k].float() for k in keys]
        if self.clip_norm > 0:
            gn = global_norm(g)
            scale = torch.clamp(
                torch.full_like(gn, self.clip_norm) / (gn + 1e-9), max=1.0)
            g = torch._foreach_mul(g, scale)

        count = state.count + 1
        b1c = float(1.0 - self.b1 ** count.float())
        b2c = float(1.0 - self.b2 ** count.float())

        # f32 copies of the new moments, turned into the step in place
        step = self._moment([state.m[k] for k in keys], g, self.b1, False)
        den = self._moment([state.v[k] for k in keys], g, self.b2, True)
        del g
        torch._foreach_div_(step, b1c)
        torch._foreach_div_(den, b2c)
        torch._foreach_sqrt_(den)
        torch._foreach_add_(den, self.eps)
        torch._foreach_div_(step, den)
        del den
        p = [params[k] for k in keys]
        p32 = [x.float() for x in p]
        torch._foreach_add_(step, p32, alpha=self.weight_decay)
        torch._foreach_add_(p32, step, alpha=-float(lr))
        for x, x32 in zip(p, p32):
            if x is not x32:
                x.copy_(x32)
        return params, AdamWState(count=count, m=state.m, v=state.v)

    def state_specs(self, param_specs: dict) -> AdamWState:
        """The state's specs: the moments like their parameters."""
        return AdamWState(count=P(), m=dict(param_specs),
                          v=dict(param_specs))

    def state_shapes(self, param_shapes: dict) -> AdamWState:
        """``sharding.Shape`` stand-ins for the state (no allocation): the
        moments in ``moment_dtype``, laid out like their parameters."""
        mom = {k: Shape(s.shape, self.moment_dtype, s.spec, s.local)
               for k, s in param_shapes.items()}
        return AdamWState(count=Shape((), torch.int32, None, ()), m=mom,
                          v=dict(mom))

    def _moment(self, stored, g, b, squared):
        """``b * mom + (1 - b) * g`` (or ``g * g``) in f32, written back to
        the stored moments; returns an f32 copy of what was stored.  The
        sum is ``fma(mom, b, (1 - b) * g)``, as XLA contracts it."""
        new = torch._foreach_mul(g, 1 - b)
        if squared:
            torch._foreach_mul_(new, g)
        torch._foreach_add_(new, [x.float() for x in stored], alpha=b)
        foreach_copy_(stored, new)
        return (new if self.moment_dtype == torch.float32
                else [x.float() for x in stored])


def foreach_copy_(dst: list, src: list):
    """``torch._foreach_copy_``; one ``copy_`` a tensor for DTensors,
    which have no sharding rule for it."""
    if dst and is_dtensor(dst[0]):
        for d, s in zip(dst, src):
            d.copy_(s)
    else:
        torch._foreach_copy_(dst, src)


def global_norm(tree) -> torch.Tensor:
    """The f32 2-norm of every tensor of ``tree`` (a dict or a list)
    together, as a 0-dim tensor on their device."""
    leaves = list(tree.values()) if isinstance(tree, dict) else list(tree)
    norms = torch._foreach_norm([x.float() for x in leaves])
    # a DTensor's norm is reduced over its shards: the whole norm on
    # every rank
    norms = [gathered(n) for n in norms]
    return torch.linalg.vector_norm(torch.stack(norms))
