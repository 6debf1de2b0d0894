"""Cost model: FLOPs, bytes, peak memory and collective wire bytes of a
step, and the roofline they give on an H100.

The port's counterpart of ``repro.launch.hlo_analysis`` and
``repro.launch.hlo_counter``.  The reference parses the compiled HLO;
the port counts what the step dispatches:

  * :class:`CostMode`, a ``TorchDispatchMode``, sees every aten op a
    step runs (forward, backward and optimizer; on the meta device, where
    nothing is allocated, as on the card; a DTensor op as the ops it runs
    on this device's blocks, so a sharded step counts per device).
    FLOPs come from ``torch.utils.flop_counter``'s formulas (2 a
    multiply-add: matmuls, batched matmuls, convolutions, attention);
    bytes are each op's tensor operands read once and its results
    written once (views move nothing and are skipped); the peak is the
    most bytes that ops' results hold alive at once (a result counts
    until its tensor is freed; the tensors autograd saves are kept as
    their own objects while counting, so they count until backward
    releases them).
  * :func:`extrapolate` takes the counts at three sequence lengths to
    any other: for lengths that are multiples of the recurrences' chunk,
    FLOPs and bytes are polynomials of degree at most 2 in S (attention
    is S^2, the chunked scans are S), so three points give them exactly.
    This is the counterpart of the reference's trip-weighting of loop
    bodies: the Mamba chunk loop and the sLSTM step loop are Python loops
    here, which the meta device runs one iteration at a time.
  * :func:`collective_wire_bytes` uses the reference's ring factors
    (``hlo_analysis.py:19-23``) on a collective's per-device result;
    :func:`redistribute_plan` lists the collectives a DTensor
    redistribution needs, and :class:`CollectiveCounter` records the ones
    DTensor issues on a live mesh, so the plan can be held to what runs.
  * :class:`Roofline`: the three per-device times against one NVIDIA H100
    SXM5 (the data sheet's dense rates at the 700 W limit): 989 TFLOP/s
    bf16 and 67 TFLOP/s f32, 3.35 TB/s of HBM3; NVLink 4 at 450 GB/s a
    direction within a node of 8, InfiniBand NDR at 50 GB/s a GPU
    between nodes.  A mesh within 8 devices uses the NVLink rate, a
    larger one the InfiniBand rate.
"""

from __future__ import annotations

import dataclasses
import weakref
from fractions import Fraction
from typing import Optional

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten


# NVIDIA H100 SXM5, data sheet, dense, 700 W
H100_BF16_FLOPS = 989e12
H100_F32_FLOPS = 67e12
H100_HBM_BW = 3.35e12          # bytes/s, HBM3
H100_HBM_BYTES = 80e9          # bytes of HBM3
NVLINK_BW = 450e9              # bytes/s a direction, NVLink 4, node of 8
IB_BW = 50e9                   # bytes/s a GPU, InfiniBand NDR (400 Gb/s)
NODE = 8                       # GPUs a node (one NVLink domain)


def _flop_registry():
    from torch.utils.flop_counter import flop_registry
    return flop_registry


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


class CostMode(TorchDispatchMode):
    """Counts FLOPs, bytes and the live-bytes peak of every aten op run
    under it (see the module docstring).  ``flops``, ``bytes``,
    ``peak_bytes`` (above what was live when the mode began), ``saved``
    (the bytes of results autograd saved for backward), ``ops`` (the op
    count) and ``by_op`` (``{op: [count, flops, bytes]}``)."""

    def __init__(self):
        super().__init__()
        self.flops = 0
        self.bytes = 0
        self.ops = 0
        self.by_op: dict = {}
        self.live = 0
        self.peak_bytes = 0
        self.saved = 0
        self._made: set = set()
        self._saved_ids: set = set()
        self._hooks = None

    def __enter__(self):
        # keep what autograd saves as the objects the ops returned, so a
        # saved result stays counted until backward frees it
        self._hooks = torch.autograd.graph.saved_tensors_hooks(
            self._pack, lambda t: t)
        self._hooks.__enter__()
        return super().__enter__()

    def _pack(self, t):
        """Count the bytes autograd saves of results made under the mode
        (each tensor once; parameters and inputs are not results)."""
        base = t._base if t._base is not None else t
        if id(base) in self._made and id(base) not in self._saved_ids:
            self._saved_ids.add(id(base))
            self.saved += _nbytes(base)
        return t

    def __exit__(self, *exc):
        out = super().__exit__(*exc)
        self._hooks.__exit__(*exc)
        return out

    def _free(self, n, key):
        self.live -= n
        self._made.discard(key)
        self._saved_ids.discard(key)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if _dtensor_op(types):
            # let DTensor run it as ops on this device's blocks (and its
            # collectives), which come back here
            return NotImplemented
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        if _fake(types):
            return out        # DTensor's shape propagation, not work
        self.ops += 1
        reg = _flop_registry()
        packet = func._overloadpacket
        f = int(reg[packet](*args, **kwargs, out_val=out)) if (
            packet in reg) else 0
        b = 0
        if not func.is_view:
            ins = [x for x in tree_flatten((args, kwargs))[0]
                   if isinstance(x, torch.Tensor)]
            outs = [x for x in tree_flatten(out)[0]
                    if isinstance(x, torch.Tensor)]
            b = sum(_nbytes(x) for x in ins) + sum(_nbytes(x) for x in outs)
            seen = {id(x) for x in ins}
            for x in outs:
                if id(x) in seen:      # written in place
                    continue
                n = _nbytes(x)
                self.live += n
                self._made.add(id(x))
                weakref.finalize(x, self._free, n, id(x))
            self.peak_bytes = max(self.peak_bytes, self.live)
        self.flops += f
        self.bytes += b
        rec = self.by_op.setdefault(str(packet), [0, 0, 0])
        rec[0] += 1
        rec[1] += f
        rec[2] += b
        return out


def _fake(types) -> bool:
    from torch._subclasses.fake_tensor import FakeTensor
    return any(issubclass(t, FakeTensor) for t in types) or (
        torch._C._get_dispatch_mode(torch._C._TorchDispatchModeKey.FAKE)
        is not None)


def _dtensor_op(types) -> bool:
    if not torch.distributed.is_available():
        return False
    from torch.distributed.tensor import DTensor
    return any(issubclass(t, DTensor) for t in types)


@dataclasses.dataclass
class Cost:
    flops: int
    bytes: int
    peak_bytes: int
    ops: int

    def as_dict(self) -> dict:
        return dataclasses.asdict(self)


def extrapolate(points: dict, s: int) -> int:
    """The value at ``s`` of the polynomial of degree ``len(points) - 1``
    through ``{S: value}`` (Lagrange, in exact rationals, so three
    counts of a quadratic give its value at any S exactly)."""
    xs = list(points)
    total = Fraction(0)
    for i, xi in enumerate(xs):
        term = Fraction(points[xi])
        for j, xj in enumerate(xs):
            if i != j:
                term *= Fraction(s - xj, xi - xj)
        total += term
    return round(total)


# ---- collectives ------------------------------------------------------------

def collective_wire_bytes(kind: str, nbytes: float, n: int) -> float:
    """Per-device wire bytes of one ring collective over ``n`` devices
    whose per-device *result* is ``nbytes`` (the reference's factors)."""
    if n <= 1:
        return 0.0
    return {
        "all-reduce": 2.0 * (n - 1) / n,
        "all-gather": (n - 1) / n,
        "reduce-scatter": float(n - 1),   # operand = n x result
        "all-to-all": (n - 1) / n,
        "collective-permute": 1.0,
    }[kind] * nbytes


@dataclasses.dataclass
class CollectiveStats:
    wire_bytes: float = 0.0
    counts: dict = dataclasses.field(default_factory=dict)
    ops: list = dataclasses.field(default_factory=list)

    def add(self, kind: str, nbytes: float, n: int):
        if n <= 1:
            return
        self.wire_bytes += collective_wire_bytes(kind, nbytes, n)
        self.counts[kind] = self.counts.get(kind, 0) + 1
        self.ops.append((kind, int(nbytes), int(n)))


def redistribute_plan(src, dst, local_shape, itemsize: int,
                      mesh_sizes) -> CollectiveStats:
    """The collectives that move a tensor from placements ``src`` to
    ``dst`` (one a mesh dim, sizes ``mesh_sizes``), mesh dim by mesh dim
    from the first, as DTensor redistributes; ``local_shape`` is the
    tensor's per-device block under ``src``.

      Partial -> Shard      reduce-scatter (result: the block / n)
      Partial -> Replicate  all-reduce
      Shard -> Replicate    all-gather (result: the block x n)
      Shard(i) -> Shard(j)  all-to-all
      Replicate -> Shard    none (each device keeps its slice)
    """
    stats = CollectiveStats()
    shape = list(local_shape)
    for i in range(len(mesh_sizes)):
        a, b, n = src[i], dst[i], mesh_sizes[i]
        if a == b or n == 1:
            continue
        numel = 1
        for d in shape:
            numel *= d
        if a.is_partial():
            if b.is_shard():
                shape[b.dim] //= n
                stats.add("reduce-scatter", numel // n * itemsize, n)
            else:
                stats.add("all-reduce", numel * itemsize, n)
        elif a.is_shard():
            if b.is_replicate():
                shape[a.dim] *= n
                stats.add("all-gather", numel * n * itemsize, n)
            elif b.is_shard():
                shape[a.dim] *= n
                shape[b.dim] //= n
                stats.add("all-to-all", numel * itemsize, n)
        elif b.is_shard():
            shape[b.dim] //= n
    return stats


_FUNCOL = {"all_reduce": "all-reduce", "all_reduce_": "all-reduce",
           "all_gather_into_tensor": "all-gather",
           "reduce_scatter_tensor": "reduce-scatter",
           "all_to_all_single": "all-to-all"}


class CollectiveCounter(TorchDispatchMode):
    """Records the functional collectives DTensor issues under it
    (``torch.ops._c10d_functional``): kind, per-device result bytes and
    group size, as :class:`CollectiveStats` in ``stats``."""

    def __init__(self):
        super().__init__()
        self.stats = CollectiveStats()

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if _dtensor_op(types):
            return NotImplemented
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        if func.namespace == "_c10d_functional":
            kind = _FUNCOL.get(func._overloadpacket.__name__)
            if kind is not None:
                res = out if isinstance(out, torch.Tensor) else args[0]
                self.stats.add(kind, _nbytes(res), _group_size(args))
        return out


def _group_size(args) -> int:
    from torch.distributed.distributed_c10d import _resolve_process_group
    return _resolve_process_group(args[-1]).size()


# ---- roofline ---------------------------------------------------------------

@dataclasses.dataclass
class Roofline:
    """Per-device times of a step on an H100 (module docstring):
    ``flops``, ``hbm_bytes`` and ``wire_bytes`` are per device."""
    flops: float
    hbm_bytes: float
    wire_bytes: float
    chips: int
    model_flops: float = 0.0
    bf16: bool = True
    collective_counts: dict = dataclasses.field(default_factory=dict)

    @property
    def peak_flops(self) -> float:
        return H100_BF16_FLOPS if self.bf16 else H100_F32_FLOPS

    @property
    def link_bw(self) -> float:
        return NVLINK_BW if self.chips <= NODE else IB_BW

    @property
    def compute_s(self) -> float:
        return self.flops / self.peak_flops

    @property
    def memory_s(self) -> float:
        return self.hbm_bytes / H100_HBM_BW

    @property
    def collective_s(self) -> float:
        return self.wire_bytes / self.link_bw

    @property
    def dominant(self) -> str:
        terms = {"compute": self.compute_s, "memory": self.memory_s,
                 "collective": self.collective_s}
        return max(terms, key=terms.get)

    @property
    def bound_s(self) -> float:
        return max(self.compute_s, self.memory_s, self.collective_s)

    @property
    def useful_flops_frac(self) -> Optional[float]:
        """MODEL_FLOPS per device over the counted FLOPs: below 1 for
        remat's recompute and the attention the 6ND estimate leaves out."""
        if self.model_flops and self.flops:
            return (self.model_flops / self.chips) / self.flops
        return None

    def summary(self) -> dict:
        return {
            "flops": self.flops,
            "hbm_bytes": self.hbm_bytes,
            "wire_bytes": self.wire_bytes,
            "chips": self.chips,
            "peak_flops": self.peak_flops,
            "link_bw": self.link_bw,
            "compute_s": self.compute_s,
            "memory_s": self.memory_s,
            "collective_s": self.collective_s,
            "dominant": self.dominant,
            "bound_s": self.bound_s,
            "model_flops": self.model_flops,
            "useful_flops_frac": self.useful_flops_frac,
            "collective_counts": self.collective_counts,
        }
