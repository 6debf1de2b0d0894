"""Mesh construction.

Port of ``repro.launch.mesh``.  Functions, not module-level constants:
importing this module touches no device and no process group.

``make_production_mesh`` is the reference's pod mesh as an
:class:`~repro_torch.models.sharding.AbstractMesh` (a shape and axis
names only), since nothing here runs 256 or 512 ranks: the dry-run lays
its tensors out on it.  ``make_debug_mesh`` is a real ``DeviceMesh`` over
the current process group (``torchrun`` sets it up; one rank a card, or
gloo ranks on the CPU).
"""

from __future__ import annotations

import contextlib

from repro_torch.models.sharding import AbstractMesh


def make_production_mesh(*, multi_pod: bool = False) -> AbstractMesh:
    """(16, 16) = (data, model) single pod; (2, 16, 16) = (pod, data,
    model) across two pods: 256 / 512 devices."""
    if multi_pod:
        return AbstractMesh((2, 16, 16), ("pod", "data", "model"))
    return AbstractMesh((16, 16), ("data", "model"))


def make_debug_mesh(data: int = 4, model: int = 2, device: str = "cuda"):
    """A (data, model) ``DeviceMesh`` over the initialised process group
    of ``data * model`` ranks, on ``"cuda"`` (NCCL, one card a rank) or
    ``"cpu"`` (gloo)."""
    from torch.distributed.device_mesh import init_device_mesh
    return init_device_mesh(device, (data, model),
                            mesh_dim_names=("data", "model"))


def parse_mesh(text: str) -> tuple[int, int]:
    """``"DxM"`` -> ``(D, M)``."""
    d, m = (int(x) for x in text.lower().split("x"))
    return d, m


def init_distributed(device: str, world: int):
    """Join the process group of ``world`` ranks: the one already set up
    (a test's spawned ranks), or the one ``torchrun`` describes in the
    environment (``nccl`` on the card, ``gloo`` on the CPU), a rank bound
    to its card by ``LOCAL_RANK``; a single process without ``torchrun``
    forms a group of one on a free local port.  Returns ``(this rank's
    device, whether this call made the group)``."""
    import os
    import socket

    import torch
    import torch.distributed as dist
    cuda = device == "cuda"
    local = int(os.environ.get("LOCAL_RANK", 0))
    dev = torch.device("cuda", local) if cuda else torch.device("cpu")
    if dist.is_initialized():
        if dist.get_world_size() != world:
            raise RuntimeError(f"the mesh needs {world} ranks, the process "
                               f"group has {dist.get_world_size()}")
        return dev, False
    if "RANK" in os.environ:
        init, rank = "env://", int(os.environ["RANK"])
        if int(os.environ["WORLD_SIZE"]) != world:
            raise RuntimeError(f"the mesh needs {world} ranks, torchrun "
                               f"started {os.environ['WORLD_SIZE']}")
    elif world == 1:
        with socket.socket() as s:
            s.bind(("localhost", 0))
            port = s.getsockname()[1]
        init, rank = f"tcp://localhost:{port}", 0
    else:
        raise RuntimeError(f"a mesh of {world} ranks runs under torchrun "
                           f"--nproc_per_node={world}")
    if cuda:
        torch.cuda.set_device(dev)
    dist.init_process_group("nccl" if cuda else "gloo", init_method=init,
                            rank=rank, world_size=world)
    return dev, True


@contextlib.contextmanager
def debug_mesh(spec: str | None, device):
    """``--mesh DxM`` of the launchers: yields ``(device, mesh)``, the
    mesh a live (data, model) ``DeviceMesh`` made ambient
    (``sharding.set_mesh``) over a process group joined or made by
    :func:`init_distributed` (``"cpu"`` for gloo when ``device`` is
    ``"cpu"``, else the card); with no ``spec``, ``(resolve_device(
    device), None)``.  A group this call made is destroyed at the end."""
    import torch.distributed as dist

    from repro_torch.device import resolve_device
    from repro_torch.models import sharding as shd
    if not spec:
        yield resolve_device(device), None
        return
    d, m = parse_mesh(spec)
    kind = "cpu" if device is not None and (
        resolve_device(device).type == "cpu") else "cuda"
    dev, made = init_distributed(kind, d * m)
    try:
        mesh = make_debug_mesh(d, m, kind)
        with shd.set_mesh(mesh):
            yield dev, mesh
    finally:
        if made:
            dist.destroy_process_group()
