"""Checkpoint manager: async, atomic, keep-N, restore onto a device.

Port of ``repro.checkpoint.manager``, with the same contract:
  * **atomic** -- writes go to ``<dir>/tmp_<step>`` and are renamed to
    ``<dir>/step_<step>`` only when complete; a crash mid-save never
    corrupts the latest checkpoint;
  * **async** -- ``save()`` snapshots the tree to host memory
    synchronously and serializes it on a background thread, so training
    resumes at once; ``wait()`` joins (and re-raises the writer's
    error) before exit and before the next save;
  * **keep-N** -- the oldest checkpoints are pruned after a successful
    save;
  * **restore** -- ``restore(step, target, device=)`` puts every leaf on
    ``device`` (the card unless the caller asks for the CPU); with
    ``mesh=`` and ``specs=`` (a tree of ``sharding.P`` like the target)
    each leaf of one or more dims is laid out as a DTensor by its
    ``divisible`` spec on that mesh: the elastic path, which restores a
    checkpoint written on any mesh, or none, onto any other.

Under a mesh (a tree holding DTensors) every rank runs ``save``: each
DTensor is gathered whole (a collective every rank takes part in), the
process of global rank 0 writes, and ``wait()`` ends with a barrier, so
no rank reads a checkpoint before it is complete.

The snapshot copies: the reference's ``np.asarray`` is safe on immutable
JAX arrays, but the port's optimizer writes parameters and moments in
place, and a CPU tensor's ``.numpy()`` shares its storage, so a writer
reading the live tensors would serialize a later step's values.
"""

from __future__ import annotations

import os
import re
import shutil
import threading
from typing import Optional

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.checkpoint import serialization
from repro_torch.device import resolve_device
from repro_torch.models.sharding import distribute, gathered, is_dtensor


def _host_copy(x, writer: bool = True):
    """``x`` copied to host memory; a DTensor is gathered on every rank
    (a collective), and only the ``writer`` keeps a copy."""
    if isinstance(x, torch.Tensor):
        whole = gathered(x.detach())
        return whole.to("cpu", copy=True) if writer else None
    return np.array(x, copy=True) if writer else None


def _rank() -> int:
    return dist.get_rank() if dist.is_available() and (
        dist.is_initialized()) else 0


class CheckpointManager:
    def __init__(self, directory: str, keep: int = 3):
        self.directory = directory
        self.keep = keep
        os.makedirs(directory, exist_ok=True)
        self._thread: Optional[threading.Thread] = None
        self._error: Optional[BaseException] = None
        self._barrier = False

    # ---- save ---------------------------------------------------------------
    def save(self, step: int, tree, blocking: bool = False):
        """Copy ``tree`` to host memory, then serialize it on a background
        thread (``blocking``: wait for the write)."""
        self.wait()
        leaves = serialization.flatten(tree).values()
        self._barrier = any(is_dtensor(x) for x in leaves)
        writer = _rank() == 0
        host_tree = serialization.tree_map(
            lambda x: _host_copy(x, writer), tree)
        if not writer:
            if blocking:
                self.wait()
            return

        def work():
            try:
                tmp = os.path.join(self.directory, f"tmp_{step}")
                final = os.path.join(self.directory, f"step_{step}")
                if os.path.exists(tmp):
                    shutil.rmtree(tmp)
                serialization.save_pytree(host_tree, tmp)
                if os.path.exists(final):
                    shutil.rmtree(final)
                os.rename(tmp, final)
                self._prune()
            except BaseException as e:  # surfaced on next wait()
                self._error = e

        self._thread = threading.Thread(target=work, daemon=True)
        self._thread.start()
        if blocking:
            self.wait()

    def wait(self):
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._barrier:
            self._barrier = False
            dist.barrier()
        if self._error is not None:
            err, self._error = self._error, None
            raise err

    # ---- restore ----------------------------------------------------------
    def all_steps(self) -> list[int]:
        out = []
        for name in os.listdir(self.directory):
            m = re.fullmatch(r"step_(\d+)", name)
            if m:
                out.append(int(m.group(1)))
        return sorted(out)

    def latest_step(self) -> Optional[int]:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def restore(self, step: int, target_tree, *, device=None, mesh=None,
                specs=None):
        """Load ``step`` in ``target_tree``'s structure, every leaf a
        tensor on ``device`` (the card when None); with ``mesh`` and
        ``specs``, each leaf of one or more dims a DTensor on ``mesh``
        laid out by ``divisible`` of its spec (0-dim leaves, the step
        and the optimizer's count, stay plain tensors)."""
        dev = resolve_device(device)
        d = os.path.join(self.directory, f"step_{step}")
        tree = serialization.load_pytree(d, target_tree)
        if mesh is None or specs is None:
            if dev.type == "cpu":
                return tree
            return serialization.tree_map(lambda x: x.to(dev), tree)
        # leaf by leaf, so the device holds one whole leaf at a time
        # besides its blocks of the others
        return serialization.tree_map(
            lambda x, s: x.to(dev) if x.dim() == 0
            else distribute(x.to(dev), s, mesh), tree, specs)

    def restore_latest(self, target_tree, *, device=None, mesh=None,
                       specs=None):
        step = self.latest_step()
        if step is None:
            return None, None
        return step, self.restore(step, target_tree, device=device,
                                  mesh=mesh, specs=specs)

    def _prune(self):
        steps = self.all_steps()
        for s in steps[:-self.keep] if self.keep > 0 else []:
            shutil.rmtree(os.path.join(self.directory, f"step_{s}"),
                          ignore_errors=True)
