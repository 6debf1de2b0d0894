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
    ``device`` (the card unless the caller asks for the CPU), where the
    reference takes a mesh and its specs.

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

from repro_torch.checkpoint import serialization
from repro_torch.device import resolve_device


def _host_copy(x):
    if isinstance(x, torch.Tensor):
        return x.detach().to("cpu", copy=True)
    return np.array(x, copy=True)


class CheckpointManager:
    def __init__(self, directory: str, keep: int = 3):
        self.directory = directory
        self.keep = keep
        os.makedirs(directory, exist_ok=True)
        self._thread: Optional[threading.Thread] = None
        self._error: Optional[BaseException] = None

    # ---- save ---------------------------------------------------------------
    def save(self, step: int, tree, blocking: bool = False):
        """Copy ``tree`` to host memory, then serialize it on a background
        thread (``blocking``: wait for the write)."""
        self.wait()
        host_tree = serialization.tree_map(_host_copy, tree)

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

    def restore(self, step: int, target_tree, *, device=None):
        """Load ``step`` in ``target_tree``'s structure, every leaf a
        tensor on ``device`` (the card when None)."""
        dev = resolve_device(device)
        d = os.path.join(self.directory, f"step_{step}")
        tree = serialization.load_pytree(d, target_tree)
        if dev.type == "cpu":
            return tree
        return serialization.tree_map(lambda x: x.to(dev), tree)

    def restore_latest(self, target_tree, *, device=None):
        step = self.latest_step()
        if step is None:
            return None, None
        return step, self.restore(step, target_tree, device=device)

    def _prune(self):
        steps = self.all_steps()
        for s in steps[:-self.keep] if self.keep > 0 else []:
            shutil.rmtree(os.path.join(self.directory, f"step_{s}"),
                          ignore_errors=True)
