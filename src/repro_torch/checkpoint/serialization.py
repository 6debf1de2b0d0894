"""Tree serialization in the reference's on-disk layout.

Port of ``repro.checkpoint.serialization``.  A directory holds
``manifest_<p>.json`` and ``shards_<p>.npz`` for process ``p``; the
manifest maps each leaf's path to its ``shape``, ``dtype`` and
``shards``.  The port holds no mesh shards, so every leaf is one full
array under ``"<path>@@full"``, which the reference reads as it reads
its own single-process checkpoints (and the other way round).

A tree is nested dicts (keys sorted, as ``jax.tree_util`` orders them),
lists, tuples and ``NamedTuple``s (a field is ``.name`` in the path, as
the reference's ``GetAttrKey`` prints) of tensors, numpy arrays or
numbers; ``None`` is an empty subtree.  numpy has no bfloat16, so a
bf16 tensor is written as its uint16 bits under dtype ``"bfloat16"``
and read back as bf16.
"""

from __future__ import annotations

import json
import os
from typing import Any

import numpy as np
import torch


def _is_namedtuple(x) -> bool:
    return isinstance(x, tuple) and hasattr(x, "_fields")


def _flatten(tree, prefix=()):
    """``[(path tuple, leaf)]`` in the reference's order."""
    if tree is None:
        return []
    if isinstance(tree, dict):
        return [kv for k in sorted(tree)
                for kv in _flatten(tree[k], prefix + (str(k),))]
    if _is_namedtuple(tree):
        return [kv for f in tree._fields
                for kv in _flatten(getattr(tree, f), prefix + (f".{f}",))]
    if isinstance(tree, (list, tuple)):
        return [kv for i, x in enumerate(tree)
                for kv in _flatten(x, prefix + (str(i),))]
    return [(prefix, tree)]


def tree_map(fn, tree, *rest):
    """``tree`` with each leaf ``x`` replaced by ``fn(x, *the leaves at
    the same path in rest)``, visited in :func:`flatten`'s order; ``None``
    stays ``None``."""
    if tree is None:
        return None
    if isinstance(tree, dict):
        return {k: tree_map(fn, tree[k], *(r[k] for r in rest))
                for k in sorted(tree)}
    if _is_namedtuple(tree):
        return type(tree)(*(tree_map(fn, x, *(r[i] for r in rest))
                            for i, x in enumerate(tree)))
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map(fn, x, *(r[i] for r in rest))
                          for i, x in enumerate(tree))
    return fn(tree, *rest)


def flatten(tree) -> dict:
    """``{"a/b/.m/w": leaf}`` in the reference's key order."""
    return {"/".join(path): leaf for path, leaf in _flatten(tree)}


def _to_numpy(leaf):
    """``(array, dtype name)``; a tensor must already be on the host."""
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach()
        if t.dtype == torch.bfloat16:
            return t.view(torch.int16).numpy().view(np.uint16), "bfloat16"
        arr = t.numpy()
    else:
        arr = np.asarray(leaf)
    return arr, str(arr.dtype)


def save_pytree(tree, directory: str, *, process_index: int = 0):
    """Write ``tree`` (tensors on the host, arrays or numbers) as this
    process's shard file and manifest into ``directory``."""
    os.makedirs(directory, exist_ok=True)
    manifest: dict[str, Any] = {"entries": {}, "process": process_index}
    arrays = {}
    for key, leaf in flatten(tree).items():
        arr, dtype = _to_numpy(leaf)
        name = f"{key}@@full"
        arrays[name] = arr
        manifest["entries"][key] = {
            "shape": list(arr.shape), "dtype": dtype,
            "shards": [{"name": name, "index": None}]}
    np.savez(os.path.join(directory, f"shards_{process_index}.npz"),
             **arrays)
    with open(os.path.join(directory, f"manifest_{process_index}.json"),
              "w") as f:
        json.dump(manifest, f)


def _from_numpy(arr: np.ndarray, dtype: str) -> torch.Tensor:
    if dtype == "bfloat16":
        bits = np.asarray(arr, order="C").view(np.int16)
        return torch.from_numpy(bits).view(torch.bfloat16)
    return torch.from_numpy(np.asarray(arr, order="C"))


def load_pytree(directory: str, target_tree):
    """Reassemble into the structure of ``target_tree`` (only its
    structure is read): CPU tensors, placement is the caller's.  Reads
    every process's manifest, full arrays and the reference's sharded
    entries alike."""
    entries: dict[str, Any] = {}
    data: dict[str, np.ndarray] = {}
    for mf in sorted(p for p in os.listdir(directory)
                     if p.startswith("manifest_")):
        with open(os.path.join(directory, mf)) as f:
            m = json.load(f)
        with np.load(os.path.join(directory,
                                  f"shards_{m['process']}.npz")) as z:
            for k in z.files:
                data[k] = z[k]
        for key, e in m["entries"].items():
            entries.setdefault(key, {"shape": e["shape"],
                                     "dtype": e["dtype"], "shards": []})
            entries[key]["shards"].extend(e["shards"])

    out = {}
    for key in flatten(target_tree):
        if key not in entries:
            raise KeyError(f"checkpoint missing leaf {key}")
        e = entries[key]
        full = None
        for sh in e["shards"]:
            part = data[sh["name"]]
            if sh["index"] is None:
                full = part
                continue
            if full is None:
                full = np.zeros(e["shape"], dtype=part.dtype)
            full[tuple(slice(a, b, c) for a, b, c in sh["index"])] = part
        out[key] = _from_numpy(full, e["dtype"])
    leaves = iter(out.values())
    return tree_map(lambda _: next(leaves), target_tree)
