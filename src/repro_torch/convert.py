"""Carry the reference's state across to the port's layout.

The JAX server shards an ``(n, dim)`` point array over its mesh axis with
``P(axis)``: shard j holds rows ``[j*m, (j+1)*m)``, m = n / k, and ids
are ``arange(n)``.  The port holds the same split as a leading shard
dimension: points ``(k, m, dim)``, ids ``(k, m)``.

A reference ``MutableStore``'s state is its host mirrors (points, ids
and valid, ``(k*cap, ...)`` with shard j owning slots ``[j*cap,
(j+1)*cap)``); :func:`store_from_mirrors` builds the port's store from
them, the role weights play elsewhere.

A reference LM's parameter tree (``repro.models.ModelApi.init_params``,
as numpy arrays) becomes the port's model state dict by
:func:`params_from_jax`, for every family: the stacked layers (and
super-blocks) are unstacked, and the dummy heads and dummy experts the
reference pads its head and expert axes with are dropped.  The same map
carries a gradient tree across, and :func:`opt_state_from_jax` a
reference ``AdamWState``.
"""

from __future__ import annotations

import numpy as np
import torch


def shards_from_numpy(points, k: int, values=None, labels=None, *,
                      device="cpu"):
    """``(n, dim)`` numpy points -> ``((k, m, dim) f32, (k, m) int32 ids,
    values, labels)`` on ``device``, by the reference's row -> shard rule.

    ``values`` (optional ``(n,)`` int payload) is returned as an int32
    numpy array, since the server looks it up on the host; ``labels``
    (optional ``(n,)`` label payload) as a ``(k, m)`` f32 tensor on
    ``device``, split like the points.  Raises when ``n`` is not a
    multiple of ``k``, as the reference server does.
    """
    points = np.ascontiguousarray(points, np.float32)
    if values is not None:
        values = np.asarray(values, np.int32)
        if values.shape != points.shape[:1]:
            raise ValueError(f"values shape {values.shape} != "
                             f"({points.shape[0]},)")
    pts, ids = shards_from_tensor(torch.from_numpy(points).to(device), k)
    if labels is not None:
        labels = labels_from_numpy(labels, pts.shape[0] * pts.shape[1], k,
                                   device)
    return pts, ids, values, labels


def labels_from_numpy(labels, n: int, k: int, device) -> torch.Tensor:
    """An ``(n,)`` label payload -> ``(k, n / k)`` f32 on ``device``, split
    like the points (the reference server's ``labels=``)."""
    labels = np.ascontiguousarray(labels, np.float32)
    if labels.shape != (n,):
        raise ValueError(f"labels shape {labels.shape} != ({n},)")
    return torch.from_numpy(labels).to(device).reshape(k, -1)


def shards_from_tensor(points: torch.Tensor, k: int):
    """The same split for an ``(n, dim)`` tensor already on its device
    (a view, no copy): ``((k, m, dim), (k, m) int32 ids)``."""
    if points.dim() != 2:
        raise ValueError(f"points must be (n, dim), got "
                         f"{tuple(points.shape)}")
    n, dim = points.shape
    if k < 1 or n % k:
        raise ValueError(f"n_points={n} must divide the shard count {k}")
    ids = torch.arange(n, dtype=torch.int32, device=points.device)
    return points.reshape(k, n // k, dim), ids.reshape(k, -1)


def store_from_mirrors(points, ids, valid, *, cap: int, shards: int,
                       used, next_id: int, used_ids, values=None,
                       labels=None, generation: int = 0, device=None,
                       **store_kwargs):
    """The port's :class:`~repro_torch.store.MutableStore` holding a
    reference store's applied state.

    ``points`` (k*cap, dim) f32, ``ids`` (k*cap,) int32 and ``valid``
    (k*cap,) bool are the reference's mirrors (``_pts`` / ``_ids`` /
    ``_valid``) as numpy arrays; ``values`` an optional id -> int payload
    mapping; ``labels`` the optional (k*cap,) f32 label mirror
    (``_labels``), which makes the store ``with_labels`` (its id -> label
    map then holds the live ids; a deleted id's label is not carried).  The slot map and live counts follow from them.  What the
    mirrors do not hold comes from the reference store as it is: ``used``
    (its ``_used``, each shard's high-water mark), ``next_id`` (its
    ``_next_id``) and ``used_ids`` (its ``_used_ids``, every id ever
    inserted, deleted ones included, so an id stays single-use across the
    conversion).  The summaries and the index are rebuilt exactly, and
    the snapshot uploaded as generation ``generation``.
    ``store_kwargs`` are the store's other knobs.  Under
    ``maintenance="background"`` the worker starts with the store, empty,
    where it plans nothing; the mirrors are installed under the store
    lock, so its first plan sees them whole, and it is poked after.
    """
    from repro_torch.store.mutable import MutableStore
    points = np.ascontiguousarray(points, np.float32)
    ids = np.ascontiguousarray(ids, np.int32)
    valid = np.ascontiguousarray(valid, bool)
    total = shards * cap
    if points.shape[0] != total or ids.shape != (total,) or (
            valid.shape != (total,)):
        raise ValueError(f"mirrors {points.shape}, {ids.shape}, "
                         f"{valid.shape} do not hold {shards} x {cap} slots")
    with_labels = bool(store_kwargs.pop("with_labels", False)) or (
        labels is not None)
    if labels is not None:
        labels = np.ascontiguousarray(labels, np.float32)
        if labels.shape != (total,):
            raise ValueError(f"labels {labels.shape} do not hold {shards} x "
                             f"{cap} slots")
    st = MutableStore(points.shape[1], capacity_per_shard=cap,
                      shards=shards, device=device,
                      with_values=values is not None,
                      with_labels=with_labels, **store_kwargs)
    with st._lock:
        st._pts, st._ids, st._valid = points.copy(), ids.copy(), valid.copy()
        slots = np.flatnonzero(valid)
        live_ids = ids[slots].astype(np.int64)
        st._slot_of = {int(i): int(s) for i, s in zip(live_ids, slots)}
        st._used_ids = {int(i) for i in used_ids}
        st._live = np.bincount(slots // cap, minlength=shards).astype(
            np.int64)
        st._used = np.asarray(used, np.int64).copy()
        st._next_id = int(next_id)
        if values is not None:
            st._values = {int(i): int(v) for i, v in dict(values).items()}
        if labels is not None:
            st._labels = labels.copy()
            st._label_of = {int(i): float(v) for i, v in zip(
                live_ids, labels[slots])}
        st._projected_live = int(st._live.sum())
        st._summ.rebuild(st._pts, st._valid, cap)
        if st._index is not None:
            st._index.rebuild(st._pts, st._valid)
        st._snap = st._upload_snapshot_locked(generation=int(generation))
        st._summaries = st._summ.freeze(int(generation))
        if st._index is not None:
            st._frozen_index = st._index.freeze(int(generation))
        st._history.clear()
        st._record_history()
        if st._worker is not None:
            st._worker.notify()
    return st


def real_heads(n_phys: int, n_kv_phys: int, n_kv: int, group: int):
    """Physical indices of the real query heads of the reference's
    kv-major padded layout, in order: head h is in KV group ``h //
    (n_phys // n_kv_phys)`` and real when that group is real and ``h``
    is among its first ``group`` heads (``attention.make_head_mask``)."""
    g_phys = n_phys // n_kv_phys
    return [h for h in range(n_phys)
            if h // g_phys < n_kv and h % g_phys < group]


def params_from_jax(tree, cfg) -> dict:
    """A reference model's parameter tree -> the port's state dict (CPU
    f32 tensors): a ``models.transformer.Transformer``'s, or for the
    audio family a ``models.encdec.EncDec``'s.

    ``tree``: the reference's ``init_params`` tree as numpy arrays.
    Decoder-only: ``{"embed", "final_ln", "blocks": {"sub{j}": ...},
    ["lm_head"]}``, every leaf of ``blocks/sub{j}`` stacked over the
    super-blocks, so layer ``sb * p + j`` (p =
    ``transformer.superblock_size(cfg)``) is ``blocks/sub{j}[sb]``.
    Encoder-decoder: ``enc_blocks`` and ``dec_blocks`` stacked over
    their layers, ``enc_ln``; the decoder's ``self`` becomes
    ``self_attn``.  Dropped on the way: the columns of ``wq``/``bq``
    and the rows of ``wo`` that belong to the dummy heads of
    ``cfg.head_pad_to`` (and the KV columns of ``kv_head_pad_to``),
    keeping the real heads in order, and the expert weights of the
    dummy experts of ``cfg.expert_pad_to``, keeping the first
    ``n_experts``.
    """
    from repro_torch.models.transformer import superblock_size
    hd = cfg.head_dim
    heads = real_heads(cfg.n_heads_phys, cfg.n_kv_phys, cfg.n_kv_heads,
                       cfg.head_group)
    kv = list(range(cfg.n_kv_heads))

    def cols(w, keep):          # (..., H_phys * hd) -> (..., len(keep)*hd)
        w = w.reshape(*w.shape[:-1], -1, hd)[..., keep, :]
        return w.reshape(*w.shape[:-2], len(keep) * hd)

    def t(x):
        return torch.from_numpy(np.array(x, np.float32))

    def attention(p, a, i):
        out = {p + "wq": t(cols(np.asarray(a["wq"][i]), heads)),
               p + "wk": t(cols(np.asarray(a["wk"][i]), kv)),
               p + "wv": t(cols(np.asarray(a["wv"][i]), kv)),
               p + "wo": t(cols(np.asarray(a["wo"][i]).T, heads).T)}
        if "bq" in a:
            out[p + "bq"] = t(cols(np.asarray(a["bq"][i]), heads))
            out[p + "bk"] = t(cols(np.asarray(a["bk"][i]), kv))
            out[p + "bv"] = t(cols(np.asarray(a["bv"][i]), kv))
        return out

    def layer(p, sub, i):
        out = {}
        for name, leaves in sub.items():
            q = p + {"self": "self_attn"}.get(name, name) + "."
            if name in ("attn", "self", "cross"):
                out.update(attention(q, leaves, i))
                continue
            for leaf, x in leaves.items():
                x = np.asarray(x[i])
                if name == "moe" and leaf != "router":
                    x = x[:cfg.n_experts]
                out[q + leaf] = t(x)
        return out

    out = {"embed.table": t(tree["embed"]["table"]),
           "final_ln.scale": t(tree["final_ln"]["scale"])}
    if "lm_head" in tree:
        out["lm_head.table"] = t(tree["lm_head"]["table"])
    if cfg.is_encdec:
        out["enc_ln.scale"] = t(tree["enc_ln"]["scale"])
        for i in range(cfg.n_enc_layers):
            out.update(layer(f"enc_blocks.{i}.", tree["enc_blocks"], i))
        for i in range(cfg.n_layers):
            out.update(layer(f"dec_blocks.{i}.", tree["dec_blocks"], i))
        return out
    p = superblock_size(cfg)
    for i in range(cfg.n_layers):
        out.update(layer(f"blocks.{i}.", tree["blocks"][f"sub{i % p}"],
                         i // p))
    return out


def opt_state_from_jax(state, cfg):
    """A reference model's ``AdamWState`` (numpy leaves) -> the port's
    ``optim.AdamWState``: the moments mapped by :func:`params_from_jax`
    (the dummy heads' and experts' entries dropped) and kept
    in their dtype, f32 or bf16; ``count`` an int32 host tensor."""
    from repro_torch.optim import AdamWState

    def moments(tree):
        dt = (torch.bfloat16 if str(np.asarray(
            tree["embed"]["table"]).dtype) == "bfloat16" else torch.float32)
        return {k: v.to(dt) for k, v in params_from_jax(tree, cfg).items()}
    return AdamWState(
        count=torch.tensor(int(np.asarray(state.count)), dtype=torch.int32),
        m=moments(state.m), v=moments(state.v))
