"""Per-query explain reports: "why was *this* query slow / broad /
approximate?" answered from data the pipeline already computed.

The port's own copy of ``repro.obs.explain``.  A capture holds host
numpy only (the query block, labels, confidences, shard answers, votes,
the routing and bucket unions) and the frozen host summaries and index,
never a snapshot's device tensors: the server's ring of 256 captures
pins no generation on the card.

The serving path (runtime/knn_server.py ``_dispatch``) captures one
:class:`BatchCapture` per micro-batch — cheap references to the frozen
objects the dispatch consumed (routing summaries, bucket index, the
padded query block) plus the scalars it produced (touched-shard count,
candidate fraction, stage timestamps, the maintenance-commit clock
before and after) — and hands every resolved request an
:class:`ExplainRecord` pointing at it.  Nothing heavy happens on the
hot path: the full report is assembled lazily by ``build()``, which
*recomputes* the per-shard lower/upper bounds and the routing threshold
T through :func:`repro_torch.store.summaries.routing_detail` and the
per-bucket keep rule through :func:`repro_torch.store.index.bucket_keep` —
both deterministic pure-f64 host math over the same frozen generation
the dispatch used, so the report shows the decision's working without
ever having taxed the dispatch that made it.

Report schema (``SCHEMA`` = ``knn.explain.v1``) is a plain dict of
python scalars/lists: ``batch`` (id, bucket, generation, touched,
contract verdict), ``request`` (row, l, recall_mode, content digests),
``routing`` (per-shard bounds + threshold + keep), ``index``
(per-bucket keep, recompute cross-check, candidate fraction),
``predict`` (the label answer, its mode and confidence, and — for
ensemble mode — the per-shard vote table and local-k split),
``timings`` (queue/snapshot/route/kernel/resolve stage seconds, and
``topl_device_s``, the distance + top-l step's device time by CUDA
events, None on the CPU), and
``maintenance`` (whether a store commit raced the request, and which).
:func:`deterministic_json` serializes the *stable* subset — timings,
maintenance, and the batch id are run-volatile by nature — so the
same query at the same key and generation produces a byte-identical
string (tests/test_operator.py pins this).

Import discipline: at import time this file is stdlib-only; numpy and
the store modules load lazily inside ``build()``.
"""

from __future__ import annotations

import hashlib
import json
from typing import Optional

SCHEMA = "knn.explain.v1"

# Report keys that legitimately differ between two otherwise-identical
# runs (wall-clock stage timings, the maintenance-commit clock) and the
# one batch field that does (the monotonically-assigned batch id).
_VOLATILE_KEYS = ("timings", "maintenance")


def _digest(arr) -> str:
    """Short content digest of an array-like (anything with tobytes())."""
    return hashlib.sha1(arr.tobytes()).hexdigest()[:16]


class BatchCapture:
    """Dispatch-time facts shared by every request in one micro-batch.

    Built once per ``_dispatch`` after the kernel returns; fields are
    references (frozen summaries/index, the dispatch's own padded query
    block) and scalars — no array copies, no recomputation.  ``timings``
    is filled in as the dispatch tail stamps its stages (reports are
    only built after the dispatch completes, so late fills are safe).
    """

    __slots__ = ("batch_id", "bucket", "n_real", "generation", "route",
                 "route_compute", "search", "slack", "oversample",
                 "queries", "ls", "summaries", "index", "active",
                 "keep_any", "touched", "candidate_fraction", "timings",
                 "maint_before", "maint_after", "maint_last",
                 "contract_ok", "predict", "predict_mode", "labels",
                 "confidences", "local_k", "shard_answers", "votes")

    def __init__(self, **kw):
        for name in self.__slots__:
            setattr(self, name, kw.pop(name, None))
        if kw:
            raise TypeError(f"unknown capture fields: {sorted(kw)}")


class ExplainRecord:
    """One request's handle into its batch capture; ``build()`` is the
    lazy, cached report assembly."""

    __slots__ = ("capture", "row", "l", "dists", "ids", "queued_s",
                 "latency_s", "_report")

    def __init__(self, capture: BatchCapture, row: int, *, l: int,
                 dists, ids, queued_s: float, latency_s: float):
        self.capture = capture
        self.row = int(row)
        self.l = int(l)
        self.dists = dists
        self.ids = ids
        self.queued_s = float(queued_s)
        self.latency_s = float(latency_s)
        self._report: Optional[dict] = None

    # ---- assembly --------------------------------------------------------

    def build(self) -> dict:
        if self._report is None:
            self._report = self._build()
        return self._report

    def _build(self) -> dict:
        import numpy as np      # lazy: module must import stdlib-only

        cap = self.capture
        routing, shard_keep = self._routing_section(np)
        report = {
            "schema": SCHEMA,
            "batch": {
                "id": int(cap.batch_id),
                "bucket": int(cap.bucket),
                "n_real": int(cap.n_real),
                "generation": int(cap.generation),
                "shards_touched": int(cap.touched),
                "contract_ok": bool(cap.contract_ok),
            },
            "request": {
                "row": self.row,
                "l": self.l,
                "recall_mode": ("approx" if cap.search == "approx"
                                else "exact"),
                "query_sha1": _digest(np.ascontiguousarray(
                    cap.queries[self.row])),
                "result_ids_sha1": _digest(np.ascontiguousarray(self.ids)),
                "result_dists_sha1": _digest(np.ascontiguousarray(
                    self.dists)),
            },
            "routing": routing,
            "index": self._index_section(np, shard_keep),
            "predict": self._predict_section(np),
            "timings": {
                "queued_s": self.queued_s,
                "latency_s": self.latency_s,
                **{k: v for k, v in (cap.timings or {}).items()},
            },
            "maintenance": {
                "commits_before": int(cap.maint_before or 0),
                "commits_after": int(cap.maint_after or 0),
                "raced_commit": bool((cap.maint_after or 0)
                                     > (cap.maint_before or 0)),
                "last_commit": cap.maint_last,
            },
        }
        return report

    def _routing_section(self, np):
        """(section dict, per-row shard-keep matrix or None).

        The bounds/threshold are *recomputed* through
        ``summaries.routing_detail`` — deterministic f64 host math over
        the frozen summaries the dispatch captured, so this is the
        dispatch-time decision with its working shown, not a new
        decision.  The batch's realized ``active`` union is reported
        beside it (identical for the host route; the device route's f32
        mask is parity-tested, tests/test_routing.py).
        """
        cap = self.capture
        sec = {"mode": cap.route, "compute": cap.route_compute,
               "slack": float(cap.slack or 0.0)}
        if cap.route != "pruned" or cap.summaries is None:
            sec.update(threshold=None, threshold_eff=None, shards=[],
                       kept_shards=[])
            return sec, None
        from repro_torch.store import summaries as summaries_mod
        detail = summaries_mod.routing_detail(
            cap.summaries, cap.queries, cap.ls, slack=cap.slack)
        r = self.row
        keep_row = detail["keep"][r]
        sec["threshold"] = float(detail["threshold"][r])
        sec["threshold_eff"] = float(detail["threshold_eff"][r])
        sec["shards"] = [
            {"shard": int(j),
             "lower": float(detail["lower"][r, j]),
             "upper": float(detail["upper"][r, j]),
             "kept": bool(keep_row[j])}
            for j in range(keep_row.shape[0])]
        sec["kept_shards"] = [int(j) for j in np.flatnonzero(keep_row)]
        if cap.active is not None:
            sec["batch_active_shards"] = [
                int(j) for j in np.flatnonzero(np.asarray(cap.active))]
        return sec, detail["keep"]

    def _index_section(self, np, shard_keep):
        cap = self.capture
        if cap.search != "approx" or cap.index is None:
            return {"enabled": False}
        from repro_torch.store import index as index_mod
        idx = cap.index
        keep = index_mod.bucket_keep(
            idx, cap.queries, cap.ls, shard_keep=shard_keep,
            oversample=cap.oversample)
        row_kept = [[int(s), int(b)]
                    for s, b in zip(*np.nonzero(keep[self.row]))]
        recomputed_any = keep.any(axis=0)
        sec = {
            "enabled": True,
            "num_buckets": int(idx.num_buckets),
            "oversample": float(cap.oversample),
            "candidate_fraction": (None if cap.candidate_fraction is None
                                   else float(cap.candidate_fraction)),
            "kept_buckets": row_kept,
            "recomputed_batch_kept": [
                [int(s), int(b)]
                for s, b in zip(*np.nonzero(recomputed_any))],
        }
        if cap.keep_any is not None:
            actual = np.asarray(cap.keep_any, bool)
            sec["batch_kept_buckets"] = [
                [int(s), int(b)] for s, b in zip(*np.nonzero(actual))]
            # Host path: the recompute IS the dispatch rule, so this is
            # an equality invariant.  Device path: the f32 kernel mirror
            # is allowed to differ (both are measured, DESIGN.md §13) —
            # the flag then honestly reports whether it did.
            sec["kept_matches_recompute"] = bool(
                (actual == recomputed_any).all())
        return sec

    def _predict_section(self, np):
        """The label answer with its working: mode, label, confidence;
        for ensemble mode additionally this row's local-k split, the
        per-shard answer table (class histogram per shard for "vote",
        [sum, count] per shard for "regress") and the shard-vote tally
        the majority was taken over — all captured from the dispatch's
        own aggregation inputs, no recomputation."""
        cap = self.capture
        if not cap.predict or cap.predict == "none":
            return {"enabled": False}
        r = self.row
        sec = {
            "enabled": True,
            "predict": cap.predict,
            "mode": cap.predict_mode,
            "label": float(np.asarray(cap.labels)[r]),
            "confidence": float(np.asarray(cap.confidences)[r]),
        }
        if cap.local_k is not None:
            sec["local_k"] = int(np.asarray(cap.local_k)[r])
        if cap.shard_answers is not None:
            table = np.asarray(cap.shard_answers)[:, r]      # (k, C|2)
            cast = int if cap.predict == "vote" else float
            sec["shard_answers"] = [[cast(v) for v in row]
                                    for row in table]
        if cap.votes is not None:
            sec["shard_votes"] = [int(v)
                                  for v in np.asarray(cap.votes)[r]]
        return sec


# ---- serialization -------------------------------------------------------


def deterministic_json(report: dict) -> str:
    """The stable subset of a report as canonical JSON: drop the
    run-volatile keys (stage timings, the maintenance clock) and the
    batch id, serialize sorted/compact.  Same query, same key, same
    generation ⇒ byte-identical string."""
    stable = {k: v for k, v in report.items() if k not in _VOLATILE_KEYS}
    batch = dict(stable.get("batch", {}))
    batch.pop("id", None)
    stable["batch"] = batch
    return json.dumps(stable, sort_keys=True, separators=(",", ":"))


def export_jsonl(reports, path_or_file) -> int:
    """Write explain reports (dicts or ExplainRecords) as JSONL; returns
    the number of lines written."""
    lines = []
    for r in reports:
        if isinstance(r, ExplainRecord):
            r = r.build()
        lines.append(json.dumps(r, sort_keys=True) + "\n")
    if hasattr(path_or_file, "write"):
        path_or_file.writelines(lines)
    else:
        with open(path_or_file, "w") as f:
            f.writelines(lines)
    return len(lines)
