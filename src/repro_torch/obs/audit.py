"""Paper-contract auditors: the Theorem-1 envelope and the shadow replay.

The port's copy of ``repro.obs.audit``.

**ContractAuditor** — the round/message envelope.  The paper's
headline is O(log l) rounds and O(k log l) messages per query w.h.p.,
regardless of n, through the Lemma 2.3 sample-and-prune.  Every
dispatched micro-batch is checked against

    rounds   <= c * (log2(L+1) + log2(log2(n+2)+2)) + b
    messages <= (k-1) * rounds_bound

with L the batch's largest request l and n the live point count.  With
``use_sampling=False`` the claim is Theorem 2.2's O(log n) and the bound
is ``c*log2(n+2)+b``.  The gather sampler has exact costs (1 round,
(k-1)*l_max messages) and is checked against them.  Defaults c=6, b=24.

**ShadowAuditor** — sampled exact replay.  Pruned and device-routed
answers are byte-identical to the exact collective; every Nth routed
batch is replayed with every shard active (and, for an indexed server,
every slot a candidate) on the operands the dispatch captured, and a
divergence is counted and detailed.  ``mode="recall"`` audits the
approx tier's recall@l floor instead, ``mode="accuracy"`` the ensemble
label agreement with the exact fold.  Answers are compared through
``.tobytes()``; stdlib only.
"""

from __future__ import annotations

import math
import threading
from typing import Callable, Optional

from repro_torch.obs.metrics import MetricsRegistry

_MAX_DETAILS = 8          # violation/divergence details kept for debugging


class ContractAuditor:
    """Per-micro-batch Theorem-1 round/message envelope check."""

    def __init__(self, registry: MetricsRegistry, *, k: int,
                 c: float = 6.0, b: float = 24.0):
        self.k = int(k)
        self.c = float(c)
        self.b = float(b)
        self._checks = registry.counter("audit.contract.checks")
        self._violations = registry.counter("audit.contract.violations")
        self._lock = threading.Lock()
        self.details: list = []

    def rounds_bound(self, l_max: int, n_live: int, *,
                     use_sampling: bool, sampler: str) -> float:
        if sampler == "gather":
            return 1.0
        n = max(int(n_live), 0)
        if use_sampling:
            base = math.log2(l_max + 1) + math.log2(math.log2(n + 2) + 2)
        else:
            base = math.log2(n + 2)
        return self.c * base + self.b

    def messages_bound(self, l_max: int, n_live: int, *,
                       use_sampling: bool, sampler: str) -> float:
        if sampler == "gather":
            return (self.k - 1) * l_max
        return (self.k - 1) * self.rounds_bound(
            l_max, n_live, use_sampling=use_sampling, sampler=sampler)

    def check(self, *, l_max: int, n_live: int, rounds: int, messages: int,
              use_sampling: bool, sampler: str, generation: int = -1) -> bool:
        """Audit one batch; True when within the envelope.  A violation
        is counted and kept in a bounded list of details."""
        rb = self.rounds_bound(l_max, n_live, use_sampling=use_sampling,
                               sampler=sampler)
        mb = self.messages_bound(l_max, n_live, use_sampling=use_sampling,
                                 sampler=sampler)
        self._checks.inc()
        ok = rounds <= rb and messages <= mb
        if not ok:
            self._violations.inc()
            with self._lock:
                if len(self.details) >= _MAX_DETAILS:
                    self.details.pop(0)
                self.details.append({
                    "l_max": int(l_max), "n_live": int(n_live),
                    "rounds": int(rounds), "rounds_bound": rb,
                    "messages": int(messages), "messages_bound": mb,
                    "sampler": sampler, "generation": int(generation)})
        return ok

    def snapshot(self) -> dict:
        with self._lock:
            return {"checks": self._checks.snapshot(),
                    "violations": self._violations.snapshot(),
                    "c": self.c, "b": self.b,
                    "details": list(self.details)}


class ShadowAuditor:
    """Sampled exact-replay check for routed/indexed answers.

    Two comparison modes, matching the serving contract being audited:

    * ``mode="bytes"`` (default) — the pruned-routing invariant: served
      dists/ids must be *byte-identical* to the exact collective replay.
      Any divergence counts.
    * ``mode="recall"`` — the ``search="approx"`` contract: the bucket
      index is allowed to drop true neighbors, but measured recall@l
      (per real row: the fraction of the exact replay's finite top-l ids
      present in the served answer; rows with no finite exact ids are
      vacuously 1.0, which makes padding rows harmless) must stay at or
      above ``floor``.  A batch whose *minimum* row recall dips below
      the floor counts as a divergence; the observed minimum also feeds
      the ``audit.shadow.recall`` histogram so the snapshot reports the
      measured contract, not just pass/fail.
    * ``mode="accuracy"`` — the ensemble-prediction contract
      (``predict_mode="ensemble"``, predict/ensemble.py): the served
      label comes from per-shard local votes, so bit-identity to the
      exact vote is not promised — instead the agreement fraction over
      the batch's real rows (label equality vs the exact-fold replay;
      a batch with no real rows is vacuously 1.0) must stay at or above
      ``floor``.  Checked through :meth:`check_labels`; the observed
      fraction feeds the ``audit.shadow.agreement`` histogram.
    """

    def __init__(self, registry: MetricsRegistry, *, every: int,
                 mode: str = "bytes", floor: float = 0.95):
        if every < 1:
            raise ValueError("every must be >= 1 (use None/off upstream)")
        if mode not in ("bytes", "recall", "accuracy"):
            raise ValueError(f"mode must be 'bytes', 'recall' or "
                             f"'accuracy', got {mode!r}")
        self.every = int(every)
        self.mode = mode
        self.floor = float(floor)
        self._n = 0
        self._lock = threading.Lock()
        self._checks = registry.counter("audit.shadow.checks")
        self._divergences = registry.counter("audit.shadow.divergences")
        self._recall = (registry.histogram("audit.shadow.recall")
                        if mode == "recall" else None)
        self._agreement = (registry.histogram("audit.shadow.agreement")
                           if mode == "accuracy" else None)
        self.last_min_recall: Optional[float] = None
        self.last_agreement: Optional[float] = None
        self.details: list = []

    def due(self) -> bool:
        """Count one routed dispatch; True on every Nth (the first
        routed dispatch is audited, so short runs still audit)."""
        with self._lock:
            due = self._n % self.every == 0
            self._n += 1
            return due

    def check(self, served_dists, served_ids,
              exact_fn: Callable[[], tuple], *,
              generation: int = -1, batch_id: int = -1,
              touched: int = -1) -> bool:
        """Replay through ``exact_fn`` (the all-shards-active,
        all-candidates executable at the same generation/key) and
        compare per ``mode``; returns True when the contract holds."""
        exact_d, exact_i = exact_fn()
        detail = {}
        if self.mode == "bytes":
            ok = (served_dists.tobytes() == exact_d.tobytes()
                  and served_ids.tobytes() == exact_i.tobytes())
        else:
            min_recall = self._min_recall(served_ids, exact_i)
            self._recall.observe(min_recall)
            self.last_min_recall = min_recall
            ok = min_recall >= self.floor
            detail["min_recall"] = min_recall
        self._checks.inc()
        if not ok:
            self._divergences.inc()
            with self._lock:
                if len(self.details) >= _MAX_DETAILS:
                    self.details.pop(0)
                self.details.append({
                    "generation": int(generation),
                    "batch_id": int(batch_id),
                    "touched": int(touched), **detail})
        return ok

    def check_labels(self, served_labels, ls, exact_fn, *,
                     generation: int = -1, batch_id: int = -1,
                     touched: int = -1) -> bool:
        """``mode="accuracy"`` entry point: replay through ``exact_fn``
        (the exact-fold executable at the same generation/key, all
        shards active — returns the (B,) exact label vector) and measure
        the agreement fraction over the batch's real rows (``ls > 0``);
        returns True while it holds the floor."""
        if self.mode != "accuracy":
            raise RuntimeError(f"check_labels needs mode='accuracy', "
                               f"auditor is {self.mode!r}")
        exact = exact_fn()
        agree = total = 0
        for s, e, l in zip(served_labels.tolist(), exact.tolist(),
                           ls.tolist()):
            if l <= 0:
                continue                    # bucket padding: no answer owed
            total += 1
            agree += int(s == e)
        agreement = agree / total if total else 1.0
        self._agreement.observe(agreement)
        self.last_agreement = agreement
        self._checks.inc()
        ok = agreement >= self.floor
        if not ok:
            self._divergences.inc()
            with self._lock:
                if len(self.details) >= _MAX_DETAILS:
                    self.details.pop(0)
                self.details.append({
                    "generation": int(generation),
                    "batch_id": int(batch_id),
                    "touched": int(touched),
                    "agreement": agreement})
        return ok

    @staticmethod
    def _min_recall(served_ids, exact_ids) -> float:
        """Minimum per-row recall@l of the served answer against the
        exact replay.  Pure python over small (B, l) id buffers — this
        module stays numpy-free.  Sentinel ids (anything the exact
        replay reports that is also sentinel in the served row) are the
        INT32_MAX no-point markers both paths emit past rank l or past
        the finite point count; only the exact replay's *finite* ids
        constitute ground truth."""
        sentinel = 2**31 - 1
        worst = 1.0
        for srow, erow in zip(served_ids.tolist(), exact_ids.tolist()):
            truth = {v for v in erow if v != sentinel}
            if not truth:
                continue                    # padding / empty row: vacuous
            got = len(truth.intersection(srow))
            worst = min(worst, got / len(truth))
        return worst

    def snapshot(self) -> dict:
        with self._lock:
            snap = {"every": self.every, "mode": self.mode,
                    "checks": self._checks.snapshot(),
                    "divergences": self._divergences.snapshot(),
                    "details": list(self.details)}
            if self.mode == "recall":
                snap["floor"] = self.floor
                snap["recall"] = self._recall.snapshot()
            elif self.mode == "accuracy":
                snap["floor"] = self.floor
                snap["agreement"] = self._agreement.snapshot()
            return snap
