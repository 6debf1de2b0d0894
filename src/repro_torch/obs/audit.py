"""Theorem-1 contract auditor: the round/message envelope of every batch.

The port's copy of ``repro.obs.audit.ContractAuditor``.  The paper's
headline is O(log l) rounds and O(k log l) messages per query w.h.p.,
regardless of n, through the Lemma 2.3 sample-and-prune.  Every
dispatched micro-batch is checked against

    rounds   <= c * (log2(L+1) + log2(log2(n+2)+2)) + b
    messages <= (k-1) * rounds_bound

with L the batch's largest request l and n the live point count.  With
``use_sampling=False`` the claim is Theorem 2.2's O(log n) and the bound
is ``c*log2(n+2)+b``.  The gather sampler has exact costs (1 round,
(k-1)*l_max messages) and is checked against them.  Defaults c=6, b=24.
"""

from __future__ import annotations

import math
import threading

from repro_torch.obs.metrics import MetricsRegistry

_MAX_DETAILS = 8          # violation details kept for debugging


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
