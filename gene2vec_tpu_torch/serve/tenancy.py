"""Tenant lanes for the micro-batcher — the part of
``gene2vec_tpu/serve/tenancy.py`` the batcher needs, copied:
:data:`DEFAULT_TENANT` and :class:`FairQueue`.  Per-tenant token-bucket
admission (``TenantAdmission``) waits for a later slice; every request
of this port is the default tenant, so the queue drains as plain FIFO.
"""

from __future__ import annotations

import collections
from typing import Callable, Dict, List, Optional

#: the tenant every untagged request belongs to
DEFAULT_TENANT = "default"


class FairQueue:
    """Per-tenant FIFO lanes + smooth weighted round-robin dequeue.

    NOT thread-safe by itself — the micro-batcher accesses it under its
    own condition-variable lock, exactly like the deque it replaces.
    ``weight_of`` maps a tenant id to its drain weight (default 1.0 for
    everyone = plain round-robin across lanes; a single-lane queue
    degenerates to FIFO, so untenanted deployments pay nothing but a
    dict lookup).

    The scheduler is the classic smooth-WRR: each :meth:`pop` credits
    every non-empty lane by its weight, drains the highest-credit lane,
    and debits the winner by the total weight in play — over a
    contended window lane ``i`` receives ``w_i / sum(w)`` of the pops
    regardless of arrival interleaving.  Credit is dropped when a lane
    empties, so an idle tenant cannot hoard scheduling debt and then
    monopolize a batch."""

    def __init__(self, weight_of: Optional[Callable[[str], float]] = None):
        self._weight_of = weight_of
        self._lanes: "collections.OrderedDict[str, collections.deque]" = (
            collections.OrderedDict()
        )
        self._credit: Dict[str, float] = {}
        self._len = 0  # guarded by the micro-batcher's condition lock

    def __len__(self) -> int:
        return self._len

    def __bool__(self) -> bool:
        return self._len > 0

    def _weight(self, tenant: str) -> float:
        if self._weight_of is None:
            return 1.0
        try:
            w = float(self._weight_of(tenant))
        except Exception:
            return 1.0
        return w if w > 0 else 1.0

    def push(self, tenant: str, item) -> None:
        lane = self._lanes.get(tenant)
        if lane is None:
            lane = collections.deque()
            self._lanes[tenant] = lane
        lane.append(item)
        self._len += 1

    def pop(self):
        """The next item under weighted fairness; None when empty."""
        if self._len == 0:
            return None
        if len(self._lanes) == 1:
            # the common single-tenant case: plain FIFO, no credit math
            tenant, lane = next(iter(self._lanes.items()))
            item = lane.popleft()
            self._len -= 1
            if not lane:
                del self._lanes[tenant]
                self._credit.pop(tenant, None)
            return item
        total = 0.0
        best: Optional[str] = None
        best_credit = float("-inf")
        for tenant, lane in self._lanes.items():
            w = self._weight(tenant)
            total += w
            c = self._credit.get(tenant, 0.0) + w
            self._credit[tenant] = c
            if c > best_credit:
                best_credit = c
                best = tenant
        assert best is not None
        self._credit[best] -= total
        lane = self._lanes[best]
        item = lane.popleft()
        self._len -= 1
        if not lane:
            del self._lanes[best]
            self._credit.pop(best, None)
        return item

    def pop_upto(self, n: int) -> List:
        out = []
        while len(out) < n and self._len:
            out.append(self.pop())
        return out
