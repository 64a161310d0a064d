"""Multi-tenant admission: per-tenant token buckets and weighted-fair
queuing — the port of ``gene2vec_tpu/serve/tenancy.py``.

One abusive caller must never starve the other tenants.  The server
tags every request with a tenant id (the ``X-Tenant`` header; untagged
traffic is the ``default`` tenant) and admits it in two layers:

* :class:`TenantAdmission` — a time-refilled :class:`RateBucket` per
  tenant.  A request whose tenant bucket is empty is rejected at the
  front end (HTTP 429) before it reaches the batcher, and the rejection
  is counted with a tenant label (``serve_rejected_total{tenant=...}``).
  The tenant table is bounded: beyond ``max_tenants`` distinct ids,
  unknown tenants share one ``other`` bucket, so a client minting header
  values cannot grow per-tenant state or metric cardinality.
* :class:`FairQueue` — per-tenant FIFO lanes drained by smooth weighted
  round-robin.  The micro-batcher dequeues through it, so admitted
  traffic is interleaved by tenant weight when the queue is contended.
  Batch jobs (``batch/``) submit on the reserved :data:`BATCH_TENANT`
  lane, whose weight is :data:`DEFAULT_BATCH_WEIGHT` unless the server
  sets another: a full-vocab job drains at a few percent of a contended
  batch while interactive lanes keep their shares.

Quotas are per replica (a fleet of N admits N x the rate per tenant in
aggregate).  Everything here is stdlib and clock-injectable; with no
:class:`TenantPolicy` (the default, ``--tenant-quota 0``) the server
never touches a bucket and ignores the header.  On a catalog fleet the
front door's per-model buckets (``serve/catalog.py:ModelAdmission``)
cross with these: a request clears its tenant's budget on the replica
and its model's at the door, and a catalog replica shares one
:class:`TenantAdmission` across its per-model apps.
"""

from __future__ import annotations

import collections
import dataclasses
import threading
import time
from typing import Callable, Dict, List, Optional, Sequence

#: the tenant every untagged request belongs to
DEFAULT_TENANT = "default"

#: the background-priority lane batch jobs submit on: a reserved id,
#: never assigned to external traffic
BATCH_TENANT = "batch"

#: the batch lane's weighted-fair share when lanes are contended
#: (ServeConfig.batch_weight overrides it per deployment)
DEFAULT_BATCH_WEIGHT = 0.05

#: the shared lane/bucket unknown tenants collapse into once the
#: bounded tenant table is full
OVERFLOW_TENANT = "other"

_MAX_TENANT_CHARS = 64


def sanitize_tenant(raw: Optional[str]) -> str:
    """Header value -> tenant id: default for missing/empty, truncated
    to a bounded length (a tenant id is a label value — unbounded
    attacker-chosen strings must not reach the metrics registry)."""
    if not raw:
        return DEFAULT_TENANT
    raw = raw.strip()
    if not raw:
        return DEFAULT_TENANT
    return raw[:_MAX_TENANT_CHARS]


class RateBucket:
    """Time-refilled token bucket: ``rate`` tokens/second up to a
    ``burst`` cap.  Unlike the client's traffic-coupled retry budget
    (``serve/client.py:TokenBucket``), this one meters *offered load
    against wall time* — the right shape for a tenant quota.  ``clock``
    is injectable so tests walk refills without sleeping."""

    def __init__(self, rate: float, burst: float,
                 clock: Callable[[], float] = time.monotonic):
        self.rate = float(rate)
        self.burst = float(burst)
        self._clock = clock
        self._tokens = self.burst  # start full: a fresh tenant may burst
        self._last = clock()
        self._lock = threading.Lock()

    def take(self, n: float = 1.0) -> bool:
        with self._lock:
            now = self._clock()
            self._tokens = min(
                self.burst, self._tokens + (now - self._last) * self.rate
            )
            self._last = now
            if self._tokens >= n:
                self._tokens -= n
                return True
            return False

    @property
    def tokens(self) -> float:
        with self._lock:
            return self._tokens


@dataclasses.dataclass(frozen=True)
class TenantQuota:
    """One tenant's admission terms: sustained ``rate`` (requests/s),
    ``burst`` headroom, and the ``weight`` the fair queue drains its
    lane at."""

    rate: float
    burst: float
    weight: float = 1.0


class TenantPolicy:
    """The quota table: a default quota for every tenant plus explicit
    per-tenant overrides.  Parsed from CLI flags via
    :meth:`from_args` (``--tenant-override id:rate:burst[:weight]``)."""

    def __init__(self, default: TenantQuota,
                 overrides: Optional[Dict[str, TenantQuota]] = None):
        self.default = default
        self.overrides = dict(overrides or {})

    def quota(self, tenant: str) -> TenantQuota:
        return self.overrides.get(tenant, self.default)

    @classmethod
    def from_args(
        cls,
        default_rate: float,
        default_burst: Optional[float] = None,
        overrides: Sequence[str] = (),
    ) -> Optional["TenantPolicy"]:
        """CLI wiring: rate exactly 0 disables tenancy entirely
        (returns None); burst defaults to 2x the rate.  Override
        strings are ``id:rate[:burst[:weight]]``; a malformed one —
        including a NEGATIVE rate or burst, which is a typo, never a
        disable request — raises ``ValueError`` (a typo'd quota must
        fail at startup, not admit everything silently)."""
        if default_rate < 0:
            raise ValueError(
                f"tenant rate must be >= 0 (got {default_rate!r}; "
                "0 is the explicit tenancy-off sentinel)"
            )
        if default_burst is not None and default_burst < 0:
            raise ValueError(
                f"tenant burst must be >= 0 (got {default_burst!r})"
            )
        if default_rate == 0 and not overrides:
            return None
        parsed: Dict[str, TenantQuota] = {}
        for spec in overrides:
            parts = spec.split(":")
            if len(parts) < 2 or len(parts) > 4 or not parts[0]:
                raise ValueError(
                    f"--tenant-override must be id:rate[:burst[:weight]],"
                    f" got {spec!r}"
                )
            rate = float(parts[1])
            burst = float(parts[2]) if len(parts) > 2 else 2 * rate
            weight = float(parts[3]) if len(parts) > 3 else 1.0
            if rate <= 0 or burst <= 0 or weight <= 0:
                raise ValueError(
                    f"tenant override {spec!r}: rate/burst/weight must "
                    "be positive"
                )
            parsed[parts[0]] = TenantQuota(rate, burst, weight)
        if default_rate == 0:
            raise ValueError(
                "--tenant-override given but the default --tenant-quota "
                "is 0 (untagged traffic would be unmetered while named "
                "tenants are capped — set a default rate)"
            )
        default_burst = (
            2 * default_rate if default_burst is None or default_burst == 0
            else default_burst
        )
        return cls(TenantQuota(default_rate, default_burst), parsed)


class TenantAdmission:
    """Per-tenant token buckets with a bounded tenant table.

    :meth:`admit` is the front door's one call per request: it lazily
    creates the tenant's bucket (up to ``max_tenants`` distinct ids,
    then the shared overflow bucket), takes a token, and on rejection
    counts ``serve_rejected_total{tenant=...}``.  O(1), non-blocking,
    safe to run on the event-loop thread."""

    def __init__(
        self,
        policy: TenantPolicy,
        metrics=None,
        clock: Callable[[], float] = time.monotonic,
        max_tenants: int = 64,
    ):
        self.policy = policy
        self.metrics = metrics
        self._clock = clock
        self.max_tenants = int(max_tenants)
        self._buckets: Dict[str, RateBucket] = {}
        self._lock = threading.Lock()

    def resolve(self, tenant: str) -> str:
        """The id this tenant is accounted under: itself while the
        table has room (or an override names it), the shared overflow
        id after."""
        if tenant in self.policy.overrides or tenant == DEFAULT_TENANT:
            return tenant
        with self._lock:
            if tenant in self._buckets or (
                len(self._buckets) < self.max_tenants
            ):
                return tenant
        return OVERFLOW_TENANT

    def _bucket(self, tenant: str) -> RateBucket:
        with self._lock:
            b = self._buckets.get(tenant)
            if b is None:
                q = self.policy.quota(tenant)
                b = RateBucket(q.rate, q.burst, clock=self._clock)
                self._buckets[tenant] = b
            return b

    def admit(self, tenant: str) -> "tuple[bool, str]":
        """(admitted, resolved label).  The label — not the raw header
        value — is what callers key batcher lanes and metrics on, so
        minted tenant ids stay bounded everywhere downstream."""
        label = self.resolve(tenant)
        ok = self._bucket(label).take()
        if self.metrics is not None:
            self.metrics.counter(
                "serve_tenant_requests_total", labels={"tenant": label}
            ).inc()
            if not ok:
                # the tenant-labeled rejection series the drill and the
                # fleet view read; sums by NAME still merge with the
                # queue-full rejections into fleet_rejection_rate
                self.metrics.counter(
                    "serve_rejected_total", labels={"tenant": label}
                ).inc()
        return ok, label

    def weight(self, tenant: str) -> float:
        return self.policy.quota(tenant).weight


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

    def drain(self) -> List:
        return self.pop_upto(self._len)
