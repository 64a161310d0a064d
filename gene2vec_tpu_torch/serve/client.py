"""Resilient HTTP client for the serve API: retries, deadlines, breakers.

The serving fleet (``serve/fleet.py``), the load generator
(``scripts/serve_loadgen.py --resilient``), and the dashboard all talk
to replicas through this client instead of raw ``urllib`` so that a
replica crash, an overloaded queue, or a slow network hop degrades one
request's latency — never the caller's correctness.  The design follows
the production serving playbook (deadline-propagating retries with
budgets + circuit breaking, the TF-Serving / finagle shape):

* **Per-attempt connect/read timeouts** — each attempt dials with its
  own connect timeout and reads under its own read timeout, both capped
  by the remaining request deadline;
* **Deadline propagation** — the caller's budget is written into the
  request body's ``timeout_ms`` field (the server's native deadline
  contract) and SHRINKS across attempts: a retry asks the server for
  only the time that is actually left, and no attempt is ever launched
  past the caller's deadline;
* **Retry-safe classification** — retries happen only for failures
  where the work provably did not complete: connect errors, HTTP 503
  (no model / injected), and 504s the server marked *expired in queue*
  (never computed).  400s are the caller's bug and 429s are explicit
  backpressure — retrying either amplifies load for zero information;
* **Token-bucket retry budget** — every primary attempt earns a
  fraction of a token, every retry/hedge spends one; during a full
  outage retries self-limit to ``retry_budget_ratio`` of offered load
  instead of multiplying it;
* **Hedging** (optional) — once enough latency samples exist, a request
  still unanswered at the observed p95 fires one hedge attempt on a
  different replica and the first answer wins — tail latency is traded
  against a bounded amount of extra work, paid from the same budget;
* **Per-replica circuit breakers** — ``closed`` → ``open`` after
  ``failure_threshold`` consecutive failures (the replica is skipped in
  rotation) → ``half-open`` after ``reset_timeout_s`` (ONE probe
  request is let through) → ``closed`` again on success.  A dead
  replica costs one connect timeout per reset window, not per request.
* **Trace propagation** — every attempt carries a ``traceparent``
  header (``obs/tracecontext.py``): the ambient request context when
  one is installed (the fleet proxy installs the caller's), else a
  fresh root sampled at ``trace_sample``.  Each retry and hedge is its
  own child span of the logical request, so attempt amplification is
  visible per-trace; the terminal :class:`ClientResponse` carries the
  ``trace_id`` for slow-request reporting (loadgen
  ``--trace-sample``).

Everything is stdlib (``http.client``); tests drive the state machines
with injected clocks and transports — no real sleeps.
"""

from __future__ import annotations

import dataclasses
import http.client
import json
import queue as queue_mod
import random
import threading
import time
from typing import Callable, Dict, List, Optional, Sequence, Tuple, Union
from urllib.parse import urlparse

from gene2vec_tpu_torch.obs import tracecontext
from gene2vec_tpu_torch.obs.trace import hop_span
from gene2vec_tpu_torch.obs.tracecontext import TRACEPARENT_HEADER, TraceContext

__all__ = [
    "BreakerState",
    "PooledTransport",
    "CircuitBreaker",
    "ClientResponse",
    "InFlightTracker",
    "ResilientClient",
    "RetryPolicy",
    "TokenBucket",
]


# -- policy ------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class RetryPolicy:
    """Knobs for :class:`ResilientClient` (defaults suit the fleet
    proxy's hop to a local replica; loadgen overrides per scenario)."""

    max_attempts: int = 3
    connect_timeout_s: float = 1.0
    read_timeout_s: float = 10.0
    default_timeout_s: float = 2.0
    backoff_base_s: float = 0.02
    backoff_max_s: float = 1.0
    jitter_frac: float = 0.5  # uniform in [1-j, 1+j] times the base
    retry_budget_ratio: float = 0.1  # tokens earned per primary attempt
    retry_budget_burst: float = 10.0
    hedge: bool = False
    hedge_min_samples: int = 32
    breaker_failure_threshold: int = 5
    breaker_reset_timeout_s: float = 5.0
    breaker_half_open_successes: int = 2
    #: root-trace sampling rate for requests arriving WITHOUT an
    #: ambient context: selected requests get a sampled root,
    #: unselected ones get NO context (no header — the downstream
    #: sampler stays free to act); propagated contexts always pass
    #: through regardless
    trace_sample: float = 0.0


# -- token-bucket retry budget -----------------------------------------------


class TokenBucket:
    """Request-coupled retry budget: :meth:`earn` adds a fraction of a
    token per primary attempt (capped at ``burst``), :meth:`spend` takes
    a whole token per retry/hedge.  Coupling refill to *traffic* rather
    than wall time is what bounds retry amplification: at 100% failure,
    retries converge to ``ratio`` x offered load no matter how long the
    outage lasts."""

    def __init__(self, ratio: float, burst: float):
        self.ratio = ratio
        self.burst = burst
        self._tokens = burst  # start full: a cold client may retry
        self._lock = threading.Lock()

    def earn(self) -> None:
        with self._lock:
            self._tokens = min(self._tokens + self.ratio, self.burst)

    def spend(self) -> bool:
        with self._lock:
            if self._tokens >= 1.0:
                self._tokens -= 1.0
                return True
            return False

    @property
    def tokens(self) -> float:
        return self._tokens


# -- per-target in-flight accounting -----------------------------------------


class InFlightTracker:
    """Per-target count of attempts currently on the wire.

    The elastic fleet's zero-drop scale-down contract rides on this:
    the front door stops routing to a draining replica (it leaves the
    rotation), then waits for this tracker's count on the victim's URL
    to settle to zero before the supervisor SIGTERMs it — a request the
    client already dispatched must come back through the socket before
    the process serving it dies.  ``enter``/``exit`` wrap exactly the
    transport call in :meth:`ResilientClient._attempt`, so hedges and
    retries are each their own in-flight unit."""

    def __init__(self):
        self._counts: Dict[str, int] = {}
        self._lock = threading.Lock()

    def enter(self, target: str) -> None:
        with self._lock:
            self._counts[target] = self._counts.get(target, 0) + 1

    def exit(self, target: str) -> None:
        with self._lock:
            n = self._counts.get(target, 0) - 1
            if n <= 0:
                self._counts.pop(target, None)
            else:
                self._counts[target] = n

    def count(self, target: str) -> int:
        with self._lock:
            return self._counts.get(target, 0)

    def total(self) -> int:
        with self._lock:
            return sum(self._counts.values())


# -- circuit breaker ---------------------------------------------------------


class BreakerState:
    CLOSED = "closed"
    OPEN = "open"
    HALF_OPEN = "half_open"


class CircuitBreaker:
    """Per-replica failure gate.  ``closed`` admits everything;
    ``failure_threshold`` *consecutive* failures open it; after
    ``reset_timeout_s`` it half-opens and admits exactly ONE in-flight
    probe; ``half_open_successes`` consecutive probe successes close it,
    any probe failure re-opens (with a fresh reset window).

    ``clock`` is injectable so tests walk the state machine without
    sleeping."""

    def __init__(
        self,
        failure_threshold: int = 5,
        reset_timeout_s: float = 5.0,
        half_open_successes: int = 1,
        clock: Callable[[], float] = time.monotonic,
    ):
        self.failure_threshold = failure_threshold
        self.reset_timeout_s = reset_timeout_s
        self.half_open_successes = half_open_successes
        self._clock = clock
        self._lock = threading.Lock()
        self._state = BreakerState.CLOSED
        self._consecutive_failures = 0
        self._probe_successes = 0
        self._opened_at = 0.0
        self._probe_in_flight = False

    @property
    def state(self) -> str:
        with self._lock:
            self._maybe_half_open()
            return self._state

    def _maybe_half_open(self) -> None:
        if (
            self._state == BreakerState.OPEN
            and self._clock() - self._opened_at >= self.reset_timeout_s
        ):
            self._state = BreakerState.HALF_OPEN
            self._probe_successes = 0
            self._probe_in_flight = False

    def allow(self) -> bool:
        """Whether a request may be sent to this replica right now.  In
        half-open, admits one probe at a time (the caller MUST follow up
        with :meth:`record_success` / :meth:`record_failure`)."""
        with self._lock:
            self._maybe_half_open()
            if self._state == BreakerState.CLOSED:
                return True
            if self._state == BreakerState.OPEN:
                return False
            if self._probe_in_flight:
                return False
            self._probe_in_flight = True
            return True

    def cancel(self) -> None:
        """Release a probe slot :meth:`allow` reserved without recording
        a verdict — for attempts abandoned before any I/O happened
        (deadline already spent, hedge budget denied)."""
        with self._lock:
            self._probe_in_flight = False

    def record_success(self) -> None:
        with self._lock:
            self._consecutive_failures = 0
            if self._state == BreakerState.HALF_OPEN:
                self._probe_in_flight = False
                self._probe_successes += 1
                if self._probe_successes >= self.half_open_successes:
                    self._state = BreakerState.CLOSED

    def record_failure(self) -> None:
        with self._lock:
            if self._state == BreakerState.HALF_OPEN:
                # the probe failed: straight back to open, fresh window
                self._state = BreakerState.OPEN
                self._opened_at = self._clock()
                self._probe_in_flight = False
                self._consecutive_failures = self.failure_threshold
                return
            self._consecutive_failures += 1
            if (
                self._state == BreakerState.CLOSED
                and self._consecutive_failures >= self.failure_threshold
            ):
                self._state = BreakerState.OPEN
                self._opened_at = self._clock()


# -- one attempt's outcome ---------------------------------------------------


class ClientResponse:
    """Terminal outcome of one logical request (after retries/hedging).

    ``status`` is the final HTTP status (0 for a transport-level
    failure); ``error_class`` is the loadgen-facing bucket: ``ok``,
    ``http_4xx``, ``http_429``, ``http_503``, ``http_504``,
    ``transport``, or ``deadline`` (the client's own budget ran out
    before any attempt could conclude).

    ``raw`` is the response body bytes when an attempt concluded over
    HTTP.  Successful bodies are **not** parsed by the client — the
    fleet proxy forwards ``raw`` verbatim (zero-copy passthrough) —
    and :attr:`doc` parses lazily on first access for callers that do
    want the document (the chaos drill's answer verification)."""

    __slots__ = ("status", "_doc", "raw", "error_class", "attempts",
                 "retries", "hedged", "target", "latency_s", "trace_id",
                 "_parsed")

    def __init__(
        self,
        status: int,
        doc: Optional[dict] = None,
        error_class: str = "ok",
        attempts: int = 0,
        retries: int = 0,
        hedged: bool = False,
        target: Optional[str] = None,
        latency_s: float = 0.0,
        trace_id: Optional[str] = None,
        raw: Optional[bytes] = None,
    ):
        self.status = status
        self._doc = doc
        self.raw = raw
        self.error_class = error_class
        self.attempts = attempts
        self.retries = retries
        self.hedged = hedged
        self.target = target
        self.latency_s = latency_s
        self.trace_id = trace_id
        self._parsed = doc is not None

    @property
    def doc(self) -> Optional[dict]:
        if not self._parsed:
            self._parsed = True
            if self.raw:
                try:
                    parsed = json.loads(self.raw.decode("utf-8"))
                    self._doc = parsed if isinstance(parsed, dict) else None
                except (ValueError, UnicodeDecodeError):
                    self._doc = None
        return self._doc

    @property
    def ok(self) -> bool:
        return self.error_class == "ok"

    def __repr__(self) -> str:  # debugging/tests
        return (
            f"ClientResponse(status={self.status}, "
            f"error_class={self.error_class!r}, "
            f"attempts={self.attempts}, target={self.target!r})"
        )


def _classify(status: int, doc: Optional[dict]) -> Tuple[str, bool]:
    """(error_class, retry_safe) for one attempt's HTTP outcome."""
    if 200 <= status < 300:
        return "ok", False
    if status == 429:
        return "http_429", False  # explicit backpressure: NEVER retry
    if status == 503:
        return "http_503", True  # not ready / injected: work not done
    if status == 504:
        # only queue-expired 504s are provably uncomputed; a 504 that
        # timed out mid-compute may have side-effect-free work, but
        # retrying it against the same deadline is wasted load
        msg = str((doc or {}).get("error", ""))
        return "http_504", "expired in queue" in msg
    if status == 408:
        return "http_4xx", True  # the server reaped OUR stalled send
    if 400 <= status < 500:
        return "http_4xx", False  # caller bug: retries can't fix it
    return f"http_{status}", True  # 5xx: replica trouble, retry-safe


# -- transport ---------------------------------------------------------------


def _default_transport(
    base_url: str,
    method: str,
    path: str,
    body: Optional[bytes],
    connect_timeout_s: float,
    read_timeout_s: float,
    headers: Optional[Dict[str, str]] = None,
) -> Tuple[int, bytes]:
    """One single-shot HTTP exchange with SEPARATE connect and read
    deadlines (one TCP connection per call — the pre-keep-alive
    transport, kept for callers that want connection-per-request
    semantics).  Raises ``OSError`` (incl.
    ``ConnectionRefusedError``/``Reset``) or ``socket.timeout`` on
    transport failure; HTTP errors return normally as (status,
    payload).  ``headers`` are per-attempt extras (the traceparent
    header)."""
    u = urlparse(base_url)
    conn = http.client.HTTPConnection(
        u.hostname, u.port, timeout=connect_timeout_s
    )
    try:
        conn.connect()
        if conn.sock is not None:
            conn.sock.settimeout(read_timeout_s)
        all_headers = {"Content-Type": "application/json"} if body else {}
        all_headers.update(headers or {})
        conn.request(method, path, body=body, headers=all_headers)
        resp = conn.getresponse()
        return resp.status, resp.read()
    finally:
        conn.close()


class PooledTransport:
    """Keep-alive transport: a bounded stack of persistent
    ``http.client`` connections per replica URL, shared by every
    thread using one client.

    Reuse rules: a connection goes back to its pool only after a fully
    read response that did not advertise ``Connection: close``; ANY
    transport error closes and discards the connection (never pooled
    poisoned).  A **reused** connection that fails before yielding a
    response gets ONE internal retry on a fresh connection — the
    server reaping an idle keep-alive connection between requests (its
    idle timeout, its request cap) is routine, not a replica failure,
    and must not surface as a transport error to the retry machinery.
    A failure on a *fresh* connection propagates: that IS a replica
    failure and the caller's breaker needs to see it.
    """

    def __init__(self, max_per_target: int = 8):
        self.max_per_target = max_per_target
        self._pools: Dict[str, List[http.client.HTTPConnection]] = {}
        self._lock = threading.Lock()
        #: observability for the loadgen report: TCP connections dialed
        #: and stale-reuse internal retries
        self.connections_opened = 0
        self.stale_retries = 0

    def _get(self, base_url: str) -> Optional[http.client.HTTPConnection]:
        with self._lock:
            pool = self._pools.get(base_url)
            return pool.pop() if pool else None

    def _put(self, base_url: str,
             conn: http.client.HTTPConnection) -> None:
        with self._lock:
            pool = self._pools.setdefault(base_url, [])
            if len(pool) < self.max_per_target:
                pool.append(conn)
                return
        conn.close()

    def close(self) -> None:
        with self._lock:
            pools, self._pools = self._pools, {}
        for pool in pools.values():
            for conn in pool:
                conn.close()

    def __call__(
        self,
        base_url: str,
        method: str,
        path: str,
        body: Optional[bytes],
        connect_timeout_s: float,
        read_timeout_s: float,
        headers: Optional[Dict[str, str]] = None,
    ) -> Tuple[int, bytes]:
        all_headers = {"Content-Type": "application/json"} if body else {}
        all_headers.update(headers or {})
        last_exc: Optional[BaseException] = None
        for attempt in (0, 1):
            conn = self._get(base_url) if attempt == 0 else None
            reused = conn is not None
            if conn is None:
                u = urlparse(base_url)
                conn = http.client.HTTPConnection(
                    u.hostname, u.port, timeout=connect_timeout_s
                )
                with self._lock:
                    self.connections_opened += 1
            try:
                if conn.sock is None:
                    conn.connect()
                conn.sock.settimeout(read_timeout_s)
                conn.request(method, path, body=body, headers=all_headers)
                resp = conn.getresponse()
                payload = resp.read()
                status = resp.status
                if resp.will_close:
                    conn.close()
                else:
                    self._put(base_url, conn)
                return status, payload
            except (OSError, http.client.HTTPException) as e:
                conn.close()
                last_exc = e
                if not reused:
                    raise
                with self._lock:
                    self.stale_retries += 1
                # fall through: one fresh-connection retry
        raise last_exc  # type: ignore[misc]  # pragma: no cover


# -- the client --------------------------------------------------------------


class ResilientClient:
    """Deadline-aware retrying client over one or more replica URLs.

    ``targets`` is a list of base URLs or a zero-arg callable returning
    the *current* list (the fleet supervisor passes its live healthy
    set).  ``transport``/``clock``/``sleep``/``rng`` are injectable for
    deterministic tests.

    Stats (also mirrored into ``metrics`` when given, prefixed
    ``fleet_client_``): ``requests``, ``retries``, ``hedges``,
    ``breaker_rejections``, ``deadline_exhausted``,
    ``budget_exhausted``.
    """

    def __init__(
        self,
        targets: Union[Sequence[str], Callable[[], Sequence[str]]],
        policy: RetryPolicy = RetryPolicy(),
        metrics=None,
        transport: Optional[Callable] = None,
        clock: Callable[[], float] = time.monotonic,
        sleep: Callable[[float], None] = time.sleep,
        rng: Optional[random.Random] = None,
        inflight: Optional[InFlightTracker] = None,
        budget: Optional[TokenBucket] = None,
    ):
        self._targets = targets
        self.policy = policy
        self.metrics = metrics
        #: optional per-target in-flight accounting (the fleet proxy's
        #: drain contract); None costs nothing on the attempt path
        self.inflight = inflight
        # default: per-client keep-alive pools (PooledTransport) — one
        # TCP dial per replica per concurrent stream, not per attempt;
        # tests inject fake transports through this same seam
        self._transport = (
            transport if transport is not None else PooledTransport()
        )
        self._clock = clock
        self._sleep = sleep
        self._rng = rng if rng is not None else random.Random()
        self._rr = 0
        self._rr_lock = threading.Lock()
        self._breakers: Dict[str, CircuitBreaker] = {}
        self._breakers_lock = threading.Lock()
        self._latencies: "List[float]" = []
        self._lat_lock = threading.Lock()
        # ``budget`` may be SHARED across clients: the sharded front
        # door (serve/shardgroup.py) hands every per-shard client one
        # bucket, so a dead shard's retries draw down the same budget
        # as every other shard's — the scatter cannot amplify attempts
        # fleet-wide no matter how many shards are failing
        self.budget = budget if budget is not None else TokenBucket(
            policy.retry_budget_ratio, policy.retry_budget_burst
        )
        self.stats: Dict[str, int] = {
            "requests": 0, "retries": 0, "hedges": 0,
            "breaker_rejections": 0, "deadline_exhausted": 0,
            "budget_exhausted": 0,
        }
        self._stats_lock = threading.Lock()

    # -- bookkeeping -------------------------------------------------------

    def _count(self, name: str, amount: int = 1) -> None:
        with self._stats_lock:
            self.stats[name] += amount
        if self.metrics is not None:
            self.metrics.counter(f"fleet_client_{name}_total").inc(amount)

    def targets(self) -> List[str]:
        t = self._targets() if callable(self._targets) else self._targets
        return [u.rstrip("/") for u in t]

    def breaker(self, target: str) -> CircuitBreaker:
        with self._breakers_lock:
            b = self._breakers.get(target)
            if b is None:
                b = CircuitBreaker(
                    failure_threshold=self.policy.breaker_failure_threshold,
                    reset_timeout_s=self.policy.breaker_reset_timeout_s,
                    half_open_successes=(
                        self.policy.breaker_half_open_successes
                    ),
                    clock=self._clock,
                )
                self._breakers[target] = b
            return b

    def _record_latency(self, seconds: float) -> None:
        with self._lat_lock:
            self._latencies.append(seconds)
            if len(self._latencies) > 512:
                del self._latencies[:256]

    def p95_latency_s(self) -> Optional[float]:
        with self._lat_lock:
            if len(self._latencies) < self.policy.hedge_min_samples:
                return None
            ordered = sorted(self._latencies)
        return ordered[min(len(ordered) - 1, int(0.95 * len(ordered)))]

    # -- target selection --------------------------------------------------

    def _pick(self, exclude: Sequence[str]) -> Optional[str]:
        """Next target in round-robin order whose breaker admits a
        request, skipping ``exclude`` (targets already tried for this
        logical request — a retry should change replicas when it can).
        Falls back to an excluded-but-admitted target when every other
        breaker is open (retrying the same replica beats failing), and
        to None only when no breaker admits anything.

        ``allow()`` is consulted lazily, one target at a time, because a
        True answer from a half-open breaker RESERVES its single probe
        slot — asking every breaker up front would leak reservations on
        the targets not chosen."""
        targets = self.targets()
        if not targets:
            return None
        with self._rr_lock:
            start = self._rr
            self._rr += 1
        order = [targets[(start + i) % len(targets)]
                 for i in range(len(targets))]
        for t in order:
            if t not in exclude and self.breaker(t).allow():
                return t
        for t in order:
            if t in exclude and self.breaker(t).allow():
                return t
        return None

    # -- one attempt -------------------------------------------------------

    def _attempt(
        self,
        target: str,
        method: str,
        path: str,
        body: Optional[dict],
        deadline: float,
        base_ctx: Optional[TraceContext] = None,
        hedge: bool = False,
        extra_headers: Optional[Dict[str, str]] = None,
    ) -> Tuple[str, int, Optional[dict], str, bool, Optional[bytes]]:
        """(error_class, status, doc, target, retry_safe, raw); records
        breaker + latency.  The remaining budget is propagated INTO the
        body's ``timeout_ms`` so the server's own deadline machinery
        never works past the caller's.  Each attempt derives its OWN
        child span of ``base_ctx`` and advertises it in the
        ``traceparent`` header — the downstream handler parents to this
        attempt, and retries/hedges show up as sibling spans."""
        remaining = deadline - self._clock()
        breaker = self.breaker(target)
        if remaining <= 0:
            # the breaker admitted this attempt (allow() in _pick) but no
            # I/O will happen; give any probe slot back without a verdict
            breaker.cancel()
            return "deadline", 0, None, target, False, None
        ctx = base_ctx.child() if base_ctx is not None else None
        headers: Optional[Dict[str, str]] = None
        if ctx is not None or extra_headers:
            headers = dict(extra_headers or {})
            if ctx is not None:
                headers[TRACEPARENT_HEADER] = ctx.to_header()
        payload: Optional[bytes] = None
        if body is not None:
            shrunk = dict(body)
            shrunk["timeout_ms"] = max(1.0, remaining * 1000.0)
            payload = json.dumps(shrunk).encode("utf-8")
        t0 = self._clock()
        t0_wall = time.time()
        if self.inflight is not None:
            self.inflight.enter(target)
        try:
            status, raw = self._transport(
                target,
                method,
                path,
                payload,
                min(self.policy.connect_timeout_s, remaining),
                min(self.policy.read_timeout_s, remaining),
                headers,
            )
        except (OSError, http.client.HTTPException):
            breaker.record_failure()
            hop_span(
                "client_attempt", ctx, dur=self._clock() - t0,
                wall=t0_wall, target=target, status=0,
                error_class="transport", hedge=hedge,
            )
            return "transport", 0, None, target, True, None
        finally:
            if self.inflight is not None:
                self.inflight.exit(target)
        # successful bodies stay UNPARSED (ClientResponse.doc parses
        # lazily; the fleet proxy forwards the raw bytes) — only error
        # statuses need the document for retry-safety classification
        doc: Optional[dict] = None
        if not 200 <= status < 300:
            try:
                doc = json.loads(raw.decode("utf-8")) if raw else None
            except (ValueError, UnicodeDecodeError):
                doc = None
        error_class, retry_safe = _classify(status, doc)
        if error_class == "ok":
            breaker.record_success()
            self._record_latency(self._clock() - t0)
        elif error_class in ("http_429", "http_4xx"):
            # the replica is healthy — it answered, and the failure is
            # ours (bad request) or deliberate (backpressure)
            breaker.record_success()
        else:
            breaker.record_failure()
        hop_span(
            "client_attempt", ctx, dur=self._clock() - t0, wall=t0_wall,
            target=target, status=status, error_class=error_class,
            hedge=hedge,
        )
        return error_class, status, doc, target, retry_safe, raw

    # -- the public call ---------------------------------------------------

    def request(
        self,
        path: str,
        body: Optional[dict] = None,
        method: Optional[str] = None,
        timeout_s: Optional[float] = None,
        headers: Optional[Dict[str, str]] = None,
    ) -> ClientResponse:
        """One logical request with retries/hedging under one deadline.
        Never raises for server/transport failures — the terminal
        outcome (including ``deadline`` exhaustion) comes back as a
        :class:`ClientResponse`.  ``headers`` are caller extras carried
        on EVERY attempt (the fleet proxy forwards the request's
        ``X-Tenant`` this way); the traceparent header still wins on
        conflict."""
        method = method or ("POST" if body is not None else "GET")
        timeout_s = (
            self.policy.default_timeout_s if timeout_s is None
            else float(timeout_s)
        )
        # the logical request's trace context: the ambient one when the
        # caller (fleet proxy handler) installed it, else a fresh
        # SAMPLED root for requests selected at trace_sample.  An
        # unselected request gets NO context at all (the Sampler
        # contract): no id minting, no header — and crucially no
        # unsampled header reaching the replica, which would suppress
        # its own head sampling for all of this client's traffic.
        base_ctx = tracecontext.current()
        if (
            base_ctx is None
            and self.policy.trace_sample > 0
            and self._rng.random() < self.policy.trace_sample
        ):
            base_ctx = tracecontext.new_trace(sampled=True)
        t_start = self._clock()
        deadline = t_start + timeout_s
        self._count("requests")
        self.budget.earn()

        tried: List[str] = []
        attempts = 0
        retries = 0
        hedged = False
        last: Tuple = ("transport", 0, None, None, True, None)

        while attempts < self.policy.max_attempts:
            remaining = deadline - self._clock()
            if remaining <= 0:
                self._count("deadline_exhausted")
                return self._done(
                    "deadline", 0, None, attempts, retries, hedged,
                    last[3], t_start, base_ctx,
                )
            target = self._pick(tried)
            if target is None:
                self._count("breaker_rejections")
                return self._done(
                    "breaker_open", 503,
                    {"error": "every replica's circuit breaker is open"},
                    attempts, retries, hedged, None, t_start, base_ctx,
                )
            attempts += 1
            if target not in tried:
                tried.append(target)

            hedge_after = self.p95_latency_s() if (
                self.policy.hedge and attempts == 1
            ) else None
            if hedge_after is not None and hedge_after < remaining:
                outcome, was_hedge = self._attempt_hedged(
                    target, method, path, body, deadline, hedge_after,
                    tried, base_ctx, extra_headers=headers,
                )
                if was_hedge:
                    hedged = True
                    attempts += 1
            else:
                outcome = self._attempt(
                    target, method, path, body, deadline, base_ctx,
                    extra_headers=headers,
                )
            last = outcome
            error_class, status, doc, _target, retry_safe, raw = outcome
            if error_class == "deadline":
                break  # the budget is gone; looping would only burn a token
            if error_class == "ok" or not retry_safe:
                return self._done(
                    error_class, status, doc, attempts, retries, hedged,
                    outcome[3], t_start, base_ctx, raw=raw,
                )
            if attempts >= self.policy.max_attempts:
                break
            if not self.budget.spend():
                self._count("budget_exhausted")
                break
            retries += 1
            self._count("retries")
            backoff = min(
                self.policy.backoff_base_s * (2 ** (retries - 1)),
                self.policy.backoff_max_s,
            ) * (1.0 + self.policy.jitter_frac * (2 * self._rng.random() - 1))
            remaining = deadline - self._clock()
            if backoff >= remaining:
                # sleeping would eat the whole budget: go now with what's
                # left rather than guaranteeing a deadline failure
                backoff = 0.0
            if backoff > 0:
                self._sleep(backoff)

        error_class, status, doc, target, _safe, raw = last
        if error_class == "deadline":
            self._count("deadline_exhausted")
        return self._done(
            error_class, status, doc, attempts, retries, hedged, target,
            t_start, base_ctx, raw=raw,
        )

    def _attempt_hedged(
        self,
        target: str,
        method: str,
        path: str,
        body: Optional[dict],
        deadline: float,
        hedge_after_s: float,
        tried: List[str],
        base_ctx: Optional[TraceContext] = None,
        extra_headers: Optional[Dict[str, str]] = None,
    ) -> Tuple[Tuple, bool]:
        """Primary attempt + one hedge fired at the p95 mark: whichever
        concludes first wins; a hedge is paid from the retry budget and
        targets a different replica.  Returns (outcome, hedge_fired)."""
        results: "queue_mod.Queue[Tuple]" = queue_mod.Queue()

        def run(t: str, is_hedge: bool = False) -> None:
            results.put(self._attempt(
                t, method, path, body, deadline, base_ctx,
                hedge=is_hedge, extra_headers=extra_headers,
            ))

        threading.Thread(target=run, args=(target,), daemon=True).start()
        try:
            return results.get(timeout=hedge_after_s), False
        except queue_mod.Empty:
            pass
        hedge_target = self._pick(tried)
        if hedge_target is None or not self.budget.spend():
            if hedge_target is not None:
                # reserved by _pick but the budget said no: release any
                # half-open probe slot before falling back to waiting
                self.breaker(hedge_target).cancel()
            remaining = max(0.05, deadline - self._clock())
            try:
                return results.get(timeout=remaining), False
            except queue_mod.Empty:
                return ("deadline", 0, None, target, False, None), False
        self._count("hedges")
        if hedge_target not in tried:
            tried.append(hedge_target)
        threading.Thread(
            target=run, args=(hedge_target, True), daemon=True
        ).start()
        # first FINAL outcome wins; a failed first arrival falls through
        # to the second (both are within the same deadline)
        remaining = max(0.05, deadline - self._clock())
        try:
            first = results.get(timeout=remaining)
        except queue_mod.Empty:
            return ("deadline", 0, None, target, False, None), True
        if first[0] == "ok":
            return first, True
        remaining = max(0.05, deadline - self._clock())
        try:
            second = results.get(timeout=remaining)
        except queue_mod.Empty:
            return first, True
        return (second if second[0] == "ok" else first), True

    def _done(
        self,
        error_class: str,
        status: int,
        doc: Optional[dict],
        attempts: int,
        retries: int,
        hedged: bool,
        target: Optional[str],
        t_start: float,
        base_ctx: Optional[TraceContext] = None,
        raw: Optional[bytes] = None,
    ) -> ClientResponse:
        if error_class == "breaker_open":
            error_class = "http_503"
        return ClientResponse(
            status=status,
            doc=doc,
            error_class=error_class,
            attempts=attempts,
            retries=retries,
            hedged=hedged,
            target=target,
            latency_s=self._clock() - t_start,
            trace_id=base_ctx.trace_id if base_ctx is not None else None,
            raw=raw,
        )
