"""Micro-batching request queue: admission policy, backpressure, caching
— a copy of ``gene2vec_tpu/serve/batcher.py``.

Requests enqueue from HTTP handler threads and one worker thread drains
them in batches under a **max-delay / max-batch** admission policy: the
first waiting request opens a batch window; the batch closes when either
``max_batch`` requests have joined or ``max_delay_s`` has elapsed since
the window opened, whichever is first.

Overload never grows memory: the queue is bounded at ``max_queue`` and
:meth:`MicroBatcher.submit` rejects immediately (:class:`RejectedError`
-> HTTP 429) when full.  Each request carries a deadline; requests that
expire while queued are failed (:class:`DeadlineExceeded` -> HTTP 504)
without spending compute on them.  A bounded LRU keyed by (model
version, query, k) serves repeat lookups without touching the queue.

The queue is a :class:`~gene2vec_tpu_torch.serve.tenancy.FairQueue` of
per-tenant lanes drained by the tenants' weights (one lane, FIFO, with
tenancy off).
Every batch runs under an obs span (``serve_batch`` wrapping
``serve_compute``); counters and histograms land in the registry
``/metrics`` exports.  Each ticket captures the submitting thread's trace
context: a sampled request gets a ``batch_item`` hop inside the batch's
span (or a ``cache_hit`` hop when the LRU answers), and its queue wait,
compute time and batch size flow into its flight-recorder record.
"""

from __future__ import annotations

import collections
import threading
import time
from typing import Any, Callable, Hashable, List, Optional, Tuple

from gene2vec_tpu_torch.obs import flight, tracecontext
from gene2vec_tpu_torch.obs.trace import ambient_span, hop_span
from gene2vec_tpu_torch.serve.tenancy import DEFAULT_TENANT, FairQueue


class RejectedError(RuntimeError):
    """Queue at capacity — explicit backpressure (HTTP 429)."""


class DeadlineExceeded(RuntimeError):
    """Request deadline passed before a result was ready (HTTP 504)."""


class _Pending:
    __slots__ = ("item", "k", "deadline", "event", "result", "error",
                 "ctx", "t0", "wait_s", "compute_s", "batch_n",
                 "on_done", "cache_key", "tenant")

    def __init__(self, item: Any, k: int, deadline: float,
                 t0: float = 0.0, on_done=None, cache_key=None,
                 tenant: str = DEFAULT_TENANT):
        self.item = item
        self.k = k
        self.deadline = deadline
        self.tenant = tenant
        self.event = threading.Event()
        self.result: Any = None
        self.error: Optional[BaseException] = None
        # the submitting request's trace context, captured on the handler
        # thread: the worker emits this ticket's hop under it
        self.ctx = tracecontext.current()
        # queue-wait / compute timings the worker fills in
        self.t0 = t0
        self.wait_s: Optional[float] = None
        self.compute_s: Optional[float] = None
        self.batch_n: Optional[int] = None
        # completion callback (event-loop coalescing path): invoked by
        # the worker thread as ``on_done(result, error)`` AFTER the
        # result/error fields settle and the event is set — so a
        # non-blocking front end gets its answer without parking a
        # thread on Ticket.get
        self.on_done = on_done
        self.cache_key = cache_key


class LRUCache:
    """Bounded thread-safe LRU (size 0 disables)."""

    def __init__(self, max_size: int):
        self.max_size = max_size
        self._data: "collections.OrderedDict[Hashable, Any]" = (
            collections.OrderedDict()
        )
        self._lock = threading.Lock()

    def get(self, key: Hashable):
        with self._lock:
            if key not in self._data:
                return None
            self._data.move_to_end(key)
            return self._data[key]

    def put(self, key: Hashable, value: Any) -> None:
        if self.max_size <= 0:
            return
        with self._lock:
            self._data[key] = value
            self._data.move_to_end(key)
            while len(self._data) > self.max_size:
                self._data.popitem(last=False)

    def __len__(self) -> int:
        return len(self._data)


class Ticket:
    """Handle for one submitted request; :meth:`get` blocks for the
    result, raising the request's failure."""

    __slots__ = ("_batcher", "_pending", "_cache_key", "_t0", "_timeout_s",
                 "_cached")

    def __init__(self, batcher, pending, cache_key, t0,
                 timeout_s: float = 0.0, cached=None):
        self._batcher = batcher
        self._pending = pending
        self._cache_key = cache_key
        self._t0 = t0
        self._timeout_s = timeout_s
        self._cached = cached

    def get(self):
        if self._pending is None:
            return self._cached
        b = self._batcher
        remaining = (self._t0 + self._timeout_s) - time.monotonic()
        if not self._pending.event.wait(max(0.0, remaining)):
            b._count("serve_deadline_expired_total")
            raise DeadlineExceeded(
                f"no result within {self._timeout_s:.3f}s"
            )
        if self._pending.error is not None:
            raise self._pending.error
        # ticket timings flow into the request's flight-recorder hop sink
        # (get() runs on the submitting handler thread)
        if self._pending.wait_s is not None:
            flight.add_hop("queue_wait_s", self._pending.wait_s)
        if self._pending.compute_s is not None:
            flight.add_hop("compute_s", self._pending.compute_s)
        if self._pending.batch_n is not None:
            flight.add_hop("batch", self._pending.batch_n)
        b._observe("serve_request_seconds", time.monotonic() - self._t0)
        # the worker already cached successful results (_settle)
        return self._pending.result


class MicroBatcher:
    """Batches ``(item, k)`` requests into calls of
    ``compute(items, k_max) -> list-of-results`` on one worker thread.

    ``compute`` receives the batch's items and the max padded ``k`` over
    the batch and must return one result per item, in order.  Mixed-k
    batches compute at the largest k; each caller gets its own result
    back untouched (the compute fn crops per-item if it cares).
    """

    def __init__(
        self,
        compute: Callable[[List[Any], int], List[Any]],
        max_batch: int = 64,
        max_delay_s: float = 0.005,
        max_queue: int = 256,
        cache_size: int = 1024,
        default_timeout_s: float = 2.0,
        metrics=None,
        tenant_weights: Optional[Callable[[str], float]] = None,
        labels: Optional[dict] = None,
    ):
        self.compute = compute
        self.max_batch = max_batch
        self.max_delay_s = max_delay_s
        self.max_queue = max_queue
        self.default_timeout_s = default_timeout_s
        self.cache = LRUCache(cache_size)
        self.metrics = metrics
        # the extra label set of every series this batcher touches: a
        # catalog runs one batcher per model on one shared registry, and
        # {model=} keeps sibling queues apart; None keeps the unlabeled
        # single-model series
        self.labels = dict(labels) if labels else None
        # per-tenant lanes, weighted-fair drained; accessed only under
        # self._cv (FairQueue itself is lock-free by contract)
        self._q = FairQueue(weight_of=tenant_weights)
        self._cv = threading.Condition()
        self._stop = False
        self._worker: Optional[threading.Thread] = None

    # -- lifecycle ---------------------------------------------------------

    def start(self) -> "MicroBatcher":
        if self._worker is None:
            self._stop = False
            self._worker = threading.Thread(
                target=self._run, name="micro-batcher", daemon=True
            )
            self._worker.start()
        return self

    def stop(self) -> None:
        if self._worker is None:
            return
        with self._cv:
            self._stop = True
            self._cv.notify_all()
        self._worker.join(timeout=5.0)
        self._worker = None

    # -- metrics helpers ---------------------------------------------------

    def _count(self, name: str, amount: int = 1) -> None:
        if self.metrics is not None:
            self.metrics.counter(name, labels=self.labels).inc(amount)

    def _observe(self, name: str, value: float) -> None:
        if self.metrics is not None:
            self.metrics.histogram(name, labels=self.labels).observe(value)

    def _gauge_depth(self) -> None:
        if self.metrics is not None:
            self.metrics.gauge("serve_queue_depth", labels=self.labels).set(len(self._q))

    # -- submission --------------------------------------------------------

    def submit_async(
        self,
        item: Any,
        k: int,
        cache_key: Optional[Hashable] = None,
        timeout_s: Optional[float] = None,
        on_done: Optional[Callable[[Any, Optional[BaseException]], None]]
        = None,
        tenant: str = DEFAULT_TENANT,
    ) -> "Ticket":
        """Enqueue one request and return a :class:`Ticket` immediately
        (so a multi-query HTTP request lands all its queries in the same
        batch window before blocking on any of them).

        ``on_done(result, error)`` — when given — is invoked by the
        worker thread once the request settles (result, per-batch
        failure, or expired-in-queue), so non-blocking callers (the
        event-loop front end's coalesced GETs) never park a thread on
        :meth:`Ticket.get`.  A cache hit invokes it synchronously.

        Raises :class:`RejectedError` right here when the queue is full
        — backpressure is decided at admission, never deferred.
        """
        self._count("serve_requests_total")
        if cache_key is not None:
            hit = self.cache.get(cache_key)
            if hit is not None:
                self._count("serve_cache_hits_total")
                ctx = tracecontext.current()
                if ctx is not None and ctx.sampled:
                    # a cached answer skips batcher and engine: record the
                    # hop so the trace does not dead-end
                    hop_span("cache_hit", ctx.child(), dur=0.0)
                if on_done is not None:
                    on_done(hit, None)
                return Ticket(self, None, None, 0.0, cached=hit)
        timeout_s = (
            self.default_timeout_s if timeout_s is None else float(timeout_s)
        )
        t0 = time.monotonic()
        pending = _Pending(item, int(k), t0 + timeout_s, t0=t0,
                           on_done=on_done, cache_key=cache_key,
                           tenant=tenant)
        with self._cv:
            if self._worker is None:
                raise RuntimeError("MicroBatcher not started")
            if len(self._q) >= self.max_queue:
                self._count("serve_rejected_total")
                raise RejectedError(
                    f"queue full ({self.max_queue} waiting requests)"
                )
            self._q.push(tenant, pending)
            self._gauge_depth()
            self._cv.notify_all()
        return Ticket(self, pending, cache_key, t0, timeout_s=timeout_s)

    def submit(
        self,
        item: Any,
        k: int,
        cache_key: Optional[Hashable] = None,
        timeout_s: Optional[float] = None,
        tenant: str = DEFAULT_TENANT,
    ) -> Any:
        """Blocking :meth:`submit_async`: the result, or
        :class:`RejectedError` / :class:`DeadlineExceeded` /
        the compute failure."""
        return self.submit_async(
            item, k, cache_key=cache_key, timeout_s=timeout_s,
            tenant=tenant,
        ).get()

    # -- worker ------------------------------------------------------------

    def _gather(self) -> List[_Pending]:
        """Admission policy: block for the first request, then hold the
        window open until ``max_batch`` joined or ``max_delay_s`` passed."""
        with self._cv:
            while not self._q and not self._stop:
                self._cv.wait()
            if self._stop and not self._q:
                return []
            window_ends = time.monotonic() + self.max_delay_s
            batch: List[_Pending] = []
            while len(batch) < self.max_batch:
                # weighted-fair drain: lanes are interleaved by tenant
                # weight, FIFO within a tenant (serve/tenancy.py)
                batch.extend(self._q.pop_upto(self.max_batch - len(batch)))
                remaining = window_ends - time.monotonic()
                if remaining <= 0 or len(batch) >= self.max_batch:
                    break
                self._cv.wait(timeout=remaining)
                if self._stop and not self._q:
                    break
            self._gauge_depth()
            return batch

    def _settle(self, p: _Pending) -> None:
        """Publish one request's outcome: cache successful results,
        release the waiter, fire the completion callback.  Runs on the
        worker thread for every non-cache-hit request exactly once."""
        if p.error is None and p.cache_key is not None:
            self.cache.put(p.cache_key, p.result)
        p.event.set()
        if p.on_done is not None:
            try:
                p.on_done(p.result, p.error)
            except Exception:  # a callback bug must not kill the worker
                self._count("serve_callback_errors_total")

    def _run(self) -> None:
        while True:
            batch = self._gather()
            if not batch:
                if self._stop:
                    return
                continue
            now = time.monotonic()
            live: List[_Pending] = []
            for p in batch:
                if p.deadline <= now:
                    # expired while queued: fail it without computing
                    # (submit() already returned DeadlineExceeded; this
                    # keeps the slot from consuming batch capacity)
                    p.error = DeadlineExceeded("expired in queue")
                    self._settle(p)
                    self._count("serve_expired_in_queue_total")
                else:
                    live.append(p)
            if not live:
                continue
            self._observe("serve_batch_size", len(live))
            k_max = max(p.k for p in live)
            for p in live:
                p.wait_s = now - p.t0
                p.batch_n = len(live)
            traced = [p for p in live if p.ctx is not None and p.ctx.sampled]
            try:
                with ambient_span(
                    "serve_batch", size=len(live), k=k_max
                ) as span:
                    t_c0 = time.monotonic()
                    with ambient_span("serve_compute"):
                        results = self.compute([p.item for p in live], k_max)
                    compute_s = time.monotonic() - t_c0
                    span["ok"] = True
                    for p in live:
                        p.compute_s = compute_s
                    if traced:
                        # one batch serves many traces: name a bounded few,
                        # and give each sampled item its own hop, emitted
                        # inside serve_batch so the hop's enclosing span
                        # links the compute subtree to its trace
                        span["traces"] = sorted({p.ctx.trace_id for p in traced})[:8]
                        for p in traced:
                            hop_span(
                                "batch_item", p.ctx.child(), dur=compute_s,
                                queue_wait_s=round(p.wait_s, 6),
                                batch=len(live), k=k_max,
                            )
                if len(results) != len(live):
                    raise RuntimeError(
                        f"compute returned {len(results)} results for "
                        f"{len(live)} items"
                    )
                for p, r in zip(live, results):
                    p.result = r
                    self._settle(p)
            except BaseException as e:  # noqa: BLE001 — failures propagate per request
                for p in live:
                    if not p.event.is_set():
                        p.error = e
                        self._settle(p)
                self._count("serve_batch_errors_total")
