"""JSON HTTP API over the registry + engine + batcher stack — the port of
``gene2vec_tpu/serve/server.py`` for one model.

Endpoints (all JSON except ``/metrics``):

* ``POST /v1/similar`` — ``{"genes": [...]}`` or ``{"vectors": [[...]]}``
  + ``"k"`` → per-query neighbor lists (gene queries drop the query row
  itself from its own neighbors); ``GET /v1/similar?gene=..&k=..``;
* ``POST /v1/embedding`` — raw embedding rows for named genes;
* ``POST /v1/interaction`` — ``{"pairs": [[gene, gene], ...]}`` → GGIPNN
  softmax scores per pair (head from ``--ggipnn-checkpoint``;
  ``trained_head`` says whether one was loaded);
* ``GET  /v1/genes`` — a slice of the served vocab;
* ``GET  /healthz`` — readiness: model and index facts once a model is
  served, 503 ``not_ready`` until then;
* ``GET  /livez`` — liveness: 200 whenever the process answers HTTP,
  model or no model;
* ``GET  /debug/flight`` — the flight recorder's ring of recent requests
  (``obs/flight.py``), the same document a SIGQUIT dumps;
* ``GET  /metrics`` — the Prometheus text of the metrics registry,
  kernel launch counts and compile events included, and with
  ``kernel_profile`` each engine bucket's ``kernel_*`` cost gauges
  (:meth:`ServeApp.profile_kernels`).

Status mapping: queue full → 429, request deadline → 504, unknown gene
or malformed body → 400, no model loaded → 503.  The front end is the
event loop (``serve/eventloop.py``); the hot read path — ``GET
/v1/similar`` — is answered from the loop itself out of a bounded LRU of
pre-serialized bodies keyed by (model version, gene, k), and concurrent
identical misses coalesce onto one batcher ticket.  Everything else —
POSTs, requests with a ``traceparent`` header, a server that samples
root traces, fault injection — runs :meth:`ServeApp.handle` on a bounded
worker pool.

Tracing: a sampled ``traceparent`` makes the request, its batcher hop and
its engine spans children of the caller's span (``obs/tracecontext.py``);
``ServeConfig.trace_sample`` starts root traces for headerless requests.
Every request lands in the flight recorder's ring with its hops (queue
wait, compute, batch size); a 5xx burst dumps the ring to ``flight_dir``
through a rate limiter.

Fault injection (``resilience/faults.py``) hooks the pool's dispatch
behind an explicit opt-in (``ServeApp(fault_injector=)``, ``--faults`` /
``GENE2VEC_TPU_FAULTS``): with an injector every request takes the pool,
whose first act is the injector's decision — a delay, an error response,
a TCP reset or a blackhole.  Without one no fault code runs.

Not in this slice: the multi-model catalog, row shards (and cross-shard
interaction scoring), batch jobs and tenant quotas.
"""

from __future__ import annotations

import dataclasses
import json
import threading
import time
from typing import Dict, List, Optional, Tuple
from urllib.parse import parse_qs, unquote_plus, urlparse

import numpy as np

from gene2vec_tpu_torch import kernels
from gene2vec_tpu_torch.obs import flight as flight_mod
from gene2vec_tpu_torch.obs import probes, tracecontext
from gene2vec_tpu_torch.obs.alerts import RateLimiter
from gene2vec_tpu_torch.obs.flight import FlightRecorder
from gene2vec_tpu_torch.obs.profiler import STATIC_FIELDS, stamp_records
from gene2vec_tpu_torch.obs.registry import MetricsRegistry
from gene2vec_tpu_torch.obs.trace import ambient_span
from gene2vec_tpu_torch.obs.tracecontext import Sampler, TraceContext
from gene2vec_tpu_torch.serve.ann import index_stats
from gene2vec_tpu_torch.serve.batcher import (
    DeadlineExceeded,
    LRUCache,
    MicroBatcher,
    RejectedError,
)
from gene2vec_tpu_torch.serve.engine import SimilarityEngine
from gene2vec_tpu_torch.serve.interaction import InteractionScorer
from gene2vec_tpu_torch.serve.eventloop import (
    ConnHandle,
    EventLoopConfig,
    EventLoopHTTPServer,
    HandlerPool,
    HTTPRequest,
    Response,
    parse_json_body,
)
from gene2vec_tpu_torch.serve.registry import ModelRegistry
from gene2vec_tpu_torch.serve.routes import V1_ROUTES


class ApiError(Exception):
    """Route failure with an HTTP status."""

    def __init__(self, status: int, message: str):
        super().__init__(message)
        self.status = status


@dataclasses.dataclass(frozen=True)
class ServeConfig:
    """Engine/batcher/queue policy knobs (``cli/serve.py`` flags)."""

    max_batch: int = 64
    max_delay_ms: float = 5.0
    max_queue: int = 256
    cache_size: int = 4096
    timeout_ms: float = 2000.0
    max_k: int = 256
    max_queries_per_request: int = 64
    # retrieval index: exact | quant (int8 scan + exact rescore) | ivf
    index: str = "exact"
    # IVF lists probed per query
    nprobe: int = 8
    # exact-rescore tail size multiplier: rb = rescore_mult * kb
    rescore_mult: int = 4
    # once a request's first byte has arrived the whole request must
    # arrive within this window (expiry -> 408 + close)
    read_timeout_s: float = 10.0
    # root-trace sampling rate for requests without a traceparent header
    # (0 = trace only when the caller propagates a sampled context)
    trace_sample: float = 0.0
    # keep-alive connections idle longer than this are closed
    idle_timeout_s: float = 30.0
    # requests served per connection before the front end closes it
    # (0 = unbounded)
    max_conn_requests: int = 0
    # acceptor event loops; > 1 enables SO_REUSEPORT multi-acceptor
    acceptors: int = 1
    # bounded worker pool for the full-dispatch path; saturation -> 429
    http_workers: int = 8
    # per-bucket kernel attribution (ServeApp.profile_kernels): each batch
    # bucket's kernel work counted from shapes and published as kernel_*
    # gauges on /metrics (cli/serve.py --kernel-profile)
    kernel_profile: bool = False
    # a 5xx burst of >= burst_threshold within burst_window_s dumps the
    # flight ring to flight_dir; dumps share one RateLimiter
    burst_threshold: int = 10
    burst_window_s: float = 5.0


#: routes with their own latency series; anything else is "other"
_KNOWN_ROUTES = V1_ROUTES | frozenset(("/", "/livez", "/healthz", "/metrics"))

#: requests the worker pool holds before the front end answers 429
_HTTP_QUEUE = 512

#: powers-of-two seconds buckets, 0.5 ms .. ~8 s
_ROUTE_BUCKETS = tuple(0.0005 * (2 ** e) for e in range(15))


def _route_label(route: str) -> str:
    return route if route in _KNOWN_ROUTES else "other"


class ServeApp:
    """The route layer: owns the registry, engine and batcher."""

    def __init__(
        self,
        registry: ModelRegistry,
        config: ServeConfig = ServeConfig(),
        metrics: Optional[MetricsRegistry] = None,
        ggipnn_checkpoint: Optional[str] = None,
        fault_injector=None,
    ):
        self.registry = registry
        self.config = config if config is not None else ServeConfig()
        config = self.config
        self.metrics = metrics if metrics is not None else MetricsRegistry()
        if registry.metrics is None:
            registry.metrics = self.metrics
        # a resilience/faults.py FaultInjector; None means no fault code
        # runs at all (the production default)
        self.faults = fault_injector
        if self.faults is not None and self.faults.metrics is None:
            self.faults.metrics = self.metrics
        if registry.loaded:
            # the registry publishes these on swap; backfill for a model
            # loaded before the metrics registry was attached
            self.metrics.gauge("model_iteration").set(registry.model.iteration)
            self.metrics.gauge("model_vocab_size").set(len(registry.model))
        self.engine = SimilarityEngine(
            max_batch=config.max_batch, index=config.index, nprobe=config.nprobe,
            rescore_mult=config.rescore_mult,
        )
        self.batcher = MicroBatcher(
            self._compute_batch,
            max_batch=config.max_batch,
            max_delay_s=config.max_delay_ms / 1000.0,
            max_queue=config.max_queue,
            cache_size=config.cache_size,
            default_timeout_s=config.timeout_ms / 1000.0,
            metrics=self.metrics,
        )
        self.ggipnn_checkpoint = ggipnn_checkpoint
        self._scorer: Optional[InteractionScorer] = None
        self._scorer_lock = threading.Lock()
        self._started = time.monotonic()
        #: kernel launches already published to /metrics, per kernel
        self._launches_published: Dict[str, int] = {}
        # compile events (kernel builds and library loads, the process-wide
        # CompileWatcher) feed a monotone counter on /metrics by delta
        self._compile_watcher = probes.CompileWatcher.install()
        self._compile_events_published = 0
        # head sampler for headerless traffic; a propagated sampled
        # context bypasses it (the root already decided)
        self.sampler = Sampler(config.trace_sample) if config.trace_sample > 0 else None
        # always-on bounded ring of recent requests; cli/serve.py sets
        # flight_dir (the run dir) and installs the SIGQUIT dump
        self.flight_limiter = RateLimiter(min_interval_s=config.burst_window_s)
        self.flight = FlightRecorder(
            burst_threshold=config.burst_threshold,
            burst_window_s=config.burst_window_s,
            limiter=self.flight_limiter,
        )
        self.flight_dir: Optional[str] = None
        # pre-serialized response bodies keyed (model version, gene, k)
        self.response_cache = LRUCache(config.cache_size)
        # coalescing table for concurrent identical GETs: key -> list of
        # (peer, deadline, t0) waiting on ONE batcher ticket
        self._coalesce: Dict[tuple, list] = {}
        self._coalesce_lock = threading.Lock()

    @staticmethod
    def _model_doc(model) -> dict:
        return {"dim": model.dim, "iteration": model.iteration}

    def start(self) -> "ServeApp":
        self.batcher.start()
        return self

    def stop(self) -> None:
        self.batcher.stop()
        self.registry.stop_watcher()

    # -- batch compute (worker thread) ------------------------------------

    def _compute_batch(self, items: List[dict], k_max: int) -> List[dict]:
        """Resolve every queued query against ONE model snapshot and run
        the padded top-k.  Items resolve here (not at submit) so a hot
        swap mid-queue cannot mix two iterations inside one batch."""
        model = self.registry.model
        vectors: List[np.ndarray] = []
        self_rows: List[Optional[int]] = []
        for item in items:
            if "gene" in item:
                row = model.index.get(item["gene"])
                if row is None:
                    # swapped away between admission and compute —
                    # per-item failure, the rest of the batch proceeds
                    vectors.append(np.zeros(model.dim, np.float32))
                    self_rows.append(-2)
                    continue
                vectors.append(model.emb[row])
                self_rows.append(row)
            else:
                vectors.append(np.asarray(item["vector"], dtype=np.float32))
                self_rows.append(None)
        # gene queries ask one extra so dropping the self-hit still
        # leaves k neighbors
        kq = min(k_max + 1, len(model))
        if self.engine.index_mode != "exact" and model.ann is None:
            # approximate engine over a snapshot without an index: served
            # exactly, but visibly
            self.metrics.counter("engine_index_fallback_total").inc()
        neighbors = self.engine.similar_batch(model, vectors, kq)
        out: List[dict] = []
        for item, row, hits in zip(items, self_rows, neighbors):
            if row == -2:
                out.append(
                    {"error": f"gene {item['gene']!r} not in the served model "
                              f"(iteration {model.iteration})"}
                )
                continue
            if row is not None:
                gene = model.tokens[row]
                hits = [h for h in hits if h[0] != gene]
            out.append({
                "neighbors": [
                    {"gene": g, "score": round(s, 6)} for g, s in hits[: item["k"]]
                ],
                "iteration": model.iteration,
            })
        return out

    # -- routes ------------------------------------------------------------

    def _model_or_503(self):
        try:
            return self.registry.model
        except RuntimeError as e:
            raise ApiError(503, str(e)) from e

    def _validate_k(self, body: dict) -> int:
        k = body.get("k", 10)
        if not isinstance(k, int) or k < 1 or k > self.config.max_k:
            raise ApiError(400, f"k must be an int in [1, {self.config.max_k}]")
        return k

    def _timeout_s(self, body: dict) -> Optional[float]:
        t = body.get("timeout_ms")
        if t is None:
            return None
        if not isinstance(t, (int, float)) or t <= 0:
            raise ApiError(400, "timeout_ms must be a positive number")
        return float(t) / 1000.0

    def similar(self, body: dict) -> dict:
        model = self._model_or_503()
        k = self._validate_k(body)
        timeout_s = self._timeout_s(body)
        genes = body.get("genes")
        vectors = body.get("vectors")
        if (genes is None) == (vectors is None):
            raise ApiError(400, "provide exactly one of 'genes' or 'vectors'")
        if genes is not None:
            if not isinstance(genes, list) or not genes:
                raise ApiError(400, "'genes' must be a non-empty list")
            unknown = [g for g in genes if g not in model.index]
            if unknown:
                raise ApiError(
                    400, f"unknown gene(s) {unknown[:5]!r} (model iteration {model.iteration})"
                )
            queries = [{"gene": g, "k": k} for g in genes]
        else:
            if not isinstance(vectors, list) or not vectors:
                raise ApiError(400, "'vectors' must be a non-empty list")
            for v in vectors:
                if not isinstance(v, list) or len(v) != model.dim:
                    raise ApiError(400, f"each vector must have dim {model.dim}")
            queries = [{"vector": v, "k": k} for v in vectors]
        if len(queries) > self.config.max_queries_per_request:
            raise ApiError(
                400, f"at most {self.config.max_queries_per_request} queries per request"
            )
        # submit everything before waiting on anything, so one request's
        # queries share a batch window
        tickets = []
        try:
            for q in queries:
                cache_key = (model.version, "similar", q["gene"], k) if "gene" in q else None
                tickets.append((q, self.batcher.submit_async(
                    q, k, cache_key=cache_key, timeout_s=timeout_s,
                )))
        except RejectedError as e:
            raise ApiError(429, str(e)) from e
        results = []
        # the iteration that ACTUALLY answered: queries landing in batches
        # on opposite sides of a hot swap are refused as a retryable 503
        served_iteration: Optional[int] = None
        for q, ticket in tickets:
            try:
                r = ticket.get()
            except DeadlineExceeded as e:
                raise ApiError(504, str(e)) from e
            if "error" in r:
                raise ApiError(400, r["error"])
            it = r.get("iteration")
            if served_iteration is None:
                served_iteration = it
            elif it is not None and it != served_iteration:
                raise ApiError(
                    503,
                    f"hot swap landed mid-request (iterations {served_iteration} "
                    f"and {it} in one response); retry",
                )
            results.append({"query": q.get("gene"), "neighbors": r["neighbors"]})
        doc = {"model": self._model_doc(model), "results": results}
        if served_iteration is not None:
            doc["model"]["iteration"] = served_iteration
        return doc

    def embedding(self, body: dict) -> dict:
        model = self._model_or_503()
        genes = body.get("genes")
        if not isinstance(genes, list) or not genes:
            raise ApiError(400, "'genes' must be a non-empty list")
        if len(genes) > self.config.max_queries_per_request:
            raise ApiError(
                400, f"at most {self.config.max_queries_per_request} genes per request"
            )
        rows = []
        for g in genes:
            row = model.index.get(g)
            if row is None:
                raise ApiError(400, f"unknown gene {g!r} (model iteration {model.iteration})")
            rows.append({"gene": g, "vector": [float(v) for v in model.emb[row]]})
        return {"model": self._model_doc(model), "embeddings": rows}

    def _get_scorer(self, model) -> InteractionScorer:
        """Scorer bound to the served iteration; rebuilt after hot swap."""
        with self._scorer_lock:
            if self._scorer is None or self._scorer.version != model.version:
                with ambient_span("scorer_build", iteration=model.iteration):
                    self._scorer = InteractionScorer(
                        model, checkpoint_path=self.ggipnn_checkpoint,
                        device=self.registry.device)
            return self._scorer

    def interaction(self, body: dict) -> dict:
        model = self._model_or_503()
        pairs = body.get("pairs")
        if not isinstance(pairs, list) or not pairs or not all(
            isinstance(p, list) and len(p) == 2 for p in pairs
        ):
            raise ApiError(400, "'pairs' must be a non-empty list of [gene, gene]")
        if len(pairs) > self.config.max_queries_per_request:
            raise ApiError(
                400, f"at most {self.config.max_queries_per_request} pairs per request"
            )
        scorer = self._get_scorer(model)
        try:
            scores = scorer.score([tuple(p) for p in pairs])
        except KeyError as e:
            raise ApiError(
                400, f"unknown gene {e.args[0]!r} (model iteration {model.iteration})"
            ) from e
        self.metrics.counter("serve_interaction_pairs_total").inc(len(pairs))
        return {
            "model": self._model_doc(model),
            "trained_head": scorer.trained,
            "scores": [{"pair": p, "score": round(s, 6)} for p, s in zip(pairs, scores)],
        }

    @staticmethod
    def _int_param(query: Dict[str, List[str]], name: str, default: int) -> int:
        raw = query.get(name, [str(default)])[0]
        try:
            return int(raw)
        except ValueError:
            raise ApiError(400, f"{name} must be an integer, got {raw!r}") from None

    def genes(self, query: Dict[str, List[str]]) -> dict:
        model = self._model_or_503()
        limit = self._int_param(query, "limit", 100)
        offset = self._int_param(query, "offset", 0)
        if limit < 0 or offset < 0:
            raise ApiError(400, "limit/offset must be >= 0")
        return {"total": len(model), "genes": list(model.tokens[offset : offset + limit])}

    def profile_kernels(self, k: int = 16) -> Dict[str, Dict]:
        """Warm-time per-bucket kernel attribution: each batch bucket's
        kernel work in the active index mode against the served model
        (``engine.profile_buckets``, counted from shapes: no kernel runs),
        published as ``kernel_*`` gauges (:meth:`publish_engine_metrics`).
        An empty dict when no model is loaded or the mode needs an ANN
        index the snapshot lacks: a replica must not fail over its own
        telemetry."""
        if not self.registry.loaded:
            return {}
        model = self.registry.model
        ann_index = getattr(model, "ann", None)
        if self.engine.index_mode != "exact" and ann_index is None:
            return {}
        try:
            costs = self.engine.profile_buckets(model.unit, valid=len(model), k=k,
                                                ann_index=ann_index)
        except Exception:
            return {}
        self.publish_engine_metrics()
        return costs

    def publish_engine_metrics(self) -> None:
        """Refresh, at each ``/metrics`` scrape: the engine's distinct
        launch shapes per index mode (``engine_jit_cache_entries{mode}``,
        the reference's name), the kernel launches since the last scrape
        (``kernel_launches_total{kernel}``), the compile events since the
        last scrape (``jit_compile_events_total``, the reference's name: a
        kernel library built or loaded; once a mode has served each of its
        buckets, more traffic adds none), the served model's age and the
        buckets' ``kernel_*`` costs of :meth:`profile_kernels`."""
        for mode, size in self.engine.cache_sizes().items():
            self.metrics.gauge(
                "engine_jit_cache_entries", labels={"mode": mode}
            ).set(size)
        for name, count in kernels.launch_counts().items():
            delta = count - self._launches_published.get(name, 0)
            if delta > 0:
                self.metrics.counter(
                    "kernel_launches_total", "CUDA kernel launches by this process",
                    labels={"kernel": name},
                ).inc(delta)
                self._launches_published[name] = count
        # a counter, not the raw count as a gauge: deltas survive a reset
        compiles = self._compile_watcher.count
        if compiles > self._compile_events_published:
            self.metrics.counter(
                "jit_compile_events_total",
                "kernel library builds and loads seen by this process",
            ).inc(compiles - self._compile_events_published)
            self._compile_events_published = compiles
        if self.registry.loaded:
            self.metrics.gauge("model_age_seconds").set(
                max(0.0, time.time() - self.registry.model.created_unix)
            )
        stamp_records(self.metrics, list(self.engine.kernel_costs().values()), STATIC_FIELDS)

    def livez(self) -> dict:
        """Liveness: the process answers HTTP.  Never inspects the
        registry: a replica mid-load is alive but not ready."""
        return {"status": "alive", "uptime_s": round(time.monotonic() - self._started, 3)}

    def healthz(self) -> Tuple[int, dict]:
        """Readiness: 200 with model facts once a model is served; 503
        ``not_ready`` until then."""
        ready = self.registry.loaded
        out = {
            "status": "ok" if ready else "not_ready",
            "uptime_s": round(time.monotonic() - self._started, 3),
            "queue_depth": len(self.batcher._q),
            "max_queue": self.config.max_queue,
            "device": str(self.registry.device),
        }
        if not ready:
            out["reason"] = (
                "every discovered checkpoint is quarantined"
                if self.registry.quarantined else "no model loaded yet"
            )
            return 503, out
        m = self.registry.model
        out["model"] = {
            "dim": m.dim, "iteration": m.iteration, "vocab_size": len(m), "source": m.source,
        }
        out["index"] = self.engine.index_mode
        if m.ann is not None:
            out["ann"] = index_stats(m.ann)
        return 200, out

    # -- dispatch ----------------------------------------------------------

    def _dispatch(self, method: str, route: str, query: Dict[str, List[str]],
                  body: Optional[dict]) -> Tuple[int, dict]:
        if method == "GET" and route == "/livez":
            return 200, self.livez()
        if method == "GET" and route == "/healthz":
            return self.healthz()
        if method == "GET" and route == "/v1/genes":
            return 200, self.genes(query)
        if method == "GET" and route == "/v1/similar":
            gene = query.get("gene", [None])[0]
            if gene is None:
                raise ApiError(400, "missing ?gene= parameter")
            k = self._int_param(query, "k", 10)
            return 200, self.similar({"genes": [gene], "k": k})
        if method == "POST" and route == "/v1/similar":
            return 200, self.similar(body or {})
        if method == "POST" and route == "/v1/embedding":
            return 200, self.embedding(body or {})
        if method == "POST" and route == "/v1/interaction":
            return 200, self.interaction(body or {})
        return 404, {"error": f"no route {method} {route}"}

    def handle(self, method: str, path: str, body: Optional[dict],
               traceparent: Optional[str] = None) -> Tuple[int, dict]:
        """(status, payload) for one request (``/metrics`` is served by the
        adapter directly).  ``traceparent`` is the caller's propagated
        context: a sampled one makes this request and its batcher and
        engine hops children of the caller's span; without one the
        server's own sampler may start a root."""
        url = urlparse(path)
        route = url.path.rstrip("/") or "/"
        query = parse_qs(url.query)
        incoming = TraceContext.from_header(traceparent)
        ctx = incoming.child() if incoming is not None else (
            self.sampler.maybe_new_trace() if self.sampler is not None else None
        )
        t0 = time.monotonic()
        status = 500
        hops: Dict[str, float] = {}
        try:
            with tracecontext.use(ctx), flight_mod.collect_hops() as hops:
                with ambient_span("serve_request", route=route) as span:
                    status, doc = self._dispatch(method, route, query, body)
                    span["status"] = status
            return status, doc
        except ApiError as e:
            self.metrics.counter(f"serve_http_{e.status}_total").inc()
            status = e.status
            return e.status, {"error": str(e)}
        except Exception as e:  # route crash -> 500, server stays up
            self.metrics.counter("serve_http_500_total").inc()
            status = 500
            return 500, {"error": f"internal error: {e!r}"}
        finally:
            dur = time.monotonic() - t0
            self.metrics.histogram("serve_handle_seconds").observe(dur)
            self.metrics.histogram(
                "serve_route_seconds", buckets=_ROUTE_BUCKETS,
                labels={"route": _route_label(route)},
            ).observe(dur)
            burst = self.flight.record(
                route, status, dur,
                trace_id=ctx.trace_id if ctx is not None else None, hops=hops,
            )
            if burst and self.flight_dir:
                try:
                    self.flight.dump(self.flight_dir, "5xx-burst")
                except OSError:
                    pass  # a full disk must not take the handler down


#: pre-encoded front-end bodies (the event loop never runs json.dumps)
_POOL_FULL_BODY = b'{"error": "handler pool saturated; shed load"}'
_DEADLINE_BODY = b'{"error": "request deadline exceeded"}'

#: sentinel: the fast path punts this request to the full pipeline
_SLOW_PATH = object()


class ServeAdapter:
    """The event-loop handler for one :class:`ServeApp`.  The hot read
    path (``GET /v1/similar``) is answered inline from the response-bytes
    cache or coalesced onto one batcher ticket; everything else runs
    :meth:`ServeApp.handle` on the bounded worker pool."""

    def __init__(self, app: ServeApp):
        self.app = app
        self.pool = HandlerPool(app.config.http_workers, _HTTP_QUEUE, name="serve-http")
        self._queue_full_body = (
            b'{"error": "queue full (%d waiting requests)"}' % app.config.max_queue
        )

    def close(self) -> None:
        self.pool.stop()

    def _account(self, route: str, status: int, dur: float) -> None:
        app = self.app
        app.metrics.histogram("serve_handle_seconds").observe(dur)
        app.metrics.histogram(
            "serve_route_seconds", buckets=_ROUTE_BUCKETS,
            labels={"route": _route_label(route)},
        ).observe(dur)
        if status >= 400:
            app.metrics.counter(f"serve_http_{status}_total").inc()
        if app.flight.record(route, status, dur) and app.flight_dir:
            # dump on a pool worker: this runs on the loop thread for the
            # fast path, and a 5xx burst is the worst moment to stall the
            # loop behind file I/O.  Dropped when the pool is saturated;
            # the burst window re-arms and the next 5xx dumps
            self.pool.submit(self._dump_flight)

    def _dump_flight(self) -> None:
        app = self.app
        try:
            app.flight.dump(app.flight_dir, "5xx-burst")
        except OSError:
            pass

    def account_protocol_error(self, status: int) -> None:
        """Loop-generated 400/408 responses keep their counters."""
        self.app.metrics.counter(f"serve_http_{status}_total").inc()

    # -- entry point (loop thread) ----------------------------------------

    def __call__(self, req: HTTPRequest, peer: ConnHandle) -> Optional[Response]:
        # an injected fault is decided on the pool and a traced request
        # needs the full pipeline's spans, so the fast path stands aside
        app = self.app
        if (req.method == "GET" and app.faults is None and app.sampler is None
                and "traceparent" not in req.headers
                and req.target.startswith("/v1/similar?")):
            out = self._similar_get_fast(req.target[len("/v1/similar?"):], peer)
            if out is not _SLOW_PATH:
                return out
        if not self.pool.submit(lambda: self._run_full(req, peer)):
            app.metrics.counter("serve_http_429_total").inc()
            return Response(429, _POOL_FULL_BODY)
        return None

    # -- the full pipeline (worker pool thread) ----------------------------

    def _run_full(self, req: HTTPRequest, peer: ConnHandle) -> None:
        app = self.app
        route = urlparse(req.target).path.rstrip("/") or "/"
        if app.faults is not None and self._apply_fault(peer, route):
            return
        if req.method == "GET" and route == "/metrics":
            app.publish_engine_metrics()
            peer.respond(Response(200, app.metrics.prometheus_text().encode("utf-8"),
                                  b"text/plain; version=0.0.4"))
            return
        if req.method == "GET" and route == "/debug/flight":
            # the SIGQUIT dump over the wire: the incident manager asks
            # every live replica for its ring when a rule fires; needs no
            # model, so a replica that is not ready still testifies
            peer.respond(Response(
                200, json.dumps(app.flight.snapshot_doc("debug")).encode("utf-8"),
            ))
            return
        if req.method not in ("GET", "POST"):
            peer.respond(Response(
                404, json.dumps({"error": f"no route {req.method} {route}"}).encode("utf-8"),
            ))
            return
        body: Optional[dict] = None
        if req.method == "POST":
            body, err = parse_json_body(req)
            if err is not None:
                peer.respond(err)
                return
        status, doc = app.handle(req.method, req.target, body,
                                 traceparent=req.headers.get("traceparent"))
        peer.respond(Response(status, json.dumps(doc).encode("utf-8")))

    def _apply_fault(self, peer: ConnHandle, route: str) -> bool:
        """The reference's fault hook: True when the fault ended the
        request.  Runs on a pool thread, so the delay and blackhole sleeps
        never touch the event loop."""
        decision = self.app.faults.decide(route)
        if decision is None:
            return False
        if decision.delay_s:
            time.sleep(decision.delay_s)
        if decision.kind is None:
            return False  # pure added latency; proceed normally
        if decision.kind == "error":
            peer.respond(Response(
                int(decision.arg), b'{"error": "injected fault (resilience drill)"}',
                close=True,
            ))
        elif decision.kind == "reset":
            peer.reset()
        elif decision.kind == "blackhole":
            # hold the socket open and answer nothing; the client's read
            # timeout is the only way out (bounded so pool threads drain)
            time.sleep(decision.arg)
            peer.close()
        return True

    # -- the hot read path (loop thread; must never block) -----------------

    def _similar_get_fast(self, query_str: str, peer: ConnHandle):
        """``GET /v1/similar?gene=...&k=...`` without the full pipeline:
        response-bytes cache hit -> reused bytes; miss -> coalesce onto
        one batcher ticket.  Returns ``_SLOW_PATH`` for anything it cannot
        answer with identical semantics (unknown params, bad k, unknown
        gene, no model) so the full pipeline produces its error shapes."""
        app = self.app
        gene: Optional[str] = None
        k = 10
        try:
            for part in query_str.split("&"):
                name, sep, value = part.partition("=")
                if not sep:
                    return _SLOW_PATH
                if name == "gene":
                    gene = unquote_plus(value) if "%" in value or "+" in value else value
                elif name == "k":
                    k = int(value)
                else:
                    return _SLOW_PATH
        except ValueError:
            return _SLOW_PATH
        if gene is None or not 1 <= k <= app.config.max_k:
            return _SLOW_PATH
        registry = app.registry
        if not registry.loaded:
            return _SLOW_PATH
        model = registry.model
        t0 = time.monotonic()
        key = (model.version, gene, k)
        body = app.response_cache.get(key)
        if body is not None:
            app.metrics.counter("serve_response_cache_hits_total").inc()
            self._account("/v1/similar", 200, time.monotonic() - t0)
            return Response(200, body)
        if gene not in model.index:
            return _SLOW_PATH
        deadline = t0 + app.config.timeout_ms / 1000.0
        with app._coalesce_lock:
            waiters = app._coalesce.get(key)
            if waiters is not None:
                # someone is already computing this exact answer
                waiters.append((peer, deadline, t0))
                app.metrics.counter("serve_coalesced_total").inc()
                return None
            app._coalesce[key] = [(peer, deadline, t0)]
        # submit_async calls on_done synchronously on a batcher-LRU hit;
        # that completion is bounced to the worker pool so no response is
        # encoded on the loop thread
        in_submit = [True]

        def done(result, error):
            if in_submit[0]:
                if not self.pool.submit(
                    lambda: self._finish_similar_get(key, model, gene, result, error)
                ):
                    self._fail_coalesced(key, 429, _POOL_FULL_BODY)
                return
            self._finish_similar_get(key, model, gene, result, error)

        try:
            app.batcher.submit_async(
                {"gene": gene, "k": k}, k,
                cache_key=(model.version, "similar", gene, k),
                timeout_s=app.config.timeout_ms / 1000.0,
                on_done=done,
            )
        except (RejectedError, RuntimeError):
            self._fail_coalesced(key, 429, self._queue_full_body)
        in_submit[0] = False
        return None

    def _fail_coalesced(self, key, status: int, body: bytes) -> None:
        app = self.app
        with app._coalesce_lock:
            waiters = app._coalesce.pop(key, [])
        now = time.monotonic()
        for w_peer, _dl, w_t0 in waiters:
            w_peer.respond(Response(status, body))
            self._account("/v1/similar", status, now - w_t0)

    def _finish_similar_get(self, key, model, gene: str, result, error) -> None:
        """Batcher completion: build and cache the response bytes once,
        then answer every coalesced waiter."""
        app = self.app
        with app._coalesce_lock:
            waiters = app._coalesce.pop(key, [])
        now = time.monotonic()
        status = 200
        if error is not None:
            if isinstance(error, DeadlineExceeded):
                status, body = 504, json.dumps({"error": str(error)}).encode("utf-8")
            else:
                status, body = 500, json.dumps(
                    {"error": f"internal error: {error!r}"}
                ).encode("utf-8")
        elif isinstance(result, dict) and "error" in result:
            status, body = 400, json.dumps({"error": result["error"]}).encode("utf-8")
        else:
            doc = {
                "model": app._model_doc(model),
                "results": [{"query": gene, "neighbors": result["neighbors"]}],
            }
            # stamp the iteration the batcher actually computed against
            if result.get("iteration") is not None:
                doc["model"]["iteration"] = result["iteration"]
            body = json.dumps(doc).encode("utf-8")
            app.response_cache.put(key, body)
        for peer, w_deadline, w_t0 in waiters:
            if status == 200 and now > w_deadline:
                app.metrics.counter("serve_deadline_expired_total").inc()
                peer.respond(Response(504, _DEADLINE_BODY))
                self._account("/v1/similar", 504, now - w_t0)
            else:
                peer.respond(Response(status, body))
                self._account("/v1/similar", status, now - w_t0)


def make_server(app: ServeApp, host: str = "127.0.0.1", port: int = 0) -> EventLoopHTTPServer:
    """The event-loop front end bound to (host, port) — port 0 picks an
    ephemeral one (``server.server_address[1]``).  The caller owns the
    serve loop and shutdown order: ``server.shutdown()`` then
    ``app.stop()``."""
    adapter = ServeAdapter(app)
    cfg = app.config
    return EventLoopHTTPServer(
        adapter,
        host,
        port,
        config=EventLoopConfig(
            read_timeout_s=cfg.read_timeout_s,
            idle_timeout_s=cfg.idle_timeout_s,
            max_conn_requests=cfg.max_conn_requests,
            acceptors=cfg.acceptors,
        ),
        on_protocol_error=adapter.account_protocol_error,
    )
