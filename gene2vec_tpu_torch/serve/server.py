"""JSON HTTP API over the registry + engine + batcher stack — the port of
``gene2vec_tpu/serve/server.py``.

Endpoints (all JSON except ``/metrics``):

* ``POST /v1/similar`` — ``{"genes": [...]}`` or ``{"vectors": [[...]]}``
  + ``"k"`` → per-query neighbor lists (gene queries drop the query row
  itself from its own neighbors); ``GET /v1/similar?gene=..&k=..``;
* ``POST /v1/embedding`` — raw embedding rows for named genes;
* ``POST /v1/interaction`` — ``{"pairs": [[gene, gene], ...]}`` → GGIPNN
  softmax scores per pair (head from ``--ggipnn-checkpoint``;
  ``trained_head`` says whether one was loaded);
* ``GET  /v1/genes`` — a slice of the served vocab;
* ``POST /v1/shard/topk|vectors|stage|flip`` — a row-shard replica's
  plane (``ModelRegistry(shard=)``, ``cli.serve --shard-index
  --num-shards``): shard-local top-k with global row ids, owned genes'
  vectors, and the coordinator's stage and flip; 404 on an unsharded
  replica;
* ``GET|POST /v1/jobs[/<id>[/cancel|/artifact]]`` — the batch-job
  surface (``batch/jobs.py``) when the server has a job store
  (``ServeConfig.jobs_dir``, ``cli.serve --jobs-dir``);
* ``/v1/<model>/...`` — in a catalog (``serve/catalog.py``), any of the
  routes above against the named model's own app;
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

Status mapping: queue full or a tenant over its quota → 429, request
deadline → 504, unknown gene or malformed body → 400, no model loaded →
503, a shard asked for another epoch than it serves → 409.

Tenants (``ServeConfig.tenant_rate``, ``cli.serve --tenant-quota``): the
``X-Tenant`` header names the caller; the front end takes a token from
its bucket before anything else runs (``serve/tenancy.py``), answers 429
and counts ``serve_rejected_total{tenant=}`` when it is empty, and the
batcher drains tenants' lanes by their weights.  Tenancy is off by
default, and then the header is ignored.  The front end is the
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

Catalog: a :class:`ServeApp` under a name other than ``"default"``
labels its route and batcher series ``{model=}`` and stamps the name into
every response's ``model`` object; its siblings' table
(``catalog_apps``) routes ``/v1/<name>/*`` to them, and an unknown name
answers 404 before any label is minted.  A single-model server never
takes a model prefix and keeps its responses and series as they were.
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
from gene2vec_tpu_torch.serve.routes import (
    JOBS_ROUTE,
    V1_ROUTES,
    collapse_jobs_route,
    split_model_route,
)
from gene2vec_tpu_torch.serve.tenancy import (
    BATCH_TENANT,
    DEFAULT_BATCH_WEIGHT,
    DEFAULT_TENANT,
    TenantAdmission,
    TenantPolicy,
    sanitize_tenant,
)


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
    # per-tenant token-bucket quota in requests/s (the X-Tenant header;
    # untagged traffic is the "default" tenant); 0 turns tenancy off
    tenant_rate: float = 0.0
    # bucket burst headroom (0 = 2 x tenant_rate)
    tenant_burst: float = 0.0
    # per-tenant overrides, "id:rate[:burst[:weight]]"; the weight is the
    # tenant's share of a contended batch
    tenant_overrides: Tuple[str, ...] = ()
    # batch-job store root (batch/jobs.py); None keeps the /v1/jobs
    # surface absent: no manager, no worker thread
    jobs_dir: Optional[str] = None
    # the batch lane's weighted-fair share against interactive lanes;
    # always wired, so batch work stays background priority with tenancy off
    batch_weight: float = DEFAULT_BATCH_WEIGHT
    # batch pacing (batch/runner.py Pacer): the share of wall time a job
    # may take (1.0 = no idle gap) and the queue fullness above which a
    # chunk yields
    batch_duty: float = 1.0
    batch_guard_max: float = 0.5


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
        model_name: str = "default",
    ):
        self.registry = registry
        self.config = config if config is not None else ServeConfig()
        config = self.config
        #: this app's catalog name; "default" keeps every series label-free
        #: and every response as a single-model server's
        self.model_name = str(model_name)
        self._mlabels = (
            {"model": self.model_name} if self.model_name != "default" else None
        )
        #: name -> sibling ServeApp, set by ModelCatalog so /v1/<name>/*
        #: reaches the named model; None outside a catalog
        self.catalog_apps: Optional[Dict[str, "ServeApp"]] = None
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
            # loaded before the metrics registry was attached (with its
            # {model=} twin under a catalog name)
            registry._gauge_labeled("model_iteration", registry.model.iteration)
            registry._gauge_labeled("model_vocab_size", len(registry.model))
        self.engine = SimilarityEngine(
            max_batch=config.max_batch, index=config.index, nprobe=config.nprobe,
            rescore_mult=config.rescore_mult,
        )
        # None (the default) turns tenancy off: every request is the
        # default tenant and no bucket is ever touched
        tenant_policy = TenantPolicy.from_args(
            config.tenant_rate, config.tenant_burst or None, config.tenant_overrides,
        )
        self.tenants: Optional[TenantAdmission] = (
            TenantAdmission(tenant_policy, metrics=self.metrics)
            if tenant_policy is not None else None
        )
        self.batcher = MicroBatcher(
            self._compute_batch,
            max_batch=config.max_batch,
            max_delay_s=config.max_delay_ms / 1000.0,
            max_queue=config.max_queue,
            cache_size=config.cache_size,
            default_timeout_s=config.timeout_ms / 1000.0,
            metrics=self.metrics,
            tenant_weights=self._tenant_weight,
            labels=self._mlabels,
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
        # the /v1/jobs manager: jobs query THIS app's batcher on the batch
        # tenant lane.  Imported lazily (batch/ imports serve.tenancy)
        self.jobs = None
        if config.jobs_dir:
            from gene2vec_tpu_torch.batch.jobs import JobManager
            from gene2vec_tpu_torch.batch.runner import BatcherBackend, Pacer

            self.jobs = JobManager(
                config.jobs_dir,
                backend_factory=lambda: BatcherBackend(self),
                metrics=self.metrics,
                pacer_factory=lambda backend: Pacer(
                    guard=backend.pressure,
                    guard_max=config.batch_guard_max,
                    duty=config.batch_duty,
                ),
            )

    def _route_labels(self, route: str) -> Dict[str, str]:
        """The per-route latency labels: the canonical route (job
        sub-routes collapse to ``/v1/jobs`` when the job surface is on)
        and, under a catalog name only, ``model=``."""
        if self.jobs is not None:
            route = collapse_jobs_route(route)
            label = route if route in _KNOWN_ROUTES or route == JOBS_ROUTE else "other"
        else:
            label = _route_label(route)
        labels = {"route": label}
        if self._mlabels is not None:
            labels["model"] = self.model_name
        return labels

    def _model_doc(self, model) -> dict:
        """The response's ``model`` object; it carries the catalog name,
        so a client can check which model answered."""
        doc = {"dim": model.dim, "iteration": model.iteration}
        if self.model_name != "default":
            doc["name"] = self.model_name
        return doc

    def _tenant_weight(self, tenant: str) -> float:
        """A tenant's share of a contended batch: ``batch_weight`` for the
        batch lane (tenancy on or off), else its quota's weight (1.0 with
        tenancy off)."""
        if tenant == BATCH_TENANT:
            return self.config.batch_weight
        if self.tenants is not None:
            return self.tenants.weight(tenant)
        return 1.0

    def start(self) -> "ServeApp":
        self.batcher.start()
        if self.jobs is not None:
            self.jobs.start()
        return self

    def stop(self) -> None:
        if self.jobs is not None:
            self.jobs.stop()
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

    def similar(self, body: dict, tenant: str = DEFAULT_TENANT) -> dict:
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
                    q, k, cache_key=cache_key, timeout_s=timeout_s, tenant=tenant,
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

    # -- the shard plane (serve/shardgroup.py scatter-gather) --------------

    def _shard_facts(self, model) -> dict:
        base = int(model.row_base or 0)
        return {
            "index": self.registry.shard[0],
            "num_shards": self.registry.shard[1],
            "rows": [base, base + len(model)],
            "total_rows": model.total_rows,
            "epoch": model.epoch,
            "iteration": model.iteration,
        }

    def _require_shard(self) -> None:
        if self.registry.shard is None:
            raise ApiError(
                404,
                "this replica is not sharded (/v1/shard/* needs "
                "cli.serve --shard-index/--num-shards)",
            )

    def shard_topk(self, body: dict) -> dict:
        """Shard-local top-k over this replica's rows with GLOBAL row ids:
        one leg of the front door's scatter.  ``vectors`` are scored as
        given; ``genes`` must be owned by this shard.  An ``epoch`` in the
        body is the caller's merge target: answering from another epoch is
        refused with 409, so a shard mid-swap never leaks another
        iteration's rows into a merge."""
        self._require_shard()
        model = self._model_or_503()
        # max_k + 1: a front-door gene query fetches k + 1 so dropping the
        # self-hit still leaves k
        k = body.get("k", 10)
        if not isinstance(k, int) or not 1 <= k <= self.config.max_k + 1:
            raise ApiError(400, f"k must be an int in [1, {self.config.max_k + 1}]")
        want_epoch = body.get("epoch")
        if want_epoch is not None and want_epoch != model.epoch:
            raise ApiError(
                409, f"epoch mismatch: serving {model.epoch}, caller wants {want_epoch}"
            )
        vectors = body.get("vectors")
        genes = body.get("genes")
        if (genes is None) == (vectors is None):
            raise ApiError(400, "provide exactly one of 'genes' or 'vectors'")
        queries: List[np.ndarray] = []
        if vectors is not None:
            if not isinstance(vectors, list) or not vectors:
                raise ApiError(400, "'vectors' must be a non-empty list")
            for v in vectors:
                if not isinstance(v, list) or len(v) != model.dim:
                    raise ApiError(400, f"each vector must have dim {model.dim}")
                queries.append(np.asarray(v, dtype=np.float32))
        else:
            if not isinstance(genes, list) or not genes:
                raise ApiError(400, "'genes' must be a non-empty list")
            for g in genes:
                row = model.index.get(g)
                if row is None:
                    raise ApiError(
                        400, f"gene {g!r} is not owned by shard {self.registry.shard[0]}"
                    )
                queries.append(model.emb[row])
        if len(queries) > self.config.max_queries_per_request:
            raise ApiError(
                400, f"at most {self.config.max_queries_per_request} queries per request"
            )
        with ambient_span("shard_topk", n=len(queries), k=k, shard=self.registry.shard[0]):
            scores, rows = self.engine.topk_rows(model, np.stack(queries), k)
        tokens = model.tokens
        base = int(model.row_base or 0)
        return {
            "shard": self._shard_facts(model),
            "results": [
                {
                    "rows": [int(r) for r in row_ids],
                    "scores": [round(float(s), 6) for s in row_scores],
                    "tokens": [tokens[int(r) - base] for r in row_ids],
                }
                for row_scores, row_ids in zip(scores, rows)
            ],
        }

    def shard_vectors(self, body: dict) -> dict:
        """Owned genes' raw vectors: the front door's gene-to-vector step
        before a vector scatter; a gene outside this shard is a routing
        bug (400)."""
        self._require_shard()
        model = self._model_or_503()
        genes = body.get("genes")
        if not isinstance(genes, list) or not genes:
            raise ApiError(400, "'genes' must be a non-empty list")
        vectors = []
        for g in genes:
            row = model.index.get(g)
            if row is None:
                raise ApiError(
                    400, f"gene {g!r} is not owned by shard {self.registry.shard[0]}"
                )
            vectors.append([float(v) for v in model.emb[row]])
        return {"shard": self._shard_facts(model), "vectors": vectors}

    def shard_stage(self, body: dict) -> dict:
        """Load and verify one iteration without serving it; the
        coordinator stages every shard before any flips.  A failure is a
        503, so the coordinator abandons the swap."""
        self._require_shard()
        dim = body.get("dim")
        iteration = body.get("iteration")
        if not isinstance(dim, int) or not isinstance(iteration, int):
            raise ApiError(400, "'dim' and 'iteration' must be ints")
        try:
            staged = self.registry.stage(dim, iteration)
        except Exception as e:
            raise ApiError(503, f"stage of dim={dim} iter={iteration} failed: {e!r}") from e
        return {
            "staged": {
                "dim": staged.dim,
                "iteration": staged.iteration,
                "rows": len(staged),
                "total_rows": staged.total_rows,
            },
        }

    def shard_flip(self, body: dict) -> dict:
        """Swap the staged iteration in under the fleet's epoch token;
        409 when nothing matching is staged (the coordinator re-stages)."""
        self._require_shard()
        epoch = body.get("epoch")
        if not isinstance(epoch, int):
            raise ApiError(400, "'epoch' must be an int")
        try:
            model = self.registry.flip(epoch)
        except RuntimeError as e:
            raise ApiError(409, str(e)) from e
        return {"shard": self._shard_facts(model)}

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
        if self.model_name != "default":
            out["model"]["name"] = self.model_name
        if self.catalog_apps is not None:
            out["catalog"] = sorted(self.catalog_apps)
        out["index"] = self.engine.index_mode
        if self.registry.shard is not None:
            out["shard"] = self._shard_facts(m)
        if self.tenants is not None:
            out["tenancy"] = {
                "default_rate": self.tenants.policy.default.rate,
                "default_burst": self.tenants.policy.default.burst,
                "overrides": sorted(self.tenants.policy.overrides),
            }
        if m.ann is not None:
            out["ann"] = index_stats(m.ann)
        return 200, out

    # -- dispatch ----------------------------------------------------------

    def _dispatch(self, method: str, route: str, query: Dict[str, List[str]],
                  body: Optional[dict], tenant: str = DEFAULT_TENANT) -> Tuple[int, dict]:
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
            return 200, self.similar({"genes": [gene], "k": k}, tenant=tenant)
        if method == "POST" and route == "/v1/similar":
            return 200, self.similar(body or {}, tenant=tenant)
        if method == "POST" and route == "/v1/embedding":
            return 200, self.embedding(body or {})
        if method == "POST" and route == "/v1/interaction":
            return 200, self.interaction(body or {})
        if method == "POST" and route == "/v1/shard/topk":
            return 200, self.shard_topk(body or {})
        if method == "POST" and route == "/v1/shard/vectors":
            return 200, self.shard_vectors(body or {})
        if method == "POST" and route == "/v1/shard/stage":
            return 200, self.shard_stage(body or {})
        if method == "POST" and route == "/v1/shard/flip":
            return 200, self.shard_flip(body or {})
        if self.jobs is not None and (
            route == JOBS_ROUTE or route.startswith(JOBS_ROUTE + "/")
        ):
            from gene2vec_tpu_torch.batch.jobs import dispatch_jobs

            return dispatch_jobs(self.jobs, method, route, query, body)
        return 404, {"error": f"no route {method} {route}"}

    def handle(self, method: str, path: str, body: Optional[dict],
               traceparent: Optional[str] = None,
               tenant: Optional[str] = None) -> Tuple[int, dict]:
        """(status, payload) for one request (``/metrics`` is served by the
        adapter directly).  ``traceparent`` is the caller's propagated
        context: a sampled one makes this request and its batcher and
        engine hops children of the caller's span; without one the
        server's own sampler may start a root.  ``tenant`` is the
        request's admitted tenant id (the adapter takes its token first);
        here it picks the batcher lane."""
        tenant = tenant if tenant else DEFAULT_TENANT
        url = urlparse(path)
        route = url.path.rstrip("/") or "/"
        if self.catalog_apps is not None or self.model_name != "default":
            # catalog dispatch: a sibling serves /v1/<name>/* with its own
            # registry, engine, cache and labels; this app's own name is an
            # alias of its unprefixed routes; an unknown name 404s before
            # any label is minted
            name, canonical = split_model_route(route)
            if name is not None:
                target = self if name == self.model_name else (
                    self.catalog_apps.get(name) if self.catalog_apps is not None else None
                )
                if target is None:
                    self.metrics.counter("serve_http_404_total").inc()
                    return 404, {"error": f"unknown model {name!r}"}
                if target is not self:
                    suffix = f"?{url.query}" if url.query else ""
                    return target.handle(method, canonical + suffix, body,
                                         traceparent=traceparent, tenant=tenant)
                route = canonical
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
                    status, doc = self._dispatch(method, route, query, body, tenant=tenant)
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
                labels=self._route_labels(route),
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
_TENANT_QUOTA_BODY = b'{"error": "tenant quota exhausted; retry after backoff"}'

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

    def _account(self, route: str, status: int, dur: float,
                 app: Optional[ServeApp] = None) -> None:
        app = self.app if app is None else app
        app.metrics.histogram("serve_handle_seconds").observe(dur)
        app.metrics.histogram(
            "serve_route_seconds", buckets=_ROUTE_BUCKETS,
            labels=app._route_labels(route),
        ).observe(dur)
        if status >= 400:
            app.metrics.counter(f"serve_http_{status}_total").inc()
        if app.flight.record(route, status, dur) and app.flight_dir:
            # dump on a pool worker: this runs on the loop thread for the
            # fast path, and a 5xx burst is the worst moment to stall the
            # loop behind file I/O.  Dropped when the pool is saturated;
            # the burst window re-arms and the next 5xx dumps
            self.pool.submit(lambda: self._dump_flight(app))

    def _dump_flight(self, app: ServeApp) -> None:
        try:
            app.flight.dump(app.flight_dir, "5xx-burst")
        except OSError:
            pass

    def account_protocol_error(self, status: int) -> None:
        """Loop-generated 400/408 responses keep their counters."""
        self.app.metrics.counter(f"serve_http_{status}_total").inc()

    # -- entry point (loop thread) ----------------------------------------

    def __call__(self, req: HTTPRequest, peer: ConnHandle) -> Optional[Response]:
        app = self.app
        tenant = DEFAULT_TENANT
        if app.tenants is not None and req.target.startswith("/v1/"):
            # the tenant's quota, decided here on the loop: an over-quota
            # request costs one bucket take and a pre-encoded 429, never a
            # pool slot or a queue place.  The resolved label (bounded:
            # minted ids collapse into "other") keys the batcher lanes
            ok, tenant = app.tenants.admit(sanitize_tenant(req.headers.get("x-tenant")))
            if not ok:
                app.metrics.counter("serve_http_429_total").inc()
                return Response(429, _TENANT_QUOTA_BODY)
        # an injected fault is decided on the pool and a traced request
        # needs the full pipeline's spans, so the fast path stands aside
        if (req.method == "GET" and app.faults is None and app.sampler is None
                and "traceparent" not in req.headers):
            # the app whose hot path this GET is: unprefixed -> this one,
            # /v1/<name>/similar? -> the named catalog sibling (or this app
            # under its own name), each with its own response cache and
            # coalescing table
            fast = None
            query_str = ""
            if req.target.startswith("/v1/similar?"):
                fast, query_str = app, req.target[len("/v1/similar?"):]
            elif (app.catalog_apps is not None or app.model_name != "default") \
                    and req.target.startswith("/v1/"):
                name, sep, tail = req.target[len("/v1/"):].partition("/")
                if sep and tail.startswith("similar?"):
                    fast = (app.catalog_apps.get(name) if app.catalog_apps is not None
                            else (app if name == app.model_name else None))
                    query_str = tail[len("similar?"):]
            if fast is not None:
                out = self._similar_get_fast(fast, query_str, peer, tenant)
                if out is not _SLOW_PATH:
                    return out
        if not self.pool.submit(lambda: self._run_full(req, peer, tenant)):
            app.metrics.counter("serve_http_429_total").inc()
            return Response(429, _POOL_FULL_BODY)
        return None

    # -- the full pipeline (worker pool thread) ----------------------------

    def _run_full(self, req: HTTPRequest, peer: ConnHandle,
                  tenant: str = DEFAULT_TENANT) -> None:
        app = self.app
        route = urlparse(req.target).path.rstrip("/") or "/"
        if app.faults is not None and self._apply_fault(peer, route):
            return
        if req.method == "GET" and route == "/metrics":
            app.publish_engine_metrics()
            if app.catalog_apps is not None:
                # one scrape refreshes every model's gauges (one registry)
                for sibling in app.catalog_apps.values():
                    if sibling is not app:
                        sibling.publish_engine_metrics()
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
                                 traceparent=req.headers.get("traceparent"), tenant=tenant)
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

    def _similar_get_fast(self, app: ServeApp, query_str: str, peer: ConnHandle,
                          tenant: str = DEFAULT_TENANT):
        """``GET /v1/similar?gene=...&k=...`` without the full pipeline:
        response-bytes cache hit -> reused bytes; miss -> coalesce onto
        one batcher ticket.  ``app`` is the resolved target (this app or a
        catalog sibling).  Returns ``_SLOW_PATH`` for anything it cannot
        answer with identical semantics (unknown params, bad k, unknown
        gene, no model) so the full pipeline produces its error shapes."""
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
            self._account("/v1/similar", 200, time.monotonic() - t0, app=app)
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
                    lambda: self._finish_similar_get(app, key, model, gene, result, error)
                ):
                    self._fail_coalesced(app, key, 429, _POOL_FULL_BODY)
                return
            self._finish_similar_get(app, key, model, gene, result, error)

        try:
            app.batcher.submit_async(
                {"gene": gene, "k": k}, k,
                cache_key=(model.version, "similar", gene, k),
                timeout_s=app.config.timeout_ms / 1000.0,
                on_done=done, tenant=tenant,
            )
        except (RejectedError, RuntimeError):
            self._fail_coalesced(app, key, 429, self._queue_full_body)
        in_submit[0] = False
        return None

    def _fail_coalesced(self, app: ServeApp, key, status: int, body: bytes) -> None:
        with app._coalesce_lock:
            waiters = app._coalesce.pop(key, [])
        now = time.monotonic()
        for w_peer, _dl, w_t0 in waiters:
            w_peer.respond(Response(status, body))
            self._account("/v1/similar", status, now - w_t0, app=app)

    def _finish_similar_get(self, app: ServeApp, key, model, gene: str,
                            result, error) -> None:
        """Batcher completion: build and cache the response bytes once,
        then answer every coalesced waiter."""
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
                self._account("/v1/similar", 504, now - w_t0, app=app)
            else:
                peer.respond(Response(status, body))
                self._account("/v1/similar", status, now - w_t0, app=app)


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
