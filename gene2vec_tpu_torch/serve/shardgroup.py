"""Fleet-sharded index serving: scatter-gather top-k over row shards —
the port of ``gene2vec_tpu/serve/shardgroup.py``.

``cli.fleet --shard-by-rows N`` gives each replica a CONTIGUOUS row
range of the table (``serve/registry.py`` loads only that slice and
indexes it alone), and this module is the front door's half:

* :class:`RoutingTable` — gene → shard routing from the export manifest:
  the newest verified checkpoint's vocab order is the global row order,
  and ``parallel/sharding.py:shard_ranges`` maps rows to shards.  The
  front door answers ``/v1/genes`` from it and sends a gene's vector
  lookup to its owner.  One immutable snapshot is swapped by reference.
* :class:`ShardGroup` — scatter-gather ``/v1/similar``: each query goes to
  every shard under a PER-SHARD deadline through per-shard
  :class:`~gene2vec_tpu_torch.serve.client.ResilientClient` instances
  (per-replica breakers, ONE shared retry budget, so a dead shard cannot
  multiply attempts), and the shard-local top-k sets merge with
  ``merge_shard_topk``.  With ``--replicas-per-shard R`` a shard is a
  replica group: a leg fails over between siblings within its deadline,
  so one replica's death degrades no answer.  Cross-shard
  ``/v1/interaction`` resolves each gene's vector from its owner and
  scores at the front door (``serve/interaction.py:CrossShardScorer``,
  built at the first pair, on the card unless ``scorer_device="cpu"``).

  The degraded contract: a shard that is dead or misses its deadline
  gives a partial answer with ``degraded: true`` and
  ``shards.answered/total`` — never a 5xx, never a silently complete
  answer; 503 only when no shard answers.  Answers merge only from
  shards reporting one epoch: a mixed gather is re-scattered once pinned
  to the majority epoch, and laggards count as unanswered.
* :class:`SwapCoordinator` — the shard-atomic hot swap.  Shard replicas
  never swap on their own; the coordinator polls the export dir and, for
  a new verified iteration, STAGES it on every live (shard, replica) cell
  (``POST /v1/shard/stage``), then FLIPS them all under one epoch token
  (``POST /v1/shard/flip``; the token is the iteration).  No cell flips
  unless every cell staged; a swap is deferred while a whole shard group
  is down, and a cell that restarts is repaired on the next tick.

Everything here runs in the front-door process and is stdlib and numpy
only; the tables live in the shard replicas on the card.
"""

from __future__ import annotations

import dataclasses
import json
import os
import threading
import time
import urllib.request
from typing import Callable, Dict, List, Optional, Sequence, Tuple, Union

import numpy as np

from gene2vec_tpu_torch.obs import tracecontext
from gene2vec_tpu_torch.obs.trace import ambient_span
from gene2vec_tpu_torch.parallel.sharding import merge_shard_topk, shard_ranges
from gene2vec_tpu_torch.serve.batcher import LRUCache
from gene2vec_tpu_torch.serve.client import (
    InFlightTracker,
    ResilientClient,
    RetryPolicy,
    TokenBucket,
)


#: ambient per-thread extras attached to every scatter leg issued
#: while set — the trace-context pattern, applied to headers: a caller
#: tags its legs (say ``X-Tenant``) without a header argument threaded
#: through every verb of the scatter.
_SCATTER_HEADERS = threading.local()


class scatter_headers:
    """Context manager installing ambient headers for scatter legs
    issued on this thread (legs fork worker threads, but ``_scatter``
    captures the headers before forking)."""

    def __init__(self, headers: Optional[Dict[str, str]]):
        self._headers = headers

    def __enter__(self):
        self._prev = getattr(_SCATTER_HEADERS, "value", None)
        _SCATTER_HEADERS.value = self._headers
        return self

    def __exit__(self, *exc):
        _SCATTER_HEADERS.value = self._prev
        return False


@dataclasses.dataclass(frozen=True)
class ShardGroupConfig:
    """Scatter policy knobs (cli/fleet.py flags)."""

    num_shards: int = 2
    #: per-shard scatter-leg deadline: a slow shard costs at most this
    #: much of the request before the merge proceeds without it
    shard_deadline_s: float = 2.0
    #: default whole-request budget when the body carries no timeout_ms
    default_timeout_s: float = 5.0
    max_k: int = 256
    max_queries_per_request: int = 64
    #: bounded gene→unit-vector cache (keyed by epoch): a hot query
    #: gene resolves once per epoch, and a gene whose OWNER shard died
    #: still answers from cache instead of failing
    qvec_cache_size: int = 4096
    #: re-scatter once when a gather observes mixed epochs
    rescatter_on_mixed_epoch: bool = True


@dataclasses.dataclass(frozen=True)
class _RoutingSnapshot:
    """One immutable routing state — swapped by a single reference
    assignment like the registry's LoadedModel, so a reader can never
    observe a new index paired with old ranges mid-reload."""

    dim: Optional[int]
    iteration: Optional[int]
    tokens: Tuple[str, ...]
    index: Dict[str, int]
    ranges: List[Tuple[int, int]]


_EMPTY_ROUTING = _RoutingSnapshot(None, None, (), {}, [])


class RoutingTable:
    """gene → global row → owning shard, derived from the export
    manifest: the newest verified checkpoint's vocab order is the
    global row order (``serve/registry.py`` slices the same order), so
    the front door can route without ever loading the table itself."""

    def __init__(self, export_dir: str, num_shards: int,
                 dim: Optional[int] = None):
        self.export_dir = export_dir
        self.num_shards = int(num_shards)
        self.dim_filter = dim
        self._snap: _RoutingSnapshot = _EMPTY_ROUTING

    def reload(self) -> bool:
        """Re-derive the table from the newest verified checkpoint.
        Returns whether anything loadable was found; reload failures
        keep the previous table (the front door must not lose routing
        because one poll raced an export)."""
        from gene2vec_tpu_torch.serve.registry import discover_newest

        newest = discover_newest(self.export_dir, self.dim_filter)
        if newest is None:
            return False
        dim, iteration, path = newest
        snap = self._snap
        if (dim, iteration) == (snap.dim, snap.iteration):
            return True
        try:
            tokens = self._read_tokens(path)
        except (OSError, ValueError):
            return False
        # one reference assignment IS the swap (the registry lesson)
        self._snap = _RoutingSnapshot(
            dim=dim,
            iteration=iteration,
            tokens=tuple(tokens),
            index={tok: i for i, tok in enumerate(tokens)},
            ranges=shard_ranges(len(tokens), self.num_shards),
        )
        return True

    # readers go through ONE snapshot reference; the properties keep
    # the attribute-style surface tests and cli.fleet use
    @property
    def dim(self) -> Optional[int]:
        return self._snap.dim

    @property
    def iteration(self) -> Optional[int]:
        return self._snap.iteration

    @property
    def tokens(self) -> Tuple[str, ...]:
        return self._snap.tokens

    @property
    def index(self) -> Dict[str, int]:
        return self._snap.index

    @property
    def ranges(self) -> List[Tuple[int, int]]:
        return self._snap.ranges

    @staticmethod
    def _read_tokens(ckpt_path: str) -> List[str]:
        if ckpt_path.endswith(".npz"):
            # sidecar-aware: a vocab-tail-extended iteration routes by
            # ITS vocab, not the dir's frozen vocab.tsv
            # (io/checkpoint.py vocab_path_for)
            from gene2vec_tpu_torch.io.checkpoint import vocab_path_for

            vocab_path = vocab_path_for(ckpt_path)
            tokens: List[str] = []
            with open(vocab_path, "r", encoding="utf-8") as f:
                for line in f:
                    line = line.rstrip("\n")
                    if line:
                        tokens.append(line.split("\t")[0])
            return tokens
        from gene2vec_tpu_torch.io.emb_io import read_word2vec_format

        tokens, _ = read_word2vec_format(ckpt_path)
        return list(tokens)

    @property
    def total_rows(self) -> int:
        return len(self._snap.tokens)

    def owner(self, gene: str) -> Optional[int]:
        """Owning shard index, or None for an unknown gene.  Reads
        ONE snapshot: the row and the ranges it is checked against
        always belong to the same reload."""
        snap = self._snap
        row = snap.index.get(gene)
        if row is None:
            return None
        for i, (start, end) in enumerate(snap.ranges):
            if start <= row < end:
                return i
        return None  # pragma: no cover - ranges always cover the vocab

    def genes_doc(self, limit: int, offset: int) -> dict:
        snap = self._snap
        return {
            "total": len(snap.tokens),
            "genes": list(snap.tokens[offset:offset + limit]),
        }


class ApiReject(Exception):
    """Scatter-level request failure with an HTTP status (the shard
    group's analogue of server.ApiError, kept import-light)."""

    def __init__(self, status: int, message: str):
        super().__init__(message)
        self.status = status


class ShardGroup:
    """The front door's scatter-gather engine over N shard replica
    GROUPS.

    ``url_for(i)`` returns shard *i*'s current live base URL(s): a
    list (the replica group — ``cli.fleet`` wires the supervisor's UP
    slots of that shard in), a single URL, or None while the whole
    group is down.  Each shard's :class:`ResilientClient` round-robins
    the group and FAILS OVER between siblings within the leg's
    deadline (retry-safe failover + per-replica breakers), so a single
    replica death produces zero degraded answers — the shard counts as
    unanswered only when no sibling can answer in time.
    All per-shard clients share ONE retry token bucket and the proxy's
    :class:`InFlightTracker`, so the drain contract and the retry-
    amplification bound both hold across the fan-out."""

    def __init__(
        self,
        config: ShardGroupConfig,
        url_for: Callable[[int], Union[Optional[str], Sequence[str]]],
        metrics=None,
        policy: Optional[RetryPolicy] = None,
        inflight: Optional[InFlightTracker] = None,
        routing: Optional[RoutingTable] = None,
        transport: Optional[Callable] = None,
        ggipnn_checkpoint: Optional[str] = None,
        scorer_device=None,
    ):
        self.config = config
        self.url_for = url_for
        self.metrics = metrics
        self.routing = routing
        self.policy = policy if policy is not None else RetryPolicy(
            max_attempts=2,
            connect_timeout_s=1.0,
            default_timeout_s=config.shard_deadline_s,
        )
        #: ONE budget across the whole fan-out (the amplification
        #: contract): every shard's retries draw it down together
        self.budget = TokenBucket(
            self.policy.retry_budget_ratio,
            self.policy.retry_budget_burst,
        )
        self.inflight = inflight
        self._transport = transport
        self._clients: Dict[int, ResilientClient] = {}
        self._clients_lock = threading.Lock()
        #: last epoch each shard was SEEN serving (scatter answers +
        #: coordinator probes feed this; /healthz renders it)
        self._epochs: Dict[int, Optional[int]] = {}
        #: last epoch each replica CELL (by URL) was seen serving —
        #: scatter answers carry the answering target, the swap
        #: coordinator probes every cell; /healthz renders the grid.
        #: BOUNDED (LRU): every respawn binds a fresh ephemeral port,
        #: so a plain dict keyed by URL would leak one entry per
        #: restart for the front door's whole lifetime
        self._replica_epochs = LRUCache(256)
        #: the fleet's current logical version (the coordinator owns
        #: writes; None until the first tick adopts the boot state)
        self.current_epoch: Optional[int] = None
        # gene → raw query vector, keyed (epoch, gene) — the epoch in
        # the key is load-bearing: a cached iteration-1 vector scored
        # against iteration-2 shards would be a wrong answer the epoch
        # check cannot see.  Reuses the batcher's bounded LRU.
        self._qvecs = LRUCache(config.qvec_cache_size)
        #: models/ggipnn_obs head checkpoint backing cross-shard
        #: /v1/interaction (cli.fleet --ggipnn-checkpoint); without it
        #: the head keeps its deterministic random init and
        #: ``trained_head`` is echoed false, like a replica's scorer
        self.ggipnn_checkpoint = ggipnn_checkpoint
        #: where the front-door scorer runs (``cuda`` unless "cpu"; the
        #: cli.fleet --device flag)
        self.scorer_device = scorer_device
        self._interaction_scorer = None
        self._scorer_lock = threading.Lock()

    # -- plumbing ----------------------------------------------------------

    def urls_of(self, shard: int) -> List[str]:
        """Shard *i*'s live replica group, normalized to a list
        (``url_for`` may return a list, one URL, or None)."""
        u = self.url_for(shard)
        if u is None:
            return []
        if isinstance(u, str):
            return [u]
        return [x for x in u if x]

    def client(self, shard: int) -> ResilientClient:
        with self._clients_lock:
            c = self._clients.get(shard)
            if c is None:
                kwargs = {}
                if self._transport is not None:
                    kwargs["transport"] = self._transport
                c = ResilientClient(
                    lambda s=shard: self.urls_of(s),
                    policy=self.policy,
                    metrics=self.metrics,
                    inflight=self.inflight,
                    budget=self.budget,
                    **kwargs,
                )
                self._clients[shard] = c
            return c

    def _count(self, name: str, amount: int = 1) -> None:
        if self.metrics is not None:
            self.metrics.counter(name).inc(amount)

    def note_epoch(self, shard: int, epoch,
                   url: Optional[str] = None) -> None:
        self._epochs[shard] = epoch
        if url is not None:
            self._replica_epochs.put(url.rstrip("/"), epoch)

    def replica_epoch(self, url: Optional[str]):
        """Last epoch one replica cell was seen serving (None before
        any scatter answer or coordinator probe touched it)."""
        if url is None:
            return None
        return self._replica_epochs.get(url.rstrip("/"))

    def shard_states(
        self,
        up_for: Optional[Callable[[int], bool]] = None,
        replicas_for: Optional[Callable[[int], List[dict]]] = None,
    ) -> List[dict]:
        """Per-shard facts for the front door's /healthz: row range,
        rotation state, last-seen epoch — plus the replica GROUP
        (``replicas: [{index, up, epoch}]``) when the caller can
        enumerate it (the proxy passes the supervisor's grid)."""
        ranges = self.routing.ranges if self.routing is not None else []
        out = []
        for i in range(self.config.num_shards):
            urls = self.urls_of(i)
            doc = {
                "index": i,
                "rows": list(ranges[i]) if i < len(ranges) else None,
                "up": bool(up_for(i)) if up_for is not None else (
                    bool(urls)
                ),
                "epoch": self._epochs.get(i),
                "url": urls[0] if urls else None,
            }
            if replicas_for is not None:
                doc["replicas"] = replicas_for(i)
            out.append(doc)
        return out

    # -- the scatter -------------------------------------------------------

    def _scatter(
        self,
        path: str,
        bodies: Dict[int, dict],
        deadline: float,
    ) -> Dict[int, dict]:
        """POST ``bodies[shard]`` to each listed shard concurrently
        under the per-shard deadline (capped by the request's overall
        remaining budget).  Returns shard → parsed 2xx doc; a shard
        that fails, 409s, or times out simply has no entry — the
        caller degrades."""
        # captured on the CALLER's thread before the legs fork, so the
        # ambient batch-tenant tag rides into every sub-request
        extra_headers = getattr(_SCATTER_HEADERS, "value", None)
        results: Dict[int, dict] = {}
        lock = threading.Lock()
        # the scatter runs on fresh threads: carry the caller's ambient
        # trace context over explicitly, so every shard leg's
        # client_attempt shows up as a SIBLING child span under the one
        # proxy_scatter span (cli.obs trace renders the fan-out)
        ctx = tracecontext.current()

        def leg(shard: int, body: dict) -> None:
            remaining = deadline - time.monotonic()
            if remaining <= 0:
                self._count("fleet_shard_leg_deadline_total")
                return
            with tracecontext.use(ctx):
                r = self.client(shard).request(
                    path, body,
                    timeout_s=min(
                        self.config.shard_deadline_s, remaining
                    ),
                    headers=extra_headers,
                )
            if r.error_class == "deadline":
                self._count("fleet_shard_leg_deadline_total")
            if r.ok:
                doc = r.doc
                if isinstance(doc, dict):
                    epoch = (doc.get("shard") or {}).get("epoch")
                    self.note_epoch(shard, epoch, url=r.target)
                    with lock:
                        results[shard] = doc

        threads = [
            threading.Thread(
                target=leg, args=(shard, body), daemon=True,
                name=f"scatter-shard-{shard}",
            )
            for shard, body in bodies.items()
        ]
        for t in threads:
            t.start()
        join_deadline = deadline + 1.0
        for t in threads:
            t.join(timeout=max(0.0, join_deadline - time.monotonic()))
        return results

    def _drop_malformed(self, answers: Dict[int, dict],
                        n_queries: int) -> Dict[int, dict]:
        """Filter 2xx legs whose result shape cannot be merged (wrong
        result count, scores/rows length mismatch — a version-skewed
        or buggy shard).  Dropping them HERE, before the degraded flag
        and ``shards.answered`` are computed, keeps the contract
        honest: a lost leg is a *visible* partial answer, never a
        silently complete one."""
        out: Dict[int, dict] = {}
        for s, doc in answers.items():
            res = doc.get("results")
            ok = isinstance(res, list) and len(res) == n_queries
            if ok:
                lens = set()
                for r in res:
                    rows = r.get("rows")
                    scores = r.get("scores")
                    if not (
                        isinstance(rows, list)
                        and isinstance(scores, list)
                        and len(rows) == len(scores)
                    ):
                        ok = False
                        break
                    lens.add(len(rows))
                # ragged per-query candidate counts cannot stack into
                # the (Q, lk) matrices the merge concatenates
                ok = ok and len(lens) <= 1
            if ok:
                out[s] = doc
            else:
                self._count("fleet_shard_malformed_total")
        return out

    # -- gene → vector resolution ------------------------------------------

    def _resolve_vectors(
        self, genes: Sequence[str], deadline: float,
        epoch_hint,
    ) -> Tuple[List[Optional[List[float]]], List, bool]:
        """Query vectors for gene queries: qvec cache (keyed by
        ``epoch_hint``) first, then one ``/v1/shard/vectors`` round to
        each owning shard.  Returns (vectors, per-query resolution
        epochs, any-unresolved): the caller fences the SCATTER against the
        resolution epochs — a swap landing between resolution and
        scatter must not score an old iteration's query vector against
        new tables.  A gene whose owner is unreachable resolves to None
        (the caller emits an empty, degraded result for it); an unknown
        gene raises 400 — exactly the single-replica error shape."""
        routing = self.routing
        assert routing is not None
        out: List[Optional[List[float]]] = [None] * len(genes)
        epochs: List[Optional[int]] = [None] * len(genes)
        by_owner: Dict[int, List[int]] = {}
        for qi, gene in enumerate(genes):
            owner = routing.owner(gene)
            if owner is None:
                raise ApiReject(
                    400,
                    f"unknown gene(s) [{gene!r}] (model iteration "
                    f"{routing.iteration})",
                )
            cached = self._qvecs.get((epoch_hint, gene))
            if cached is not None:
                out[qi] = cached
                epochs[qi] = epoch_hint
                self._count("fleet_qvec_cache_hits_total")
            else:
                by_owner.setdefault(owner, []).append(qi)
        degraded = False
        if by_owner:
            bodies = {
                owner: {"genes": [genes[qi] for qi in qis]}
                for owner, qis in by_owner.items()
            }
            answers = self._scatter("/v1/shard/vectors", bodies, deadline)
            for owner, qis in by_owner.items():
                doc = answers.get(owner)
                vectors = (doc or {}).get("vectors")
                if not isinstance(vectors, list) or (
                    len(vectors) != len(qis)
                ):
                    # owner dead/slow and no cache: these queries stay
                    # unresolved — degraded, never a 5xx
                    degraded = True
                    self._count(
                        "fleet_qvec_unresolved_total", len(qis)
                    )
                    continue
                resolved_epoch = (doc.get("shard") or {}).get("epoch")
                for qi, vec in zip(qis, vectors):
                    out[qi] = vec
                    epochs[qi] = resolved_epoch
                    self._qvecs.put((resolved_epoch, genes[qi]), vec)
        return out, epochs, degraded

    # -- the public entry points -------------------------------------------

    def similar(self, body: dict) -> Tuple[int, dict]:
        """Scatter-gather ``/v1/similar``: same request/response schema
        as a single replica, plus the degradation facts (``degraded``,
        ``shards``).  Returns ``(status, doc)``; client errors are 400,
        an all-shards-dead scatter is the one non-partial case and
        returns 503."""
        try:
            return self._similar(body)
        except ApiReject as e:
            self._count(f"fleet_http_{e.status}_total")
            return e.status, {"error": str(e)}

    def _validate(self, body: dict):
        k = body.get("k", 10)
        if not isinstance(k, int) or k < 1 or k > self.config.max_k:
            raise ApiReject(
                400, f"k must be an int in [1, {self.config.max_k}]"
            )
        genes = body.get("genes")
        vectors = body.get("vectors")
        if (genes is None) == (vectors is None):
            raise ApiReject(
                400, "provide exactly one of 'genes' or 'vectors'"
            )
        queries = genes if genes is not None else vectors
        if not isinstance(queries, list) or not queries:
            raise ApiReject(
                400,
                "'genes' must be a non-empty list" if genes is not None
                else "'vectors' must be a non-empty list",
            )
        if len(queries) > self.config.max_queries_per_request:
            raise ApiReject(
                400,
                f"at most {self.config.max_queries_per_request} "
                "queries per request",
            )
        timeout = body.get("timeout_ms")
        if timeout is not None and (
            not isinstance(timeout, (int, float)) or timeout <= 0
        ):
            raise ApiReject(400, "timeout_ms must be a positive number")
        dim = self.routing.dim if self.routing is not None else None
        if genes is None and dim is not None:
            for v in vectors:
                if not isinstance(v, list) or len(v) != dim:
                    raise ApiReject(
                        400, f"each vector must have dim {dim}"
                    )
        return genes, vectors, k, (
            float(timeout) / 1000.0 if timeout is not None
            else self.config.default_timeout_s
        )

    def _similar(self, body: dict) -> Tuple[int, dict]:
        genes, vectors, k, timeout_s = self._validate(body)
        deadline = time.monotonic() + timeout_s
        n_shards = self.config.num_shards
        self._count("fleet_scatter_requests_total")

        # TWO epoch fences guard a swap racing this request: (1) the
        # gather merges only shards reporting one epoch (mixed gather →
        # one re-scatter pinned to the newest); (2) gene queries whose
        # VECTOR was resolved under a different epoch than the gather's
        # are retried once against the new epoch and, if still racing,
        # dropped to unresolved — an old iteration's query vector must
        # never be scored against new tables and labeled as new.
        degraded = False
        unresolved = False
        answers: Dict[int, dict] = {}
        qvecs: List[Optional[List[float]]] = []
        res_epochs: List[Optional[int]] = []
        merged_epoch = None
        epoch_hint = self.current_epoch
        for fence_try in (0, 1):
            if genes is not None:
                qvecs, res_epochs, unresolved = self._resolve_vectors(
                    genes, deadline, epoch_hint
                )
                # gene queries ask one extra so dropping the self-hit
                # still leaves k neighbors (the single-replica contract)
                k_fetch = k + 1
            else:
                qvecs = [list(map(float, v)) for v in vectors]
                res_epochs = [None] * len(qvecs)
                k_fetch = k
            live_idx = [
                qi for qi, v in enumerate(qvecs) if v is not None
            ]
            answers = {}
            if live_idx:
                scatter_body = {
                    "vectors": [qvecs[qi] for qi in live_idx],
                    "k": k_fetch,
                }
                # the scatter gets its OWN child trace context: the
                # proxy_scatter span becomes a distinct node in the
                # cross-process tree, and every shard leg's
                # client_attempt parents to it as a sibling — cli.obs
                # trace renders the fan-out instead of flattening it
                # into the request span
                cur_ctx = tracecontext.current()
                scatter_ctx = (
                    cur_ctx.child() if cur_ctx is not None else None
                )
                with tracecontext.use(
                    scatter_ctx if scatter_ctx is not None else cur_ctx
                ), ambient_span(
                    "proxy_scatter", shards=n_shards,
                    queries=len(live_idx), k=k,
                ) as span:
                    bodies = {
                        i: scatter_body for i in range(n_shards)
                    }
                    answers = self._drop_malformed(
                        self._scatter(
                            "/v1/shard/topk", bodies, deadline
                        ),
                        len(live_idx),
                    )
                    epochs = {
                        (d.get("shard") or {}).get("epoch")
                        for d in answers.values()
                    }
                    if len(epochs) > 1:
                        # mixed epochs observed: a swap is in flight.
                        # Re-scatter ONCE pinned to the MAJORITY epoch
                        # (ties toward the newer one) and merge only
                        # matching answers — majority, not max: one
                        # restarted shard that self-loaded a brand-new
                        # export must degrade the fleet by 1/N, not
                        # collapse every answer to its lone shard for
                        # the whole staging window.
                        self._count("fleet_mixed_epoch_scatters_total")
                        votes: Dict = {}
                        for d in answers.values():
                            e = (d.get("shard") or {}).get("epoch")
                            if e is not None:
                                votes[e] = votes.get(e, 0) + 1
                        target = max(
                            votes.items(), key=lambda kv: (kv[1], kv[0])
                        )[0] if votes else None
                        if self.config.rescatter_on_mixed_epoch:
                            self._count(
                                "fleet_mixed_epoch_rescatter_total"
                            )
                            pinned = dict(scatter_body, epoch=target)
                            answers = self._drop_malformed(
                                self._scatter(
                                    "/v1/shard/topk",
                                    {i: pinned
                                     for i in range(n_shards)},
                                    deadline,
                                ),
                                len(live_idx),
                            )
                        answers = {
                            s: d for s, d in answers.items()
                            if (d.get("shard") or {}).get("epoch")
                            == target
                        }
                    span["shards_answered"] = len(answers)
            merged_epoch = next(
                ((d.get("shard") or {}).get("epoch")
                 for d in answers.values()), None,
            )
            if (
                genes is not None and answers and fence_try == 0
                and any(
                    e is not None and e != merged_epoch
                    for e in res_epochs
                )
            ):
                # the resolution/scatter epoch race: retry once with
                # the gather's epoch as the cache hint — the owners
                # have flipped by now and re-resolve consistently
                self._count("fleet_epoch_race_retries_total")
                epoch_hint = merged_epoch
                continue
            break
        stale_qis = set()
        if genes is not None:
            for qi, e in enumerate(res_epochs):
                if (
                    qvecs[qi] is not None and e is not None
                    and e != merged_epoch
                ):
                    # still racing after the retry (a second swap mid-
                    # request): refuse to emit a stale-vector answer —
                    # this query degrades to unresolved instead (the
                    # scatter-time live_idx stays untouched so the
                    # merge's column mapping cannot desync)
                    stale_qis.add(qi)
                    unresolved = True
                    self._count("fleet_qvec_unresolved_total")
        degraded |= unresolved

        if not answers and live_idx:
            # nothing answered at all: not partial, not recoverable —
            # the one case the scatter surfaces as unavailability
            self._count("fleet_scatter_unanswered_total")
            return 503, {
                "error": "no shard answered the scatter",
                "shards": {"total": n_shards, "answered": 0},
            }

        answered = sorted(answers)
        if len(answered) < n_shards:
            degraded = True
            self._count(
                "fleet_shard_unanswered_total",
                n_shards - len(answered),
            )
        epoch = next(
            ((answers[s].get("shard") or {}).get("epoch")
             for s in answered), self.current_epoch,
        )
        # an all-unresolved (empty) answer still declares the logical
        # version the fleet serves: epoch == iteration by convention,
        # so current_epoch is the honest fallback
        iteration = next(
            ((answers[s].get("shard") or {}).get("iteration")
             for s in answered), self.current_epoch,
        )

        results = self._merge(
            answers, answered, genes, qvecs, live_idx, k,
        )
        for qi in stale_qis:
            results[qi] = {
                "query": genes[qi], "neighbors": [], "degraded": True,
            }
        if degraded:
            self._count("fleet_degraded_responses_total")
        doc = {
            "model": {
                "dim": (
                    self.routing.dim if self.routing is not None
                    else None
                ),
                "iteration": iteration,
            },
            "results": results,
            "degraded": degraded,
            "shards": {
                "total": n_shards,
                "answered": len(answered),
                "indexes": answered,
                "epoch": epoch,
            },
        }
        return 200, doc

    def _merge(
        self,
        answers: Dict[int, dict],
        answered: List[int],
        genes: Optional[Sequence[str]],
        qvecs: List[Optional[List[float]]],
        live_idx: List[int],
        k: int,
    ) -> List[dict]:
        """Cross-process merge of the shard-local top-k sets, per
        query, preserving lax.top_k selection semantics (see
        ``merge_shard_topk``); token lookup rides the candidates each
        shard already returned."""
        n_queries = len(qvecs)
        # per answered shard: (Q_live, lk) score/row matrices + a
        # row→token map from the candidates themselves
        parts: List[Tuple[np.ndarray, np.ndarray]] = []
        tokens_by_row: Dict[int, str] = {}
        for s in answered:
            res = answers[s].get("results")
            if not isinstance(res, list) or len(res) != len(live_idx):
                continue  # malformed leg: treat as unanswered
            scores = np.asarray(
                [r.get("scores", []) for r in res], dtype=np.float32
            )
            rows = np.asarray(
                [r.get("rows", []) for r in res], dtype=np.int64
            )
            if scores.ndim != 2 or scores.shape != rows.shape:
                continue
            for r in res:
                for row, tok in zip(r.get("rows", []),
                                    r.get("tokens", [])):
                    tokens_by_row[int(row)] = tok
            parts.append((scores, rows))
        out: List[dict] = []
        merged: Dict[int, Tuple[np.ndarray, np.ndarray]] = {}
        if parts and live_idx:
            m_scores, m_rows = merge_shard_topk(
                parts, k + 1 if genes is not None else k
            )
            merged = {
                qi: (m_scores[j], m_rows[j])
                for j, qi in enumerate(live_idx)
            }
        for qi in range(n_queries):
            gene = genes[qi] if genes is not None else None
            if qi not in merged:
                out.append({
                    "query": gene,
                    "neighbors": [],
                    "degraded": True,
                })
                continue
            scores, rows = merged[qi]
            neighbors = []
            for s, r in zip(scores, rows):
                tok = tokens_by_row.get(int(r), str(int(r)))
                if gene is not None and tok == gene:
                    continue  # drop the self-hit, like the replica does
                neighbors.append(
                    {"gene": tok, "score": round(float(s), 6)}
                )
                if len(neighbors) >= k:
                    break
            out.append({"query": gene, "neighbors": neighbors})
        return out

    def embedding(self, body: dict) -> Tuple[int, dict]:
        """Point lookups routed to the owning shards.  No partial
        semantics: a gene whose owner cannot answer fails the request
        (503) — callers asking for raw vectors need all of them."""
        genes = body.get("genes")
        if not isinstance(genes, list) or not genes:
            return 400, {"error": "'genes' must be a non-empty list"}
        if len(genes) > self.config.max_queries_per_request:
            return 400, {
                "error": (
                    f"at most {self.config.max_queries_per_request} "
                    "genes per request"
                ),
            }
        routing = self.routing
        assert routing is not None
        by_owner: Dict[int, List[str]] = {}
        for g in genes:
            owner = routing.owner(g)
            if owner is None:
                return 400, {
                    "error": (
                        f"unknown gene {g!r} (model iteration "
                        f"{routing.iteration})"
                    ),
                }
            by_owner.setdefault(owner, []).append(g)
        deadline = time.monotonic() + self.config.default_timeout_s
        answers = self._scatter(
            "/v1/shard/vectors",
            {o: {"genes": gs} for o, gs in by_owner.items()},
            deadline,
        )
        vecs: Dict[str, List[float]] = {}
        for owner, gs in by_owner.items():
            doc = answers.get(owner)
            vectors = (doc or {}).get("vectors")
            if not isinstance(vectors, list) or len(vectors) != len(gs):
                return 503, {
                    "error": (
                        f"shard {owner} (owning {len(gs)} requested "
                        "gene(s)) did not answer"
                    ),
                }
            vecs.update(zip(gs, vectors))
        return 200, {
            "model": {
                "dim": routing.dim,
                "iteration": routing.iteration,
            },
            "embeddings": [
                {"gene": g, "vector": vecs[g]} for g in genes
            ],
        }

    # -- cross-shard /v1/interaction ---------------------------------------

    def _scorer(self):
        """The front-door GGIPNN pair scorer, built lazily on first use:
        a front door that scores no pair touches no device.  Vectors come
        from the shards, so the scorer needs only the dim and the head
        checkpoint."""
        with self._scorer_lock:
            if self._interaction_scorer is None:
                from gene2vec_tpu_torch.serve.interaction import (
                    CrossShardScorer,
                )

                dim = self.routing.dim if self.routing is not None else None
                if dim is None:
                    raise ApiReject(
                        503, "no routing table loaded; cannot score"
                    )
                self._interaction_scorer = CrossShardScorer(
                    dim,
                    checkpoint_path=self.ggipnn_checkpoint,
                    max_pairs=self.config.max_queries_per_request,
                    device=self.scorer_device,
                )
            return self._interaction_scorer

    def interaction(self, body: dict) -> Tuple[int, dict]:
        """Cross-shard GGIPNN pair scoring — the paper's extrinsic
        workload on a sharded fleet.  Each gene's raw vector is
        resolved from its OWNER shard's replica group
        (``/v1/shard/vectors``, qvec-cached per epoch) and the MLP head
        runs at the front door, so a pair spanning shards scores
        exactly like on a single replica.  Degraded-contract honesty:
        a pair whose owner group is fully down gets ``score: null`` +
        ``degraded: true`` in a 200 — never a 5xx, never a silently
        missing pair."""
        try:
            return self._interaction(body)
        except ApiReject as e:
            self._count(f"fleet_http_{e.status}_total")
            return e.status, {"error": str(e)}
        except Exception as e:
            # a scorer that cannot build (e.g. a head checkpoint
            # trained at a different dim) or a scoring crash must
            # ANSWER — the proxy's handler pool swallows exceptions,
            # so raising here would hang the client until its timeout
            # with no counter and no trace status
            self._count("fleet_interaction_errors_total")
            return 500, {
                "error": f"interaction scoring failed: {e!r}",
            }

    def _interaction(self, body: dict) -> Tuple[int, dict]:
        pairs = body.get("pairs")
        if not isinstance(pairs, list) or not pairs or not all(
            isinstance(p, list) and len(p) == 2
            and all(isinstance(g, str) for g in p)
            for p in pairs
        ):
            # string-ness is part of the 400 contract: a non-string
            # element would TypeError in the dedup set below and turn
            # a client mistake into a 500 server-error signal
            raise ApiReject(
                400,
                "'pairs' must be a non-empty list of [gene, gene] "
                "name pairs",
            )
        if len(pairs) > self.config.max_queries_per_request:
            raise ApiReject(
                400,
                f"at most {self.config.max_queries_per_request} pairs "
                "per request",
            )
        timeout = body.get("timeout_ms")
        if timeout is not None and (
            not isinstance(timeout, (int, float)) or timeout <= 0
        ):
            raise ApiReject(400, "timeout_ms must be a positive number")
        timeout_s = (
            float(timeout) / 1000.0 if timeout is not None
            else self.config.default_timeout_s
        )
        scorer = self._scorer()
        deadline = time.monotonic() + timeout_s
        # one resolution per distinct gene; unknown genes 400 exactly
        # like the single-replica scorer's KeyError path
        genes = []
        seen = set()
        for a, b in pairs:
            for g in (a, b):
                if g not in seen:
                    seen.add(g)
                    genes.append(g)
        epoch_hint = self.current_epoch
        for fence_try in (0, 1):
            vecs, epochs, unresolved = self._resolve_vectors(
                genes, deadline, epoch_hint
            )
            resolved_epochs = {e for e in epochs if e is not None}
            if len(resolved_epochs) > 1 and fence_try == 0:
                # a swap landed mid-resolution: retry once pinned to
                # the newest epoch — scoring a pair from two different
                # iterations' tables would be a wrong answer
                self._count("fleet_epoch_race_retries_total")
                epoch_hint = max(resolved_epochs)
                continue
            break
        merged_epoch = (
            max(resolved_epochs) if resolved_epochs else self.current_epoch
        )
        by_gene = {}
        for g, v, e in zip(genes, vecs, epochs):
            # still racing after the retry: the minority-epoch vector
            # degrades to unresolved rather than crossing iterations
            if v is not None and e is not None and e != merged_epoch:
                self._count("fleet_qvec_unresolved_total")
                unresolved = True
                v = None
            by_gene[g] = v
        scorable = [
            (i, p) for i, p in enumerate(pairs)
            if by_gene[p[0]] is not None and by_gene[p[1]] is not None
        ]
        if all(v is None for v in by_gene.values()):
            # no owner group answered anything: the one non-partial case
            self._count("fleet_scatter_unanswered_total")
            return 503, {
                "error": "no owner shard answered the vector scatter",
                "shards": {"total": self.config.num_shards,
                           "answered": 0},
            }
        scores = scorer.score_vectors(
            [
                (np.asarray(by_gene[a], np.float32),
                 np.asarray(by_gene[b], np.float32))
                for _, (a, b) in scorable
            ]
        )
        out: List[dict] = [
            {"pair": list(p), "score": None, "degraded": True}
            for p in pairs
        ]
        for (i, p), s in zip(scorable, scores):
            out[i] = {"pair": list(p), "score": round(float(s), 6)}
        degraded = bool(unresolved)
        if degraded:
            self._count("fleet_degraded_responses_total")
        self._count("fleet_interaction_pairs_total", len(pairs))
        return 200, {
            "model": {
                "dim": (
                    self.routing.dim if self.routing is not None
                    else None
                ),
                "iteration": merged_epoch,
            },
            "trained_head": scorer.trained,
            "scores": out,
            "degraded": degraded,
            "shards": {"total": self.config.num_shards},
        }


class SwapCoordinator:
    """Drives the shard-atomic hot swap from the front-door process.

    Polls the export dir (manifest-verified discovery, the registry's
    own rules); on a new iteration: STAGE on every shard → only if all
    staged, FLIP all under one epoch token.  Also repairs shards that
    restarted into a different epoch.  All HTTP here is plain urllib
    with generous timeouts — staging loads a table."""

    def __init__(
        self,
        export_dir: str,
        group: ShardGroup,
        dim: Optional[int] = None,
        interval_s: float = 2.0,
        stage_timeout_s: float = 180.0,
        metrics=None,
    ):
        self.export_dir = export_dir
        self.group = group
        self.dim = dim
        self.interval_s = interval_s
        self.stage_timeout_s = stage_timeout_s
        self.metrics = metrics
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    # -- plumbing ----------------------------------------------------------

    def _count(self, name: str, amount: int = 1) -> None:
        if self.metrics is not None:
            self.metrics.counter(name).inc(amount)

    def _post(self, url: str, path: str, body: dict,
              timeout_s: float) -> Optional[dict]:
        data = json.dumps(body).encode("utf-8")
        req = urllib.request.Request(
            url + path, data=data,
            headers={"Content-Type": "application/json"},
        )
        try:
            with urllib.request.urlopen(req, timeout=timeout_s) as resp:
                return json.loads(resp.read().decode("utf-8"))
        except Exception:
            return None

    def _probe_epoch(self, url: str) -> Optional[int]:
        try:
            with urllib.request.urlopen(
                url + "/healthz", timeout=5.0
            ) as resp:
                doc = json.loads(resp.read().decode("utf-8"))
            return (doc.get("shard") or {}).get("epoch")
        except Exception:
            return None

    # -- the protocol ------------------------------------------------------

    def tick(self) -> None:
        from gene2vec_tpu_torch.serve.registry import discover_newest

        newest = discover_newest(self.export_dir, self.dim)
        if newest is None:
            return
        dim, iteration, _path = newest
        group = self.group
        if group.routing is not None and group.routing.dim is None:
            group.routing.reload()
        if group.current_epoch is None:
            # boot: every shard loaded the then-newest iteration on its
            # own; adopt it as the fleet epoch (the repair pass below
            # converges any shard that raced a concurrent export)
            group.current_epoch = iteration
        if iteration != group.current_epoch:
            self._swap(dim, iteration)
        else:
            self._repair(dim, iteration)

    def _cells(self) -> List[Tuple[int, str]]:
        """Every live (shard, replica-URL) cell of the grid — the swap
        protocol's unit.  With ``--replicas-per-shard 1`` this is one
        URL a shard."""
        out: List[Tuple[int, str]] = []
        for i in range(self.group.config.num_shards):
            for url in self.group.urls_of(i):
                out.append((i, url))
        return out

    def _swap(self, dim: int, iteration: int) -> None:
        """STAGE every (shard, replica) cell, then FLIP all under one
        token.  Deferred while any shard GROUP is fully down: flipping
        half a fleet can never be atomic, and the supervisor's restart
        is coming.  A single dead replica with a live sibling does NOT
        defer — the sibling flips with the fleet, and the dead cell is
        repaired (re-staged + flipped) when it returns."""
        cells = self._cells()
        covered = {i for i, _ in cells}
        if any(
            i not in covered
            for i in range(self.group.config.num_shards)
        ):
            self._count("fleet_swap_deferred_total")
            return
        threads = []
        results: Dict[Tuple[int, str], Optional[dict]] = {}

        def stage(i: int, url: str) -> None:
            results[(i, url)] = self._post(
                url, "/v1/shard/stage",
                {"dim": dim, "iteration": iteration},
                self.stage_timeout_s,
            )

        for i, url in cells:
            t = threading.Thread(
                target=stage, args=(i, url), daemon=True,
                name=f"swap-stage-{i}",
            )
            t.start()
            threads.append(t)
        for t in threads:
            t.join(timeout=self.stage_timeout_s + 10.0)
        staged = [
            isinstance(results.get(cell), dict)
            and "staged" in results[cell]
            for cell in cells
        ]
        if not all(staged):
            # NO cell flips: the fleet keeps serving the old epoch as
            # one logical version; retry next tick
            self._count("fleet_swap_stage_failures_total")
            return
        flips_ok = True
        for i, url in cells:
            doc = self._post(
                url, "/v1/shard/flip", {"epoch": iteration}, 30.0
            )
            if doc is None:
                flips_ok = False
            else:
                self.group.note_epoch(
                    i, (doc.get("shard") or {}).get("epoch"), url=url
                )
        # the fleet's logical version moves forward once the flip wave
        # has been ISSUED: stragglers (a cell that died mid-flip) are
        # epoch-fenced out of merges and repaired next tick
        self.group.current_epoch = iteration
        if self.group.routing is not None:
            self.group.routing.reload()
        self._count("fleet_swap_flips_total")
        if not flips_ok:
            self._count("fleet_swap_flip_failures_total")

    def _repair(self, dim: int, iteration: int) -> None:
        """Converge cells serving a different epoch than the fleet's
        (typically a replica the supervisor restarted mid-history):
        stage + flip just those."""
        for i, url in self._cells():
            epoch = self._probe_epoch(url)
            self.group.note_epoch(i, epoch, url=url)
            if epoch == iteration or epoch is None:
                continue
            doc = self._post(
                url, "/v1/shard/stage",
                {"dim": dim, "iteration": iteration},
                self.stage_timeout_s,
            )
            if isinstance(doc, dict) and "staged" in doc:
                flipped = self._post(
                    url, "/v1/shard/flip", {"epoch": iteration}, 30.0
                )
                if flipped is not None:
                    self.group.note_epoch(
                        i, (flipped.get("shard") or {}).get("epoch"),
                        url=url,
                    )
                    self._count("fleet_swap_repairs_total")

    # -- lifecycle ---------------------------------------------------------

    def start(self) -> "SwapCoordinator":
        if self._thread is not None:
            return self
        self._stop.clear()

        def loop() -> None:
            while not self._stop.wait(self.interval_s):
                try:
                    self.tick()
                except Exception:
                    # coordination must outlive surprises; the fleet
                    # keeps serving its current epoch either way
                    self._count("fleet_swap_tick_errors_total")

        self._thread = threading.Thread(
            target=loop, name="shard-swap-coordinator", daemon=True
        )
        self._thread.start()
        return self

    def stop(self) -> None:
        if self._thread is None:
            return
        self._stop.set()
        self._thread.join(timeout=10.0)
        self._thread = None
