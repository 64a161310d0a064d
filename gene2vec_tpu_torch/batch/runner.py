"""Batch-job runners: chunk loops generic over a query backend — the
port of ``gene2vec_tpu/batch/runner.py``.

One runner per job type (kNN graph, bulk pair scoring, streaming
export), each writing through :class:`batch.artifact.ChunkedArtifact`'s
commit protocol so a SIGKILL anywhere resumes to a bit-identical final
artifact.  The backend abstracts WHERE queries execute:

* :class:`EngineBackend` — in-process model + engine on the card
  (``cli.batch`` local mode; the engine's kernels K7-K9r, the
  interaction scorer's ``row_gather``);
* :class:`BatcherBackend` — a live replica's micro-batcher, every
  query submitted on the low-weight ``batch`` tenant lane
  (serve/tenancy.py) so interactive traffic wins the weighted-fair
  dequeue; queue-full rejections back off instead of erroring;
* :class:`ShardGroupBackend` — the fleet front door's scatter-gather
  (serve/shardgroup.py): full-vocab queries fan out across the shard
  grid, degraded answers (a shard group mid-failover) retry with
  backoff rather than poisoning the artifact;
* :class:`ClientBackend` — an unsharded fleet front door's replica
  pool through its resilient client.

Determinism contract: record bytes are a pure function of the served
model (scores rounded to 6 decimals exactly like the interactive
surface), so control and resumed builds against the same iteration
compare equal byte-for-byte.  A hot swap mid-job changes that function;
runners pin the iteration at job start and fail loudly on drift.
"""

from __future__ import annotations

import time
import zlib
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np

from gene2vec_tpu_torch.batch.artifact import ChunkedArtifact, pack_graph_rows
from gene2vec_tpu_torch.obs.trace import ambient_span
from gene2vec_tpu_torch.serve.tenancy import BATCH_TENANT

__all__ = [
    "BatcherBackend",
    "ChunkFailed",
    "ClientBackend",
    "EngineBackend",
    "JobCancelled",
    "Pacer",
    "ShardGroupBackend",
    "run_job",
]

#: generous per-query deadline for batch-lane requests: the lane is
#: background priority, so queue time under interactive load is the
#: POINT, not a failure
_BATCH_TIMEOUT_S = 60.0


class JobCancelled(Exception):
    """The job's cancel flag was observed between chunks."""


class ChunkFailed(Exception):
    """One chunk kept failing after every retry (backend down/degraded
    past the retry budget, or answers that cannot be mapped)."""


class Pacer:
    """Background-priority pacing: before each chunk, yield while the
    interactive plane is under pressure (``guard()`` above
    ``guard_max``), then pay a duty-cycle sleep proportional to the
    last chunk's wall time so batch work never monopolizes the
    backend even when the queue is empty.

    ``duty`` is the fraction of wall time the job may consume: 1.0 =
    no idle gap, 0.5 = sleep as long as each chunk took."""

    def __init__(
        self,
        guard: Optional[Callable[[], float]] = None,
        guard_max: float = 0.5,
        duty: float = 1.0,
        clock: Callable[[], float] = time.monotonic,
        sleep: Callable[[float], None] = time.sleep,
    ):
        self.guard = guard
        self.guard_max = float(guard_max)
        self.duty = min(1.0, max(0.05, float(duty)))
        self._clock = clock
        self._sleep = sleep
        self.yielded_s = 0.0

    def wait(self, last_chunk_s: float,
             should_stop: Optional[Callable[[], bool]] = None) -> None:
        t0 = self._clock()
        if self.duty < 1.0 and last_chunk_s > 0:
            gap = last_chunk_s * (1.0 - self.duty) / self.duty
            self._sleep(min(gap, 5.0))
        backoff = 0.05
        while self.guard is not None and self.guard() > self.guard_max:
            if should_stop is not None and should_stop():
                break
            self._sleep(backoff)
            backoff = min(backoff * 2, 1.0)
        self.yielded_s += self._clock() - t0


def _retrying(fn: Callable, attempts: int = 5,
              sleep: Callable[[float], None] = time.sleep):
    """Retry a chunk computation with exponential backoff — a shard
    failover or a saturated queue is a pause, not a job failure."""
    delay = 0.25
    last: Optional[Exception] = None
    for _ in range(max(1, attempts)):
        try:
            return fn()
        except (ChunkFailed, OSError) as e:
            last = e
            sleep(delay)
            delay = min(delay * 2, 8.0)
    raise ChunkFailed(
        f"chunk failed after {attempts} attempts: {last}"
    ) from last


# -- backends -----------------------------------------------------------------


class EngineBackend:
    """Direct model + engine compute (no serving stack): ``cli.batch``
    local mode.  The interaction scorer runs where the model's table
    lies."""

    def __init__(self, model, engine, ggipnn_checkpoint: Optional[str] = None):
        self.model = model
        self.engine = engine
        self._ggipnn_checkpoint = ggipnn_checkpoint
        self._scorer = None

    @property
    def tokens(self) -> Sequence[str]:
        return self.model.tokens

    @property
    def dim(self) -> int:
        return self.model.dim

    @property
    def iteration(self) -> int:
        return self.model.iteration

    def pressure(self) -> float:
        return 0.0

    def knn_rows(self, start: int, n: int, k: int
                 ) -> Tuple[np.ndarray, np.ndarray]:
        model = self.model
        kq = min(k + 1, len(model))
        queries = np.asarray(model.emb[start:start + n], dtype=np.float32)
        scores, rows = self.engine.topk_rows(model, queries, kq)
        return _drop_self(
            np.asarray(rows), np.asarray(scores), start, k
        )

    def pair_scores(self, pairs: Sequence[Tuple[str, str]]) -> List[float]:
        if self._scorer is None:
            from gene2vec_tpu_torch.serve.interaction import InteractionScorer

            self._scorer = InteractionScorer(
                self.model, checkpoint_path=self._ggipnn_checkpoint,
                device=self.model.unit.device,
            )
        return [
            round(float(s), 6)
            for s in self._scorer.score([tuple(p) for p in pairs])
        ]

    def vector_rows(self, start: int, n: int) -> List[List[float]]:
        return [
            [float(v) for v in row]
            for row in self.model.emb[start:start + n]
        ]


def _drop_self(rows: np.ndarray, scores: np.ndarray, start: int, k: int
               ) -> Tuple[np.ndarray, np.ndarray]:
    """(n, k+1) engine answers -> (n, k) neighbor records with the
    query's own row removed (the interactive /v1/similar contract);
    scores rounded to 6 decimals exactly like the serve surface."""
    n = rows.shape[0]
    out_ids = np.empty((n, k), dtype=np.int32)
    out_scores = np.empty((n, k), dtype=np.float32)
    for i in range(n):
        self_row = start + i
        keep = [j for j in range(rows.shape[1])
                if int(rows[i, j]) != self_row][:k]
        if len(keep) < k:
            raise ChunkFailed(
                f"row {self_row}: only {len(keep)} non-self neighbors "
                f"returned (need k={k}; vocab too small?)"
            )
        out_ids[i] = rows[i, keep]
        out_scores[i] = np.asarray(
            [round(float(scores[i, j]), 6) for j in keep],
            dtype=np.float32,
        )
    return out_ids, out_scores


class BatcherBackend:
    """A live :class:`serve.server.ServeApp`'s query plane, entered on
    the ``batch`` tenant lane.  Every kNN query is one batcher item —
    the FairQueue interleaves them under interactive lanes at
    ``batch_weight``, and queue-full rejections back off (admission is
    pressure-aware by construction)."""

    def __init__(self, app):
        self.app = app
        self._model = app.registry.model

    @property
    def tokens(self) -> Sequence[str]:
        return self._model.tokens

    @property
    def dim(self) -> int:
        return self._model.dim

    @property
    def iteration(self) -> int:
        return self._model.iteration

    def pressure(self) -> float:
        depth = len(self.app.batcher._q)
        return depth / max(1, self.app.config.max_queue)

    def knn_rows(self, start: int, n: int, k: int
                 ) -> Tuple[np.ndarray, np.ndarray]:
        from gene2vec_tpu_torch.serve.batcher import (
            DeadlineExceeded,
            RejectedError,
        )

        model = self._model
        genes = model.tokens[start:start + n]
        tickets = []
        for g in genes:
            q = {"gene": g, "k": k}
            while True:
                try:
                    tickets.append(self.app.batcher.submit_async(
                        q, k,
                        cache_key=(model.version, "similar", g, k),
                        timeout_s=_BATCH_TIMEOUT_S,
                        tenant=BATCH_TENANT,
                    ))
                    break
                except RejectedError:
                    # the bounded queue is full of interactive work:
                    # yield, never displace it
                    time.sleep(0.05)
        ids = np.empty((n, k), dtype=np.int32)
        scores = np.empty((n, k), dtype=np.float32)
        index = model.index
        for i, t in enumerate(tickets):
            try:
                r = t.get()
            except DeadlineExceeded as e:
                raise ChunkFailed(str(e)) from e
            if "error" in r:
                raise ChunkFailed(r["error"])
            hits = r["neighbors"][:k]
            if len(hits) < k:
                raise ChunkFailed(
                    f"gene {genes[i]!r}: {len(hits)} neighbors < k={k}"
                )
            for j, h in enumerate(hits):
                row = index.get(h["gene"])
                if row is None:
                    raise ChunkFailed(
                        f"neighbor {h['gene']!r} not in served vocab "
                        "(swap mid-chunk?)"
                    )
                ids[i, j] = row
                scores[i, j] = h["score"]
        return ids, scores

    def pair_scores(self, pairs: Sequence[Tuple[str, str]]) -> List[float]:
        scorer = self.app._get_scorer(self._model)
        try:
            raw = scorer.score([tuple(p) for p in pairs])
        except KeyError as e:
            raise ChunkFailed(f"unknown gene {e.args[0]!r}") from e
        return [round(float(s), 6) for s in raw]

    def vector_rows(self, start: int, n: int) -> List[List[float]]:
        return [
            [float(v) for v in row]
            for row in self._model.emb[start:start + n]
        ]


class ClientBackend:
    """An unsharded fleet front door's replica pool, queried through
    its :class:`serve.client.ResilientClient` with ``X-Tenant: batch``
    — each replica's own FairQueue then drains the job's queries at
    the batch weight, so front-door jobs inherit the same priority
    contract as in-process ones.  ``max_queries`` bounds each request
    to the replicas' per-request query cap."""

    _HEADERS = {"X-Tenant": BATCH_TENANT}

    def __init__(self, client, max_queries: int = 64):
        self.client = client
        self._sub = int(max_queries)
        facts = self._post("/healthz", None, method="GET")
        model = facts.get("model")
        if not model:
            raise ChunkFailed(f"fleet not ready: {facts}")
        self._dim = int(model["dim"])
        self._iteration = int(model["iteration"])
        self._tokens = self._fetch_tokens(int(model["vocab_size"]))
        self._index = {t: i for i, t in enumerate(self._tokens)}

    def _post(self, path: str, body, method: str = "POST") -> dict:
        resp = self.client.request(
            path, body=body, method=method,
            timeout_s=_BATCH_TIMEOUT_S, headers=dict(self._HEADERS),
        )
        if not resp.ok or resp.doc is None:
            raise ChunkFailed(
                f"{method} {path} -> {resp.status} "
                f"({resp.error_class})"
            )
        return resp.doc

    def _fetch_tokens(self, total: int) -> List[str]:
        tokens: List[str] = []
        while len(tokens) < total:
            doc = self._post(
                f"/v1/genes?offset={len(tokens)}&limit=1000", None,
                method="GET",
            )
            got = doc.get("genes", [])
            if not got:
                raise ChunkFailed(
                    f"vocab fetch stalled at {len(tokens)}/{total}"
                )
            tokens.extend(got)
        return tokens

    @property
    def tokens(self) -> Sequence[str]:
        return self._tokens

    @property
    def dim(self) -> int:
        return self._dim

    @property
    def iteration(self) -> int:
        return self._iteration

    def pressure(self) -> float:
        try:
            doc = self._post("/healthz", None, method="GET")
        except ChunkFailed:
            return 1.0  # unreachable fleet = maximal pressure: yield
        return float(doc.get("queue_depth", 0)) / max(
            1, int(doc.get("max_queue", 1))
        )

    def knn_rows(self, start: int, n: int, k: int
                 ) -> Tuple[np.ndarray, np.ndarray]:
        genes = self._tokens[start:start + n]
        ids = np.empty((n, k), dtype=np.int32)
        scores = np.empty((n, k), dtype=np.float32)
        done = 0
        while done < n:
            sub = genes[done:done + self._sub]
            doc = self._post("/v1/similar", {"genes": sub, "k": k})
            results = doc.get("results", [])
            if len(results) != len(sub):
                raise ChunkFailed(
                    f"{len(results)} results for {len(sub)} queries"
                )
            for i, r in enumerate(results):
                hits = r.get("neighbors", [])[:k]
                if len(hits) < k:
                    raise ChunkFailed(
                        f"gene {sub[i]!r}: {len(hits)} neighbors < "
                        f"k={k}"
                    )
                for j, h in enumerate(hits):
                    row = self._index.get(h["gene"])
                    if row is None:
                        raise ChunkFailed(
                            f"neighbor {h['gene']!r} not in fetched "
                            "vocab (swap mid-job?)"
                        )
                    ids[done + i, j] = row
                    scores[done + i, j] = h["score"]
            done += len(sub)
        return ids, scores

    def pair_scores(self, pairs: Sequence[Tuple[str, str]]) -> List[float]:
        out: List[float] = []
        done = 0
        pairs = [list(p) for p in pairs]
        while done < len(pairs):
            sub = pairs[done:done + self._sub]
            doc = self._post("/v1/interaction", {"pairs": sub})
            recs = doc.get("scores", [])
            if len(recs) != len(sub):
                raise ChunkFailed("interaction result count mismatch")
            out.extend(round(float(r["score"]), 6) for r in recs)
            done += len(sub)
        return out

    def vector_rows(self, start: int, n: int) -> List[List[float]]:
        genes = self._tokens[start:start + n]
        out: List[List[float]] = []
        done = 0
        while done < n:
            sub = genes[done:done + self._sub]
            doc = self._post("/v1/embedding", {"genes": sub})
            embs = doc.get("embeddings", [])
            if len(embs) != len(sub):
                raise ChunkFailed("embedding result count mismatch")
            out.extend([float(v) for v in e["vector"]] for e in embs)
            done += len(sub)
        return out


class ShardGroupBackend:
    """The sharded fleet's scatter plane: chunk queries fan out through
    :class:`serve.shardgroup.ShardGroup` in sub-requests tagged
    ``X-Tenant: batch`` (``shardgroup.scatter_headers``), so every
    replica's FairQueue drains them at the batch weight.  Degraded
    answers (an owner group mid-failover) are retryable, not
    recordable — the artifact only ever holds full-rank answers.

    ``sub_queries`` is deliberately SMALLER than the front-door cap: a
    scatter leg is one uninterruptible unit of replica work, and the
    interactive p99 under batch load is bounded by that unit's service
    time — tenancy weighting orders queued requests but cannot preempt
    one in flight.  ``pressure_fn`` (cli.fleet wires the aggregator's
    normalized replica queue depth) feeds the Pacer's yield guard."""

    _HEADERS = {"X-Tenant": BATCH_TENANT}

    def __init__(self, group, pressure_fn=None, sub_queries: int = 16):
        from gene2vec_tpu_torch.serve.shardgroup import scatter_headers

        self.group = group
        self._scatter_headers = scatter_headers
        self._pressure_fn = pressure_fn
        self._sub = max(1, min(
            int(group.config.max_queries_per_request),
            int(sub_queries),
        ))

    @property
    def tokens(self) -> Sequence[str]:
        return self.group.routing.tokens

    @property
    def dim(self) -> int:
        return int(self.group.routing.dim)

    @property
    def iteration(self) -> int:
        return int(self.group.routing.iteration)

    def pressure(self) -> float:
        if self._pressure_fn is None:
            return 0.0
        try:
            return float(self._pressure_fn())
        except Exception:
            return 1.0  # a broken signal reads as pressure: yield

    def knn_rows(self, start: int, n: int, k: int
                 ) -> Tuple[np.ndarray, np.ndarray]:
        tokens = self.tokens
        index = self.group.routing.index
        genes = list(tokens[start:start + n])
        ids = np.empty((n, k), dtype=np.int32)
        scores = np.empty((n, k), dtype=np.float32)
        done = 0
        while done < n:
            sub = genes[done:done + self._sub]
            with self._scatter_headers(dict(self._HEADERS)):
                status, doc = self.group.similar(
                    {"genes": sub, "k": k}
                )
            if status != 200:
                raise ChunkFailed(
                    f"scatter answered {status}: {doc.get('error')}"
                )
            results = doc.get("results", [])
            if len(results) != len(sub):
                raise ChunkFailed(
                    f"scatter returned {len(results)} results for "
                    f"{len(sub)} queries"
                )
            for i, r in enumerate(results):
                hits = r.get("neighbors", [])[:k]
                if r.get("degraded") or len(hits) < k:
                    raise ChunkFailed(
                        f"gene {sub[i]!r}: degraded/short answer "
                        f"({len(hits)} neighbors; shard down?)"
                    )
                for j, h in enumerate(hits):
                    row = index.get(h["gene"])
                    if row is None:
                        raise ChunkFailed(
                            f"neighbor {h['gene']!r} not in routing "
                            "vocab"
                        )
                    ids[done + i, j] = row
                    scores[done + i, j] = h["score"]
            done += len(sub)
        return ids, scores

    def pair_scores(self, pairs: Sequence[Tuple[str, str]]) -> List[float]:
        out: List[float] = []
        done = 0
        pairs = [list(p) for p in pairs]
        while done < len(pairs):
            sub = pairs[done:done + self._sub]
            with self._scatter_headers(dict(self._HEADERS)):
                status, doc = self.group.interaction({"pairs": sub})
            if status != 200:
                raise ChunkFailed(
                    f"interaction answered {status}: {doc.get('error')}"
                )
            recs = doc.get("scores", [])
            if len(recs) != len(sub):
                raise ChunkFailed("interaction result count mismatch")
            for rec in recs:
                if rec.get("score") is None:
                    raise ChunkFailed(
                        f"pair {rec.get('pair')!r} degraded (owner "
                        "shard down?)"
                    )
                out.append(round(float(rec["score"]), 6))
            done += len(sub)
        return out

    def vector_rows(self, start: int, n: int) -> List[List[float]]:
        tokens = self.tokens
        genes = list(tokens[start:start + n])
        out: List[List[float]] = []
        done = 0
        while done < n:
            sub = genes[done:done + self._sub]
            with self._scatter_headers(dict(self._HEADERS)):
                status, doc = self.group.embedding({"genes": sub})
            if status != 200:
                raise ChunkFailed(
                    f"embedding answered {status}: {doc.get('error')}"
                )
            embs = doc.get("embeddings", [])
            if len(embs) != len(sub):
                raise ChunkFailed("embedding result count mismatch")
            out.extend([float(v) for v in e["vector"]] for e in embs)
            done += len(sub)
        return out


# -- the job loops ------------------------------------------------------------


def _render_w2v_rows(tokens: Sequence[str],
                     vectors: Sequence[Sequence[float]]) -> bytes:
    # byte-identical to io/emb_io.py write_word2vec_format rows
    return "".join(
        str(t) + " " + " ".join(repr(float(v)) for v in row) + "\n"
        for t, row in zip(tokens, vectors)
    ).encode("utf-8")


def _render_pair_rows(pairs: Sequence[Sequence[str]],
                      scores: Sequence[float]) -> bytes:
    return "".join(
        f"{a}\t{b}\t{round(float(s), 6)!r}\n"
        for (a, b), s in zip(pairs, scores)
    ).encode("utf-8")


def run_job(
    spec,
    backend,
    art: ChunkedArtifact,
    metrics=None,
    should_stop: Optional[Callable[[], bool]] = None,
    pace: Optional[Pacer] = None,
    progress: Optional[Callable[[int, int], None]] = None,
) -> Dict:
    """Drive one job to its finalized artifact (resuming past already
    committed chunks), returning goodput facts.  Raises
    :class:`JobCancelled` when ``should_stop`` fires between chunks and
    :class:`ChunkFailed` when the backend stays broken past the retry
    budget — in both cases committed progress stays on disk for the
    next attempt."""
    t0 = time.monotonic()
    resumed_records = art.records_done
    pace = pace if pace is not None else Pacer()
    tokens = list(backend.tokens)
    iteration = backend.iteration
    chunk_rows = max(1, int(getattr(spec, "chunk_rows", 256)))
    kind = spec.type

    if kind == "knn_graph":
        plan = _plan_graph(spec, tokens, backend)
    elif kind == "pair_scores":
        plan = _plan_pairs(spec, backend)
    elif kind == "export":
        plan = _plan_export(spec, tokens, backend)
    else:
        raise ValueError(f"unknown job type {kind!r}")
    total_chunks, total_records, compute = plan

    if art.chunks_done == 0 and kind == "knn_graph":
        art.write_tokens(tokens)
    last_chunk_s = 0.0
    for ci in range(art.chunks_done, total_chunks):
        if should_stop is not None and should_stop():
            raise JobCancelled(
                f"cancelled at chunk {ci}/{total_chunks}"
            )
        pace.wait(last_chunk_s, should_stop)
        tc = time.monotonic()
        with ambient_span(
            "batch_chunk", job=getattr(spec, "job_id", None),
            type=kind, chunk=ci,
        ) as span:
            data, records = _retrying(lambda: compute(ci, chunk_rows))
            art.append_chunk(data, records)
            span["records"] = records
        last_chunk_s = time.monotonic() - tc
        if metrics is not None:
            metrics.counter("batch_chunks_committed_total").inc()
            metrics.counter("batch_records_total").inc(records)
            if records and last_chunk_s > 0:
                # per-chunk goodput
                metrics.gauge("batch_chunk_rows_per_sec").set(
                    records / last_chunk_s
                )
        if progress is not None:
            progress(art.records_done, total_records)

    meta = {
        "type": kind,
        "k": int(getattr(spec, "k", 0) or 0),
        "rows": total_records,
        "dim": int(backend.dim),
        "iteration": int(iteration),
        "chunk_rows": chunk_rows,
        "tokens_crc32": zlib.crc32(
            "\n".join(tokens).encode("utf-8")
        ) & 0xFFFFFFFF,
    }
    if kind == "export":
        meta["format"] = "word2vec"
    path = art.finalize(meta)
    wall = max(time.monotonic() - t0, 1e-9)
    new_records = art.records_done - resumed_records
    return {
        "artifact": path,
        "records": art.records_done,
        "chunks": art.chunks_done,
        "data_bytes": art.data_bytes,
        "resumed_records": resumed_records,
        "wall_s": round(wall, 3),
        "rows_per_sec": round(new_records / wall, 3),
        "yielded_s": round(pace.yielded_s, 3),
    }


def _plan_graph(spec, tokens, backend):
    v = len(tokens)
    k = int(spec.k)
    if v <= k:
        raise ValueError(f"vocab {v} too small for k={k}")

    def compute(ci: int, chunk_rows: int):
        start = ci * chunk_rows
        n = min(chunk_rows, v - start)
        ids, scores = backend.knn_rows(start, n, k)
        return pack_graph_rows(ids, scores), n

    chunk_rows = max(1, int(spec.chunk_rows))
    return (-(-v // chunk_rows), v, compute)


def _plan_pairs(spec, backend):
    pairs = [list(p) for p in (spec.pairs or [])]
    if not pairs:
        raise ValueError("pair_scores job needs a non-empty 'pairs' list")

    def compute(ci: int, chunk_rows: int):
        sub = pairs[ci * chunk_rows:(ci + 1) * chunk_rows]
        scores = backend.pair_scores([tuple(p) for p in sub])
        return _render_pair_rows(sub, scores), len(sub)

    chunk_rows = max(1, int(spec.chunk_rows))
    return (-(-len(pairs) // chunk_rows), len(pairs), compute)


def _plan_export(spec, tokens, backend):
    v = len(tokens)
    dim = backend.dim

    def compute(ci: int, chunk_rows: int):
        if ci == 0:
            # the word2vec "<count> <dim>" header is its own chunk so
            # row chunks stay aligned to record counts
            return f"{v} {dim}\n".encode("utf-8"), 0
        start = (ci - 1) * chunk_rows
        n = min(chunk_rows, v - start)
        vectors = backend.vector_rows(start, n)
        return _render_w2v_rows(tokens[start:start + n], vectors), n

    chunk_rows = max(1, int(spec.chunk_rows))
    return (1 + -(-v // chunk_rows), v, compute)
