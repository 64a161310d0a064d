"""Job lifecycle: journal, background worker, and the ``/v1/jobs``
HTTP surface — the port of ``gene2vec_tpu/batch/jobs.py``.

One :class:`JobManager` per front door (a single replica's
:class:`serve.server.ServeApp` or the fleet proxy).  Jobs live under
``<jobs_root>/<job_id>/``:

* ``JOB.json`` — the journal (spec + state + progress), every write
  atomic (resilience/snapshot.py), so the manager can be SIGKILLed at
  any instruction and rebuild its queue from disk;
* ``DATA.bin`` / ``CURSOR.json`` / ``ARTIFACT.json`` — the chunk store
  (batch/artifact.py commit protocol).

Exactly ONE worker thread drains the queue FIFO: the batch plane is
background priority by definition, and a single in-flight job bounds
its interference with the interactive SLO on top of the FairQueue
weight and the pacing guard.  On :meth:`start`, journal states
``pending``/``running`` re-enqueue — a ``running`` job whose process
died resumes from its artifact cursor and still converges to the
bit-identical final artifact.

:func:`dispatch_jobs` maps the ``/v1/jobs`` routes onto a manager and
is shared verbatim by the single-replica server and the fleet proxy.
"""

from __future__ import annotations

import base64
import dataclasses
import json
import os
import re
import threading
import time
from typing import Callable, Dict, List, Optional, Tuple

from gene2vec_tpu_torch.batch.artifact import ChunkedArtifact
from gene2vec_tpu_torch.batch.runner import (
    ChunkFailed,
    JobCancelled,
    Pacer,
    run_job,
)
from gene2vec_tpu_torch.obs.trace import ambient_span
from gene2vec_tpu_torch.resilience import snapshot as snap

JOB_SCHEMA = "gene2vec-tpu/batch-job/v1"
JOB_NAME = "JOB.json"
JOB_TYPES = ("knn_graph", "pair_scores", "export")
JOB_STATES = ("pending", "running", "done", "failed", "cancelled")

_JOB_ID_RE = re.compile(r"^[A-Za-z0-9][A-Za-z0-9._-]{0,63}$")

#: artifact bytes returned per /v1/jobs/<id>/artifact page (base64 in
#: the JSON body); clients page with ?offset= until empty
_ARTIFACT_PAGE = 1 << 20

#: submitted pair lists are part of the journal — bound them so one
#: request cannot write an unbounded JOB.json
_MAX_PAIRS = 200_000


@dataclasses.dataclass
class JobSpec:
    """One job's immutable parameters (journaled verbatim, so a resume
    after SIGKILL replays exactly the same plan)."""

    type: str
    k: int = 10
    chunk_rows: int = 256
    pairs: Optional[List[List[str]]] = None
    job_id: Optional[str] = None

    @classmethod
    def from_body(cls, body: dict) -> "JobSpec":
        kind = body.get("type")
        if kind not in JOB_TYPES:
            raise ValueError(
                f"'type' must be one of {list(JOB_TYPES)}, got {kind!r}"
            )
        k = body.get("k", 10)
        if not isinstance(k, int) or not 1 <= k <= 256:
            raise ValueError("'k' must be an int in [1, 256]")
        chunk_rows = body.get("chunk_rows", 256)
        if not isinstance(chunk_rows, int) or not 1 <= chunk_rows <= 8192:
            raise ValueError("'chunk_rows' must be an int in [1, 8192]")
        pairs = body.get("pairs")
        if kind == "pair_scores":
            if (
                not isinstance(pairs, list) or not pairs
                or len(pairs) > _MAX_PAIRS
                or not all(
                    isinstance(p, list) and len(p) == 2
                    and all(isinstance(g, str) for g in p)
                    for p in pairs
                )
            ):
                raise ValueError(
                    "'pairs' must be a non-empty list of [gene, gene] "
                    f"(at most {_MAX_PAIRS})"
                )
        else:
            pairs = None
        job_id = body.get("job_id")
        if job_id is not None and not _JOB_ID_RE.match(str(job_id)):
            raise ValueError(
                "'job_id' must match [A-Za-z0-9][A-Za-z0-9._-]{0,63}"
            )
        return cls(
            type=kind, k=k, chunk_rows=chunk_rows, pairs=pairs,
            job_id=job_id,
        )

    def to_doc(self) -> dict:
        return {
            "type": self.type,
            "k": self.k,
            "chunk_rows": self.chunk_rows,
            "pairs": self.pairs,
            "job_id": self.job_id,
        }


class JobManager:
    """The jobs root + the one background worker.

    ``backend_factory`` builds the query backend lazily per job run
    (the served model may have swapped between jobs; each RUN pins the
    iteration it started against)."""

    def __init__(
        self,
        root: str,
        backend_factory: Callable,
        metrics=None,
        pacer_factory: Optional[Callable[..., Pacer]] = None,
        clock: Callable[[], float] = time.time,
    ):
        self.root = root
        os.makedirs(root, exist_ok=True)
        self.backend_factory = backend_factory
        self.metrics = metrics
        self.pacer_factory = pacer_factory
        self._clock = clock
        self._lock = threading.Lock()
        self._wake = threading.Condition(self._lock)
        # guarded by _lock (the _wake condition's lock): the worker and
        # the route threads touch these only under `with self._wake`
        self._queue: List[str] = []
        self._cancelled: set = set()
        self._seq = 0  # the submit side's id mint
        self._thread: Optional[threading.Thread] = None
        self._stopping = threading.Event()

    # -- journal ----------------------------------------------------------

    def job_dir(self, job_id: str) -> str:
        return os.path.join(self.root, job_id)

    def _journal_path(self, job_id: str) -> str:
        return os.path.join(self.job_dir(job_id), JOB_NAME)

    def _read_journal(self, job_id: str) -> Optional[dict]:
        try:
            with open(self._journal_path(job_id), "r",
                      encoding="utf-8") as f:
                doc = json.load(f)
        except (OSError, ValueError):
            return None
        return doc if isinstance(doc, dict) else None

    def _write_journal(self, job_id: str, doc: dict) -> None:
        doc = dict(doc)
        doc["schema"] = JOB_SCHEMA
        doc["updated_unix"] = self._clock()
        snap.atomic_write_json(self._journal_path(job_id), doc)

    def _update(self, job_id: str, **fields) -> dict:
        doc = self._read_journal(job_id) or {}
        doc.update(fields)
        self._write_journal(job_id, doc)
        return doc

    # -- lifecycle --------------------------------------------------------

    def start(self) -> "JobManager":
        """Recover the on-disk queue, then start the worker.  Jobs the
        dead process left ``running`` go FIRST (their artifact cursor
        already holds committed chunks), then ``pending`` in submit
        order."""
        running: List[Tuple[float, str]] = []
        pending: List[Tuple[float, str]] = []
        try:
            entries = sorted(os.listdir(self.root))
        except OSError:
            entries = []
        for name in entries:
            doc = self._read_journal(name)
            if doc is None:
                continue
            state = doc.get("state")
            created = float(doc.get("created_unix", 0))
            if state == "running":
                running.append((created, name))
            elif state == "pending":
                pending.append((created, name))
        with self._wake:
            self._queue = [
                j for _, j in sorted(running) + sorted(pending)
            ]
        self._stopping.clear()
        self._thread = threading.Thread(
            target=self._work, name="batch-jobs", daemon=True
        )
        self._thread.start()
        return self

    def stop(self) -> None:
        self._stopping.set()
        with self._wake:
            self._wake.notify_all()
        if self._thread is not None:
            self._thread.join(timeout=10.0)
            self._thread = None

    # -- the /v1/jobs verbs ----------------------------------------------

    def submit(self, spec: JobSpec) -> dict:
        """Journal + enqueue.  Resubmitting an existing job_id is
        idempotent: done jobs return their status, dead ones
        re-enqueue (the journal survives, progress resumes)."""
        with self._wake:
            if spec.job_id is None:
                self._seq += 1
                spec = dataclasses.replace(
                    spec,
                    job_id=f"job-{int(self._clock() * 1000)}-{self._seq}",
                )
            job_id = spec.job_id
            existing = self._read_journal(job_id)
            if existing is not None:
                state = existing.get("state")
                if state in ("pending", "running") or (
                    state == "done"
                ):
                    return self.status(job_id)[1]
                # failed/cancelled: re-enqueue the journaled spec (NOT
                # the resubmitted one — the artifact cursor belongs to
                # the original plan)
                self._update(job_id, state="pending", error=None)
                if job_id not in self._queue:
                    self._queue.append(job_id)
                self._cancelled.discard(job_id)
                self._wake.notify_all()
                return self.status(job_id)[1]
            os.makedirs(self.job_dir(job_id), exist_ok=True)
            self._write_journal(job_id, {
                "spec": spec.to_doc(),
                "state": "pending",
                "created_unix": self._clock(),
                "records_done": 0,
                "records_total": None,
                "error": None,
            })
            self._queue.append(job_id)
            self._wake.notify_all()
        if self.metrics is not None:
            self.metrics.counter("batch_jobs_submitted_total").inc()
        return self.status(job_id)[1]

    def status(self, job_id: str) -> Tuple[int, dict]:
        doc = self._read_journal(job_id)
        if doc is None:
            return 404, {"error": f"no job {job_id!r}"}
        spec = doc.get("spec", {})
        out = {
            "job_id": job_id,
            "type": spec.get("type"),
            "state": doc.get("state"),
            "created_unix": doc.get("created_unix"),
            "updated_unix": doc.get("updated_unix"),
            "records_done": doc.get("records_done"),
            "records_total": doc.get("records_total"),
            "iteration": doc.get("iteration"),
            "error": doc.get("error"),
        }
        if doc.get("result"):
            out["result"] = doc["result"]
        return 200, out

    def list_jobs(self) -> dict:
        jobs = []
        try:
            entries = sorted(os.listdir(self.root))
        except OSError:
            entries = []
        for name in entries:
            status, doc = self.status(name)
            if status == 200:
                jobs.append(doc)
        jobs.sort(key=lambda d: d.get("created_unix") or 0)
        return {"jobs": jobs}

    def cancel(self, job_id: str) -> Tuple[int, dict]:
        with self._wake:
            doc = self._read_journal(job_id)
            if doc is None:
                return 404, {"error": f"no job {job_id!r}"}
            state = doc.get("state")
            if state in ("done", "failed", "cancelled"):
                return 409, {
                    "error": f"job {job_id} already {state}",
                    "state": state,
                }
            self._cancelled.add(job_id)
            if job_id in self._queue:
                # not yet running: settle it right here
                self._queue.remove(job_id)
                self._update(job_id, state="cancelled")
                self._cancelled.discard(job_id)
        return 200, self.status(job_id)[1]

    def artifact(self, job_id: str, offset: int = 0,
                 limit: int = _ARTIFACT_PAGE,
                 part: str = "data") -> Tuple[int, dict]:
        """One page of the finalized artifact, base64 in JSON (the
        front doors speak JSON; clients page by ``offset``, reassemble,
        and verify against ``data_crc32``).  ``part`` selects the data
        bytes (default) or the tokens sidecar, so a remote client can
        rebuild a complete, :func:`~gene2vec_tpu_torch.batch.artifact
        .load_graph`-loadable artifact dir."""
        doc = self._read_journal(job_id)
        if doc is None:
            return 404, {"error": f"no job {job_id!r}"}
        if doc.get("state") != "done":
            return 409, {
                "error": f"job {job_id} is {doc.get('state')}, not done",
                "state": doc.get("state"),
            }
        art = ChunkedArtifact(self.job_dir(job_id))
        manifest = art.manifest()
        if manifest is None:
            return 500, {"error": "done job has no artifact manifest"}
        if part == "data":
            path = art.data_path
        elif part == "tokens":
            path = os.path.join(self.job_dir(job_id), "TOKENS.txt")
            if not os.path.exists(path):
                return 404, {
                    "error": f"job {job_id} has no tokens sidecar "
                    f"({doc.get('spec', {}).get('type')} job)"
                }
        else:
            return 400, {"error": "part must be 'data' or 'tokens'"}
        offset = max(0, int(offset))
        limit = max(1, min(int(limit), _ARTIFACT_PAGE))
        total = os.path.getsize(path)
        with open(path, "rb") as f:
            f.seek(offset)
            blob = f.read(limit)
        return 200, {
            "job_id": job_id,
            "part": part,
            "offset": offset,
            "total_bytes": total,
            "data_crc32": manifest["data_crc32"],
            "chunks": manifest["chunks"],
            "records": manifest["records"],
            "meta": manifest.get("meta", {}),
            "data_b64": base64.b64encode(blob).decode("ascii"),
            "eof": offset + len(blob) >= total,
        }

    # -- the worker -------------------------------------------------------

    def _next_job(self) -> Optional[str]:
        with self._wake:
            while not self._queue and not self._stopping.is_set():
                self._wake.wait(timeout=0.5)
            if self._stopping.is_set():
                return None
            return self._queue.pop(0)

    def _is_cancelled(self, job_id: str) -> bool:
        with self._lock:
            return job_id in self._cancelled

    def _work(self) -> None:
        while not self._stopping.is_set():
            job_id = self._next_job()
            if job_id is None:
                return
            try:
                self._run_one(job_id)
            except Exception as e:  # a job bug must not kill the lane
                self._update(
                    job_id, state="failed",
                    error=f"worker crash: {e!r}",
                )
                self._count_done("failed")

    def _count_done(self, state: str) -> None:
        if self.metrics is not None:
            self.metrics.counter(
                "batch_jobs_completed_total", labels={"state": state}
            ).inc()
            self.metrics.gauge("batch_job_running").set(0)

    def _run_one(self, job_id: str) -> None:
        doc = self._read_journal(job_id)
        if doc is None:
            return
        spec = JobSpec(**(doc.get("spec") or {}))
        backend = self.backend_factory()
        # pin the iteration: a resumed job must extend bytes computed
        # against the SAME model or the artifact would silently mix
        # iterations
        expect = doc.get("iteration")
        if expect is not None and int(backend.iteration) != int(expect):
            self._update(
                job_id, state="failed",
                error=(
                    f"model swapped mid-job (journal iteration {expect}"
                    f", serving {backend.iteration}); resubmit under a "
                    "new job_id"
                ),
            )
            self._count_done("failed")
            return
        self._update(
            job_id, state="running", iteration=int(backend.iteration),
        )
        if self.metrics is not None:
            self.metrics.gauge("batch_job_running").set(1)

        def progress(done: int, total: int) -> None:
            self._update(
                job_id, records_done=done, records_total=total,
            )

        art = ChunkedArtifact(self.job_dir(job_id))
        pace = (
            self.pacer_factory(backend)
            if self.pacer_factory is not None
            else Pacer(guard=backend.pressure)
        )
        t0 = time.monotonic()
        try:
            with ambient_span(
                "batch_job", job=job_id, type=spec.type,
            ) as span:
                result = run_job(
                    spec, backend, art,
                    metrics=self.metrics,
                    should_stop=lambda: (
                        self._is_cancelled(job_id)
                        or self._stopping.is_set()
                    ),
                    pace=pace,
                    progress=progress,
                )
                span["records"] = result["records"]
        except JobCancelled:
            if self._stopping.is_set():
                # shutdown, not cancellation: stay "running" so the
                # next start() resumes from the committed cursor
                return
            self._update(job_id, state="cancelled")
            with self._lock:
                self._cancelled.discard(job_id)
            self._count_done("cancelled")
            return
        except (ChunkFailed, ValueError, OSError) as e:
            self._update(job_id, state="failed", error=str(e))
            self._count_done("failed")
            return
        self._update(
            job_id, state="done",
            records_done=result["records"],
            records_total=result["records"],
            result={
                "rows_per_sec": result["rows_per_sec"],
                "wall_s": result["wall_s"],
                "yielded_s": result["yielded_s"],
                "chunks": result["chunks"],
                "data_bytes": result["data_bytes"],
                "resumed_records": result["resumed_records"],
            },
        )
        with self._lock:
            self._cancelled.discard(job_id)
        self._count_done("done")
        if self.metrics is not None:
            self.metrics.gauge("batch_job_rows_per_sec").set(
                result["rows_per_sec"]
            )
            self.metrics.histogram("batch_job_seconds").observe(
                time.monotonic() - t0
            )


# -- the shared /v1/jobs route table ------------------------------------------


def dispatch_jobs(
    manager: Optional[JobManager], method: str, route: str,
    query: Dict[str, List[str]], body: Optional[dict],
) -> Tuple[int, dict]:
    """Map one ``/v1/jobs`` request onto a manager — shared by the
    single-replica server and the fleet front door so both speak the
    identical lifecycle contract."""
    if manager is None:
        return 404, {
            "error": "batch jobs disabled (start with --jobs-dir)"
        }
    if route == "/v1/jobs":
        if method == "POST":
            try:
                spec = JobSpec.from_body(body or {})
            except ValueError as e:
                return 400, {"error": str(e)}
            return 200, manager.submit(spec)
        if method == "GET":
            return 200, manager.list_jobs()
        return 404, {"error": f"no route {method} {route}"}
    parts = route.split("/")
    # ["", "v1", "jobs", <id>] or ["", "v1", "jobs", <id>, <verb>]
    if len(parts) < 4 or not _JOB_ID_RE.match(parts[3]):
        return 404, {"error": f"no route {method} {route}"}
    job_id = parts[3]
    verb = parts[4] if len(parts) == 5 else None
    if verb is None and method == "GET":
        return manager.status(job_id)
    if verb == "cancel" and method == "POST":
        return manager.cancel(job_id)
    if verb == "artifact" and method == "GET":
        try:
            offset = int(query.get("offset", ["0"])[0])
            limit = int(query.get("limit", [str(_ARTIFACT_PAGE)])[0])
        except ValueError:
            return 400, {"error": "offset/limit must be integers"}
        if offset < 0 or limit < 1:
            return 400, {"error": "offset must be >= 0, limit >= 1"}
        part = query.get("part", ["data"])[0]
        return manager.artifact(job_id, offset, limit, part=part)
    return 404, {"error": f"no route {method} {route}"}
