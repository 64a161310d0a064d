"""Model registry: checkpoint discovery, device-resident tables, hot swap —
the port of ``gene2vec_tpu/serve/registry.py`` without the mesh and
partition-rule placement.

The registry watches one ``<export_dir>`` written by either package's
``io/checkpoint.py`` (``gene2vec_dim_<D>_iter_<N>.npz`` + ``vocab.tsv``),
loads the newest verified iteration into an immutable
:class:`LoadedModel` — the raw float32 host table for ``/v1/embedding``
plus an L2-normalized copy on the registry's device for the top-k
kernels — and swaps it in atomically: readers take one reference
(:attr:`ModelRegistry.model`) and every field they touch belongs to the
same iteration.  Export dirs with only the text exports load through the
word2vec-format twin (``*_w2v.txt``).

Row shards: ``ModelRegistry(shard=(i, n))`` loads only the contiguous
row range ``shard_ranges(V, n)[i]`` of the table (one seek and one read
of the uncompressed npz, ``io/checkpoint.py:read_npz_rows``) and builds
its ANN index over that slice alone, so only the shard's rows reach the
card.  A sharded registry never swaps on its own: the fleet's swap
coordinator stages an iteration on every shard and then flips them all
under one epoch token (:meth:`ModelRegistry.stage`, :meth:`flip`).

Crash safety: discovery is manifest-verified, so a torn newest export is
never read; a checkpoint that verifies but fails to load is retried with
exponential backoff and quarantined after ``quarantine_after``
consecutive failures, while the last good snapshot keeps serving.
"""

from __future__ import annotations

import dataclasses
import json
import os
import threading
import time
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from gene2vec_tpu_torch.device import resolve_device
from gene2vec_tpu_torch.io.checkpoint import (
    iter_checkpoints_newest_first,
    read_npz_rows,
    vocab_path_for,
)
from gene2vec_tpu_torch.io.emb_io import read_word2vec_format
from gene2vec_tpu_torch.obs.trace import ambient_span, get_tracer
from gene2vec_tpu_torch.parallel.sharding import shard_ranges
from gene2vec_tpu_torch.resilience.snapshot import stat_sig
from gene2vec_tpu_torch.serve.ann import INDEX_MODES, AnnIndex, build_index


def _trace_event(name: str, **attrs) -> None:
    tracer = get_tracer()
    if tracer is not None:
        tracer.event(name, **attrs)


def l2_normalize(matrix: np.ndarray, eps: float = 1e-12) -> np.ndarray:
    """Unit-normalize rows (zero rows stay zero)."""
    matrix = np.asarray(matrix, dtype=np.float32)
    norms = np.linalg.norm(matrix, axis=1, keepdims=True)
    return matrix / np.maximum(norms, eps)


@dataclasses.dataclass(frozen=True)
class LoadedModel:
    """One immutable loaded iteration.  ``unit`` is the L2-normalized
    (V, D) float32 tensor on the registry's device that the kernels
    score against; ``emb`` is the raw host table ``/v1/embedding``
    serves; ``ann`` is the index built for exactly this table (None
    under ``--index exact``), so one reference swaps table and index
    together."""

    dim: int
    iteration: int
    tokens: Tuple[str, ...]
    index: Dict[str, int]
    emb: np.ndarray
    unit: torch.Tensor
    source: str
    meta: Dict
    ann: Optional[AnnIndex] = None
    #: global row offset of this table's first row (0 unsharded): the
    #: engine's local indices + row_base are the global ids a shard
    #: replica answers with
    row_base: int = 0
    #: the whole table's row count (a shard holds a slice of it)
    total_rows: Optional[int] = None
    #: the swap token stamped by :meth:`ModelRegistry.flip`
    epoch: Optional[int] = None
    #: checkpoint mtime at load (the model-age gauge)
    created_unix: float = 0.0

    @property
    def version(self) -> Tuple[int, int]:
        return (self.dim, self.iteration)

    def __len__(self) -> int:
        return len(self.tokens)


def discover_candidates(export_dir: str, dim: Optional[int] = None,
                        verified_only: bool = True):
    """Lazy iterator of loadable ``(dim, iteration, path)`` candidates,
    newest first (highest iteration; among equal iterations the largest
    dim).  ``verified_only`` filters through the checkpoint manifests."""
    return iter_checkpoints_newest_first(
        export_dir, text_fallback=True, verified_only=verified_only, dim=dim
    )


def discover_newest(export_dir: str, dim: Optional[int] = None,
                    verified_only: bool = True) -> Optional[Tuple[int, int, str]]:
    """Newest verified ``(dim, iteration, path)`` in ``export_dir``."""
    return next(discover_candidates(export_dir, dim, verified_only), None)


def _read_vocab_lines(ckpt_path: str) -> List[str]:
    """The vocab's non-empty lines for a checkpoint (id order is row
    order), from the per-iteration sidecar when the vocab was
    tail-extended; split in one call, not line by line (a shard of a
    10M-row table reads the whole vocab to find its own rows)."""
    with open(vocab_path_for(ckpt_path), "r", encoding="utf-8") as f:
        return [line for line in f.read().split("\n") if line]


def _read_vocab_tokens(ckpt_path: str) -> List[str]:
    """The vocab token list for a checkpoint."""
    return [line.split("\t", 1)[0] for line in _read_vocab_lines(ckpt_path)]


def _load_npz(path: str) -> Tuple[List[str], np.ndarray, Dict]:
    with np.load(path) as z:
        meta = json.loads(str(z["meta"])) if "meta" in z.files else {}
        emb = np.asarray(z["emb"], dtype=np.float32)
    tokens = _read_vocab_tokens(path)
    if len(tokens) != emb.shape[0]:
        raise ValueError(
            f"{path}: {emb.shape[0]} embedding rows vs {len(tokens)} "
            "vocab tokens in vocab.tsv"
        )
    return tokens, emb, meta


def _file_age_base(path: str) -> float:
    try:
        return os.path.getmtime(path)
    except OSError:
        return 0.0


class ModelRegistry:
    """Discovers, loads and hot-swaps checkpoints from one export dir.

    ``device`` places the unit matrix and the index (``cuda`` unless
    ``"cpu"`` is asked for).  ``metrics`` (an obs ``MetricsRegistry``)
    receives ``model_iteration`` / ``model_vocab_size`` /
    ``model_quarantined`` gauges and ``model_swaps_total`` /
    ``model_load_failures_total`` counters.  ``index_mode``
    (exact|quant|ivf) builds a ``serve/ann.py`` index per loaded
    checkpoint; IVF centroids cache under ``<export_dir>/ann_cache``
    keyed by the table CRC, in the reference's file layout.

    A candidate that fails to load is retried with exponential backoff
    (``retry_backoff_s`` doubling per failure, capped at 5 min) and
    quarantined after ``quarantine_after`` failures; ``refresh`` then
    falls back to the next-newest verified candidate.

    ``name`` is the catalog model name this registry serves
    (``serve/catalog.py``).  Under a name other than ``"default"`` the
    failure and quarantine series gain a ``{model=}`` twin and the trace
    events a ``model`` attribute; the default name keeps the unlabeled
    series as the only ones, so a single-model scrape is unchanged.
    """

    def __init__(
        self,
        export_dir: str,
        dim: Optional[int] = None,
        metrics=None,
        retry_backoff_s: float = 2.0,
        quarantine_after: int = 3,
        index_mode: str = "exact",
        ann_clusters: Optional[int] = None,
        device=None,
        shard: Optional[Tuple[int, int]] = None,
        name: str = "default",
    ):
        if index_mode not in INDEX_MODES:
            raise ValueError(f"index_mode must be one of {INDEX_MODES}, got {index_mode!r}")
        if shard is not None:
            idx, n = int(shard[0]), int(shard[1])
            if n < 1 or not 0 <= idx < n:
                raise ValueError(
                    f"shard must be (index, num_shards) with 0 <= index < num_shards, "
                    f"got {shard!r}"
                )
            shard = (idx, n)
        self.device = resolve_device(device)
        self.export_dir = export_dir
        self.dim = dim
        self.name = str(name)
        #: the extra label set of the failure/quarantine series: None under
        #: the default name, so a single-model deployment's are unchanged
        self._mlabels = {"model": self.name} if self.name != "default" else None
        self.metrics = metrics
        self.retry_backoff_s = retry_backoff_s
        self.quarantine_after = quarantine_after
        self.index_mode = index_mode
        self.ann_clusters = ann_clusters
        #: (shard_index, num_shards): load only that contiguous row range
        #: of the table and index it alone; swaps are stage/flip only
        self.shard = shard
        self._model: Optional[LoadedModel] = None
        self._staged: Optional[LoadedModel] = None
        self._refresh_lock = threading.Lock()
        self._watcher: Optional[threading.Thread] = None
        self._stop = threading.Event()
        # path -> (consecutive failures, stat signature at last failure):
        # verdicts apply to BYTES, not names
        self._failures: Dict[str, Tuple[int, Optional[Tuple]]] = {}
        self._next_retry: Dict[str, float] = {}
        self._quarantined: Dict[str, Tuple[str, Optional[Tuple]]] = {}

    # -- reading -----------------------------------------------------------

    @property
    def model(self) -> LoadedModel:
        """The current model (immutable: hold the reference for one
        request and every field is from the same iteration)."""
        m = self._model
        if m is None:
            raise RuntimeError(
                f"no checkpoint loaded yet from {self.export_dir!r} "
                "(call refresh() or check the export dir)"
            )
        return m

    @property
    def loaded(self) -> bool:
        return self._model is not None

    # -- loading / swapping ------------------------------------------------

    def _load_shard_npz(self, path: str):
        """(tokens, emb, meta, row_base, total_rows) of this shard's row
        range, read without materializing the whole table; None for an
        npz it cannot seek (the caller then loads it whole and slices)."""
        idx, n = self.shard
        try:
            _, total_rows = read_npz_rows(path, "emb", 0, 0)
            row_base, end = shard_ranges(total_rows, n)[idx]
            emb, _ = read_npz_rows(path, "emb", row_base, end)
        except ValueError:
            return None
        with np.load(path) as z:
            # members load lazily: this reads the small meta entry only
            meta = json.loads(str(z["meta"])) if "meta" in z.files else {}
        lines = _read_vocab_lines(path)
        if len(lines) != total_rows:
            raise ValueError(
                f"{path}: {total_rows} embedding rows vs {len(lines)} vocab tokens"
            )
        tokens = [line.split("\t", 1)[0] for line in lines[row_base:end]]
        return tokens, np.asarray(emb, dtype=np.float32), meta, row_base, total_rows

    def _load(self, dim: int, iteration: int, path: str) -> LoadedModel:
        with ambient_span("model_load", dim=dim, iteration=iteration, path=path):
            loaded = None
            if self.shard is not None and path.endswith(".npz"):
                loaded = self._load_shard_npz(path)
            if loaded is not None:
                tokens, emb, meta, row_base, total_rows = loaded
            else:
                if path.endswith(".npz"):
                    tokens, emb, meta = _load_npz(path)
                else:
                    tokens, emb = read_word2vec_format(path)
                    meta = {"dim": dim, "iteration": iteration, "format": "w2v"}
                total_rows, row_base = emb.shape[0], 0
                if self.shard is not None:
                    row_base, end = shard_ranges(total_rows, self.shard[1])[self.shard[0]]
                    tokens = tokens[row_base:end]
                    emb = np.ascontiguousarray(emb[row_base:end])
            unit_np = l2_normalize(emb)
            ann = None
            if self.index_mode in ("quant", "ivf"):
                with ambient_span("ann_build", mode=self.index_mode, dim=dim,
                                  iteration=iteration):
                    ann = build_index(
                        unit_np,
                        self.index_mode,
                        clusters=self.ann_clusters,
                        cache_dir=os.path.join(self.export_dir, "ann_cache"),
                        tag=f"dim{dim}_iter{iteration}" + (
                            f"_shard{self.shard[0]}of{self.shard[1]}"
                            if self.shard is not None else ""),
                        version=(dim, iteration),
                        device=self.device,
                    )
                if self.metrics is not None:
                    self.metrics.gauge("ann_build_seconds").set(ann.build_seconds)
                    self.metrics.counter(
                        "ann_cache_hits_total" if ann.built_from_cache else "ann_builds_total"
                    ).inc()
            unit = torch.from_numpy(unit_np).to(self.device)
        return LoadedModel(
            dim=dim,
            iteration=iteration,
            tokens=tuple(tokens),
            index={tok: i for i, tok in enumerate(tokens)},
            emb=emb,
            unit=unit,
            source=path,
            meta=meta,
            ann=ann,
            row_base=row_base,
            total_rows=total_rows,
            # a shard's swap token is the iteration (the coordinator flips
            # every shard to it together)
            epoch=iteration if self.shard is not None else None,
            created_unix=_file_age_base(path),
        )

    def _record_failure(self, path: str, err: BaseException) -> None:
        n = self._failures.get(path, (0, None))[0] + 1
        self._failures[path] = (n, stat_sig(path))
        self._next_retry[path] = time.monotonic() + min(
            self.retry_backoff_s * (2 ** (n - 1)), 300.0
        )
        if self.metrics is not None:
            self._count_labeled("model_load_failures_total")
        _trace_event("model_load_error", **self._model_attr(), path=path,
                     attempt=n, error=repr(err)[:200])
        if n >= self.quarantine_after and path not in self._quarantined:
            self._quarantined[path] = (repr(err)[:200], stat_sig(path))
            _trace_event("model_quarantined", **self._model_attr(), path=path,
                         error=repr(err)[:200])
            if self.metrics is not None:
                self._gauge_labeled("model_quarantined", len(self._quarantined))

    def _model_attr(self) -> Dict[str, str]:
        return dict(self._mlabels) if self._mlabels is not None else {}

    def _count_labeled(self, metric: str) -> None:
        """The unlabeled series and, under a catalog name, its
        ``{model=}`` twin."""
        self.metrics.counter(metric).inc()
        if self._mlabels is not None:
            self.metrics.counter(metric, labels=self._mlabels).inc()

    def _gauge_labeled(self, metric: str, value: float) -> None:
        self.metrics.gauge(metric).set(value)
        if self._mlabels is not None:
            self.metrics.gauge(metric, labels=self._mlabels).set(value)

    def _clear_failure_state(self, path: str) -> None:
        self._failures.pop(path, None)
        self._next_retry.pop(path, None)
        if self._quarantined.pop(path, None) is not None:
            _trace_event("model_quarantine_cleared", **self._model_attr(), path=path)
            if self.metrics is not None:
                self._gauge_labeled("model_quarantined", len(self._quarantined))

    def _skip_for_failures(self, path: str, now: float) -> bool:
        """Whether refresh passes over this candidate: quarantine or an
        open backoff window — unless its bytes changed since."""
        recorded = self._quarantined.get(path) or self._failures.get(path)
        if recorded is None:
            return False
        if stat_sig(path) != recorded[1]:
            self._clear_failure_state(path)
            return False
        if path in self._quarantined:
            return True
        return now < self._next_retry.get(path, 0.0)

    def _gc_failure_state(self) -> None:
        for path in list(self._failures) + list(self._quarantined):
            if not os.path.exists(path):
                self._clear_failure_state(path)

    @property
    def quarantined(self) -> Dict[str, str]:
        """Quarantined checkpoint paths → last error."""
        return {p: reason for p, (reason, _) in self._quarantined.items()}

    def refresh(self) -> bool:
        """Load and atomically swap in the newest verified candidate newer
        than the served one, falling back through older candidates when
        the newest fails to load.  Returns whether a swap happened; load
        failures are counted and backed off, not raised."""
        with self._refresh_lock:
            self._gc_failure_state()
            cur = self._model
            now = time.monotonic()
            model = None
            for dim, iteration, path in discover_candidates(self.export_dir, self.dim):
                if cur is not None and (iteration, dim) <= (cur.iteration, cur.dim):
                    break  # nothing newer than the served model remains
                if self._skip_for_failures(path, now):
                    continue
                try:
                    model = self._load(dim, iteration, path)
                except Exception as e:
                    self._record_failure(path, e)
                    continue
                self._clear_failure_state(path)
                break
            if model is None:
                return False
            # one reference assignment IS the swap
            self._model = model
        self._publish(model)
        return True

    # -- staged swap -------------------------------------------------------

    def stage(self, dim: int, iteration: int) -> LoadedModel:
        """Load ``(dim, iteration)`` into the staging slot without serving
        it; raises on any failure."""
        with self._refresh_lock:
            staged = self._staged
            if staged is not None and staged.version == (dim, iteration):
                return staged
            for d, it, path in discover_candidates(self.export_dir, dim):
                if (d, it) == (dim, iteration):
                    model = self._load(d, it, path)
                    self._staged = model
                    if self.metrics is not None:
                        self.metrics.gauge("model_staged_iteration").set(iteration)
                    return model
            raise FileNotFoundError(
                f"no verified checkpoint dim={dim} iteration={iteration} "
                f"in {self.export_dir!r} to stage"
            )

    def flip(self, epoch: int) -> LoadedModel:
        """Atomically swap the staged model in, stamped with ``epoch``;
        idempotent when the served model already carries it."""
        with self._refresh_lock:
            cur = self._model
            if cur is not None and cur.epoch == epoch:
                return cur
            staged = self._staged
            if staged is None or staged.iteration != epoch:
                raise RuntimeError(
                    f"no staged model for epoch {epoch} "
                    f"(staged: {staged.version if staged else None})"
                )
            model = dataclasses.replace(staged, epoch=epoch)
            self._model = model
            self._staged = None
        self._publish(model)
        if self.metrics is not None:
            self.metrics.gauge("model_epoch").set(epoch)
        return model

    def _publish(self, model: LoadedModel) -> None:
        """The swap's metrics: one more swap, the served iteration and
        vocab size."""
        if self.metrics is not None:
            self.metrics.counter("model_swaps_total").inc()
            self.metrics.gauge("model_iteration").set(model.iteration)
            self.metrics.gauge("model_vocab_size").set(len(model))

    # -- watching ----------------------------------------------------------

    def start_watcher(self, interval_s: float = 5.0) -> None:
        """Poll :meth:`refresh` every ``interval_s`` on a daemon thread."""
        if self._watcher is not None:
            return
        self._stop.clear()

        def loop() -> None:
            while not self._stop.wait(interval_s):
                try:
                    self.refresh()
                except Exception as e:
                    if self.metrics is not None:
                        self.metrics.counter("model_refresh_errors_total").inc()
                    _trace_event("model_refresh_error", error=repr(e)[:200])

        self._watcher = threading.Thread(target=loop, name="model-registry-watcher",
                                         daemon=True)
        self._watcher.start()

    def stop_watcher(self) -> None:
        if self._watcher is None:
            return
        self._stop.set()
        self._watcher.join(timeout=5.0)
        self._watcher = None
