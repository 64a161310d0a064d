"""Bucketed top-k cosine similarity on the port's serving kernels.

The reference (``gene2vec_tpu/serve/engine.py``) binds one jitted
program per index mode and pads batch and ``k`` to powers of two so its
jit cache stays bounded.  The port runs the same bucketed shapes through
hand-written kernels (``kernels/``), one per stage:

* ``exact`` — K7 ``topk_exact`` over the float32 unit matrix;
* ``quant`` — K8 ``quant_scan`` (int8 full-table scan, approximate
  top-``rb``) then K9r ``rescore`` (exact float32 rescore, top-``kb``);
* ``ivf`` — K9 ``ivf_scan`` (centroid probe, int8 candidate scan,
  approximate top-``rb``) then K9r ``rescore``.

Tensors on the CPU take the kernels' plain versions; on the card the
kernels run, or the call raises.  :meth:`BucketedTopKEngine.cache_sizes`
counts the distinct (bucket, kb, rb) shapes launched per mode — what the
reference's jit cache held.  :meth:`BucketedTopKEngine.profile_buckets`
counts each bucket's kernel work from shapes (``obs/profiler.py``).  The
mesh (row-sharded tables) waits for the port of ``parallel/``.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Set, Tuple

import numpy as np
import torch

from gene2vec_tpu_torch.kernels import ivf_scan, quant_scan, rescore, topk_exact
from gene2vec_tpu_torch.obs.trace import ambient_span
from gene2vec_tpu_torch.serve.ann import INDEX_MODES, AnnIndex

_EPS = 1e-12


def next_pow2(n: int) -> int:
    """Smallest power of two >= n (n >= 1)."""
    return 1 << max(0, int(n) - 1).bit_length()


def normalize_queries(queries: np.ndarray) -> np.ndarray:
    """``q / max(‖q‖, 1e-12)`` per row, on the host: the approximate
    kernels take normalized queries, as the reference's scans do."""
    norms = np.sqrt(np.sum(queries * queries, axis=1, keepdims=True))
    return (queries / np.maximum(norms, _EPS)).astype(np.float32)


class BucketedTopKEngine:
    """Bucketed batched top-k over a device-resident unit matrix, with an
    optional quantized/IVF path (``index=``) whose candidates are always
    exactly rescored before anything is returned.  ``nprobe`` (IVF lists
    probed per query) and ``rescore_mult`` (``rb = rescore_mult * kb``)
    are the recall/latency knobs."""

    def __init__(
        self,
        max_batch: int = 64,
        index: str = "exact",
        nprobe: int = 8,
        rescore_mult: int = 4,
    ):
        if max_batch < 1:
            raise ValueError(f"max_batch must be >= 1, got {max_batch}")
        if index not in INDEX_MODES:
            raise ValueError(f"index must be one of {INDEX_MODES}, got {index!r}")
        if nprobe < 1 or rescore_mult < 1:
            raise ValueError("nprobe and rescore_mult must be >= 1")
        self.max_batch = next_pow2(max_batch)
        #: ascending padded batch shapes
        self.buckets: Tuple[int, ...] = tuple(
            1 << e for e in range(self.max_batch.bit_length())
        )
        self.index_mode = index
        self.nprobe = int(nprobe)
        self.rescore_mult = int(rescore_mult)
        #: distinct (bucket, kb, rb) shapes launched, per mode
        self._shapes: Dict[str, Set[Tuple]] = {"exact": set()}
        #: records of :meth:`profile_buckets`, by kernel name
        self._kernel_costs: Dict[str, Dict] = {}

    # -- shape accounting --------------------------------------------------

    def cache_sizes(self) -> Dict[str, Optional[int]]:
        """Distinct (bucket, kb, rb) shapes launched per index mode
        (``exact`` always; approximate modes once used)."""
        return {mode: len(shapes) for mode, shapes in self._shapes.items()}

    def cache_size(self, mode: Optional[str] = None) -> Optional[int]:
        """One mode's shape count, or the sum over all modes."""
        sizes = self.cache_sizes()
        if mode is not None:
            return sizes.get(mode)
        return sum(sizes.values())

    def _note_shape(self, mode: str, shape: Tuple) -> None:
        self._shapes.setdefault(mode, set()).add(shape)

    # -- bucketing ---------------------------------------------------------

    def bucket(self, n: int) -> int:
        """Padded batch size for ``n`` queries."""
        if n > self.max_batch:
            raise ValueError(f"{n} queries exceed max_batch={self.max_batch}")
        return next_pow2(max(1, n))

    def k_bucket(self, k: int, vocab_size: int) -> int:
        """Padded k: next power of two, capped at the vocab."""
        return min(next_pow2(max(1, k)), vocab_size)

    def r_bucket(self, kb: int, vocab_size: int) -> int:
        """Padded rescore-tail size: ``rescore_mult * kb`` rounded to the
        next power of two, capped at the vocab."""
        return min(next_pow2(max(kb, self.rescore_mult * kb)), vocab_size)

    def _pad_queries(self, queries: np.ndarray) -> Tuple[np.ndarray, int]:
        queries = np.atleast_2d(np.asarray(queries, dtype=np.float32))
        n = queries.shape[0]
        b = self.bucket(n)
        if b != n:
            queries = np.concatenate(
                [queries, np.zeros((b - n, queries.shape[1]), np.float32)]
            )
        return queries, n

    @staticmethod
    def _valid_arg(unit, valid: Optional[int]) -> Optional[int]:
        return int(valid) if valid is not None and valid < int(unit.shape[0]) else None

    # -- exact path --------------------------------------------------------

    def top_k(
        self, unit: torch.Tensor, queries: np.ndarray, k: int,
        valid: Optional[int] = None,
    ) -> Tuple[np.ndarray, np.ndarray]:
        """Top-k cosine matches of ``queries`` (n, D) against ``unit``
        (V, D): (n, k) float32 scores and (n, k) int row indices, cropped
        back from the padded shapes.  ``valid`` is the real row count when
        ``unit`` carries pad rows."""
        queries, n = self._pad_queries(queries)
        vocab_size = int(valid if valid is not None else unit.shape[0])
        k = min(int(k), vocab_size)
        if k < 1:
            raise ValueError(f"k must be >= 1, got {k}")
        kb = self.k_bucket(k, vocab_size)
        valid_arg = self._valid_arg(unit, valid)
        self._note_shape("exact", (queries.shape[0], kb, None))
        with ambient_span("engine_topk", batch=queries.shape[0], k=kb):
            q = torch.from_numpy(queries).to(unit.device)
            scores, idx = topk_exact.topk_exact(unit, q, kb, valid_arg)
            scores, idx = scores.cpu().numpy(), idx.cpu().numpy()
        return scores[:n, :k], idx[:n, :k]

    # -- approximate path --------------------------------------------------

    def top_k_ann(
        self, index: AnnIndex, unit: torch.Tensor, queries: np.ndarray, k: int,
        valid: Optional[int] = None,
    ) -> Tuple[np.ndarray, np.ndarray]:
        """Approximate top-k through a built :class:`AnnIndex` — the same
        contract and padding as :meth:`top_k`; the candidates are rescored
        exactly, so returned scores are exact cosines."""
        queries, n = self._pad_queries(queries)
        vocab_size = int(valid if valid is not None else unit.shape[0])
        k = min(int(k), vocab_size)
        if k < 1:
            raise ValueError(f"k must be >= 1, got {k}")
        kb = self.k_bucket(k, vocab_size)
        rb = self.r_bucket(kb, vocab_size)
        valid_arg = self._valid_arg(unit, valid)
        qn = torch.from_numpy(normalize_queries(queries)).to(unit.device)
        with ambient_span("engine_topk", batch=queries.shape[0], k=kb, index=index.mode):
            if index.mode == "quant":
                rs, ri = quant_scan.quant_scan(
                    qn, index.table_q, index.scale, rb, valid_arg
                )
            elif index.mode == "ivf":
                # enough probes that the candidate pool can cover kb even
                # on tiny tables; fixed per (kb, geometry)
                nprobe = min(self.nprobe, index.n_clusters)
                if index.list_len:
                    need = -(-kb // index.list_len)  # ceil
                    nprobe = min(max(nprobe, need), index.n_clusters)
                rs, ri = ivf_scan.ivf_scan(
                    qn, index.centroids, index.lists, index.table_q, index.scale,
                    nprobe, rb, valid_arg,
                )
            else:
                raise ValueError(f"AnnIndex mode {index.mode!r} is not approximate")
            self._note_shape(index.mode, (queries.shape[0], kb, rb))
            scores, idx = rescore.rescore(qn, unit, ri, rs, kb)
            scores, idx = scores.cpu().numpy(), idx.cpu().numpy()
        return scores[:n, :k], idx[:n, :k]

    # -- kernel attribution -----------------------------------------------

    def _nprobe(self, kb: int, index: AnnIndex) -> int:
        """The lists a query probes at ``kb``, as :meth:`top_k_ann` sets it."""
        nprobe = min(self.nprobe, index.n_clusters)
        if index.list_len:
            nprobe = min(max(nprobe, -(-kb // index.list_len)), index.n_clusters)
        return nprobe

    def bucket_work(self, b: int, kb: int, rb: int, rows: int, dim: int, valid: int,
                    ann_index: Optional[AnnIndex] = None) -> dict:
        """The work (``kernels/_work.py``) of one batch of bucket ``b`` in
        this engine's mode, from shapes: K7 over ``rows`` unit rows; K8 or
        K9, then K9r over ``b``·r candidates on at most ``valid`` distinct
        rows.  K9's candidates are the probed lists' mean fill (the
        index's filled slots over its lists) a probe."""
        from gene2vec_tpu_torch.obs.profiler import add_work

        mode = self.index_mode
        if mode == "exact":
            return topk_exact.work(rows, dim, b, kb)
        kind = "int8" if ann_index.table_q.dtype == torch.int8 else "bfloat16"
        if mode == "quant":
            r = rb
            total = quant_scan.work(rows, dim, b, rb, kind)
        else:
            nprobe = self._nprobe(kb, ann_index)
            c, lst = ann_index.n_clusters, ann_index.list_len
            r = min(rb, nprobe * lst)
            n_cand = b * nprobe * int((ann_index.lists >= 0).sum()) / c
            total = ivf_scan.work(b, dim, c, nprobe, lst, r, n_cand,
                                  min(valid, int(n_cand)), kind)
        return add_work(dict(total), rescore.work(b, dim, r, kb, b * r, min(valid, b * r)))

    def profile_buckets(self, unit, valid: Optional[int] = None, k: int = 16,
                        ann_index: Optional[AnnIndex] = None,
                        buckets: Optional[Sequence[int]] = None) -> Dict[str, Dict]:
        """Each batch bucket's kernel work in the active index mode, counted
        from shapes (:meth:`bucket_work`) — it launches no kernel, so the
        launch counters stay as they were — recorded under
        ``serve_topk_<mode>/b<bucket>`` with ``bucket``, ``k_bucket`` and
        ``mode`` (the reference's AOT compile per bucket; here ``flops``
        and ``bytes_accessed``, ``lower_s`` and ``compile_s`` null: no
        program is compiled).  Kept for :meth:`kernel_costs`; an
        approximate mode needs its :class:`AnnIndex`."""
        from gene2vec_tpu_torch.obs import profiler as prof

        mode = self.index_mode
        if mode != "exact" and ann_index is None:
            raise ValueError(f"profile_buckets needs an AnnIndex for mode {mode!r}")
        rows, dim = (int(s) for s in unit.shape)
        vocab_size = int(valid if valid is not None else rows)
        kb = self.k_bucket(max(1, min(int(k), vocab_size)), vocab_size)
        rb = self.r_bucket(kb, vocab_size)
        p = prof.KernelProfiler(backend={"platform": None, "device_kind": None})
        out: Dict[str, Dict] = {}
        for b in tuple(buckets) if buckets else self.buckets:
            b = int(b)
            name = f"serve_topk_{mode}/b{b}"
            p.register_costs(name, prof.costs(self.bucket_work(b, kb, rb, vocab_size, dim,
                                                               vocab_size, ann_index)))
            rec = dict(p.records()[-1])
            rec.update(bucket=b, k_bucket=kb, mode=mode)
            out[name] = rec
        self._kernel_costs.update(out)
        return out

    def kernel_costs(self) -> Dict[str, Dict]:
        """Records of :meth:`profile_buckets` so far, by kernel name
        (copies)."""
        return {k: dict(v) for k, v in self._kernel_costs.items()}

    # -- model-level entry points ------------------------------------------

    def topk_rows(self, model, queries: np.ndarray, k: int) -> Tuple[np.ndarray, np.ndarray]:
        """Top-k with global row ids: ``(n, k')`` float32 scores and int64
        rows, ``k' = min(k, len(model))``, offset by the snapshot's
        ``row_base``; routed through the snapshot's index like
        :meth:`similar_batch`."""
        queries = np.atleast_2d(np.asarray(queries, dtype=np.float32))
        k = min(int(k), len(model))
        scores, idx = self._route(model, queries, k)
        rows = idx.astype(np.int64) + int(getattr(model, "row_base", 0) or 0)
        return scores, rows

    def _route(self, model, queries: np.ndarray, k: int):
        index = getattr(model, "ann", None)
        if self.index_mode != "exact" and index is not None:
            return self.top_k_ann(index, model.unit, queries, k, valid=len(model))
        return self.top_k(model.unit, queries, k, valid=len(model))

    def similar_batch(
        self, model, queries: Sequence[np.ndarray], k: int,
    ) -> List[List[Tuple[str, float]]]:
        """Neighbor lists for raw query vectors against one
        :class:`~gene2vec_tpu_torch.serve.registry.LoadedModel`: per
        query, ``k`` (token, cosine) pairs, best first.  Through the
        snapshot's index when this engine runs an approximate mode and the
        snapshot carries one; otherwise exact."""
        if not queries:
            return []
        scores, idx = self._route(model, np.stack(queries), k)
        tokens = model.tokens
        return [
            [(tokens[int(j)], float(s)) for j, s in zip(row_i, row_s)]
            for row_i, row_s in zip(idx, scores)
        ]


#: historical name, as in the reference
SimilarityEngine = BucketedTopKEngine
