"""Approximate + quantized retrieval: the index half of
``gene2vec_tpu/serve/ann.py``, with the scans moved to the kernels.

* **Quantized scoring table** — int8 symmetric per-row quantization of
  the unit matrix (``q[i] = rint(unit[i] / scale[i])``, ``scale[i] =
  max|unit[i]| / 127``) with a float32 scale vector, or a bf16 table.
  The approximate scan (K8, ``kernels/quant_scan.py``) scores queries in
  the compressed domain, and its top-``r`` candidates are exactly
  rescored against the float32 unit rows (K9r, ``kernels/rescore.py``).
* **IVF two-stage index** — spherical k-means centroids built on the
  host (numpy, byte for byte the reference's, cached beside the
  checkpoint keyed by table CRC) and capacity-capped inverted lists;
  a query probes the ``nprobe`` nearest lists (K9,
  ``kernels/ivf_scan.py``) and rescores the approximate top-``r``.

The host build (``table_crc`` .. ``build_lists``, the centroid cache,
``bytes_per_query``, the oracles) is a copy of the reference's, so the
same seed gives the same centroids and lists and either package reads
the other's cache.  :class:`AnnIndex` holds torch tensors on the
engine's device; :func:`build_index` places them there.
"""

from __future__ import annotations

import dataclasses
import json
import os
import time
import zlib
from typing import Dict, Mapping, Optional, Tuple

import numpy as np
import torch

from gene2vec_tpu_torch.device import resolve_device

INDEX_MODES = ("exact", "quant", "ivf")

#: quantized-table widths build_index accepts
QUANT_DTYPES = ("int8", "bf16")

_EPS = 1e-12


# -- host-side build (copies of the reference's) ----------------------------


def table_crc(unit: np.ndarray) -> int:
    """CRC32 of the table bytes — the cache key that pins a built index
    to exactly the table it was built from."""
    return zlib.crc32(np.ascontiguousarray(unit, dtype=np.float32)) & 0xFFFFFFFF


def quantize_rows(x: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """Symmetric per-row int8 quantization: ``(q, scale)`` with
    ``q * scale[:, None] ~= x`` and ``scale = max|row| / 127`` (zero
    rows get an epsilon scale and stay zero)."""
    x = np.asarray(x, dtype=np.float32)
    scale = np.abs(x).max(axis=1) / 127.0
    scale = np.maximum(scale, _EPS).astype(np.float32)
    q = np.clip(np.rint(x / scale[:, None]), -127, 127).astype(np.int8)
    return q, scale


def default_clusters(rows: int) -> int:
    """Heuristic centroid count: ~4·sqrt(V) clamped to [8, 4096], never
    more than rows // 4."""
    c = int(4.0 * np.sqrt(max(rows, 1)))
    return max(1, min(max(8, c), 4096, max(1, rows // 4)))


def kmeans_centroids(
    unit: np.ndarray,
    clusters: int,
    iters: int = 8,
    sample: int = 131072,
    seed: int = 0,
) -> np.ndarray:
    """Spherical k-means on (a sample of) the unit rows — returns
    L2-normalized (C, D) float32 centroids."""
    rng = np.random.RandomState(seed)
    unit = np.asarray(unit, dtype=np.float32)
    rows = unit.shape[0]
    clusters = min(int(clusters), rows)
    xs = (
        unit[rng.choice(rows, sample, replace=False)]
        if 0 < sample < rows else unit
    )
    cent = xs[rng.choice(xs.shape[0], clusters, replace=False)].copy()
    for _ in range(max(1, int(iters))):
        cn = cent / np.maximum(np.linalg.norm(cent, axis=1, keepdims=True), _EPS)
        assign = np.argmax(xs @ cn.T, axis=1)
        sums = np.zeros_like(cent)
        np.add.at(sums, assign, xs)
        counts = np.bincount(assign, minlength=clusters).astype(np.float32)
        refreshed = xs[rng.randint(xs.shape[0], size=clusters)]
        cent = np.where(
            (counts == 0)[:, None],  # dead centroid: reseed from data
            refreshed,
            sums / np.maximum(counts, 1.0)[:, None],
        )
    return cent / np.maximum(np.linalg.norm(cent, axis=1, keepdims=True), _EPS)


def build_lists(
    unit: np.ndarray,
    centroids: np.ndarray,
    cap_mult: float = 2.0,
    choices: int = 4,
    chunk: int = 65536,
) -> np.ndarray:
    """(C, L) int32 inverted lists over the table rows, ``-1``-padded.
    Every row lands in exactly one list; ``L`` is a power of two near
    ``cap_mult`` times the mean list size, and rows overflowing their
    nearest centroid spill to the next-nearest with space (up to
    ``choices``, then any list with room)."""
    unit = np.asarray(unit, dtype=np.float32)
    rows, C = unit.shape[0], centroids.shape[0]
    mean = max(1, rows // max(C, 1))
    cap = 1 << max(0, int(np.ceil(cap_mult * mean)) - 1).bit_length()
    while cap * C < rows:  # capacity must fit every row
        cap *= 2
    choices = min(max(1, int(choices)), C)
    assign = np.empty(rows, np.int64)
    for s in range(0, rows, chunk):
        assign[s : s + chunk] = np.argmax(unit[s : s + chunk] @ centroids.T, axis=1)
    lists = np.full((C, cap), -1, dtype=np.int32)
    # group rows by cluster; each row's rank within its cluster decides
    # whether it fits under the cap (stable order: low row ids first)
    order = np.argsort(assign, kind="stable")
    a_sorted = assign[order]
    counts = np.bincount(assign, minlength=C)
    starts = np.concatenate([[0], np.cumsum(counts)[:-1]])
    within = np.arange(rows) - starts[a_sorted]
    fits = within < cap
    lists[a_sorted[fits], within[fits]] = order[fits].astype(np.int32)
    fill = np.minimum(counts, cap).astype(np.int64)
    overflow = order[~fits]
    if overflow.size:
        block = unit[overflow] @ centroids.T
        pref = np.argsort(-block, axis=1)[:, :choices]
        for j, i in enumerate(overflow):
            for c in pref[j]:
                if fill[c] < cap:
                    lists[c, fill[c]] = i
                    fill[c] += 1
                    break
            else:
                c = int(np.argmin(fill))
                lists[c, fill[c]] = i
                fill[c] += 1
    return lists


# -- the index ---------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class AnnIndex:
    """One immutable built index, resident on one device, pinned to one
    table.  ``table_q`` is the quantized scoring table (int8 with
    ``scale``; or bf16, scale unused), row-padded like the model's unit
    matrix; ``centroids``/``lists`` are the IVF stage (``None`` in quant
    mode).  ``version`` mirrors ``LoadedModel.version`` and ``crc`` pins
    the index to the table bytes it was built from."""

    mode: str
    table_q: torch.Tensor                 # (V, D) int8 | bfloat16
    scale: torch.Tensor                   # (V,) float32
    centroids: Optional[torch.Tensor]     # (C, D) float32
    lists: Optional[torch.Tensor]         # (C, L) int32
    crc: int
    version: Optional[Tuple[int, int]] = None
    built_from_cache: bool = False
    build_seconds: float = 0.0

    @property
    def n_clusters(self) -> int:
        return 0 if self.centroids is None else int(self.centroids.shape[0])

    @property
    def list_len(self) -> int:
        return 0 if self.lists is None else int(self.lists.shape[1])


def _cache_name(tag: str, clusters: int, crc: int) -> str:
    return f"ivf_{tag}_c{clusters}_crc{crc:08x}.npz"


def _load_centroid_cache(path: str, crc: int) -> Optional[Tuple[np.ndarray, np.ndarray]]:
    """(centroids, lists) from a cache file, or None when the file is
    missing, unreadable, or stamped with a different table CRC (a
    forged or stale file triggers a rebuild, never a silent reuse)."""
    try:
        with np.load(path) as z:
            meta = json.loads(str(z["meta"]))
            if int(meta.get("crc", -1)) != crc:
                return None
            return (
                np.asarray(z["centroids"], dtype=np.float32),
                np.asarray(z["lists"], dtype=np.int32),
            )
    except Exception:
        # any unreadable cache means REBUILD — a bad cache file must
        # never block loading a good checkpoint
        return None


def _bf16_from_numpy(x: np.ndarray) -> torch.Tensor:
    """A numpy bfloat16 array (ml_dtypes, as the JAX package hands it
    out) as a torch bfloat16 tensor, bit for bit."""
    bits = np.ascontiguousarray(x).view(np.uint16).view(np.int16)
    return torch.from_numpy(bits.copy()).view(torch.bfloat16)


def build_index(
    unit: np.ndarray,
    mode: str,
    *,
    clusters: Optional[int] = None,
    nprobe_hint: int = 8,
    seed: int = 0,
    quant_dtype: str = "int8",
    cache_dir: Optional[str] = None,
    tag: str = "table",
    version: Optional[Tuple[int, int]] = None,
    pad_rows: int = 0,
    device=None,
) -> AnnIndex:
    """Build (or load from cache) the index for one unit matrix and place
    it on ``device`` (``cuda`` unless ``"cpu"`` is asked for).

    ``unit`` is the UNPADDED L2-normalized table — IVF lists reference
    real rows only.  ``pad_rows`` appends that many zero rows (scale
    epsilon) to the quantized table, mirroring a padded unit matrix.
    With ``cache_dir`` the k-means centroids and lists are cached under
    a name keyed by ``tag`` and the table CRC."""
    from gene2vec_tpu_torch.resilience.snapshot import atomic_savez

    if mode not in ("quant", "ivf"):
        raise ValueError(f"build_index mode must be quant|ivf, got {mode!r}")
    if quant_dtype not in QUANT_DTYPES:
        raise ValueError(f"quant_dtype must be one of {QUANT_DTYPES}, got {quant_dtype!r}")
    dev = resolve_device(device)
    t0 = time.monotonic()
    unit = np.asarray(unit, dtype=np.float32)
    crc = table_crc(unit)

    cent_np = lists_np = None
    from_cache = False
    if mode == "ivf":
        n_clusters = int(clusters or default_clusters(unit.shape[0]))
        cache_path = None
        if cache_dir:
            cache_path = os.path.join(cache_dir, _cache_name(tag, n_clusters, crc))
            cached = _load_centroid_cache(cache_path, crc)
            if cached is not None:
                cent_np, lists_np = cached
                from_cache = True
        if cent_np is None:
            cent_np = kmeans_centroids(unit, n_clusters, seed=seed)
            lists_np = build_lists(unit, cent_np)
            if cache_path is not None:
                os.makedirs(cache_dir, exist_ok=True)
                atomic_savez(
                    cache_path,
                    centroids=cent_np,
                    lists=lists_np,
                    meta=json.dumps({
                        "crc": crc,
                        "clusters": int(cent_np.shape[0]),
                        "rows": int(unit.shape[0]),
                        "nprobe_hint": int(nprobe_hint),
                    }),
                )

    pad = np.zeros((pad_rows, unit.shape[1]), np.float32)
    if quant_dtype == "bf16":
        # round to nearest even, as the reference's astype(bfloat16)
        table_q = torch.from_numpy(np.concatenate([unit, pad])).to(torch.bfloat16)
        scale_np = np.ones(unit.shape[0], np.float32)
    else:
        tq_np, scale_np = quantize_rows(unit)
        table_q = torch.from_numpy(
            np.concatenate([tq_np, pad.astype(np.int8)]) if pad_rows else tq_np
        )
    if pad_rows:
        scale_np = np.concatenate([scale_np, np.full(pad_rows, _EPS, np.float32)])
    return AnnIndex(
        mode=mode,
        table_q=table_q.to(dev),
        scale=torch.from_numpy(scale_np).to(dev),
        centroids=None if cent_np is None else torch.from_numpy(cent_np).to(dev),
        lists=None if lists_np is None else torch.from_numpy(lists_np).to(dev),
        crc=crc,
        version=version,
        built_from_cache=from_cache,
        build_seconds=time.monotonic() - t0,
    )


def from_jax_index(fields: Mapping, device=None) -> AnnIndex:
    """An :class:`AnnIndex` from another build's fields as numpy arrays
    (``table_q``, ``scale`` and, for IVF, ``centroids`` and ``lists``;
    optional ``mode``, ``crc``, ``version``) — e.g. the reference
    package's index, so two scans can be compared on the same index."""
    dev = resolve_device(device)
    tq = np.asarray(fields["table_q"])
    table_q = (
        _bf16_from_numpy(tq) if tq.dtype.name == "bfloat16"
        else torch.from_numpy(np.array(tq, dtype=np.int8))
    )
    cent, lists = fields.get("centroids"), fields.get("lists")
    mode = fields.get("mode") or ("ivf" if cent is not None else "quant")
    return AnnIndex(
        mode=mode,
        table_q=table_q.to(dev),
        scale=torch.from_numpy(np.asarray(fields["scale"], np.float32).copy()).to(dev),
        centroids=None if cent is None
        else torch.from_numpy(np.asarray(cent, np.float32).copy()).to(dev),
        lists=None if lists is None
        else torch.from_numpy(np.asarray(lists, np.int32).copy()).to(dev),
        crc=int(fields.get("crc", 0)),
        version=fields.get("version"),
    )


# -- bytes accounting --------------------------------------------------------


def bytes_per_query(
    mode: str,
    rows: int,
    dim: int,
    *,
    r: int = 0,
    clusters: int = 0,
    list_len: int = 0,
    nprobe: int = 0,
) -> float:
    """Table bytes touched per single query.  exact: the full f32
    table.  quant: the int8 table + scale vector + the r rescored f32
    rows.  ivf: the f32 centroids + the probed lists' int8 rows (ids and
    scales included) + the r rescored f32 rows."""
    if mode == "exact":
        return float(rows * dim * 4)
    if mode == "quant":
        return float(rows * dim + rows * 4 + r * dim * 4)
    if mode == "ivf":
        probed = min(nprobe * list_len, rows) if list_len else rows
        return float(clusters * dim * 4 + probed * (dim + 8) + r * dim * 4)
    raise ValueError(f"unknown mode {mode!r}")


# -- numpy oracle (tests / smoke run) ----------------------------------------


def exact_oracle(unit: np.ndarray, queries: np.ndarray, k: int, chunk: int = 128) -> np.ndarray:
    """(Q, k) row indices of the exact cosine top-k — the recall
    reference."""
    unit = np.asarray(unit, dtype=np.float32)
    qn = np.asarray(queries, dtype=np.float32)
    qn = qn / np.maximum(np.linalg.norm(qn, axis=1, keepdims=True), _EPS)
    out = np.empty((qn.shape[0], k), np.int64)
    for s in range(0, qn.shape[0], chunk):
        scores = qn[s : s + chunk] @ unit.T
        part = np.argpartition(-scores, k - 1, axis=1)[:, :k]
        order = np.argsort(-np.take_along_axis(scores, part, axis=1), axis=1)
        out[s : s + chunk] = np.take_along_axis(part, order, axis=1)
    return out


def recall_at_k(found_idx: np.ndarray, oracle_idx: np.ndarray) -> float:
    """Mean fraction of oracle rows recovered, per query."""
    hits = 0
    for f, o in zip(found_idx, oracle_idx):
        hits += len(set(int(i) for i in f) & set(int(i) for i in o))
    return hits / float(oracle_idx.size)


def _dtype_name(t: torch.Tensor) -> str:
    return {torch.int8: "int8", torch.bfloat16: "bfloat16"}.get(t.dtype, str(t.dtype))


def index_stats(index: AnnIndex) -> Dict:
    """JSON-ready facts about one built index (``/healthz``)."""
    return {
        "mode": index.mode,
        "dtype": _dtype_name(index.table_q),
        "rows": int(index.table_q.shape[0]),
        "clusters": index.n_clusters,
        "list_len": index.list_len,
        "crc": index.crc,
        "built_from_cache": index.built_from_cache,
        "build_seconds": round(index.build_seconds, 3),
    }
