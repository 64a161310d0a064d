"""K15 — UMAP's fuzzy graph (source: ``csrc/k15_umap_graph.cu``).

Replaces ``gene2vec_tpu/viz/umap.py:114-157`` (``_smooth_knn_weights`` and
``_fuzzy_graph``, one jitted XLA program): from the (N, N) squared
distances, each row's k nearest other points (``lax.top_k`` of −d², ties
to the lower index), ρ = the nearest distance, a 64-step bisection of σ so
that Σ exp(−max(d − ρ, 0)/σ) = log2(k), the weights w = exp(−max(d − ρ,
0)/σ) (launch 1, :func:`knn_weights`), then the probabilistic t-conorm P
= W + Wᵀ − W∘Wᵀ (:func:`fuzzy_union`).  :func:`graph` is both.

P is kept sparse, as a :class:`Graph`: compressed rows (CSR), each row's
columns ascending, no diagonal and no stored zero, values
``(w_ij + w_ji) − w_ij·w_ji`` in the reference's order (:157), so the
pattern and the values are symmetric bit for bit.  A row holds its k
neighbours and every j that has it among its own k (hubs hold many more
than 2k).  :func:`to_dense` gives the reference's dense P (tests and
checks only).

On the card launch 1 reads d² as an (N, N) view of rows
``tsne_calibrate.row_pitch(N)`` floats apart (``viz/umap.py``'s
``_squared_distances`` writes it so: its bulk copies need 16-byte aligned
rows) and stages each row in shared memory once (:func:`stages`: two rows
in flight, one, or none past the shared memory).  The union is four more
launches: each edge's value and each row's count, a scan of the counts,
the fill, and a sort of each row's columns, so a graph build makes five
launches.  The host reads the entry count once, between the scan and the
fill, to size the CSR.

Tolerance: on the same d² the kernel selects exactly the plain version's
neighbours in its order (both rank by (d², index)).  The weights differ
from the plain ones by the bisection's root: the row sum Σ exp runs in
another order and the card's ``expf`` is not the CPU's, so the sum moves
by a few ulps of log2(k), σ by that over the sum's slope Σ x·e^{−x} (x =
shifted/σ), and w by at most σ's relative change over e (max x·e^{−x} =
1/e).  A row whose sum barely moves with σ moves its weights further; the
tests state their bars with the values they measured.  The union of the
same (idx, w) is the plain union's bit for bit.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional

import numpy as np
import torch

from gene2vec_tpu_torch.kernels import _args, build, tsne_calibrate

#: kernel launches: the neighbours and weights (""), then the union's
#: four: edge values and row counts ("union"), the scan ("scan"), the
#: fill ("fill") and the per-row sort ("sort")
launches = {("umap_graph", ""): 0, ("umap_graph", "union"): 0, ("umap_graph", "scan"): 0,
            ("umap_graph", "fill"): 0, ("umap_graph", "sort"): 0}

_LIB = "k15_umap_graph"
ITERS = 64
#: a block's opt-in shared memory on the H100
SMEM_BYTES = 232448
#: launch 1's static shared memory (the 2,048-bin histogram and a few
#: counters) with room to spare
STATIC_BYTES = 9 * 1024
#: the candidates a row may keep in launch 1's first route (keys at most
#: the k-th smallest of the warps' minima, k <= 32); more send the row to
#: the radix select
MAX_CANDIDATES = 1024
#: the largest k launch 1 takes: its kept (key, column) pairs, 8 bytes
#: each, fill the shared memory beside the histogram
MAX_K = 14000


@dataclasses.dataclass(frozen=True)
class Graph:
    """P as compressed rows: row i's columns ``col[rowptr[i]:rowptr[i+1]]``
    (int32, ascending, no diagonal) and values ``val`` (float32, none 0)."""

    rowptr: torch.Tensor
    col: torch.Tensor
    val: torch.Tensor

    @property
    def n(self) -> int:
        return self.rowptr.shape[0] - 1

    @property
    def nnz(self) -> int:
        return self.col.shape[0]


def to_dense(p: Graph, n: Optional[int] = None) -> torch.Tensor:
    """The dense (N, N) P of ``p`` (the reference's form; zeros where no
    entry is stored)."""
    n = p.n if n is None else n
    dev = p.val.device
    rows = torch.repeat_interleave(torch.arange(n, device=dev),
                                   (p.rowptr[1:] - p.rowptr[:-1]).long())
    dense = torch.zeros((n, n), dtype=torch.float32, device=dev)
    dense[rows, p.col.long()] = p.val
    return dense


def target(k: int) -> float:
    """log2(k) in float32, as the reference computes it
    (``jnp.log2(jnp.float32(k))``)."""
    return float(np.log2(np.float32(k)))


def stages(n: int, k: int) -> int:
    """Rows of ``n`` columns launch 1 holds in shared memory at once: 2
    (the next row's copy in flight while this one is selected), 1, or 0
    (rows read from global memory) — by shape alone."""
    kept = max(MAX_CANDIDATES, k) * 8
    row = tsne_calibrate.row_pitch(n) * 4
    for s in (2, 1):
        if STATIC_BYTES + kept + s * row <= SMEM_BYTES:
            return s
    return 0


def smooth_knn_plain(knn_d: torch.Tensor, k: int, iters: int = ITERS) -> torch.Tensor:
    """``_smooth_knn_weights`` in torch ops: the (N, k) membership weights
    of the sorted neighbour distances ``knn_d``."""
    rho = knn_d[:, :1]
    tgt = torch.tensor(target(k), dtype=torch.float32, device=knn_d.device)
    shifted = torch.clamp_min(knn_d - rho, 0.0)
    n = knn_d.shape[0]
    lo = torch.full((n, 1), 1e-6, dtype=torch.float32, device=knn_d.device)
    hi = torch.full((n, 1), 1e3, dtype=torch.float32, device=knn_d.device)
    for _ in range(iters):
        mid = 0.5 * (lo + hi)
        val = torch.sum(torch.exp(-shifted / mid), dim=1, keepdim=True)
        gt = val > tgt
        hi = torch.where(gt, mid, hi)
        lo = torch.where(gt, lo, mid)
    sigma = 0.5 * (lo + hi)
    return torch.exp(-shifted / sigma)


def neighbors_plain(d2: torch.Tensor, k: int):
    """(idx (N, k) int64, their d² (N, k)): each row's k smallest
    off-diagonal entries in ascending order, ties to the lower index — the
    order of ``lax.top_k`` on −d² (a stable sort; ``torch.topk`` leaves the
    order of ties unspecified)."""
    n = d2.shape[0]
    eye = torch.eye(n, dtype=torch.bool, device=d2.device)
    vals, idx = torch.sort(d2.masked_fill(eye, math.inf), dim=1, stable=True)
    return idx[:, :k], vals[:, :k]


def sqrt_rn(x: torch.Tensor) -> torch.Tensor:
    """The correctly rounded float32 square root of ``x`` >= 0 (XLA's
    ``sqrt`` and CUDA's ``sqrtf``).  torch's float32 ``sqrt`` on the CPU
    misses it by one ulp on ~1 in 5 arguments, and one ulp of a neighbour
    distance moves its row's bisection of σ.  The float64 root rounded to
    float32 is then corrected against the two half-way points, whose
    squares float64 holds exactly."""
    xd = x.double()
    s = torch.sqrt(xd).float()
    sd = s.double()
    up = torch.nextafter(s, torch.full_like(s, math.inf))
    down = torch.nextafter(s, torch.zeros_like(s))
    mid_up, mid_down = (sd + up.double()) / 2, (sd + down.double()) / 2
    return torch.where(mid_up * mid_up < xd, up,
                       torch.where(mid_down * mid_down > xd, down, s))


def knn_weights_plain(d2: torch.Tensor, k: int):
    """Launch 1's function in torch ops: (idx (N, k) int32, w (N, k))."""
    idx, vals = neighbors_plain(d2, k)
    knn_d = sqrt_rn(torch.clamp_min(vals, 0.0))
    return idx.to(torch.int32), smooth_knn_plain(knn_d, k)


def fuzzy_union_plain(idx: torch.Tensor, w: torch.Tensor) -> Graph:
    """The union's function in torch ops: every edge i→j of the lists and
    its reverse, each entry's (w_ij + w_ji) − w_ij·w_ji (a missing edge's
    weight 0), zeros dropped, rows in column order."""
    n, k = idx.shape
    dev = idx.device
    i = torch.arange(n, device=dev).repeat_interleave(k)
    j = idx.reshape(-1).long()
    fwd = i * n + j
    order = torch.argsort(fwd)
    fwd_sorted, w_sorted = fwd[order], w.reshape(-1)[order]
    keys = torch.unique(torch.cat([fwd, j * n + i]))  # sorted: by row, then column
    r, c = keys // n, keys % n

    def weight(q):  # w of the edge q, 0 where the lists lack it
        pos = torch.searchsorted(fwd_sorted, q).clamp_max(fwd_sorted.numel() - 1)
        return torch.where(fwd_sorted[pos] == q, w_sorted[pos], 0.0)

    w_rc, w_cr = weight(keys), weight(c * n + r)
    val = (w_rc + w_cr) - w_rc * w_cr
    keep = val != 0
    rowptr = torch.zeros(n + 1, dtype=torch.int32, device=dev)
    rowptr[1:] = torch.cumsum(torch.bincount(r[keep], minlength=n), 0)
    return Graph(rowptr, c[keep].to(torch.int32), val[keep])


def knn_weights(d2: torch.Tensor, k: int):
    """(idx (N, k) int32, w (N, k) float32) of the (N, N) squared
    distances: each row's k nearest other points in ascending order (ties
    to the lower index) and their smooth-kNN weights.  On the card ``d2``
    is a view of padded rows (``tsne_calibrate.check_pitch``)."""
    if _args.on_cpu(d2):
        return knn_weights_plain(d2, k)
    n = d2.shape[0]
    tsne_calibrate.check_pitch(d2, "d2", n, n)
    if not 1 <= k <= min(n - 1, MAX_K):
        raise ValueError(f"k = {k}: K15 takes 1 <= k <= min(N - 1, {MAX_K}) (N = {n})")
    idx = torch.empty((n, k), dtype=torch.int32, device=d2.device)
    w = torch.empty((n, k), dtype=torch.float32, device=d2.device)
    lib = _lib()
    status = lib.k15_knn_weights(_args.ptr(d2), tsne_calibrate.row_pitch(n), n, k, target(k),
                                 ITERS, stages(n, k), _args.sm_count(d2), _args.ptr(idx), _args.ptr(w),
                                 _args.stream(d2))
    build.check(lib, status, "K15 knn_weights launch")
    launches["umap_graph", ""] += 1
    return idx, w


def fuzzy_union(idx: torch.Tensor, w: torch.Tensor) -> Graph:
    """P = W + Wᵀ − W∘Wᵀ of each row's neighbours ``idx`` and weights
    ``w``, as a :class:`Graph` (four launches on the card)."""
    if _args.on_cpu(idx, w):
        return fuzzy_union_plain(idx, w)
    n, k = idx.shape
    _args.expect(idx, "idx", torch.int32, (n, k))
    _args.expect(w, "w", torch.float32, (n, k))
    if 2 * n * k >= 2 ** 31:
        raise ValueError(f"N·k = {n * k}: the graph's int32 offsets take fewer than 2^30 edges")
    dev = idx.device
    lib = _lib()
    edge_val = torch.empty((n, k), dtype=torch.float32, device=dev)
    mutual = torch.empty((n, k), dtype=torch.int8, device=dev)
    counts = torch.zeros(n, dtype=torch.int32, device=dev)
    rowptr = torch.empty(n + 1, dtype=torch.int32, device=dev)
    stream = _args.stream(idx)
    build.check(lib, lib.k15_union_count(_args.ptr(idx), _args.ptr(w), n, k, _args.ptr(edge_val),
                                         _args.ptr(mutual), _args.ptr(counts), stream),
                "K15 union count launch")
    launches["umap_graph", "union"] += 1
    build.check(lib, lib.k15_union_scan(_args.ptr(counts), n, _args.ptr(rowptr), stream),
                "K15 union scan launch")
    launches["umap_graph", "scan"] += 1
    nnz = int(rowptr[n])  # the one host read of a build: the CSR's size
    tmp_col = torch.empty(nnz, dtype=torch.int32, device=dev)
    tmp_val = torch.empty(nnz, dtype=torch.float32, device=dev)
    build.check(lib, lib.k15_union_fill(_args.ptr(idx), _args.ptr(edge_val), _args.ptr(mutual),
                                        n, k, _args.ptr(rowptr), _args.ptr(counts),
                                        _args.ptr(tmp_col), _args.ptr(tmp_val), stream),
                "K15 union fill launch")
    launches["umap_graph", "fill"] += 1
    col = torch.empty(nnz, dtype=torch.int32, device=dev)
    val = torch.empty(nnz, dtype=torch.float32, device=dev)
    build.check(lib, lib.k15_union_sort(_args.ptr(rowptr), _args.ptr(tmp_col), _args.ptr(tmp_val),
                                        n, _args.ptr(col), _args.ptr(val), stream),
                "K15 union sort launch")
    launches["umap_graph", "sort"] += 1
    return Graph(rowptr, col, val)


def graph(d2: torch.Tensor, k: int) -> Graph:
    """The fuzzy graph P of the (N, N) squared distances at k neighbours."""
    return fuzzy_union(*knn_weights(d2, k))


def _lib():
    lib = build.load(_LIB)
    fn = lib.k15_knn_weights
    if fn.argtypes is None:
        P, I, F = _args.P, _args.I, _args.F
        fn.argtypes = [P, I, I, I, F, I, I, I, P, P, P]
        fn.restype = I
        for name, args in (("k15_union_count", [P, P, I, I, P, P, P, P]),
                           ("k15_union_scan", [P, I, P, P]),
                           ("k15_union_fill", [P, P, P, I, I, P, P, P, P, P]),
                           ("k15_union_sort", [P, P, P, I, P, P, P])):
            getattr(lib, name).argtypes = args
            getattr(lib, name).restype = I
    return lib
