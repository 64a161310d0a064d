"""K15 — UMAP's fuzzy graph (source: ``csrc/k15_umap_graph.cu``).

Replaces ``gene2vec_tpu/viz/umap.py:114-157`` (``_smooth_knn_weights`` and
``_fuzzy_graph``, one jitted XLA program): from the (N, N) squared
distances, each row's k nearest other points (``lax.top_k`` of −d², ties
to the lower index), ρ = the nearest distance, a 64-step bisection of σ so
that Σ exp(−max(d − ρ, 0)/σ) = log2(k), the weights w = exp(−max(d − ρ,
0)/σ) (launch 1, :func:`knn_weights`), then the probabilistic t-conorm P
= W + Wᵀ − W∘Wᵀ as a dense (N, N) matrix (launch 2, :func:`fuzzy_union`).
:func:`graph` is both.

On the card P is an (N, N) view of rows ``tsne_calibrate.row_pitch(N)``
floats apart (``tsne_calibrate.empty_rows``; zeros past N), the layout K16
streams it in.  The plain versions take whatever layout they are given.

Tolerance: on the same d² the kernel selects exactly the plain version's
neighbours in its order (both rank by (d², index)).  The weights differ
from the plain ones by the bisection's root: the row sum Σ exp runs in
another order and the card's ``expf`` is not the CPU's, so the sum moves
by a few ulps of log2(k), σ by that over the sum's slope Σ x·e^{−x} (x =
shifted/σ), and w by at most σ's relative change over e (max x·e^{−x} =
1/e).  A row whose sum barely moves with σ moves its weights further; the
tests state their bars with the values they measured.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from gene2vec_tpu_torch.kernels import _args, build, tsne_calibrate

#: kernel launches: the neighbours and weights (""), the union ("union")
launches = {("umap_graph", ""): 0, ("umap_graph", "union"): 0}

_LIB = "k15_umap_graph"
ITERS = 64
#: the largest k launch 1 takes: its kept neighbours' keys, columns,
#: columns by rank and distances (16 bytes each) share a block's opt-in
#: shared memory (232,448 bytes) with its 8 KB histogram
MAX_K = 14000


def target(k: int) -> float:
    """log2(k) in float32, as the reference computes it
    (``jnp.log2(jnp.float32(k))``)."""
    return float(np.log2(np.float32(k)))


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


def knn_weights_plain(d2: torch.Tensor, k: int):
    """Launch 1's function in torch ops: (idx (N, k) int32, w (N, k))."""
    idx, vals = neighbors_plain(d2, k)
    knn_d = torch.sqrt(torch.clamp_min(vals, 0.0))
    return idx.to(torch.int32), smooth_knn_plain(knn_d, k)


def fuzzy_union_plain(idx: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Launch 2's function as the reference writes it: W scattered into a
    dense (N, N) matrix, then W + Wᵀ − W∘Wᵀ."""
    n = idx.shape[0]
    dense = torch.zeros((n, n), dtype=torch.float32, device=w.device)
    rows = torch.arange(n, device=w.device)[:, None].expand_as(idx)
    dense[rows, idx.long()] = w
    return dense + dense.T - dense * dense.T


def knn_weights(d2: torch.Tensor, k: int):
    """(idx (N, k) int32, w (N, k) float32) of the (N, N) squared
    distances: each row's k nearest other points in ascending order (ties
    to the lower index) and their smooth-kNN weights."""
    if _args.on_cpu(d2):
        return knn_weights_plain(d2, k)
    n = d2.shape[0]
    _args.expect(d2, "d2", torch.float32, (n, n))
    if not 1 <= k <= min(n - 1, MAX_K):
        raise ValueError(f"k = {k}: K15 takes 1 <= k <= min(N - 1, {MAX_K}) (N = {n})")
    idx = torch.empty((n, k), dtype=torch.int32, device=d2.device)
    w = torch.empty((n, k), dtype=torch.float32, device=d2.device)
    lib = _lib()
    status = lib.k15_knn_weights(_args.ptr(d2), n, k, target(k), ITERS, _args.ptr(idx),
                                 _args.ptr(w), _args.stream(d2))
    build.check(lib, status, "K15 knn_weights launch")
    launches["umap_graph", ""] += 1
    return idx, w


def fuzzy_union(idx: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """The dense (N, N) P = W + Wᵀ − W∘Wᵀ of each row's neighbours ``idx``
    and weights ``w`` (on the card an (N, N) view of padded rows)."""
    if _args.on_cpu(idx, w):
        return fuzzy_union_plain(idx, w)
    n, k = idx.shape
    _args.expect(idx, "idx", torch.int32, (n, k))
    _args.expect(w, "w", torch.float32, (n, k))
    pitch = tsne_calibrate.row_pitch(n)
    p = torch.zeros((n, pitch), dtype=torch.float32, device=idx.device)[:, :n]
    lib = _lib()
    status = lib.k15_fuzzy_union(_args.ptr(idx), _args.ptr(w), n, k, _args.ptr(p), pitch,
                                 _args.stream(idx))
    build.check(lib, status, "K15 fuzzy_union launch")
    launches["umap_graph", "union"] += 1
    return p


def graph(d2: torch.Tensor, k: int) -> torch.Tensor:
    """The fuzzy graph P of the (N, N) squared distances at k neighbours."""
    return fuzzy_union(*knn_weights(d2, k))


def _lib():
    lib = build.load(_LIB)
    fn = lib.k15_knn_weights
    if fn.argtypes is None:
        P, I, F = _args.P, _args.I, _args.F
        fn.argtypes = [P, I, I, F, I, P, P, P]
        fn.restype = I
        lib.k15_fuzzy_union.argtypes = [P, P, I, I, P, I, P]
        lib.k15_fuzzy_union.restype = I
    return lib
