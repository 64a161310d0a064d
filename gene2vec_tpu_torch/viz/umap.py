"""UMAP on the GPU — the port of ``gene2vec_tpu/viz/umap.py``.

The reference projects the embedding with a full-batch UMAP in place of
umap-learn (``src/plot_gene2vec.py:124-133``): exact kNN from one (N, N)
distance pass, smooth-kNN weights, the fuzzy union P = W + Wᵀ − W∘Wᵀ,
then a few hundred iterations of the exact cross-entropy gradient over
every pair (McInnes et al. 2018, §3; the reference's docstring has the
formulation).  Here:

* ``fit_ab`` is the reference's numpy fit, bit for bit;
* the distances are ``viz/tsne.py:_squared_distances``'s (one float32
  ``torch.matmul``) on PCA-reduced points (``pca_reduce``, bit for bit);
  on the card :func:`_squared_distances` writes them into rows padded to
  ``tsne_calibrate.row_pitch(N)`` floats, the layout K15 bulk-copies;
* the graph is K15 (``kernels/umap_graph.py``, five launches): each row's
  neighbours and weights, then the union into a sparse P (CSR rows,
  ``umap_graph.Graph``; no (N, N) P exists); the distances are freed once
  the neighbours are written;
* each iteration is K16 (``kernels/umap_step.py``, one launch), from y and
  the graph, from one (N, 2) buffer into another, swapped between
  launches, starting from :func:`start`; one host copy per callback.

On CPU tensors (``device="cpu"``) the kernels' plain versions run.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np
import torch

from gene2vec_tpu_torch.viz import tsne
from gene2vec_tpu_torch.viz.tsne import pca_reduce


def fit_ab(
    min_dist: float = 0.1,
    spread: float = 1.0,
    fixed_b: Optional[float] = None,
) -> Tuple[float, float]:
    """Fit the low-dim kernel 1/(1 + a·d^{2b}) to the piecewise target
    exp(−(d − min_dist)/spread) for d > min_dist, 1 otherwise — a coarse
    grid, then Gauss-Newton (umap-learn fits the same curve with scipy).
    For the defaults this lands on the canonical (a ≈ 1.58, b ≈ 0.90).

    ``fixed_b`` pins the exponent and fits only ``a`` (the fast kernel
    pins b = 7/8, so u^b is three rsqrts)."""
    d = np.linspace(0, 3.0 * spread, 300)
    target = np.where(
        d <= min_dist, 1.0, np.exp(-(d - min_dist) / spread)
    )

    def resid(a, b):
        return 1.0 / (1.0 + a * d ** (2.0 * b)) - target

    b_grid = (
        [fixed_b] if fixed_b is not None else np.linspace(0.5, 2.0, 31)
    )
    best = (1.0, 1.0, np.inf)
    for a in np.linspace(0.5, 3.0, 26):
        for b in b_grid:
            s = float(np.sum(resid(a, b) ** 2))
            if s < best[2]:
                best = (a, b, s)
    a, b = best[0], best[1]
    for _ in range(40):  # Gauss-Newton on (a, b) (or a alone)
        u = d ** (2.0 * b)
        q = 1.0 / (1.0 + a * u)
        r = q - target
        da = -u * q * q
        if fixed_b is not None:
            step_a = float(np.dot(da, r) / (np.dot(da, da) + 1e-6))
            a = float(a - step_a)
        else:
            db = -a * u * np.log(np.maximum(d, 1e-12)) * 2.0 * q * q
            J = np.stack([da, db], axis=1)
            g = J.T @ r
            H = J.T @ J + 1e-6 * np.eye(2)
            step = np.linalg.solve(H, g)
            a, b = float(a - step[0]), float(b - step[1])
            b = min(max(b, 1e-2), 4.0)
        a = min(max(a, 1e-3), 10.0)
    return a, b


@dataclasses.dataclass(frozen=True)
class UMAPConfig:
    """The reference's UMAP defaults.  The iteration computes in float32;
    ``compute_dtype="bfloat16"`` is refused until bf16 arithmetic is
    ported (ROADMAP.md, Queue A, A6h)."""

    n_neighbors: int = 15
    min_dist: float = 0.1
    spread: float = 1.0
    n_iters: int = 400
    learning_rate: float = 1.0
    repulsion: float = 1.0      # γ — weight on the (1 − p) repulsive term
    fast_kernel: bool = True    # b pinned to 7/8: u^b = u·rsqrt³(u)
    pca_dims: int = 50          # high-dim pre-reduction (t-SNE parity)
    init_scale: float = 10.0    # PCA-2 init rescaled to this max-extent
    seed: int = 0
    compute_dtype: str = "float32"

    def __post_init__(self):
        if self.compute_dtype != "float32":
            raise NotImplementedError(
                f"UMAPConfig.compute_dtype={self.compute_dtype!r} is not "
                "supported by gene2vec_tpu_torch: the bfloat16 (N, N) pass is "
                "not ported (K16 computes in float32; ROADMAP.md, Queue A, A6h)"
            )


def _smooth_knn_weights(knn_d: torch.Tensor, n_neighbors: int, iters: int = 64) -> torch.Tensor:
    """Per-point σ by bisection so that Σ_j exp(−max(d_ij − ρ_i, 0)/σ_i) =
    log2(k); the (N, k) membership weights of the sorted neighbour
    distances (torch ops; K15 computes them on the card)."""
    from gene2vec_tpu_torch.kernels import umap_graph

    return umap_graph.smooth_knn_plain(knn_d, n_neighbors, iters)


def _squared_distances(x: torch.Tensor) -> torch.Tensor:
    """``viz/tsne.py:_squared_distances`` of the points ``x``; on the card
    an (N, N) view of rows ``tsne_calibrate.row_pitch(N)`` floats apart:
    one product x·[xᵀ | 0] into the padded rows, then the reference's
    rank-1 terms and clamp in place (−2m + sq_i is sq_i − 2m bit for
    bit)."""
    from gene2vec_tpu_torch.kernels import tsne_calibrate

    if x.device.type == "cpu":
        return tsne._squared_distances(x)
    n = x.shape[0]
    xt = torch.zeros((x.shape[1], tsne_calibrate.row_pitch(n)), dtype=x.dtype, device=x.device)
    xt[:, :n] = x.T
    d = torch.mm(x, xt)[:, :n]
    sq = torch.sum(x * x, dim=1)
    return d.mul_(-2.0).add_(sq[:, None]).add_(sq[None, :]).clamp_min_(0.0)


def _fuzzy_graph(x: torch.Tensor, n_neighbors: int) -> "umap_graph.Graph":
    """The symmetrized fuzzy simplicial weights P of the points ``x`` as a
    sparse ``umap_graph.Graph``.  The distances are freed once K15 has
    written the neighbours and weights."""
    from gene2vec_tpu_torch.kernels import umap_graph

    d2 = _squared_distances(x)
    idx, w = umap_graph.knn_weights(d2, n_neighbors)
    del d2
    return umap_graph.fuzzy_union(idx, w)


def start(
    x: np.ndarray, config: UMAPConfig, device
) -> Tuple["umap_step.Constants", torch.Tensor]:
    """The iteration's start from the PCA-reduced points ``x``: K16's
    constants (``fit_ab``; the fast kernel pins b = 7/8) and the PCA-2
    layout scaled to ``init_scale``, as an (N, 2) float32 tensor on
    ``device``."""
    from gene2vec_tpu_torch.kernels import umap_step

    cfg = config
    a, b = fit_ab(
        cfg.min_dist, cfg.spread,
        fixed_b=0.875 if cfg.fast_kernel else None,
    )
    y0 = pca_reduce(x, 2)
    y0 = y0 / max(np.abs(y0).max(), 1e-12) * cfg.init_scale
    consts = umap_step.constants(a, b, cfg.repulsion, cfg.fast_kernel)
    return consts, torch.from_numpy(np.asarray(y0, np.float32)).to(device)


def umap_layout(
    emb: np.ndarray,
    config: UMAPConfig = UMAPConfig(),
    callback=None,
    device: Optional[str] = None,
) -> np.ndarray:
    """(N, D) embedding → (N, 2) UMAP layout.  ``callback(it, y)`` every 50
    iterations.  ``device``: ``"cuda"`` (the default; raises without a
    GPU) or ``"cpu"``."""
    from gene2vec_tpu_torch.device import resolve_device
    from gene2vec_tpu_torch.kernels import umap_step

    dev = resolve_device(device)
    cfg = config
    x = pca_reduce(np.asarray(emb, np.float32), cfg.pca_dims)
    # umap-learn clamps k to N-1 (with a warning)
    n_neighbors = max(1, min(int(cfg.n_neighbors), x.shape[0] - 1))
    p = _fuzzy_graph(torch.from_numpy(x).to(dev), n_neighbors)

    consts, y = start(x, cfg, dev)
    spare = torch.empty_like(y)
    for it in range(cfg.n_iters):
        lr = umap_step.learning_rate(cfg.learning_rate, it, cfg.n_iters)
        y, spare = umap_step.step(p, y, consts, lr, out=spare), y
        if callback is not None and (it + 1) % 50 == 0:
            callback(it + 1, y.to("cpu", copy=True).numpy())
    out = y.to("cpu", copy=True).numpy()
    if not np.isfinite(out).all():
        raise FloatingPointError("UMAP layout diverged (non-finite coords)")
    return out
