"""K16 — one UMAP iteration (source: ``csrc/k16_umap_step.cu``).

Replaces ``gene2vec_tpu/viz/umap.py:188-225`` (``iterate``, a jitted XLA
program): from the resident (N, N) fuzzy graph P and the (N, 2) layout y,
each pair's u = |y_i − y_j|², the low-dimensional kernel's attraction
2ab·u^{b−1}/(1 + a·u^b)·p and repulsion 2bγ/((u + 1e-3)(1 + a·u^b))·(1 − p),
coef = attraction − repulsion (0 on the diagonal), the force
rowsum(coef)·y_i − Σ_j coef_ij·y_j clipped to ±4 per coordinate, and y′ =
y − lr·force.  ``fast_kernel`` takes u^b as u·rsqrt(rsqrt(rsqrt(u)))
(b = 7/8), else ``pow``.

One launch an iteration: it reads y and writes y′ into another buffer
(the caller swaps the two), streaming P once; coef is never stored.  On
the card P is an (N, N) view of rows ``tsne_calibrate.row_pitch(N)``
floats apart, as K15 writes it.

The constants are the reference's: 2ab and 2bγ in float64 on the host,
then float32 (:func:`constants`), and lr = learning_rate·(1 − it/n_iters)
in float32 (:func:`learning_rate`).

Tolerance: the kernel sums each row in another order than XLA's matmul,
and its ``rsqrtf`` / ``powf`` are not the CPU's, so the force agrees to a
share of its terms |rowsum·y_i| + Σ_j |coef_ij|·|y_j| (the sum cancels as
the layout spreads), and a clip decision may differ where the force lies
within that share of ±4 (counted by the checks).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from gene2vec_tpu_torch.kernels import _args, build, tsne_calibrate

#: kernel launches (one an iteration)
launches = {("umap_step", ""): 0}

_LIB = "k16_umap_step"


@dataclasses.dataclass(frozen=True)
class Constants:
    """The iteration's float32 constants (as Python floats) and its kernel
    choice."""

    a: float
    b: float
    two_ab: float
    two_bg: float
    fast_kernel: bool


def constants(a: float, b: float, repulsion: float, fast_kernel: bool) -> Constants:
    """2ab and 2bγ from the same float64 expressions as the reference's,
    each rounded to float32 once, as are a and b."""
    f32 = lambda v: float(np.float32(v))  # noqa: E731
    return Constants(f32(a), f32(b), f32(2.0 * a * b), f32(2.0 * b * repulsion), fast_kernel)


def learning_rate(base: float, it: int, n_iters: int) -> float:
    """``learning_rate·(1 − it/n_iters)`` in float32 (``it`` is a float32
    scalar in the reference)."""
    f = np.float32
    return float(f(base) * (f(1.0) - f(it) / f(n_iters)))


def coef_plain(p: torch.Tensor, y: torch.Tensor, c: Constants) -> torch.Tensor:
    """The (N, N) coef = attraction − repulsion in torch ops, in the
    reference's order, with a zero diagonal."""
    y0, y1 = y[:, 0], y[:, 1]
    u = (y0[:, None] - y0[None, :]) ** 2 + (y1[:, None] - y1[None, :]) ** 2
    um = torch.clamp_min(u, 1e-12)
    if c.fast_kernel:
        ub = um * torch.rsqrt(torch.rsqrt(torch.rsqrt(um)))
    else:
        ub = torch.pow(um, c.b)
    q_inv = 1.0 + c.a * ub
    attract = c.two_ab * ub / um / q_inv * p
    repel = c.two_bg / ((u + 1e-3) * q_inv) * (1.0 - p)
    coef = attract - repel
    coef.diagonal().zero_()
    return coef


def force_plain(p: torch.Tensor, y: torch.Tensor, c: Constants) -> torch.Tensor:
    """The unclipped (N, 2) force rowsum(coef)·y − coef·y, through one
    matmul with [y | 1] as the reference folds the row sums."""
    n = y.shape[0]
    aug = torch.cat([y, torch.ones((n, 1), dtype=y.dtype, device=y.device)], dim=1)
    fr = torch.matmul(coef_plain(p, y, c), aug)
    return fr[:, 2:3] * y - fr[:, :2]


def step_plain(p: torch.Tensor, y: torch.Tensor, c: Constants, lr: float) -> torch.Tensor:
    """One iteration in torch ops; returns the new layout."""
    return y - lr * torch.clamp(force_plain(p, y, c), -4.0, 4.0)


def step(p: torch.Tensor, y: torch.Tensor, c: Constants, lr: float,
         out: torch.Tensor = None) -> torch.Tensor:
    """One iteration from the layout ``y``: the new layout, written into
    ``out`` on the card (a new tensor where None; never ``y`` itself).  On
    the card ``p`` is an (N, N) view of padded rows
    (``tsne_calibrate.check_pitch``)."""
    if _args.on_cpu(p, y):
        return step_plain(p, y, c, lr)
    n = y.shape[0]
    _args.expect(y, "y", torch.float32, (n, 2))
    tsne_calibrate.check_pitch(p, "p", n, n)
    if out is None:
        out = torch.empty_like(y)
    _args.expect(out, "out", torch.float32, (n, 2))
    if out.data_ptr() == y.data_ptr():
        raise ValueError("out: must not be y (the kernel reads every y while it writes)")
    lib = _lib()
    status = lib.k16_umap_step(_args.ptr(p), tsne_calibrate.row_pitch(n), _args.ptr(y),
                               _args.ptr(out), n, c.a, c.b, c.two_ab, c.two_bg, float(lr),
                               int(c.fast_kernel), _args.stream(y))
    build.check(lib, status, "K16 umap_step launch")
    launches["umap_step", ""] += 1
    return out


def _lib():
    lib = build.load(_LIB)
    fn = lib.k16_umap_step
    if fn.argtypes is None:
        P, I, F = _args.P, _args.I, _args.F
        fn.argtypes = [P, I, P, P, I, F, F, F, F, F, I, P]
        fn.restype = I
    return lib
