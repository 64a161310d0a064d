"""K10 — one exact t-SNE iteration (source: ``csrc/k10_tsne_step.cu``).

Replaces the body of ``gene2vec_tpu/viz/tsne.py:143-219`` (``_segment``):
from the resident (N, N) P and the (N, 2) layout y, the Student-t kernel
num = 1/(1 + d²), Z = Σnum − N, g = (exag·P − num/Z)·num, grad =
4(rowsum(g)·y − g·y), the adaptive gains, momentum, y += vel and the
re-centring.  One iteration is one cooperative launch that streams P
once: each row's sums of P·num·[y, 1] and num²·[y, 1] and Σnum, then
(grid-wide) Z, every row's update and the centring; num and g are never
stored, so P's bytes bound it.  On the card P is an (N, N) view of rows
``tsne_calibrate.row_pitch(N)`` floats apart, as ``tsne_calibrate``
writes it.

:func:`step_` updates y, vel and gains in place (on the CPU as well).
The host passes the iteration's exaggeration and momentum.

Tolerance: the kernel sums g's attractive and repulsive parts apart and
then combines them with 1/Z (:func:`split_sums_plain` models that
association), and its sums run in another order than XLA's (the
arithmetic of each pair is the reference's, operation for operation), so
one iteration agrees to float32 rounding of those sums; over many
iterations the layout is chaotic and only its structure is compared.
"""

from __future__ import annotations

import types

import torch

from gene2vec_tpu_torch.kernels import _args, build, tsne_calibrate

#: kernel launches (one an iteration)
launches = {("tsne_step", ""): 0}

_LIB = "k10_tsne_step"
ROW_WORDS = 8   # kRowWords of the source: a row's six sums, then y + vel


def step_plain(p, y, vel, gains, exaggeration: float, momentum: float,
               learning_rate: float):
    """One iteration in torch ops, in the reference's order; returns the
    new (y, vel, gains).  Materializes num and g."""
    n, k = y.shape
    sq = torch.sum(y * y, dim=1)
    d2 = sq[:, None] + sq[None, :]
    for c in range(k):
        d2 = d2 - 2.0 * y[:, c:c + 1] * y[:, c]
    num = 1.0 / (1.0 + torch.clamp_min(d2, 0.0))
    z = torch.sum(num, dtype=torch.float32) - n
    inv_z = 1.0 / z
    g = (exaggeration * p - inv_z * num) * num
    ext = torch.cat([y, torch.ones((n, 1), dtype=y.dtype, device=y.device)], dim=1)
    gy_ext = torch.matmul(g, ext)
    rowsum = gy_ext[:, k]
    grad = 4.0 * (rowsum[:, None] * y - gy_ext[:, :k])
    same_sign = torch.sign(grad) == torch.sign(vel)
    gains = torch.clamp_min(torch.where(same_sign, gains * 0.8, gains + 0.2), 0.01)
    vel = momentum * vel - learning_rate * gains * grad
    y = y + vel
    y = y - torch.mean(y, dim=0)
    return y, vel, gains


def split_sums_plain(p, y, exaggeration: float):
    """The kernel's association of one iteration's sums in torch ops: Z
    from Σnum, then [gy | rowsum] = exag·(P·num)@[y | 1] − (1/Z)·num²@[y |
    1], the two parts summed apart (float64 Z, as the kernel's).  Returns
    [gy | rowsum] (N, 3)."""
    n, k = y.shape
    sq = torch.sum(y * y, dim=1)
    d2 = sq[:, None] + sq[None, :]
    for c in range(k):
        d2 = d2 - 2.0 * y[:, c:c + 1] * y[:, c]
    num = 1.0 / (1.0 + torch.clamp_min(d2, 0.0))
    z = (torch.sum(num, dtype=torch.float64) - n).to(torch.float32)
    ext = torch.cat([y, torch.ones((n, 1), dtype=y.dtype, device=y.device)], dim=1)
    attract = torch.matmul(p * num, ext)
    repel = torch.matmul(num * num, ext)
    return exaggeration * attract - (1.0 / z) * repel


def workspace(n: int, device) -> types.SimpleNamespace:
    """The kernel's scratch for an N-point layout: each row's sums and its
    y + vel, the blocks' float64 partials (of Z, of Σ(y + vel)) and the
    grid barrier's counter and generation (0).  On the CPU, where no
    kernel runs, a grid of one."""
    grid = 1
    if torch.device(device).type != "cpu":
        grid = _lib().k10_grid(n)
        if grid < 0:
            raise RuntimeError(f"K10 grid size: CUDA error {-grid}")
    return types.SimpleNamespace(
        n=n, grid=grid,
        rows=torch.empty((n, ROW_WORDS), dtype=torch.float32, device=device),
        partials=torch.empty((grid, 4), dtype=torch.float64, device=device),
        sync=torch.zeros((2,), dtype=torch.int32, device=device),
    )


def step_(p: torch.Tensor, y: torch.Tensor, vel: torch.Tensor, gains: torch.Tensor,
          exaggeration: float, momentum: float, learning_rate: float, ws=None) -> None:
    """One iteration, updating y, vel and gains in place.  ``ws`` is a
    :func:`workspace` (made here when None).  On the card ``p`` is an
    (N, N) view of padded rows (``tsne_calibrate.check_pitch``)."""
    if _args.on_cpu(p, y, vel, gains):
        new = step_plain(p, y, vel, gains, exaggeration, momentum, learning_rate)
        for t, v in zip((y, vel, gains), new):
            t.copy_(v)
        return
    n = y.shape[0]
    for t, name in ((y, "y"), (vel, "vel"), (gains, "gains")):
        _args.expect(t, name, torch.float32, (n, 2))
    if ws is None:
        ws = workspace(n, y.device)
    if ws.n != n:
        raise ValueError(f"workspace for {ws.n} points, layout has {n}")
    tsne_calibrate.check_pitch(p, "p", n, n)
    if y.data_ptr() % 16:
        raise ValueError("y: must start on a 16-byte boundary")
    lib = _lib()
    status = lib.k10_tsne_step(
        _args.ptr(p), tsne_calibrate.row_pitch(n), _args.ptr(y), _args.ptr(vel),
        _args.ptr(gains), n, float(exaggeration), float(momentum), float(learning_rate),
        _args.ptr(ws.rows), _args.ptr(ws.partials), _args.ptr(ws.sync), ws.grid,
        _args.stream(y))
    build.check(lib, status, "K10 tsne_step launch")
    launches["tsne_step", ""] += 1


def _lib():
    lib = build.load(_LIB)
    fn = lib.k10_tsne_step
    if fn.argtypes is None:
        P, I, F = _args.P, _args.I, _args.F
        fn.argtypes = [P, I, P, P, P, I, F, F, F, P, P, P, I, P]
        fn.restype = I
        lib.k10_grid.argtypes = [I]
        lib.k10_grid.restype = I
        lib.k10_reciprocal.argtypes = [P, P, _args.L, P]
        lib.k10_reciprocal.restype = I
    return lib


def reciprocal(x: torch.Tensor) -> torch.Tensor:
    """The kernel's reciprocal of each x ≥ 1 (a CUDA float32 tensor), for
    the card test that holds it to the IEEE reciprocal."""
    _args.expect(x, "x", torch.float32, (None,))
    out = torch.empty_like(x)
    lib = _lib()
    build.check(lib, lib.k10_reciprocal(_args.ptr(x), _args.ptr(out), x.numel(),
                                        _args.stream(x)), "K10 reciprocal launch")
    return out
