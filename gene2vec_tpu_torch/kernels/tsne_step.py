"""K10 — one exact t-SNE iteration (source: ``csrc/k10_tsne_step.cu``).

Replaces the body of ``gene2vec_tpu/viz/tsne.py:143-219`` (``_segment``):
from the resident (N, N) P and the (N, 2) layout y, the Student-t kernel
num = 1/(1 + d²), Z = Σnum − N, g = (exag·P − num/Z)·num, grad =
4(rowsum(g)·y − g·y), the adaptive gains, momentum, y += vel and the
re-centring.  One iteration is three launches (Z; gradient and update;
centring); num and g are never stored, so P's bytes bound it.

:func:`step_` updates y, vel and gains in place (on the CPU as well).
The host passes the iteration's exaggeration and momentum.

Tolerance: Z's and the gradient's sums run in another order than XLA's
(the arithmetic of each pair is the reference's, operation for
operation), so one iteration agrees to float32 rounding of those sums;
over many iterations the layout is chaotic and only its structure is
compared.
"""

from __future__ import annotations

import types

import torch

from gene2vec_tpu_torch.kernels import _args, build

#: kernel launches, by launch: Z ("z"), gradient and update ("grad"),
#: centring ("center")
launches = {("tsne_step", "z"): 0, ("tsne_step", "grad"): 0, ("tsne_step", "center"): 0}

_LIB = "k10_tsne_step"
Z_ROWS = 8   # kZRows of the source: rows a block of the Z launch, one partial a block


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


def workspace(n: int, device) -> types.SimpleNamespace:
    """The kernel's scratch for an N-point layout: the new y before
    centring, Z's per-block partials, the last-block ticket (0) and Z."""
    return types.SimpleNamespace(
        n=n,
        y_new=torch.empty((n, 2), dtype=torch.float32, device=device),
        partials=torch.empty((-(-n // Z_ROWS),), dtype=torch.float64, device=device),
        ticket=torch.zeros((1,), dtype=torch.int32, device=device),
        z=torch.empty((1,), dtype=torch.float32, device=device),
    )


def step_(p: torch.Tensor, y: torch.Tensor, vel: torch.Tensor, gains: torch.Tensor,
          exaggeration: float, momentum: float, learning_rate: float, ws=None) -> None:
    """One iteration, updating y, vel and gains in place.  ``ws`` is a
    :func:`workspace` (made here when None)."""
    if _args.on_cpu(p, y, vel, gains):
        new = step_plain(p, y, vel, gains, exaggeration, momentum, learning_rate)
        for t, v in zip((y, vel, gains), new):
            t.copy_(v)
        return
    n = y.shape[0]
    _args.expect(p, "p", torch.float32, (n, n))
    for t, name in ((y, "y"), (vel, "vel"), (gains, "gains")):
        _args.expect(t, name, torch.float32, (n, 2))
    if ws is None:
        ws = workspace(n, y.device)
    if ws.n != n:
        raise ValueError(f"workspace for {ws.n} points, layout has {n}")
    lib = _lib()
    status = lib.k10_tsne_step(
        _args.ptr(p), _args.ptr(y), _args.ptr(vel), _args.ptr(gains), n,
        float(exaggeration), float(momentum), float(learning_rate), _args.ptr(ws.y_new),
        _args.ptr(ws.partials), _args.ptr(ws.ticket), _args.ptr(ws.z), _args.stream(y))
    build.check(lib, status, "K10 tsne_step launch")
    for part in ("z", "grad", "center"):
        launches["tsne_step", part] += 1


def _lib():
    lib = build.load(_LIB)
    fn = lib.k10_tsne_step
    if fn.argtypes is None:
        P, I, F = _args.P, _args.I, _args.F
        fn.argtypes = [P, P, P, P, I, F, F, F, P, P, P, P, P]
        fn.restype = I
        lib.k10_z_rows.restype = I
        if lib.k10_z_rows() != Z_ROWS:  # the partials buffer is sized by Z_ROWS
            raise RuntimeError(f"K10 library takes {lib.k10_z_rows()} rows a Z block, "
                               f"the wrapper {Z_ROWS}")
    return lib
