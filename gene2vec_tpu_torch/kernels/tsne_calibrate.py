"""K10c — t-SNE calibration (source: ``csrc/k10c_tsne_calibrate.cu``).

Replaces ``gene2vec_tpu/viz/tsne.py:52-85`` (``_calibrate_p``): for each
row of the squared distances, a 50-step bisection of β so that the
conditional ``exp(−d²β)`` (diagonal 0) has entropy log(perplexity), then
``P_cond = w / Σw`` (launch 1, :func:`conditional`), and
``P = max((P_cond + P_condᵀ) / (2N), 1e-12)`` (launch 2,
:func:`symmetrize_`, in place).  :func:`calibrate` is both.

Launch 1 stages each row in shared memory up to :data:`STAGED_MAX_COLS`
columns and reads longer rows from global memory at every step
(:func:`staged`); a row stops at the first step that leaves its (β, lo,
hi) unchanged, which every later step would repeat, so the result is the
50-step one bit for bit.  It takes a row range (an (R, N) slab whose first
row is row ``row0`` of the full matrix), so the long-row route can be held
against its plain version on a slab.  On the card the conditionals and P are (R, N) views of rows
padded to :func:`row_pitch` floats (zeros past N), the layout K10 streams
P in (16-byte aligned rows); :func:`check_pitch` holds a caller's P to it.

Tolerance: the kernel's sums run in another order than XLA's, and its
``expf`` is not XLA's exponential, so β lands within float32 rounding of
the reference's root; P agrees to a relative 1e-5 on rows whose β is
well conditioned (see the tests).
"""

from __future__ import annotations

import math

import torch

from gene2vec_tpu_torch.kernels import _args, build

#: kernel launches: conditional rows staged in shared memory (""), read
#: from global memory ("global"), and the symmetrization ("sym")
launches = {("tsne_calibrate", ""): 0, ("tsne_calibrate", "global"): 0,
            ("tsne_calibrate", "sym"): 0}

_LIB = "k10c_tsne_calibrate"
ITERS = 50
#: a block's opt-in shared memory on the H100 (232,448 bytes), less 1 KB
#: for the block's static reduction buffers
STAGED_MAX_COLS = (232448 - 1024) // 4
#: P's rows are padded to a multiple of this many floats (128 bytes)
PITCH_FLOATS = 32


def staged(n: int) -> bool:
    """Whether launch 1 stages a row of ``n`` columns in shared memory."""
    return n <= STAGED_MAX_COLS


def row_pitch(n: int) -> int:
    """Floats between P's rows on the card: ``n`` rounded up to a multiple
    of :data:`PITCH_FLOATS`."""
    return -(-n // PITCH_FLOATS) * PITCH_FLOATS


def empty_rows(rows: int, n: int, device) -> torch.Tensor:
    """An uninitialized (rows, n) float32 view of rows :func:`row_pitch`
    (n) floats apart."""
    return torch.empty((rows, row_pitch(n)), dtype=torch.float32, device=device)[:, :n]


def check_pitch(t: torch.Tensor, name: str, rows: int, n: int) -> None:
    """Raise unless ``t`` is a (rows, n) float32 view of rows
    :func:`row_pitch` (n) floats apart, 16-byte aligned: the layout K10c
    writes and K10 reads (``_args.expect`` asks for contiguity, which an
    unpadded (N, N) P has and a padded one has not)."""
    if t.dtype is not torch.float32:
        raise TypeError(f"{name}: expected torch.float32, got {t.dtype}")
    if tuple(t.shape) != (rows, n):
        raise ValueError(f"{name}: expected shape {(rows, n)}, got {tuple(t.shape)}")
    if t.stride() != (row_pitch(n), 1) and rows > 1:
        raise ValueError(f"{name}: rows must be row_pitch({n}) = {row_pitch(n)} floats apart "
                         f"(tsne_calibrate.empty_rows), got strides {t.stride()}")
    if t.stride(-1) != 1 or t.data_ptr() % 16:
        raise ValueError(f"{name}: rows must be contiguous and start 16-byte aligned")


def target_entropy(perplexity: float) -> float:
    """log(perplexity) as the reference computes it (numpy float64, then
    float32 on the device)."""
    return float(torch.tensor(math.log(perplexity), dtype=torch.float32))


def conditional_plain(d2: torch.Tensor, perplexity: float, row0: int = 0,
                      iters: int = ITERS) -> torch.Tensor:
    """``_calibrate_p``'s bisection and P_cond in torch ops, for rows
    row0 .. row0 + R − 1 of the full matrix."""
    r, n = d2.shape
    target = torch.tensor(math.log(perplexity), dtype=torch.float32, device=d2.device)
    cols = torch.arange(n, device=d2.device)
    eye = cols[None, :] == (row0 + torch.arange(r, device=d2.device))[:, None]

    def entropy_and_p(beta):
        w = torch.where(eye, 0.0, torch.exp(-d2 * beta[:, None]))
        sum_w = torch.clamp_min(torch.sum(w, dim=1), 1e-12)
        h = torch.log(sum_w) + beta * torch.sum(d2 * w, dim=1) / sum_w
        return h, w / sum_w[:, None]

    beta = torch.ones(r, dtype=torch.float32, device=d2.device)
    lo = torch.zeros_like(beta)
    hi = torch.full_like(beta, math.inf)
    for _ in range(iters):
        h, _ = entropy_and_p(beta)
        too_high = h > target
        lo = torch.where(too_high, beta, lo)
        hi = torch.where(too_high, hi, beta)
        beta = torch.where(torch.isinf(hi), beta * 2.0, (lo + hi) / 2.0)
    return entropy_and_p(beta)[1]


def symmetrize_plain(p_cond: torch.Tensor) -> torch.Tensor:
    n = p_cond.shape[0]
    return torch.clamp_min((p_cond + p_cond.T) / (2.0 * n), 1e-12)


def conditional(d2: torch.Tensor, perplexity: float, row0: int = 0,
                steps: torch.Tensor = None) -> torch.Tensor:
    """P_cond for an (R, N) slab of squared distances whose first row is
    row ``row0`` of the full (N, N) matrix (its diagonal column); on the
    card an (R, N) view of padded rows (:func:`empty_rows`).  ``steps``, an
    (R,) int32 tensor on the card, receives each row's bisection steps."""
    if _args.on_cpu(d2):
        return conditional_plain(d2, perplexity, row0)
    r, n = d2.shape
    _args.expect(d2, "d2", torch.float32, (r, n))
    if not (0 <= row0 and row0 + r <= n):
        raise ValueError(f"rows {row0}..{row0 + r} outside an ({n}, {n}) matrix")
    if steps is not None:
        _args.expect(steps, "steps", torch.int32, (r,))
    out = empty_rows(r, n, d2.device)
    on_chip = staged(n)
    lib = _lib()
    status = lib.k10c_calibrate_rows(_args.ptr(d2), r, n, row0, target_entropy(perplexity),
                                     ITERS, int(on_chip), _args.ptr(out), out.stride(0),
                                     None if steps is None else _args.ptr(steps),
                                     _args.stream(d2))
    build.check(lib, status, "K10c calibrate_rows launch")
    launches["tsne_calibrate", "" if on_chip else "global"] += 1
    return out


def symmetrize_(p_cond: torch.Tensor) -> torch.Tensor:
    """``max((P_cond + P_condᵀ) / (2N), 1e-12)``, written over the (N, N)
    ``p_cond`` (on the card: padded rows, as :func:`conditional` returns
    them; on the CPU: a new tensor)."""
    if _args.on_cpu(p_cond):
        return symmetrize_plain(p_cond)
    n = p_cond.shape[0]
    check_pitch(p_cond, "p_cond", n, n)
    lib = _lib()
    status = lib.k10c_symmetrize(_args.ptr(p_cond), n, row_pitch(n), _args.stream(p_cond))
    build.check(lib, status, "K10c symmetrize launch")
    launches["tsne_calibrate", "sym"] += 1
    return p_cond


def calibrate(d2: torch.Tensor, perplexity: float) -> torch.Tensor:
    """The symmetrized, normalized P of the (N, N) squared distances (on
    the card: padded rows, the layout :func:`tsne_step.step_` reads)."""
    return symmetrize_(conditional(d2, perplexity))


def work(rows: int, cols: int, passes, symmetrize: bool = True) -> dict:
    """What K10c's function needs on (rows, cols) squared distances whose
    rows take ``passes`` passes in all (each row its bisection steps and
    the pass that writes P_cond; ``_work.py``): d² read once and P written
    once; an exponential an element a pass at the special-function unit
    and the pass's float32 operations (−d·β, Σw, d·w, Σd·w: 4); the
    symmetrization's (P_cond + P_condᵀ) / 2N and its clamp 3 more an
    element."""
    elems = float(passes) * cols
    return {"bytes": 2.0 * rows * cols * 4, "sfu_ops": elems,
            "flops": 4.0 * elems + 3.0 * rows * cols * symmetrize}


def _lib():
    lib = build.load(_LIB)
    fn = lib.k10c_calibrate_rows
    if fn.argtypes is None:
        P, I, L, F = _args.P, _args.I, _args.L, _args.F
        fn.argtypes = [P, I, I, L, F, I, I, P, I, P, P]
        fn.restype = I
        lib.k10c_symmetrize.argtypes = [P, I, I, P]
        lib.k10c_symmetrize.restype = I
    return lib
