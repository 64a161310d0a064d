"""K11 — co-expression mask (source: ``csrc/k11_coexpr_mask.cu``).

Replaces ``gene2vec_tpu/corpus/builder.py:145-171`` (``abs_correlation_mask``
with ``backend="jax"``): from the float32 standardized study matrix z
(n samples × g genes), the bits of ``clip(|zᵀz| / (n − 1), 0, 1) > thr``,
compared in float32.  Only the bits are written: row-padded ``uint32``
words, ⌈g/32⌉ a row, bit b of word w holding column 32w + b (carried in an
int32 tensor), which :func:`unpack` turns into the reference's (g, g) bool
mask.

The kernel compares each sum with :func:`sum_threshold`'s a*, the least
float32 sum that passes the reference's epilogue, in place of dividing:
the same bits for every float32 sum.  It reads z with rows padded to a
multiple of 4 floats (:func:`row_pitch`), copying z when g is not one.

Tolerance: the kernel sums the n products in another order than the
reference's float32 product (Eigen) and than numpy's float64 one, so a
pair whose float64 |corr| lies within :func:`eps_n` of the threshold may
land on either side.  Every other pair agrees.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from gene2vec_tpu_torch.kernels import _args, build

#: kernel launches made through :func:`coexpr_mask`
launches = {("coexpr_mask", ""): 0}

_LIB = "k11_coexpr_mask"


def eps_n(n: int) -> float:
    """|corr| distance from the threshold within which float32's dot over
    n terms of standardized columns (Σz² = n − 1), plus the cast of z to
    float32, may flip a pair: (n + 2)·2⁻²⁴."""
    return (n + 2) * 2.0 ** -24


def words_per_row(g: int) -> int:
    return -(-g // 32)


def row_pitch(g: int) -> int:
    """Floats a row of z as the kernel reads it: g rounded up to a multiple
    of 4 (its 16-byte copies)."""
    return -(-g // 4) * 4


def _passes(bits: np.ndarray, d: np.float32, thr: np.float32) -> np.ndarray:
    """The reference's epilogue (builder.py:166-170) in float32 on the
    non-negative sums whose float32 bit patterns are ``bits``: IEEE
    division, as the first design's ``__fdiv_rn``, and a clip that keeps
    NaN."""
    a = np.asarray(bits, dtype=np.uint32).view(np.float32)
    with np.errstate(all="ignore"):
        return np.clip(a / d, np.float32(0.0), np.float32(1.0)) > thr


@functools.lru_cache(maxsize=None)
def sum_threshold(n: int, threshold: float) -> float:
    """a*, the least float32 a ≥ 0 with clip(fl(a / (n − 1)), 0, 1) > thr
    in float32 (``thr`` the threshold cast to float32), by bisection over
    the bit patterns of +0 … +inf.  fl(a / d) is monotone in a, so for
    every float32 sum s the reference's test on |s| is |s| ≥ a*.  NaN
    where no sum passes (thr ≥ 1: the clip caps at 1), since every compare
    with NaN is false, +inf's too."""
    d, thr = np.float32(n - 1), np.float32(threshold)
    lo, hi = 0, 0x7F800000
    if _passes(lo, d, thr):
        return 0.0
    if not _passes(hi, d, thr):
        return float("nan")
    while hi - lo > 1:  # passes(lo) false, passes(hi) true
        mid = (lo + hi) // 2
        if _passes(mid, d, thr):
            hi = mid
        else:
            lo = mid
    return float(np.uint32(hi).view(np.float32))


def pack_plain(bits: torch.Tensor) -> torch.Tensor:
    """(g, g) bool → (g, ⌈g/32⌉) int32 words, bit b of word w = column
    32w + b, in torch ops: each byte is its 8 bits weighted 1 … 128, and
    four little-endian bytes make a word."""
    rows, g = bits.shape
    w = words_per_row(g)
    if w == 0:
        return torch.empty((rows, 0), dtype=torch.int32, device=bits.device)
    padded = torch.zeros((rows, w * 32), dtype=torch.uint8, device=bits.device)
    padded[:, :g] = bits
    weights = torch.tensor([1 << b for b in range(8)], dtype=torch.uint8, device=bits.device)
    packed = (padded.view(rows, w * 4, 8) * weights).sum(dim=2, dtype=torch.uint8)
    return packed.view(torch.int32)


def coexpr_mask_plain(z: torch.Tensor, threshold: float) -> torch.Tensor:
    """The reference's jax backend in torch ops: the float32 product, the
    same epilogue, then the same word packing as the kernel."""
    n = z.shape[0]
    prod = torch.matmul(z.T, z)
    corr = torch.clamp(torch.abs(prod) / (n - 1), 0.0, 1.0)
    thr = torch.tensor(threshold, dtype=torch.float32, device=z.device)
    return pack_plain(corr > thr)


def coexpr_mask(z: torch.Tensor, threshold: float) -> torch.Tensor:
    """Packed |corr| > threshold words of the (n, g) float32 standardized
    matrix z: (g, ⌈g/32⌉) int32."""
    if _args.on_cpu(z):
        return coexpr_mask_plain(z, threshold)
    n, g = z.shape
    _args.expect(z, "z", torch.float32, (n, g))
    if g == 0:
        return torch.empty((0, 0), dtype=torch.int32, device=z.device)
    lib = _lib()
    pitch = row_pitch(g)
    if pitch != g or z.data_ptr() % 16:
        zp = torch.empty((n, pitch), dtype=torch.float32, device=z.device)
        zp[:, :g] = z
        zp[:, g:] = 0.0
        z = zp
    out = torch.empty((g, words_per_row(g)), dtype=torch.int32, device=z.device)
    status = lib.k11_coexpr_mask(_args.ptr(z), pitch, n, g, sum_threshold(n, threshold),
                                 _args.ptr(out), _args.stream(z))
    build.check(lib, status, "K11 coexpr_mask launch")
    launches["coexpr_mask", ""] += 1
    return out


def unpack(words: torch.Tensor, g: int) -> torch.Tensor:
    """(g, ⌈g/32⌉) int32 words → the (g, g) bool mask, on the words'
    device."""
    shifts = torch.arange(8, dtype=torch.uint8, device=words.device)
    bits = (words.contiguous().view(torch.uint8).unsqueeze(-1) >> shifts) & 1
    return bits.view(torch.bool).reshape(words.shape[0], words.shape[1] * 32)[:, :g]


def work(n: int, g: int) -> dict:
    """What K11's function needs for z of ``n`` samples × ``g`` genes
    (``_work.py``): z read once, the packed mask written; C = zᵀz is
    symmetric, so one triangle's g(g + 1)/2 dots of n products."""
    return {"bytes": n * g * 4 + g * words_per_row(g) * 4, "flops": float(g) * (g + 1) * n}


def _lib():
    lib = build.load(_LIB)
    fn = lib.k11_coexpr_mask
    if fn.argtypes is None:
        P, I, F = _args.P, _args.I, _args.F
        fn.argtypes = [P, I, I, I, F, P, P]
        fn.restype = I
    return lib
