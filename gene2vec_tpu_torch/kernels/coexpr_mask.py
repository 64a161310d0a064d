"""K11 — co-expression mask (source: ``csrc/k11_coexpr_mask.cu``).

Replaces ``gene2vec_tpu/corpus/builder.py:145-171`` (``abs_correlation_mask``
with ``backend="jax"``): from the float32 standardized study matrix z
(n samples × g genes), the bits of ``clip(|zᵀz| / (n − 1), 0, 1) > thr``,
compared in float32.  Only the bits are written: row-padded ``uint32``
words, ⌈g/32⌉ a row, bit b of word w holding column 32w + b (carried in an
int32 tensor), which :func:`unpack` turns into the reference's (g, g) bool
mask.

Tolerance: the kernel sums the n products in another order than the
reference's float32 product (Eigen) and than numpy's float64 one, so a
pair whose float64 |corr| lies within :func:`eps_n` of the threshold may
land on either side.  Every other pair agrees.
"""

from __future__ import annotations

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
    out = torch.empty((g, words_per_row(g)), dtype=torch.int32, device=z.device)
    lib = _lib()
    status = lib.k11_coexpr_mask(_args.ptr(z), n, g, float(threshold), _args.ptr(out),
                                 _args.stream(z))
    build.check(lib, status, "K11 coexpr_mask launch")
    launches["coexpr_mask", ""] += 1
    return out


def unpack(words: torch.Tensor, g: int) -> torch.Tensor:
    """(g, ⌈g/32⌉) int32 words → the (g, g) bool mask, on the words'
    device."""
    shifts = torch.arange(8, dtype=torch.uint8, device=words.device)
    bits = (words.contiguous().view(torch.uint8).unsqueeze(-1) >> shifts) & 1
    return bits.view(torch.bool).reshape(words.shape[0], words.shape[1] * 32)[:, :g]


def _lib():
    lib = build.load(_LIB)
    fn = lib.k11_coexpr_mask
    if fn.argtypes is None:
        P, I, F = _args.P, _args.I, _args.F
        fn.argtypes = [P, I, I, F, P, P]
        fn.restype = I
    return lib
