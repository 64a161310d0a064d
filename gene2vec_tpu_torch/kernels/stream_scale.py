"""K12 — streaming scale (source: ``csrc/k12_stream_scale.cu``).

The counterpart of ``experiments/test_bw.py:39`` (``pallas_copy_loop``:
``out = x · 1.0000001`` over (n, 256) float32) and
``experiments/test_lane_gather.py:100`` (``stream_copy``: the same over a
(256, 24576) table, float32 and bfloat16): one streaming read and write
of every element, ``out = x · scale`` as one float32 multiply (bfloat16
rounded back to nearest-even).  It measures the streaming bandwidth a
read-modify-write pass reaches on the card, the ceiling for K4's
finalize.  No path of the package runs it.
"""

from __future__ import annotations

import torch

from gene2vec_tpu_torch.kernels import _args, build

#: kernel launches made through :func:`stream_scale`, by element type
#: ("" float32, "bf16")
launches = {("stream_scale", ""): 0, ("stream_scale", "bf16"): 0}

_LIB = "k12_stream_scale"
SCALE = 1.0000001


def stream_scale_plain(x, scale: float = SCALE):
    return x * scale


def stream_scale(x: torch.Tensor, scale: float = SCALE) -> torch.Tensor:
    """x · scale (one float32 rounding; bfloat16 rounded to nearest-even),
    as a new tensor of x's type."""
    if _args.on_cpu(x):
        return stream_scale_plain(x, scale)
    _args.expect(x, "x", _args.TABLE_DTYPES, (None,) * x.dim())
    if x.data_ptr() % 16:
        raise ValueError("x: must start on a 16-byte boundary")
    bf16 = int(x.dtype == torch.bfloat16)
    out = torch.empty_like(x)
    lib = _lib()
    status = lib.k12_stream_scale(_args.ptr(x), _args.ptr(out), x.numel(), float(scale), bf16,
                                  _args.stream(x))
    build.check(lib, status, "K12 stream_scale launch")
    launches["stream_scale", "bf16" if bf16 else ""] += 1
    return out


def _lib():
    lib = build.load(_LIB)
    fn = lib.k12_stream_scale
    if fn.argtypes is None:
        P, I, L, F = _args.P, _args.I, _args.L, _args.F
        fn.argtypes = [P, P, L, F, I, P]
        fn.restype = I
    return lib
