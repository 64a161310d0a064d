"""K12 — streaming scale (source: ``csrc/k12_stream_scale.cu``).

The counterpart of ``experiments/test_bw.py:39`` (``pallas_copy_loop``):
``out = x · 1.0000001`` over an (n, 256) float32 tensor, one streaming
read and write of every element.  It measures the streaming bandwidth a
read-modify-write pass reaches on the card, the ceiling for K4's
finalize.  No path of the package runs it.
"""

from __future__ import annotations

import torch

from gene2vec_tpu_torch.kernels import _args, build

#: kernel launches made through :func:`stream_scale`
launches = {("stream_scale", ""): 0}

_LIB = "k12_stream_scale"
SCALE = 1.0000001


def stream_scale_plain(x):
    return x * SCALE


def stream_scale(x: torch.Tensor) -> torch.Tensor:
    """x · 1.0000001 (float32, one rounding), as a new tensor."""
    if _args.on_cpu(x):
        return stream_scale_plain(x)
    _args.expect(x, "x", torch.float32, (None,) * x.dim())
    if x.data_ptr() % 16:
        raise ValueError("x: must start on a 16-byte boundary")
    out = torch.empty_like(x)
    lib = _lib()
    status = lib.k12_stream_scale(_args.ptr(x), _args.ptr(out), x.numel(),
                                  _args.sm_count(x), _args.stream(x))
    build.check(lib, status, "K12 stream_scale launch")
    launches["stream_scale", ""] += 1
    return out


def _lib():
    lib = build.load(_LIB)
    fn = lib.k12_stream_scale
    if fn.argtypes is None:
        P, I, L = _args.P, _args.I, _args.L
        fn.argtypes = [P, P, L, I, P]
        fn.restype = I
    return lib
