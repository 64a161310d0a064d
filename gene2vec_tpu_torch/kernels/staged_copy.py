"""K14 — staged copy through shared memory by TMA bulk copies (source:
``csrc/k14_staged_copy.cu``).

The counterpart of the Pallas staging probes, (N, D) float32:
``experiments/test_dma2.py:83`` (``callh``, 8-row tiles),
``experiments/test_vmem_dma.py:24`` (``vmem_probe``, a capacity probe)
and ``experiments/test_feature_matrix.py:35-132`` (``calla`` … ``callf``:
scalar prefetch, DMA with a semaphore, scratch staging, a direct HBM
read, an SMEM-scalar dynamic slice).  It computes

* ``out[r] = scale · x[off + r]`` for ``r < head``, ``off`` the first
  element of the device int32 ``offset``, clamped so the rows lie in x
  (as ``dynamic_slice`` clamps);
* ``out[r] = scale · x[r − head]`` for ``r ≥ head``;

so ``head = 0`` is a scaled copy.  ``tile_rows`` rows a block are staged
(8 up to :func:`max_tile_rows`, the card's opt-in shared-memory limit).
No path of the package runs it.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Optional

import torch

from gene2vec_tpu_torch.kernels import _args, build

#: kernel launches made through :func:`staged_copy`
launches = {("staged_copy", ""): 0}

_LIB = "k14_staged_copy"


def _source_rows(n: int, head: int, offset: Optional[torch.Tensor], device) -> torch.Tensor:
    off = int(offset.reshape(-1)[0]) if offset is not None else 0
    off = min(max(off, 0), n - head)
    return torch.cat([torch.arange(off, off + head, device=device),
                      torch.arange(0, n - head, device=device)])


def staged_copy_plain(x, scale: float = 1.0, offset=None, head: int = 0):
    if head == 0:
        return x * scale
    return x.index_select(0, _source_rows(x.shape[0], head, offset, x.device)) * scale


def staged_copy(x: torch.Tensor, scale: float = 1.0, tile_rows: int = 8,
                offset: Optional[torch.Tensor] = None, head: int = 0) -> torch.Tensor:
    """(N, D) float32 → the staged scaled copy described above, as a new
    tensor.  ``offset`` (an int32 tensor; its first element is read) is
    needed when ``head > 0``."""
    n = x.shape[0]
    if not 0 <= head <= n:
        raise ValueError(f"head={head} outside [0, {n}]")
    if head and offset is None:
        raise ValueError("head > 0 needs an offset")
    if tile_rows < 1:
        raise ValueError(f"tile_rows={tile_rows} must be positive")
    tensors = (x,) if offset is None else (x, offset)
    if _args.on_cpu(*tensors):
        return staged_copy_plain(x, scale, offset, head)
    _args.expect(x, "x", torch.float32, (n, None))
    d = x.shape[1]
    if (4 * d) % 16 or x.data_ptr() % 16:
        raise ValueError("x: rows must be a multiple of 16 bytes from a 16-byte boundary "
                         "(bulk copies)")
    if offset is not None:
        _args.expect(offset, "offset", torch.int32, (None,) * offset.dim())
        if offset.numel() < 1:
            raise ValueError("offset: empty")
    lib = _lib()
    if tile_rows > max_tile_rows(x, d):
        raise ValueError(f"tile_rows={tile_rows} exceeds the card's shared memory "
                         f"({max_tile_rows(x, d)} rows of {d} floats)")
    out = torch.empty_like(x)
    status = lib.k14_staged_copy(_args.ptr(x), _args.ptr(out), n, d, tile_rows, head,
                                 _args.ptr(offset) if offset is not None else None,
                                 float(scale), _args.stream(x))
    build.check(lib, status, "K14 staged_copy launch")
    launches["staged_copy", ""] += 1
    return out


def max_tile_rows(x: torch.Tensor, d: int) -> int:
    """The most rows of ``d`` float32 a block can stage on ``x``'s card
    (the opt-in shared-memory limit less the kernel's static use), a
    multiple of 8."""
    return _max_tile_bytes(x.device.index) // (4 * d) // 8 * 8


@functools.lru_cache(maxsize=None)
def _max_tile_bytes(index: int) -> int:
    lib = _lib()
    out = ctypes.c_int(0)
    build.check(lib, lib.k14_max_tile_bytes(index, ctypes.byref(out)), "K14 shared memory query")
    return out.value


def work(n: int, d: int) -> dict:
    """What K14's function needs for an (n, d) float32 x (``_work.py``): x
    read and the result written; a product an element."""
    return {"bytes": 2 * 4 * n * d, "flops": float(n * d)}


def _lib():
    lib = build.load(_LIB)
    if lib.k14_staged_copy.argtypes is None:
        P, I, F = _args.P, _args.I, _args.F
        lib.k14_staged_copy.argtypes = [P, P, I, I, I, I, P, F, P]
        lib.k14_staged_copy.restype = I
        lib.k14_max_tile_bytes.argtypes = [I, ctypes.POINTER(ctypes.c_int)]
        lib.k14_max_tile_bytes.restype = I
    return lib
