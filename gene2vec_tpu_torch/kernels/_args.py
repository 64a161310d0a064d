"""Argument checks and ctypes plumbing shared by the kernel wrappers."""

from __future__ import annotations

import ctypes
import functools

import torch


def on_cpu(*tensors: torch.Tensor) -> bool:
    """True when every tensor lies on the CPU (→ the plain version), False
    when all lie on one CUDA device (→ the kernel); raises otherwise."""
    devs = {t.device for t in tensors}
    if len(devs) != 1:
        raise ValueError(f"tensors on several devices: {sorted(map(str, devs))}")
    dev = devs.pop()
    if dev.type == "cpu":
        return True
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}")
    return False


#: the element types a training table may have (``SGNSConfig.table_dtype``)
TABLE_DTYPES = (torch.float32, torch.bfloat16)


def expect(t: torch.Tensor, name: str, dtype, shape) -> None:
    """Raise unless ``t`` has ``dtype`` (or one of a tuple of dtypes),
    ``shape`` (None = any extent) and is contiguous."""
    # the common case first, with no generator: every launch of a step
    # passes through here several times
    if t.dtype is dtype or (type(dtype) is tuple and t.dtype in dtype):
        ts = t.shape
        if len(ts) == len(shape):
            for s, n in zip(shape, ts):
                if s is not None and s != n:
                    break
            else:
                if t.is_contiguous():
                    return
    ok = dtype if isinstance(dtype, tuple) else (dtype,)
    if t.dtype not in ok:
        raise TypeError(f"{name}: expected {' or '.join(map(str, ok))}, got {t.dtype}")
    if t.dim() != len(shape) or any(
        s is not None and s != n for s, n in zip(shape, t.shape)
    ):
        raise ValueError(f"{name}: expected shape {tuple(shape)}, got {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: must be contiguous")


def table_bf16(tables, names, shapes) -> int:
    """Check training tables (float32 or bfloat16, all of one type, each of
    its shape, contiguous); returns the kernels' ``bf16`` flag (1 for
    bfloat16)."""
    for t, name, shape in zip(tables, names, shapes):
        expect(t, name, TABLE_DTYPES, shape)
    if len({t.dtype for t in tables}) != 1:
        raise TypeError(f"{', '.join(names)}: tables of several dtypes "
                        f"{sorted(str(t.dtype) for t in tables)}")
    for t, name in zip(tables, names):
        if t.data_ptr() % 16:  # the kernels' 16-byte row loads
            raise ValueError(f"{name}: must start on a 16-byte boundary")
    return int(tables[0].dtype == torch.bfloat16)


def table_kind(t: torch.Tensor, name: str) -> bool:
    """True for a bfloat16 scan table, False for int8; raises otherwise."""
    if t.dtype not in (torch.int8, torch.bfloat16):
        raise TypeError(f"{name}: expected int8 or bfloat16, got {t.dtype}")
    return t.dtype == torch.bfloat16


def ptr(t: torch.Tensor) -> ctypes.c_void_p:
    return ctypes.c_void_p(t.data_ptr())


def stream(t: torch.Tensor) -> ctypes.c_void_p:
    return ctypes.c_void_p(torch.cuda.current_stream(t.device).cuda_stream)


@functools.lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def sm_count(t: torch.Tensor) -> int:
    """Multiprocessors of the card ``t`` lies on."""
    return _sm_count(t.device.index if t.device.index is not None
                     else torch.cuda.current_device())


def noise_ranges(tiles: int, k_len: int, t: torch.Tensor) -> int:
    """How many example ranges K2/K3's second launch cuts a contraction of
    ``k_len`` examples into, so that ``tiles`` output tiles times the
    ranges put at most one block on each SM (ranges of at least 32)."""
    return max(1, min(sm_count(t) // max(tiles, 1), -(-k_len // 32)))


def padded_slab(s: int) -> int:
    """K2/K3's g rows: ``s`` slab columns padded to a multiple of 4 (so
    the second launch copies them in 16-byte pieces)."""
    return -(-s // 4) * 4


P = ctypes.c_void_p
I = ctypes.c_int
F = ctypes.c_float
U32 = ctypes.c_uint32
L = ctypes.c_longlong
