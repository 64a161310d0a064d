"""Argument checks and ctypes plumbing shared by the kernel wrappers."""

from __future__ import annotations

import ctypes

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


def expect(t: torch.Tensor, name: str, dtype: torch.dtype, shape) -> None:
    """Raise unless ``t`` has ``dtype``, ``shape`` (None = any extent) and
    is contiguous."""
    if t.dtype != dtype:
        raise TypeError(f"{name}: expected {dtype}, got {t.dtype}")
    if t.dim() != len(shape) or any(
        s is not None and s != n for s, n in zip(shape, t.shape)
    ):
        raise ValueError(f"{name}: expected shape {tuple(shape)}, got {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: must be contiguous")


def ptr(t: torch.Tensor) -> ctypes.c_void_p:
    return ctypes.c_void_p(t.data_ptr())


def stream(t: torch.Tensor) -> ctypes.c_void_p:
    return ctypes.c_void_p(torch.cuda.current_stream(t.device).cuda_stream)


def split_k(tiles: int, groups: int, k_len: int, device: torch.device) -> int:
    """How many ranges to cut a contraction of ``k_len`` into so that
    ``tiles * groups * splits`` blocks cover the card about twice."""
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    want = -(-2 * sms // max(tiles * groups, 1))
    return max(1, min(want, -(-k_len // 64)))


P = ctypes.c_void_p
I = ctypes.c_int
F = ctypes.c_float
