"""Helpers of the kernels' ``work`` functions.

Each kernel module has a pure function of shapes and ids that returns
what the kernel's function must do as a dict: ``bytes`` (each input read
once, each output written once; where the work depends on the ids, what
these ids need, such as each distinct table row read once) and
``flops`` (float32 operations outside the tensor cores, an FMA counted as
two), and where the kernel's route uses them ``tf32_ops``, ``bf16_ops``,
``int8_ops`` (tensor-core operations) and ``sfu_ops`` (special-function
unit: ex2, rcp, rsqrt).  Other keys are the counts those are made of.
``obs/profiler.py:bound`` turns a dict into the least time the card could
take, and ``chip_smoke.py`` gives each kernel that bound at its shapes.
"""

from __future__ import annotations

import numpy as np
import torch

#: 3xTF32 tensor-core passes of (the logits, d_center, the accumulator's
#: gᵀv) in ``csrc/noise_tc.cuh``: 3 a product, 2 where a bfloat16 table
#: row is an operand (the accumulator's product is float32 either way)
TF32_PASSES = {False: (3, 3, 3), True: (2, 2, 3)}


def _flat(ids) -> torch.Tensor:
    if isinstance(ids, torch.Tensor):
        return ids.reshape(-1).to(torch.int64)
    return torch.from_numpy(np.asarray(ids, dtype=np.int64).reshape(-1))


def distinct(*ids) -> int:
    """Distinct values across ``ids`` (tensors or arrays of any shapes; the
    tensors on one device)."""
    parts = [_flat(i) for i in ids]
    if not parts:
        return 0
    dev = parts[0].device
    return int(torch.unique(torch.cat([p.to(dev) for p in parts])).numel())


def count(ids) -> int:
    """Elements of ``ids``."""
    return int(ids.numel()) if isinstance(ids, torch.Tensor) else int(np.asarray(ids).size)
