"""Device selection for the port's entry points.

Entry points run on ``cuda`` unless the caller asks for the CPU.  Without
a GPU they raise rather than carry on quietly on the CPU.
"""

from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    """``None``/"cuda" → the current CUDA device (raises if there is none);
    "cpu" → the CPU, only when asked for by name."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; gene2vec_tpu_torch runs on the "
            "GPU unless device='cpu' is passed explicitly"
        )
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {device!r}")
    return dev
