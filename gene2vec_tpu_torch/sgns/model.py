"""SGNS parameters: an input ("emb") and output ("ctx") table.

Initialization follows the reference (``gene2vec_tpu/sgns/model.py``):
input vectors U(−0.5/D, 0.5/D), output (context) vectors zero.  The
published artifact is the input table.  Under hierarchical softmax the
output table is the (V − 1, D) Huffman node table (``out_rows``).
Tables are float32 or bfloat16 (``SGNSConfig.table_dtype``); a bfloat16
table is drawn in float32 and rounded to nearest-even, as the reference's
``astype``.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Union

import numpy as np
import torch

#: ``SGNSConfig.table_dtype`` → torch dtype
_TORCH_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


class SGNSParams(NamedTuple):
    emb: torch.Tensor  # (V, D) input/center vectors — the published embedding
    ctx: torch.Tensor  # (V, D) output/context vectors, or (V-1, D) HS nodes


def table_dtype(dtype: Union[str, torch.dtype]) -> torch.dtype:
    """A table dtype given by its config name or as a torch dtype."""
    if isinstance(dtype, torch.dtype):
        if dtype not in _TORCH_DTYPES.values():
            raise ValueError(f"unsupported table dtype {dtype}")
        return dtype
    if dtype not in _TORCH_DTYPES:
        raise ValueError(f"unknown table_dtype {dtype!r}")
    return _TORCH_DTYPES[dtype]


def init_params(
    generator: torch.Generator, vocab_size: int, dim: int, device="cpu",
    out_rows: Optional[int] = None, dtype=torch.float32,
) -> SGNSParams:
    """U(−0.5/D, 0.5/D) emb and a zero (``out_rows`` or V, D) output
    table of ``dtype``, drawn from ``generator`` (a CPU generator, so the
    same seed gives the same tables on any device)."""
    dtype = table_dtype(dtype)
    emb = torch.rand((vocab_size, dim), generator=generator, dtype=torch.float32)
    emb = (emb - 0.5) / dim
    rows = vocab_size if out_rows is None else out_rows
    ctx = torch.zeros((rows, dim), dtype=torch.float32)
    return SGNSParams(emb=emb.to(device, dtype), ctx=ctx.to(device, dtype))


def init_params_numpy(
    seed: int, vocab_size: int, dim: int, device="cpu", out_rows: Optional[int] = None,
    dtype=torch.float32,
) -> SGNSParams:
    """The reference's host-side init (same RandomState stream, float32,
    then cast to ``dtype``), so both packages can start from identical
    tables."""
    rng = np.random.RandomState(seed)
    emb = rng.uniform(-0.5 / dim, 0.5 / dim, (vocab_size, dim)).astype(np.float32)
    rows = vocab_size if out_rows is None else out_rows
    ctx = np.zeros((rows, dim), dtype=np.float32)
    return from_jax_params(emb, ctx, device, dtype=dtype)


def from_jax_params(emb, ctx, device="cpu", dtype=None) -> SGNSParams:
    """Carry tables across from the reference (numpy or JAX arrays, e.g.
    ``np.asarray(params.emb)``) as tensors on ``device``: float32 or
    bfloat16 per ``dtype``, or (None) each at its source's width.  A
    bfloat16 source crosses bit-exactly (bfloat16 → float32 is exact)."""
    def to(t):
        want = table_dtype(dtype) if dtype is not None else (
            torch.bfloat16 if str(getattr(t, "dtype", "")) == "bfloat16" else torch.float32)
        f32 = torch.from_numpy(np.array(t, dtype=np.float32, copy=True))
        return f32.to(device, want)

    return SGNSParams(emb=to(emb), ctx=to(ctx))
