"""SGNS parameters: an input ("emb") and output ("ctx") table.

Initialization follows the reference (``gene2vec_tpu/sgns/model.py``):
input vectors U(−0.5/D, 0.5/D), output (context) vectors zero.  The
published artifact is the input table.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch


class SGNSParams(NamedTuple):
    emb: torch.Tensor  # (V, D) input/center vectors — the published embedding
    ctx: torch.Tensor  # (V, D) output/context vectors


def init_params(
    generator: torch.Generator, vocab_size: int, dim: int, device="cpu"
) -> SGNSParams:
    """U(−0.5/D, 0.5/D) emb and zero ctx, drawn from ``generator`` (a CPU
    generator, so the same seed gives the same tables on any device)."""
    emb = torch.rand((vocab_size, dim), generator=generator, dtype=torch.float32)
    emb = (emb - 0.5) / dim
    ctx = torch.zeros((vocab_size, dim), dtype=torch.float32)
    return SGNSParams(emb=emb.to(device), ctx=ctx.to(device))


def init_params_numpy(
    seed: int, vocab_size: int, dim: int, device="cpu"
) -> SGNSParams:
    """The reference's host-side init (same RandomState stream), so both
    packages can start from identical tables."""
    rng = np.random.RandomState(seed)
    emb = rng.uniform(-0.5 / dim, 0.5 / dim, (vocab_size, dim)).astype(np.float32)
    ctx = np.zeros((vocab_size, dim), dtype=np.float32)
    return from_jax_params(emb, ctx, device)


def from_jax_params(emb: np.ndarray, ctx: np.ndarray, device="cpu") -> SGNSParams:
    """Carry tables across from the reference (numpy arrays, e.g.
    ``np.asarray(params.emb)``) as float32 tensors on ``device``."""
    def to(t):
        return torch.from_numpy(np.array(t, dtype=np.float32, copy=True)).to(device)

    return SGNSParams(emb=to(emb), ctx=to(ctx))
