"""Unigram^0.75 noise: the alias table behind the shared and per-example
modes, and the stratified noise layout
(``gene2vec_tpu/data/negative_sampling.py``).

The Vose alias table draws in O(1): j ~ U[0, V), then keep j with
probability prob[j], else take alias[j].  The table is built on the host
exactly as the reference builds it (same arrays); the draw runs on the
device from a ``torch.Generator``.

The stratified estimator splits the frequency-sorted vocab into an exact
HEAD — rows [0, head) contribute K*q_j*softplus(v.u_j) densely — and a
TAIL of ``nb`` contiguous blocks of ``block`` rows (the last block clamps
to the vocab end and may overlap its predecessor).  Each example group
draws one block uniformly; ``tail_w[j] = q_j / p_j`` divides each row's
noise weight by its draw probability p_j = (blocks containing j)/nb, so
the estimator is unbiased row by row, overlap included.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch


def noise_distribution(counts: np.ndarray, ns_exponent: float = 0.75) -> np.ndarray:
    """Normalized unigram^ns_exponent noise distribution over the vocab."""
    p = np.asarray(counts, dtype=np.float64) ** ns_exponent
    return (p / p.sum()).astype(np.float32)


class NoiseTable(NamedTuple):
    """Vose alias table: draw j ~ U[0,V), keep j with prob[j] else alias[j]."""

    prob: torch.Tensor   # (V,) float32 — acceptance probability per slot
    alias: torch.Tensor  # (V,) int32 — fallback token per slot

    @property
    def vocab_size(self) -> int:
        return int(self.prob.shape[0])

    def to(self, device) -> "NoiseTable":
        return NoiseTable(self.prob.to(device), self.alias.to(device))


def build_alias_table(probs: np.ndarray, device="cpu") -> NoiseTable:
    """Host-side O(V) Vose construction (the reference's, step for step)."""
    p = np.asarray(probs, dtype=np.float64)
    if p.ndim != 1 or p.size == 0:
        raise ValueError("probs must be a non-empty 1-D distribution")
    v = p.size
    scaled = p * v / p.sum()
    prob = np.ones(v, dtype=np.float64)
    alias = np.arange(v, dtype=np.int64)
    small = [i for i in range(v) if scaled[i] < 1.0]
    large = [i for i in range(v) if scaled[i] >= 1.0]
    while small and large:
        s, l = small.pop(), large.pop()
        prob[s] = scaled[s]
        alias[s] = l
        scaled[l] -= 1.0 - scaled[s]
        (small if scaled[l] < 1.0 else large).append(l)
    # leftovers (float round-off) keep prob 1 / self alias
    return NoiseTable(
        prob=torch.from_numpy(prob.astype(np.float32)).to(device),
        alias=torch.from_numpy(alias.astype(np.int32)).to(device),
    )


class NegativeSampler:
    """Batched categorical sampler over unigram^ns_exponent counts."""

    def __init__(self, counts: np.ndarray, ns_exponent: float = 0.75, device="cpu"):
        self.probs = noise_distribution(counts, ns_exponent)
        self.table = build_alias_table(self.probs, device=device)
        self.vocab_size = int(len(self.probs))

    def sample(self, generator: torch.Generator, shape) -> torch.Tensor:
        """Draw int32 token ids with the noise distribution."""
        return sample_negatives(self.table, generator, shape)


def sample_negatives(table: NoiseTable, generator: torch.Generator, shape) -> torch.Tensor:
    """Alias-method draw of ``shape`` int32 ids on the table's device;
    ``generator`` must live on that device."""
    dev = table.prob.device
    j = torch.randint(0, table.vocab_size, tuple(shape), generator=generator,
                      device=dev, dtype=torch.int64)
    coin = torch.rand(tuple(shape), generator=generator, device=dev)
    return torch.where(coin < table.prob[j], j, table.alias[j]).to(torch.int32)


class StratifiedSpec:
    """Geometry (host ints) + per-row weights (float32 device tensors)."""

    def __init__(self, q: torch.Tensor, tail_w: torch.Tensor, head: int,
                 block: int, nb: int):
        self.q = q
        self.tail_w = tail_w
        self.head = int(head)
        self.block = int(block)
        self.nb = int(nb)

    @property
    def vocab_size(self) -> int:
        return int(self.q.shape[0])

    def to(self, device) -> "StratifiedSpec":
        return StratifiedSpec(self.q.to(device), self.tail_w.to(device),
                              self.head, self.block, self.nb)


def build_stratified_spec(
    counts: np.ndarray,
    head: int = 256,
    block: int = 128,
    ns_exponent: float = 0.75,
    device="cpu",
) -> StratifiedSpec:
    """Host-side construction; clamps the geometry for small vocabs (head
    to half the vocab, block to the tail size) so every vocab works."""
    q = noise_distribution(counts, ns_exponent)
    v = q.shape[0]
    head = max(1, min(head, v // 2))
    block = max(1, min(block, v - head))
    nb = -(-(v - head) // block)  # ceil: last block start clamps to v - block
    starts = np.minimum(head + np.arange(nb) * block, v - block)
    coverage = np.zeros(v, np.int64)
    for s in starts:
        coverage[s : s + block] += 1
    tail_w = np.zeros(v, np.float32)
    tail = coverage > 0
    tail_w[tail] = q[tail] * nb / coverage[tail]
    return StratifiedSpec(
        q=torch.from_numpy(q).to(device),
        tail_w=torch.from_numpy(tail_w).to(device),
        head=head,
        block=block,
        nb=nb,
    )
