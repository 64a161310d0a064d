"""Unigram^0.75 noise and the stratified noise layout
(``gene2vec_tpu/data/negative_sampling.py:27-30, 88-156``).

The stratified estimator splits the frequency-sorted vocab into an exact
HEAD — rows [0, head) contribute K*q_j*softplus(v.u_j) densely — and a
TAIL of ``nb`` contiguous blocks of ``block`` rows (the last block clamps
to the vocab end and may overlap its predecessor).  Each example group
draws one block uniformly; ``tail_w[j] = q_j / p_j`` divides each row's
noise weight by its draw probability p_j = (blocks containing j)/nb, so
the estimator is unbiased row by row, overlap included.

The alias table behind the shared and per-example modes is not ported.
"""

from __future__ import annotations

import numpy as np
import torch


def noise_distribution(counts: np.ndarray, ns_exponent: float = 0.75) -> np.ndarray:
    """Normalized unigram^ns_exponent noise distribution over the vocab."""
    p = np.asarray(counts, dtype=np.float64) ** ns_exponent
    return (p / p.sum()).astype(np.float32)


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
