"""Pair-stream pipeline (``gene2vec_tpu/data/pipeline.py``): the encoded
corpus lives on the device as one (N, 2) int32 tensor and each epoch's
shuffle is a handful of index operations there.

Every random draw of a shuffle can be passed in as a :class:`ShuffleDraw`
(the reference's draws, recomputed with its own key derivations, in the
parity tests).  Without one, :func:`draw_shuffle` makes a draw of the same
shape and distribution from a ``torch.Generator``.

Batching drops the ragged tail (< batch_pairs pairs) of each epoch, as the
reference does.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

from gene2vec_tpu_torch.io.vocab import Vocab


class PairCorpus:
    """Encoded pair corpus (host numpy) + vocab."""

    def __init__(self, vocab: Vocab, pairs: np.ndarray):
        pairs = np.asarray(pairs, dtype=np.int32)
        if pairs.ndim != 2 or pairs.shape[1] != 2:
            raise ValueError(f"pairs must be (N, 2), got {pairs.shape}")
        self.vocab = vocab
        self.pairs = pairs

    @property
    def num_pairs(self) -> int:
        return int(self.pairs.shape[0])

    @property
    def vocab_size(self) -> int:
        return len(self.vocab)

    def num_batches(self, batch_pairs: int) -> int:
        return self.num_pairs // batch_pairs

    def device_pairs(self, device) -> torch.Tensor:
        """Upload the corpus once."""
        return torch.from_numpy(self.pairs).to(device)


class ShuffleDraw(NamedTuple):
    """The random draws of one :func:`epoch_shuffle` call.

    ``"offset"`` mode: ``offset`` is the circular roll in [0, num_pairs)
    and ``perm`` a permutation of the epoch span's 512-pair blocks
    (``pipeline.py:146-153``).  ``"full"`` mode: ``perm`` is a row
    permutation of at least num_batches·batch_pairs entries."""

    offset: int
    perm: np.ndarray


def _shuffle_block(span: int, batch_pairs: int) -> int:
    return 512 if span % 512 == 0 else batch_pairs


def draw_shuffle(
    num_pairs: int, num_batches: int, batch_pairs: int, mode: str,
    generator: torch.Generator,
) -> ShuffleDraw:
    """Draws of the reference's shapes and distributions from ``generator``
    (a CPU generator: the same seed gives the same epoch on any device)."""
    span = num_batches * batch_pairs
    if mode == "full":
        perm = torch.randperm(num_pairs, generator=generator)[:span]
        return ShuffleDraw(0, perm.numpy())
    if mode != "offset":
        raise ValueError(f"unknown shuffle_mode {mode!r}")
    offset = int(torch.randint(0, num_pairs, (), generator=generator))
    nblocks = span // _shuffle_block(span, batch_pairs)
    return ShuffleDraw(offset, torch.randperm(nblocks, generator=generator).numpy())


def epoch_shuffle(
    pairs: torch.Tensor,
    num_pairs: int,
    num_batches: int,
    batch_pairs: int,
    mode: str,
    draw: Optional[ShuffleDraw] = None,
    generator: Optional[torch.Generator] = None,
    enabled: bool = True,
) -> torch.Tensor:
    """Per-epoch corpus shuffle; returns rows the epoch slices in order.

    ``"offset"`` (default): the corpus was host-shuffled once, and each
    epoch applies a random circular roll plus a permutation of fixed
    512-pair blocks — coalesced block copies, no per-row gather.
    ``"full"``: an exact per-epoch row permutation."""
    if not enabled:
        return pairs
    if draw is None:
        draw = draw_shuffle(num_pairs, num_batches, batch_pairs, mode, generator)
    span = num_batches * batch_pairs
    perm = torch.from_numpy(np.array(draw.perm, dtype=np.int64)).to(pairs.device)
    if mode == "full":
        return pairs[perm[:span]]
    if mode != "offset":
        raise ValueError(f"unknown shuffle_mode {mode!r}")
    block = _shuffle_block(span, batch_pairs)
    rolled = torch.roll(pairs, int(draw.offset), dims=0)
    blocks = rolled[:span].reshape(span // block, block, 2)
    return blocks[perm].reshape(span, 2)


def pool_class_pairs(n_classes: int):
    """Canonical (class_a, class_b) per pool, a <= b, lexicographic."""
    return [(a, b) for a in range(n_classes) for b in range(a, n_classes)]


def segment_corpus_by_head(
    pairs: np.ndarray, head, batch_pairs: int
) -> Tuple[Tuple[np.ndarray, ...], Tuple[int, ...]]:
    """Host-side class segmentation (copy of the reference's): classify
    each token by frequency band (``head`` is one boundary, or an
    ascending sequence such as ``(512, 2560)`` for head/mid/tail), split
    the corpus into one pool per unordered class pair (lower-class token
    first), and compute static per-batch quotas summing to
    ``batch_pairs`` so every batch carries the corpus's class mix at fixed
    offsets — the [HH|HT|TT] / [HH|HM|HT|MM|MT|TT] layout that decides
    which pairs share a step.

    Quotas are floors of each pool's share of ``num_batches`` batches,
    settled deterministically (largest-pool decrement / largest-leftover
    increment, the latter wrap-padding its pool).  The reference's
    ``multiple`` (per-device quotas) is 1 here: the port has no mesh."""
    if batch_pairs <= 0 or pairs.shape[0] < batch_pairs:
        raise ValueError(
            f"cannot segment {pairs.shape[0]} pairs into batches of {batch_pairs}"
        )
    boundaries = np.atleast_1d(np.asarray(head, dtype=np.int64))
    if boundaries.ndim != 1 or np.any(np.diff(boundaries) <= 0):
        raise ValueError(f"head boundaries must be ascending, got {head}")
    n_classes = len(boundaries) + 1
    num_batches = pairs.shape[0] // batch_pairs
    cls = np.searchsorted(boundaries, pairs, side="right")
    swap = cls[:, 0] > cls[:, 1]
    canon = pairs.copy()
    canon[swap] = canon[swap][:, ::-1]
    cls.sort(axis=1)
    pools = [
        canon[(cls[:, 0] == a) & (cls[:, 1] == b)]
        for a, b in pool_class_pairs(n_classes)
    ]
    floors = [1 if len(p) else 0 for p in pools]
    if sum(floors) > batch_pairs:
        raise ValueError(
            f"batch_pairs={batch_pairs} is smaller than the number of "
            f"non-empty head classes ({sum(floors)})"
        )
    quotas = [max(len(p) // num_batches, f) for p, f in zip(pools, floors)]
    while sum(quotas) > batch_pairs:
        c = int(np.argmax([q if q > f else -1 for q, f in zip(quotas, floors)]))
        quotas[c] -= 1
    while sum(quotas) < batch_pairs:
        leftover = [len(p) - q * num_batches for p, q in zip(pools, quotas)]
        quotas[int(np.argmax(leftover))] += 1
    for c, (pool, q) in enumerate(zip(pools, quotas)):
        need = q * num_batches
        if 0 < len(pool) < need:
            reps = -(-need // len(pool))
            pools[c] = np.concatenate([pool] * reps, axis=0)[:need]
    return tuple(pools), tuple(quotas)


def segmented_epoch_shuffle(
    pools: Sequence[torch.Tensor],
    quotas: Sequence[int],
    num_batches: int,
    mode: str,
    draws: Optional[Sequence[Optional[ShuffleDraw]]] = None,
    generator: Optional[torch.Generator] = None,
    enabled: bool = True,
):
    """Per-epoch shuffle of class-segmented pools: each pool shuffles on
    its own (one draw per pool, ``draws[i]``; zero-quota pools take none),
    and batch ``b`` is rows ``[b*q_c, (b+1)*q_c)`` of every pool."""
    out = []
    for i, (pool, q) in enumerate(zip(pools, quotas)):
        if q == 0:
            out.append(pool[:0])
            continue
        out.append(epoch_shuffle(
            pool, int(pool.shape[0]), num_batches, q, mode,
            draw=None if draws is None else draws[i],
            generator=generator, enabled=enabled,
        ))
    return tuple(out)


def segmented_batch(
    pools: Sequence[torch.Tensor], quotas: Sequence[int], step: int
) -> torch.Tensor:
    """Batch ``step`` of shuffled class-segmented pools: each pool's quota
    slice, in pool order — the [HH|HT|TT] / [HH|HM|HT|MM|MT|TT] layout."""
    return torch.cat(
        [pool[step * q : (step + 1) * q] for pool, q in zip(pools, quotas) if q], dim=0
    )


def host_preshuffle(corpus: PairCorpus, seed: int) -> PairCorpus:
    """One-time host-side shuffle backing the offset mode (the same
    ``np.random.RandomState(seed)`` permutation as the reference)."""
    rng = np.random.RandomState(seed)
    return PairCorpus(corpus.vocab, corpus.pairs[rng.permutation(corpus.num_pairs)])
