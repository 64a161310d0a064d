"""Contiguous row shards of one embedding table across serving
processes — copies of the numpy helpers of
``gene2vec_tpu/parallel/sharding.py`` (``shard_ranges`` :118,
``shard_of_row`` :146, ``merge_shard_topk`` :155).

``cli.fleet --shard-by-rows N`` gives each replica the rows
``shard_ranges(V, N)[i]``; the front door routes a gene to its owner with
``shard_of_row`` and merges the shards' local top-k candidate sets with
``merge_shard_topk`` (``serve/shardgroup.py``).
"""

from __future__ import annotations

from typing import List, Sequence, Tuple

import numpy as np


def shard_ranges(total_rows: int, num_shards: int,
                 pad_to_multiple: bool = False) -> List[Tuple[int, int]]:
    """Contiguous ``[start, end)`` row ranges assigning ``total_rows``
    to ``num_shards``.  Balanced by default (the first ``total % n``
    shards take the ceiling), which is what the serving fleet uses;
    ``pad_to_multiple=True`` gives every shard ``ceil(total/n)`` rows,
    the trailing ones running past ``total_rows`` (the device layout of
    a row-sharded mesh)."""
    if num_shards < 1:
        raise ValueError(f"num_shards must be >= 1, got {num_shards}")
    if total_rows < 0:
        raise ValueError(f"total_rows must be >= 0, got {total_rows}")
    if pad_to_multiple:
        per = -(-total_rows // num_shards) if total_rows else 0
        return [(i * per, (i + 1) * per) for i in range(num_shards)]
    base, extra = divmod(total_rows, num_shards)
    out = []
    start = 0
    for i in range(num_shards):
        end = start + base + (1 if i < extra else 0)
        out.append((start, end))
        start = end
    return out


def shard_of_row(row: int, ranges) -> int:
    """Owning shard index for a global row under ``ranges``."""
    for i, (start, end) in enumerate(ranges):
        if start <= row < end:
            return i
    raise ValueError(f"row {row} outside every shard range")


def merge_shard_topk(parts: Sequence, k: int) -> Tuple[np.ndarray, np.ndarray]:
    """Merge shard-local top-k candidate sets across processes.

    ``parts`` is a sequence, in shard order, of ``(scores, rows)`` pairs:
    ``(B, lk_i)`` float32 scores (descending per row) with their GLOBAL
    row ids.  Returns ``(B, k')`` merged scores and rows, ``k' = min(k,
    total candidates)``, descending by score with ties broken toward the
    earlier position in the concatenated candidate axis (``lax.top_k``'s
    rule, so the merge equals the reference's in-mesh ``two_stage_topk``
    on the same table bit for bit).  A dead shard contributes no columns:
    the answer is the exact one over the live shards' rows."""
    parts = [p for p in parts if p is not None]
    if not parts:
        raise ValueError("merge_shard_topk needs at least one shard part")
    scores = np.concatenate([np.asarray(s, dtype=np.float32) for s, _ in parts], axis=1)
    rows = np.concatenate([np.asarray(r) for _, r in parts], axis=1)
    k_eff = min(int(k), scores.shape[1])
    # a stable sort of the negated scores keeps equal scores in candidate order
    order = np.argsort(-scores, axis=1, kind="stable")[:, :k_eff]
    return (np.take_along_axis(scores, order, axis=1),
            np.take_along_axis(rows, order, axis=1))
