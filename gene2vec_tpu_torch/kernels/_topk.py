"""Selection order and launch plan shared by the serving kernels K7-K9r.

**Order.**  ``lax.top_k`` ranks by value descending, the lower index
first among equal values, with ``+0.0`` ahead of ``-0.0`` and ``-inf``
last: the order of the integer key ``bits ^ ((bits >> 31) & 0x7fffffff)``
of each float32, which is what the kernels sort by
(``csrc/topk_common.cuh``).  :func:`topk_plain` is that order in plain
PyTorch: a stable descending sort of the keys.

**Plan.**  A kernel scores ``n`` rows for each query in tiles of ``T``
rows (a power of two), keeps each tile's top-``keep`` in shared memory
and merges the tiles' lists; ``QB`` queries share a tile so each row is
read once per ``QB`` queries.  :func:`plan` fixes ``T`` and ``QB`` and
the scratch the merge needs; the CUDA side derives the same tile count
from ``T``.
"""

from __future__ import annotations

import dataclasses

import torch

_EPS = 1e-12

#: shared memory a tile block may use for its scores, sort buffer and
#: queries (the card allows 227 KB a block)
SMEM_BUDGET = 160 * 1024
#: most pairs one merge block sorts (128 KB of keys and ids)
MERGE_MAX = 16384
#: most queries one tile block scores (registers: one sum per query)
QB_MAX = 8


def order_keys(scores: torch.Tensor) -> torch.Tensor:
    """float32 → int32 keys whose signed order is ``lax.top_k``'s."""
    bits = scores.contiguous().view(torch.int32)
    return bits ^ ((bits >> 31) & 0x7FFFFFFF)


def topk_plain(scores: torch.Tensor, k: int):
    """``lax.top_k(scores, k)`` over the last axis: (values, int32
    indices)."""
    order = torch.sort(order_keys(scores), dim=-1, descending=True, stable=True).indices
    order = order[..., :k]
    return torch.gather(scores, -1, order), order.to(torch.int32)


def normalize_plain(queries: torch.Tensor) -> torch.Tensor:
    """``q / max(‖q‖, 1e-12)`` per row, as the reference's ``_normalize``."""
    norms = torch.sqrt(torch.sum(queries * queries, dim=1, keepdim=True))
    return queries / torch.clamp_min(norms, _EPS)


def next_pow2(n: int) -> int:
    return 1 << max(0, int(n) - 1).bit_length()


@dataclasses.dataclass(frozen=True)
class Plan:
    tile: int       # rows per tile (power of two, >= keep)
    qb: int         # queries per tile block
    ntiles: int
    scratch: int    # pairs in each of the two ping-pong scratch buffers


def plan(n: int, keep: int, batch: int, query_bytes: int, per_query: bool,
         sms: int = 0) -> Plan:
    """Tile size and queries per block for ``n`` rows, top-``keep``.
    ``query_bytes`` is the shared memory one query takes in the tile
    block; ``per_query`` means every query has rows of its own (a
    candidate list), so blocks hold one query each.  Tiles start at
    max(1024, 4·keep) rows (at most 8192) and halve, down to max(256,
    4·keep), while the grid would cover the ``sms`` multiprocessors less
    than twice; keeping T >= 4·keep bounds what the merge sorts."""
    if not 1 <= keep <= n:
        raise ValueError(f"need 1 <= keep <= rows, got keep={keep}, rows={n}")
    if keep > MERGE_MAX // 2:
        raise ValueError(f"keep={keep} exceeds {MERGE_MAX // 2}")

    def clamp(t):
        return max(min(t, 8192, next_pow2(n)), next_pow2(keep), 32)

    def queries_per_block(t):
        if per_query:
            return 1
        fit = (SMEM_BUDGET - 8 * t) // (4 * t + query_bytes)
        return max(1, min(QB_MAX, batch, fit))

    tile = clamp(max(next_pow2(4 * keep), 1024))
    floor = clamp(max(next_pow2(4 * keep), 256))
    while tile > floor and (-(-n // tile)) * (-(-batch // queries_per_block(tile))) < 2 * sms:
        tile //= 2
    ntiles = -(-n // tile)
    return Plan(tile, queries_per_block(tile), ntiles, batch * ntiles * keep)


def scratch(p: Plan, device) -> torch.Tensor:
    """Two ping-pong (key, id) buffers for the tile lists and merges."""
    return torch.empty((4, max(p.scratch, 1)), dtype=torch.int32, device=device)
