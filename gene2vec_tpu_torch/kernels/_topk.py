"""Selection order and launch plans shared by the serving kernels K7-K9r.

**Order.**  ``lax.top_k`` ranks by value descending, the lower index
first among equal values, with ``+0.0`` ahead of ``-0.0`` and ``-inf``
last: the order of the integer key ``bits ^ ((bits >> 31) & 0x7fffffff)``
of each float32, then of the row — what the kernels select and sort by
(``csrc/topk_common.cuh``).  :func:`topk_plain` is that order in plain
PyTorch: a stable descending sort of the keys.

**Plans.**  A call makes two launches.  The scan cuts the ``n`` rows into
chunks of ``tile`` rows; a block scores one chunk for ``qb`` queries and
writes each query's top-``slot`` (``slot = min(keep, tile)``) to that
query's run in the scratch buffers.  The final launch gives each query a
block that selects the top-``keep`` of its ``ntiles`` runs, sorts them and
writes them.  Plans are pure functions of their arguments and cached
(a serving call costs host time).  :func:`plan_staged` plans K7 and K8, whose blocks stage
tiles of ``rows`` table rows in shared memory and score every query of a
group of up to 64 against them (rows too wide for a 32-row tile beside
one query: tiles of ``dslice``-column slices of the rows, whose partial
scores add up before the select); :func:`plan` plans K9 and K9r, a thread a
row or candidate and up to 8 queries a block (one for per-query
candidates).  Lists longer than ``SORT_MAX`` (any ``keep`` up to the row
count works, as in the reference) are sorted in ``SORT_MAX`` runs that
the final block merges in the scratch buffers, so each query's region
(``stride`` pairs) holds at least ``keep`` rounded up to ``SORT_MAX``.
"""

from __future__ import annotations

import dataclasses
import functools

import torch

_EPS = 1e-12

#: dynamic shared memory a scan block may use (the card allows 227 KB a
#: block; the kernels' static shared memory and mbarriers take the rest)
SMEM_BUDGET = 220 * 1024
#: most pairs one merge block sorts in shared memory at once is half this;
#: longer lists are sorted in runs and merged in device memory
MERGE_MAX = 16384
SORT_MAX = MERGE_MAX // 2
#: most rows a scan block keeps scores for (a multiple of 64)
CHUNK_MAX = 512
#: most queries a thread-per-row block scores (registers: one sum each)
QB_MAX = 8
#: most queries a staged block scores
QG_MAX = 64
#: a scan block's select state (3 double words, 16 bins and 4 words for
#: each of up to QG_MAX queries)
SELECT_BYTES = QG_MAX * (3 * 8 + 4 * 20)
#: bytes per element of a staged table, by kind
ELEMENT_BYTES = {"float32": 4, "bfloat16": 2, "int8": 1}
#: rows of a d-sliced tile; the widest slice (a multiple of 32 columns)
SLICED_ROWS = 32
SLICE_MAX = 1024


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


def _ceil(a: int, b: int) -> int:
    return -(-a // b)


def _round_up(a: int, b: int) -> int:
    return _ceil(a, b) * b


@dataclasses.dataclass(frozen=True)
class Plan:
    tile: int       # rows a scan block covers (a chunk)
    qb: int         # queries a scan block scores
    ntiles: int     # chunks
    slot: int       # pairs in one chunk's run: min(keep, tile)
    stride: int     # pairs a query takes in each scratch buffer
    rows: int       # rows a staged tile holds (0: not staged)
    scratch: int    # pairs in each of the four scratch buffers
    dslice: int = 0  # columns a staged d-slice holds (0: whole rows)


def _finish(n: int, keep: int, batch: int, tile: int, qb: int, rows: int = 0,
            dslice: int = 0) -> Plan:
    ntiles = _ceil(n, tile)
    slot = min(keep, tile)
    long_list = _round_up(keep, SORT_MAX) if keep > SORT_MAX else 0
    stride = max(ntiles * slot, long_list)
    return Plan(tile, qb, ntiles, slot, stride, rows, batch * stride, dslice)


def _check_keep(n: int, keep: int) -> None:
    if not 1 <= keep <= n:
        raise ValueError(f"need 1 <= keep <= rows, got keep={keep}, rows={n}")


@functools.lru_cache(maxsize=512)
def plan(n: int, keep: int, batch: int, query_bytes: int, per_query: bool,
         sms: int = 0) -> Plan:
    """Plan of the thread-per-row scan (K9, K9r) over ``n`` rows, top-
    ``keep``.  ``query_bytes`` is the shared memory one query takes in a
    scan block; ``per_query`` means every query has rows of its own (a
    candidate list), so blocks hold one query each.  Chunks start at
    ``CHUNK_MAX`` rows and halve, down to 64, while the grid would cover
    the ``sms`` multiprocessors less than twice; a block scores up to
    ``QB_MAX`` queries, as many as its shared memory holds."""
    _check_keep(n, keep)
    qb = 1 if per_query else max(1, min(QB_MAX, batch))
    tile = CHUNK_MAX
    while tile > 64 and _ceil(n, tile) * _ceil(batch, qb) < 2 * sms:
        tile //= 2
    while qb > 1 and qb * (4 * tile + query_bytes) + SELECT_BYTES > SMEM_BUDGET:
        qb -= 1
    return _finish(n, keep, batch, tile, qb)


def staged_tile_bytes(d: int, kind: str, rows: int) -> int:
    """Shared memory of one staged tile (``csrc/topk_common.cuh``
    ``g2v_tile_bytes``): rows padded as the kernels pad them (at most)."""
    if kind == "int8":
        stride = _round_up(d, 16)
    else:
        stride = _padded_stride(ELEMENT_BYTES[kind] * _round_up(d, 4))
    return _round_up(rows * stride + 32, 128)


def sliced_tile_bytes(ds: int, kind: str, rows: int) -> int:
    """Shared memory of one staged tile of ``ds``-column d-slices
    (``k7_topk_exact.cu``, ``k8_quant_scan.cu``): padded rows."""
    if kind == "int8":
        stride = _padded_stride(ds)
    else:
        stride = _padded_stride(ELEMENT_BYTES[kind] * _round_up(ds, 4))
    return _round_up(rows * stride + 32, 128)


def _padded_stride(nbytes: int) -> int:
    s = _round_up(nbytes, 16)
    return s + 16 if (s // 4) % 8 == 0 else s


def staged_query_bytes(d: int, kind: str, qg: int) -> int:
    """Shared memory of a staged block's ``qg`` queries: int8 rows of the
    next multiple of 32 (padded) and their scales for K8's int8 table,
    float32 rows for K7 and the bf16 table."""
    if kind == "int8":
        return _round_up(qg, 16) * (_padded_stride(_round_up(d, 32)) + 4)
    groups = 1
    while 4 * groups < qg:
        groups *= 2
    return 4 * groups * _padded_stride(4 * _round_up(d, 4))


def staged_smem(d: int, kind: str, qg: int, tile: int, rows: int) -> int:
    """Dynamic shared memory of a staged scan block: two tiles, the
    queries, ``qg`` x ``tile`` scores and the select state."""
    return (2 * staged_tile_bytes(d, kind, rows) + staged_query_bytes(d, kind, qg)
            + 4 * qg * tile + SELECT_BYTES)


@functools.lru_cache(maxsize=512)
def plan_staged(n: int, keep: int, batch: int, d: int, kind: str, sms: int = 0) -> Plan:
    """Plan of the staged scan (K7, K8) over ``n`` table rows of width
    ``d`` and element ``kind`` ("float32", "bfloat16" or "int8"), top-
    ``keep``.  A block scores up to ``QG_MAX`` queries against tiles of 64
    rows (32 where 64 do not fit; fewer queries where neither does; d-
    slices of 32-row tiles where not even one query fits beside whole
    rows); chunks are multiples of the tile, sized so that the grid about
    covers the ``sms`` multiprocessors once, at most ``CHUNK_MAX`` rows and
    what shared memory holds."""
    _check_keep(n, keep)
    qg = min(QG_MAX, batch)
    while True:
        rows = next((r for r in (64, 32) if staged_smem(d, kind, qg, r, r) <= SMEM_BUDGET), 0)
        if rows:
            break
        if qg == 1:
            return _plan_sliced(n, keep, batch, d, kind, sms)
        qg = _ceil(qg, 2)
    groups = _ceil(batch, qg)
    fit = (SMEM_BUDGET - staged_smem(d, kind, qg, 0, rows)) // (4 * qg) // rows * rows
    want = _round_up(_ceil(n, max(1, sms // groups)), rows)
    tile = max(rows, min(want, CHUNK_MAX // rows * rows, fit))
    return _finish(n, keep, batch, tile, qg, rows)


def _plan_sliced(n: int, keep: int, batch: int, d: int, kind: str, sms: int) -> Plan:
    """The staged scan of rows too wide for a 32-row tile beside one query:
    tiles of SLICED_ROWS rows staged as d-slices, the widest multiple of 32
    columns (up to SLICE_MAX) that fits beside the queries, which take at
    most half the budget (fewer queries a block where they would take
    more)."""
    rows = SLICED_ROWS
    qg = min(QG_MAX, batch)
    while qg > 1 and staged_query_bytes(d, kind, qg) > SMEM_BUDGET // 2:
        qg = _ceil(qg, 2)

    def smem(ds: int, tile: int) -> int:
        return (2 * sliced_tile_bytes(ds, kind, rows) + staged_query_bytes(d, kind, qg)
                + 4 * qg * tile + SELECT_BYTES)

    ds = next((w for w in range(min(SLICE_MAX, _round_up(d, 32)), 0, -32)
               if smem(w, rows) <= SMEM_BUDGET), 0)
    if not ds:
        raise ValueError(f"rows of width {d} ({kind}) do not fit a scan block, not even "
                         f"in d-slices: its queries take more than half of it")
    groups = _ceil(batch, qg)
    fit = (SMEM_BUDGET - smem(ds, 0)) // (4 * qg) // rows * rows
    want = _round_up(_ceil(n, max(1, sms // groups)), rows)
    tile = max(rows, min(want, CHUNK_MAX // rows * rows, fit))
    return _finish(n, keep, batch, tile, qg, rows, ds)


def scratch(p: Plan, device) -> torch.Tensor:
    """The four scratch buffers: the runs' keys and ids, then the long-list
    survivors' keys and ids."""
    return torch.empty((4, max(p.scratch, 1)), dtype=torch.int32, device=device)
