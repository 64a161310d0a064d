"""Selection order and launch plans shared by the serving kernels K7-K9r.

**Order.**  ``lax.top_k`` ranks by value descending, the lower index
first among equal values, with ``+0.0`` ahead of ``-0.0`` and ``-inf``
last: the order of the integer key ``bits ^ ((bits >> 31) & 0x7fffffff)``
of each float32, then of the row — what the kernels select and sort by
(``csrc/topk_common.cuh``).  :func:`topk_plain` is that order in plain
PyTorch: a stable descending sort of the keys.

**Plans.**  Plans are pure functions of their arguments and cached (a
serving call costs host time), so CPU tests pin them.  :func:`plan_staged`
plans K7 and K8: two launches a call.  The scan cuts the ``n`` rows into
chunks of ``tile`` rows; a block stages tiles of ``rows`` table rows in
shared memory, scores every query of a group of up to 64 against them
(rows too wide for a 32-row tile beside one query: tiles of ``dslice``-
column slices of the rows, whose partial scores add up before the select)
and writes each query's top-``slot`` (``slot = min(keep, tile)``) to that
query's run in the scratch buffers.  The final launch gives each query a
block that selects the top-``keep`` of its ``ntiles`` runs, sorts them and
writes them.  Lists longer than ``SORT_MAX`` (any ``keep`` up to the row
count works, as in the reference) are sorted in ``SORT_MAX`` runs that
the final block merges in the scratch buffers, so each query's region
(``stride`` pairs) holds at least ``keep`` rounded up to ``SORT_MAX``.

:func:`plan_probe` plans K9's probe (a cluster of blocks that split the
centroids, for a group of queries, selecting in the same launch) and
:func:`plan_list` K9's scan and K9r: a query's candidate list in one
block or cluster that keeps its real candidates, scores them a lane group
a row and selects and sorts in the same launch (``route`` 0), or, for
lists past what that holds, chunks that write runs for the final launch
(``route`` 1).
"""

from __future__ import annotations

import ctypes
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


# -- K9's probe, and one query's candidate list (K9's scan, K9r) ---------------

#: most blocks a cluster holds (the portable cluster size)
CLUSTER_MAX = 8
#: words a lane loads of a row in one pass (csrc/topk_common.cuh
#: G2V_LIST_WORDS)
LIST_WORDS = 4
#: fewest candidate positions a block of a query's cluster takes: shorter
#: lists stay in fewer blocks
SHARE_MIN = 256


def _up16(n: int) -> int:
    return _round_up(n, 16)


def list_word(d: int, kind: str, address: int) -> int:
    """Bytes a load of a list scan's row takes: the widest of 16 (8 for
    int8), 4 and one element that the row width ``d`` and the table's
    ``address`` allow (every row then starts on that boundary)."""
    elem = ELEMENT_BYTES[kind]
    for w in ((8, 4) if kind == "int8" else (16, 4)):
        if (d * elem) % w == 0 and address % w == 0:
            return w
    return elem


def list_query_bytes(d: int, kind: str) -> int:
    """Shared memory of a list block's query: int8 rows padded to 16 bytes
    and their scale (K9), else ``d`` floats."""
    return _round_up(d, 16) + 16 if kind == "int8" else 4 * d


def list_smem(share: int, ncand: int, p: int, query_bytes: int, src_bytes: int) -> int:
    """Dynamic shared memory of a list block (``g2v_list_smem``): its
    ``share`` (key, id) pairs, a cluster leader's ``ncand`` candidates
    (key, tie, id) as sent and packed, ``p`` sort triples, the query and
    the source's own."""
    return (_up16(8 * share) + _up16(24 * ncand) + _up16(12 * p) + _up16(query_bytes)
            + _up16(src_bytes))


def _list_route0_smem(n: int, keep: int, nseg: int, query_bytes: int, src_bytes: int) -> int:
    share = _ceil(n, nseg)
    ncand = nseg * min(keep, share) if nseg > 1 else 0
    return list_smem(share, ncand, next_pow2(min(keep, ncand if nseg > 1 else share)),
                     query_bytes, src_bytes)


@dataclasses.dataclass(frozen=True)
class ListPlan:
    route: int      # 0: a block or cluster a query, one launch; 1: chunks + final
    share: int      # candidate positions a block covers (S)
    nseg: int       # blocks a query: its cluster (route 0) or its chunks (route 1)
    lanes: int      # lanes that score one row together
    word: int       # bytes a row load takes
    slot: int       # route 1: pairs in a chunk's run
    stride: int     # route 1: pairs a query takes in each run buffer
    smem: int       # dynamic shared memory of a block

    def describe(self) -> str:
        if self.route == 0:
            where = "one block" if self.nseg == 1 else f"a cluster of {self.nseg} blocks"
            return f"{where} a query, one launch"
        return f"chunks of {self.share} positions, runs and a final launch"


@functools.lru_cache(maxsize=512)
def plan_list(n: int, keep: int, batch: int, d: int, kind: str, word: int, src_bytes: int,
              sms: int = 0) -> ListPlan:
    """Plan of a list scan over ``n`` candidate positions a query (rows of
    width ``d`` and element ``kind``, loads of ``word`` bytes; the
    candidate source stages ``src_bytes``), top-``keep``.  Route 0 where
    ``keep`` <= ``SORT_MAX`` and a block's share of the list, the
    leader's candidates and the sort fit shared memory: the list is split
    over a cluster of as many blocks, up to ``CLUSTER_MAX``, as keep every
    block ``SHARE_MIN`` positions and the batch's blocks within the
    ``sms`` multiprocessors (the sizes that measured best at the serving
    shapes, runs 12C and 12G), more where a share does not fit, fewer
    where the leader's candidates do not.  Else route 1: chunks sized so
    that the grid about covers the multiprocessors."""
    _check_keep(n, keep)
    words = d * ELEMENT_BYTES[kind] // word
    lanes = min(32, next_pow2(_ceil(words, LIST_WORDS)))
    qbytes = list_query_bytes(d, kind)
    nseg = 1
    while (2 * nseg <= CLUSTER_MAX and _ceil(n, 2 * nseg) >= SHARE_MIN
           and batch * 2 * nseg <= max(sms, 1)):
        nseg *= 2
    sizes = [nseg] + [c for c in (2, 4, 8) if c > nseg] + [c for c in (4, 2, 1) if c < nseg]
    for nseg in sizes if keep <= SORT_MAX else ():
        smem = _list_route0_smem(n, keep, nseg, qbytes, src_bytes)
        if smem <= SMEM_BUDGET:
            return ListPlan(0, _ceil(n, nseg), nseg, lanes, word, 0, 0, smem)
    fit = (SMEM_BUDGET - list_smem(0, 0, 0, qbytes, src_bytes)) // 8 // 64 * 64
    want = _round_up(_ceil(n, max(1, sms // batch)), 64)
    share = max(64, min(fit, max(want, 1024)))
    nseg = _ceil(n, share)
    slot = min(keep, share)
    long_list = _round_up(keep, SORT_MAX) if keep > SORT_MAX else 0
    return ListPlan(1, share, nseg, lanes, word, slot, max(nseg * slot, long_list),
                    list_smem(share, 0, 0, qbytes, src_bytes))


def list_scratch(p: ListPlan, batch: int, n: int, device):
    """Route 1's buffers in one tensor: the runs' keys and ids and the
    long-list survivors' keys and ids (``batch * stride`` each), then each
    kept candidate's row (``batch * n``); None for route 0, which needs
    none."""
    if p.route == 0:
        return None
    return torch.empty(4 * batch * p.stride + batch * n, dtype=torch.int32, device=device)


def list_scratch_ptrs(scr, run: int):
    """The five buffers of ``list_scratch`` (``run`` ints each of the
    first four) as pointers; null pointers for None."""
    if scr is None:
        return [ctypes.c_void_p(0)] * 5
    base = scr.data_ptr()
    return [ctypes.c_void_p(base + 4 * i * run) for i in range(5)]


@dataclasses.dataclass(frozen=True)
class ProbePlan:
    qg: int         # queries a cluster scores
    qpt: int        # queries a thread scores against its row
    share: int      # centroids a block of the cluster stages and scores
    cluster: int    # blocks a cluster
    rows: int       # centroid rows a staged tile holds
    tstride: int    # bytes a staged row takes
    cp: int         # 1: 16-byte cp.async copies; 0: element by element
    smem: int       # dynamic shared memory of a block


def probe_smem(c: int, nprobe: int, d: int, qg: int, qpt: int, cluster: int, rows: int,
               tstride: int) -> int:
    """Dynamic shared memory of a probe block (``k9_probe_kernel``): two
    tiles (one where it holds all the block's centroids), the group's queries (rows padded to ``qpt``), its keys over the
    block's centroids, each block's top-``nprobe`` candidates (key,
    centroid) for the queries the block selects for, and a sort's triples."""
    share = _ceil(c, cluster)
    rows_q = _round_up(qg, qpt)
    cand = _ceil(qg, cluster) * cluster * min(nprobe, share)
    nbuf = 1 if rows >= share else 2
    return (nbuf * _up16(rows * tstride) + _up16(4 * rows_q * _round_up(d, 4))
            + 4 * (qg * share + 2 * cand + 3 * next_pow2(nprobe)))


@functools.lru_cache(maxsize=512)
def plan_probe(c: int, nprobe: int, batch: int, d: int, aligned: bool, sms: int = 0) -> ProbePlan:
    """Plan of K9's probe over ``c`` centroids of width ``d`` (``aligned``:
    the centroids start on a 16-byte boundary), top-``nprobe``: clusters
    of up to ``CLUSTER_MAX`` blocks that split the centroids, each for a
    group of queries sized so that the grid about covers the ``sms``
    multiprocessors (fewer blocks a cluster or more queries a group
    measured slower at the default geometry, runs 12E-12I); tiles of as
    many centroid rows as shared memory holds (fewer queries a group where
    not even one row fits)."""
    _check_keep(c, nprobe)
    cluster = 1
    while 2 * cluster <= min(CLUSTER_MAX, c):
        cluster *= 2
    share = _ceil(c, cluster)
    qg = min(max(1, _ceil(batch * cluster, max(sms, 1))), batch)
    tstride = _padded_stride(4 * _round_up(d, 4))
    while True:
        qpt = min(4, next_pow2(qg))
        fixed = probe_smem(c, nprobe, d, qg, qpt, cluster, 0, tstride)
        rows = min(share, (SMEM_BUDGET - fixed) // (2 * tstride))
        if rows >= 1:
            break
        if qg == 1:
            raise ValueError(f"centroids of width {d} do not fit a probe block")
        qg = _ceil(qg, 2)
    cp = int(d % 4 == 0 and aligned)
    return ProbePlan(qg, qpt, share, cluster, rows, tstride, cp,
                     probe_smem(c, nprobe, d, qg, qpt, cluster, rows, tstride))

