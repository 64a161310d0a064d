"""K4 — (V, D+1) accumulators and the combiner finalize
(source: ``csrc/k4_row_update.cu``).

Replaces ``gene2vec_tpu/sgns/step.py:143-172, 229-263`` as used at
:800-851.  Scatter-adds [d_center | 1] by center id into ``acc_emb`` and
[g_pos·v | 1] by context id into ``acc_ctx`` (which already holds K2's
and K3's noise rows), then finalizes both tables in place::

    table -= lr · acc[:, :D] / divisor(acc[:, D])

with divisor 1 (``sum``), max(w, 1) (``mean``) or max(max(w, 1)/32, 1)
(``capped``).

Which rows a finalize visits: the reference visits every row, and a row
whose accumulator is +0 keeps its bits, so the finalize may visit only
the rows the step touched, which the caller names in a :class:`Touched`:
the scattered ids and the other producers' rows (K2's head, K3's blocks,
K5a's draws, K5b's pool, K6's shallow prefix and path nodes).
``touched=None`` visits every row.  A row that a producer wrote and the
set leaves out would keep its old value: the step-parity tests hold each
objective against the reference with exactly the sets the steps pass.

The generic entry points serve the other noise modes and hierarchical
softmax: :func:`scatter_rows` adds [grads | weights] rows into an
accumulator (``_scatter_accumulator``, step.py:229-245);
:func:`finalize_rows` finalizes one table, of any row count, against its
accumulator (``_finalize_row_updates``, step.py:248-263) over the rows it
is given.  No call leaves marks for a later one: on the card each call
flags its rows in a workspace and consumes the flags before it returns.

Tables are float32 or bfloat16; accumulators are float32.  A bfloat16
table is read as float32, ``new = t − lr·update`` is computed in float32,
and the result is written back by stochastic rounding when the caller
gives the table's two salt words (``_stochastic_round_bf16``,
step.py:179-226: a salted murmur-finalizer hash of the flat element index
r·D + c supplies the 16 bits added below the bf16 mantissa), else by
round-to-nearest-even (XLA's ``astype``).  A float32 table ignores salts.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple, Optional

import torch

from gene2vec_tpu_torch.kernels import _args, _work, build

#: kernel launches made through :func:`row_update`, :func:`scatter_rows`
#: (``row_scatter``) and :func:`finalize_rows` (``row_finalize``), by
#: write-back: "" float32 tables (or none), "bf16_sr" bfloat16 tables by
#: stochastic rounding, "bf16_rn" by nearest-even
launches = {(entry, variant): 0 for entry, variants in (
    ("row_update", ("", "bf16_sr", "bf16_rn")), ("row_scatter", ("",)),
    ("row_finalize", ("", "bf16_sr", "bf16_rn"))) for variant in variants}

_LIB = "k4_row_update"
_CAP = 32.0
COMBINERS = {"sum": 0, "mean": 1, "capped": 2}


class Touched(NamedTuple):
    """Rows of one table that a step's producers wrote; duplicates and
    overlaps are allowed.

    ``ids``: int32 row ids, one tensor of any shape or a tuple of up to
    two; ``prefix``: the rows [0, prefix); ``blocks``: (G,) int32 draws,
    each the ``block`` rows from min(prefix + b·block, limit − block)
    (K3's tail blocks after K2's head); ``paths``: (points (N, L), lengths
    (N,), targets (E,)) int32, the rows points[t, l] for l < lengths[t]
    of each target t (K6's deep path nodes)."""

    ids: object = ()
    prefix: int = 0
    blocks: Optional[torch.Tensor] = None
    block: int = 0
    limit: int = 0
    paths: Optional[tuple] = None

    def id_lists(self) -> tuple:
        """``ids`` as a tuple of tensors."""
        return (self.ids,) if isinstance(self.ids, torch.Tensor) else tuple(self.ids)

    def rows(self, device) -> torch.Tensor:
        """The set's rows as int64, with duplicates (the plain version)."""
        parts = [torch.arange(self.prefix, device=device)]
        parts += [i.reshape(-1).to(device, torch.int64) for i in self.id_lists()]
        if self.blocks is not None and self.block > 0:
            starts = torch.clamp_max(self.prefix + self.blocks.to(device, torch.int64)
                                     * self.block, self.limit - self.block)
            parts.append((starts[:, None]
                          + torch.arange(self.block, device=device)[None, :]).reshape(-1))
        if self.paths is not None:
            points, lengths, targets = (a.to(device) for a in self.paths)
            t = targets.long()
            on = (torch.arange(points.shape[1], device=device)[None, :]
                  < lengths[t].long()[:, None])
            parts.append(points[t][on].long())
        return torch.cat(parts)


def row_divisor(cnt: torch.Tensor, combiner: str) -> torch.Tensor:
    """Per-row divisor given the row's example-unit load (``_row_divisor``)."""
    cnt = torch.clamp_min(cnt, 1.0)
    if combiner == "sum":
        return torch.ones_like(cnt)
    if combiner == "mean":
        return cnt
    if combiner == "capped":
        return torch.clamp_min(cnt / _CAP, 1.0)
    raise ValueError(f"unknown combiner {combiner!r}")


_MASK32 = 0xFFFFFFFF


def _mul32(h: torch.Tensor, c: int) -> torch.Tensor:
    """h · c mod 2³² for int64 ``h`` in [0, 2³²), exact in int64: the
    constant is split into 16-bit halves so no product passes 2⁴⁸."""
    lo = h * (c & 0xFFFF)
    hi = ((h * (c >> 16)) & 0xFFFF) << 16
    return (lo + hi) & _MASK32


def sr_hash(flat: torch.Tensor, s0: int, s1: int) -> torch.Tensor:
    """step.py:206-209 in int64 with each product and sum taken mod 2³²
    (CPU torch lacks most uint32 operators)."""
    h = _mul32(flat ^ s0, 0x9E3779B1)
    h = _mul32(h ^ (h >> 15), 0x85EBCA6B)
    return ((h ^ (h >> 13)) + s1) & _MASK32


def stochastic_round_bf16(x: torch.Tensor, salts, flat=None) -> torch.Tensor:
    """float32 ``x`` → bfloat16 by the reference's stochastic rounding with
    the salt words ``salts`` = (s0, s1): add the low 16 bits of the hash of
    each element's flat index (``flat``, int64 of x's shape, default
    0..numel − 1) below the bf16 mantissa, then truncate.  Bit for bit
    ``_stochastic_round_bf16`` given the same salts."""
    s0, s1 = (int(w) for w in salts)
    bits = x.contiguous().view(torch.int32).to(torch.int64) & _MASK32
    if flat is None:
        flat = torch.arange(x.numel(), dtype=torch.int64, device=x.device).reshape(x.shape)
    top = ((bits + (sr_hash(flat & _MASK32, s0, s1) & 0xFFFF)) & 0xFFFF0000) >> 16
    return torch.where(top >= 0x8000, top - 0x10000, top).to(torch.int16).view(torch.bfloat16)


def write_back(table: torch.Tensor, new: torch.Tensor, salts=None, rows=None) -> None:
    """Store float32 ``new`` into ``table`` (into its rows ``rows``, int64,
    when given): as is (float32), by stochastic rounding with ``salts`` —
    hashing each element's flat index in the whole table — or nearest-even
    without (bfloat16)."""
    if table.dtype == torch.bfloat16 and salts is not None:
        flat = None
        if rows is not None:
            d = table.shape[1]
            flat = rows[:, None] * d + torch.arange(d, device=table.device)[None, :]
        new = stochastic_round_bf16(new, salts, flat)
    if rows is None:
        table.copy_(new)
    else:
        table[rows] = new.to(table.dtype)


def _write_mode(table, salts):
    """(sr flag, s0, s1) of a table's write-back for the kernel."""
    if table.dtype == torch.bfloat16 and salts is not None:
        s0, s1 = (int(w) for w in salts)
        if not (0 <= s0 <= _MASK32 and 0 <= s1 <= _MASK32):
            raise ValueError(f"salts {salts} are not uint32 words")
        return 1, s0, s1
    return 0, 0, 0


def _variant(bf16: int, sr: int) -> str:
    return ("bf16_sr" if sr else "bf16_rn") if bf16 else ""


# -- the kernels' flag workspaces ---------------------------------------------

#: workspaces by (device, stream, row count, slot): a call flags its rows
#: and finalizes them before it returns, so a workspace carries nothing
#: between calls but stale generations, and any one of its row count on
#: the call's stream serves (row_update takes slots 0 and 1)
_workspaces: dict = {}


class _Flags:
    """A workspace on the card: one uint32 flag a row, then the finalize
    barrier's two counters; and the generation the next call stores
    (flags of earlier generations count as clean, so no call clears
    them)."""

    __slots__ = ("flags", "gen")

    def __init__(self, rows: int, device):
        self.flags = torch.zeros((rows + 2,), dtype=torch.int32, device=device)
        self.gen = 1

    def advance(self) -> None:
        self.gen += 1
        if self.gen > _MASK32:  # wraps: start over from zeroed flags
            self.flags.zero_()
            self.gen = 1


def _flags(rows: int, device, stream, slot: int = 0) -> _Flags:
    key = device, stream.value, rows, slot
    ws = _workspaces.get(key)
    if ws is None:
        ws = _workspaces[key] = _Flags(rows, device)
    return ws


def _plain_rows(touched, device, scattered=None):
    """The rows a plain finalize visits (int64, sorted, distinct): every
    row (None) for ``touched`` None; else the rows of ``touched`` and the
    ids ``scattered``."""
    if touched is None:
        return None
    parts = [touched.rows(device)]
    if scattered is not None:
        parts.append(scattered.reshape(-1).to(device, torch.int64))
    return torch.unique(torch.cat(parts))


#: id lists a row set carries (G2vRowSet's ids0 and ids1)
_ID_LISTS = 2


class _RowSet(ctypes.Structure):
    """csrc/k4_row_update.cu's G2vRowSet."""

    _fields_ = [("ids0", ctypes.c_void_p), ("ids1", ctypes.c_void_p),
                ("n_ids0", ctypes.c_longlong), ("n_ids1", ctypes.c_longlong),
                ("prefix", ctypes.c_int), ("blocks", ctypes.c_void_p),
                ("n_blocks", ctypes.c_int), ("block", ctypes.c_int), ("limit", ctypes.c_int),
                ("points", ctypes.c_void_p), ("lengths", ctypes.c_void_p),
                ("targets", ctypes.c_void_p), ("n_targets", ctypes.c_int),
                ("path_len", ctypes.c_int)]


def _ids(t: torch.Tensor, name: str, device) -> int:
    """The address of an int32 row-id tensor on ``device``; raises otherwise."""
    if t.dtype != torch.int32 or t.device != device or not t.is_contiguous():
        _args.expect(t, name, torch.int32, (None,) * t.dim())
        raise ValueError(f"{name}: on {t.device}, not {device}")
    return t.data_ptr()


def _row_set(touched: Optional[Touched], rows: int, device) -> _RowSet:
    """``touched`` as the kernel's row set, its tensors checked; None is
    the empty set (the caller finalizes every row without flags).  Fields
    are set only where a part is present: this runs on every step."""
    s = _RowSet()
    if touched is None:
        return s
    ids, prefix, blocks, block, limit, paths = touched
    if not 0 <= prefix <= rows:
        raise ValueError(f"prefix {prefix} outside [0, {rows}]")
    s.prefix = prefix
    k = 0
    for i in (ids,) if isinstance(ids, torch.Tensor) else ids:
        n = i.numel()
        if not n:
            continue
        if k == _ID_LISTS:
            raise ValueError(f"more than {_ID_LISTS} id lists; a row set carries {_ID_LISTS}")
        if k == 0:
            s.ids0, s.n_ids0 = _ids(i, "touched ids", device), n
        else:
            s.ids1, s.n_ids1 = _ids(i, "touched ids", device), n
        k += 1
    if blocks is not None and block > 0 and blocks.numel():
        if not block <= limit <= rows:
            raise ValueError(f"blocks of {block} rows below limit {limit} of {rows} rows")
        s.blocks = _ids(blocks, "touched blocks", device)
        s.n_blocks, s.block, s.limit = blocks.numel(), block, limit
    if paths is not None:
        points, lengths, targets = paths
        if targets.numel() and points.shape[1]:
            s.points, s.lengths = _ids(points, "path points", device), _ids(
                lengths, "path lengths", device)
            s.targets = _ids(targets, "path targets", device)
            s.n_targets, s.path_len = targets.numel(), points.shape[1]
    return s


def _finalize_plain(table, acc, lr, combiner, salts, rows):
    d = table.shape[1]
    a = acc if rows is None else acc[rows]
    t = table if rows is None else table[rows]
    update = a[:, :d] / row_divisor(a[:, d], combiner)[:, None]
    write_back(table, t.float() - lr * update, salts, rows)


def row_update_plain(emb, ctx, acc_emb, acc_ctx, centers, contexts, d_center, v,
                     g_pos, lr, combiner, salts=None, touched=None):
    ones = torch.ones((centers.shape[0], 1), dtype=torch.float32, device=emb.device)
    acc_emb.index_add_(0, centers, torch.cat([d_center, ones], dim=1))
    acc_ctx.index_add_(0, contexts, torch.cat([g_pos[:, None] * v, ones], dim=1))
    sets = (None, None) if touched is None else touched
    for i, (table, acc, ids) in enumerate(((emb, acc_emb, centers), (ctx, acc_ctx, contexts))):
        _finalize_plain(table, acc, lr, combiner, None if salts is None else salts[i],
                        _plain_rows(sets[i], acc.device, ids))


def row_update(emb, ctx, acc_emb, acc_ctx, centers, contexts, d_center, v, g_pos,
               lr: float, combiner: str, salts=None, touched=None) -> None:
    """``salts``: (2, 2) uint32 words, emb's row then ctx's, for stochastic
    rounding of bfloat16 tables; None rounds them to nearest-even.
    ``touched``: (emb's, ctx's) :class:`Touched`, the rows besides the
    scattered centers and contexts — each None, or ``touched`` None,
    finalizes every row of that table."""
    if combiner not in COMBINERS:
        raise ValueError(f"unknown combiner {combiner!r}")
    if _args.on_cpu(emb, ctx, acc_emb, acc_ctx, centers, contexts, d_center, v,
                    g_pos):
        return row_update_plain(emb, ctx, acc_emb, acc_ctx, centers, contexts,
                                d_center, v, g_pos, lr, combiner, salts, touched)
    v_size, d = emb.shape
    e = centers.shape[0]
    bf16 = _args.table_bf16((emb, ctx), ("emb", "ctx"), ((v_size, d), (v_size, d)))
    _args.expect(acc_emb, "acc_emb", torch.float32, (v_size, d + 1))
    _args.expect(acc_ctx, "acc_ctx", torch.float32, (v_size, d + 1))
    _args.expect(centers, "centers", torch.int32, (e,))
    _args.expect(contexts, "contexts", torch.int32, (e,))
    _args.expect(d_center, "d_center", torch.float32, (e, d))
    _args.expect(v, "v", torch.float32, (e, d))
    _args.expect(g_pos, "g_pos", torch.float32, (e,))
    sr, s0e, s1e = _write_mode(emb, None if salts is None else salts[0])
    _, s0c, s1c = _write_mode(ctx, None if salts is None else salts[1])
    te, tc = (None, None) if touched is None else touched
    if te is None:  # every row: all flagged in launch 1
        te = Touched(prefix=v_size)
    if tc is None:
        tc = Touched(prefix=v_size)
    dev = emb.device
    set_e, set_c = _row_set(te, v_size, dev), _row_set(tc, v_size, dev)
    lib = _lib()
    stream = _args.stream(emb)
    fe = _flags(v_size, dev, stream, 0)
    fc = _flags(v_size, dev, stream, 1)
    status = lib.k4_row_update(
        _args.ptr(emb), _args.ptr(ctx), _args.ptr(acc_emb), _args.ptr(acc_ctx),
        _args.ptr(centers), _args.ptr(contexts), _args.ptr(d_center),
        _args.ptr(v), _args.ptr(g_pos), float(lr), COMBINERS[combiner],
        e, v_size, d, bf16, sr, s0e, s1e, s0c, s1c,
        _args.ptr(fe.flags), fe.gen, ctypes.byref(set_e),
        _args.ptr(fc.flags), fc.gen, ctypes.byref(set_c), stream,
    )
    fe.advance()
    fc.advance()
    build.check(lib, status, "K4 row_update launch")
    launches["row_update", _variant(bf16, sr)] += 1


def scatter_rows_plain(acc, idx, grads, weights):
    acc.index_add_(0, idx, torch.cat([grads, weights[:, None]], dim=1))


def scatter_rows(acc, idx, grads, weights) -> None:
    """acc[idx[r]] += [grads[r] | weights[r]], in place."""
    if _args.on_cpu(acc, idx, grads, weights):
        return scatter_rows_plain(acc, idx, grads, weights)
    v_rows, d1 = acc.shape
    r = idx.shape[0]
    _args.expect(acc, "acc", torch.float32, (v_rows, d1))
    _args.expect(idx, "idx", torch.int32, (r,))
    _args.expect(grads, "grads", torch.float32, (r, d1 - 1))
    _args.expect(weights, "weights", torch.float32, (r,))
    lib = _lib()
    status = lib.k4_scatter_rows(_args.ptr(acc), _args.ptr(idx), _args.ptr(grads),
                                 _args.ptr(weights), r, d1 - 1, _args.stream(acc))
    build.check(lib, status, "K4 scatter_rows launch")
    launches["row_scatter", ""] += 1


def finalize_rows_plain(table, acc, lr, combiner, salts=None, touched=None):
    _finalize_plain(table, acc, lr, combiner, salts, _plain_rows(touched, acc.device))


def finalize_rows(table, acc, lr: float, combiner: str, salts=None,
                  touched: Optional[Touched] = None) -> None:
    """table −= lr · acc[:, :D] / divisor(acc[:, D]), in place, over the
    rows of ``touched`` (every row for None); a bfloat16 table rounds
    stochastically with ``salts`` (s0, s1), else nearest-even."""
    if combiner not in COMBINERS:
        raise ValueError(f"unknown combiner {combiner!r}")
    if _args.on_cpu(table, acc):
        return finalize_rows_plain(table, acc, lr, combiner, salts, touched)
    v_rows, d = table.shape
    bf16 = _args.table_bf16((table,), ("table",), ((v_rows, d),))
    _args.expect(acc, "acc", torch.float32, (v_rows, d + 1))
    sr, s0, s1 = _write_mode(table, salts)
    dev = table.device
    rows = _row_set(touched, v_rows, dev)
    lib = _lib()
    stream = _args.stream(table)
    ws = None if touched is None else _flags(v_rows, dev, stream)
    status = lib.k4_finalize_rows(_args.ptr(table), _args.ptr(acc), float(lr),
                                  COMBINERS[combiner], v_rows, d, bf16, sr, s0, s1,
                                  None if ws is None else _args.ptr(ws.flags),
                                  0 if ws is None else ws.gen, ctypes.byref(rows), stream)
    if ws is not None:
        ws.advance()
    build.check(lib, status, "K4 finalize_rows launch")
    launches["row_finalize", _variant(bf16, sr)] += 1


# -- work counts (``_work.py``) ------------------------------------------------

#: integer operations of the stochastic-rounding hash and carry, an element
SR_HASH_OPS = 8


def _device_of(*parts):
    for p in parts:
        if isinstance(p, torch.Tensor):
            return p.device
        if isinstance(p, (tuple, list)):
            dev = _device_of(*p)
            if dev is not None:
                return dev
    return None


def visited_rows(touched: Optional[Touched], n_rows: int, scattered=None) -> int:
    """Rows a finalize visits: ``n_rows`` (every row) for ``touched`` None,
    else the distinct rows of ``touched`` and the ids ``scattered``."""
    if touched is None:
        return n_rows
    dev = _device_of(scattered, *touched) or torch.device("cpu")
    return int(_plain_rows(touched, dev, scattered).numel())


def _ids_read(touched: Optional[Touched]) -> int:
    """Row ids a finalize reads to name its rows: the id lists, the block
    draws, the path targets with each distinct target's lengths entry and
    path row."""
    if touched is None:
        return 0
    n = sum(_work.count(i) for i in touched.id_lists())
    if touched.blocks is not None:
        n += _work.count(touched.blocks)
    if touched.paths is not None:
        points, _, targets = touched.paths
        n += _work.count(targets) + _work.distinct(targets) * (points.shape[1] + 1)
    return n


def work(centers, contexts, d: int, n_rows: int, table_bytes: int = 4,
         touched=None, salts: bool = False) -> dict:
    """What K4's ``row_update`` needs for ids ``centers`` / ``contexts``
    into tables of ``n_rows`` rows and the finalizes' row sets ``touched``
    (as :func:`row_update` takes it): the ids, d_center, v and g_pos read
    once, each visited row's accumulator read and its table row read and
    written; the scatters' FMAs, 3 operations a visited element, and with
    ``salts`` the stochastic rounding's hash."""
    e = _work.count(centers)
    sets = (None, None) if touched is None else touched
    emb_rows = visited_rows(sets[0], n_rows, centers)
    ctx_rows = visited_rows(sets[1], n_rows, contexts)
    rows = emb_rows + ctx_rows
    return {"bytes": 4 * (2 * e + 2 * e * d + e + rows * (d + 1)) + 2 * table_bytes * rows * d,
            "flops": 2 * e * (d + 1) + 3 * d * rows + (SR_HASH_OPS * d * rows if salts else 0),
            "emb_rows": emb_rows, "ctx_rows": ctx_rows}


def scatter_work(idx, d: int) -> dict:
    """What ``scatter_rows`` needs for ids ``idx``: the ids, the gradients
    and weights read once, each distinct accumulator row read and
    written; an add an element."""
    r = _work.count(idx)
    n = _work.distinct(idx)
    return {"bytes": 4 * (r + r * d + r + 2 * n * (d + 1)), "flops": r * (d + 1)}


def finalize_work(touched: Optional[Touched], n_rows: int, d: int, table_bytes: int = 4,
                  salts: bool = False) -> dict:
    """What ``finalize_rows`` needs over the rows of ``touched`` in a table
    of ``n_rows`` rows: each visited row's accumulator read and table row
    read and written, the ids that name them; 3 operations a visited
    element, and with ``salts`` the stochastic rounding's hash."""
    rows = visited_rows(touched, n_rows)
    return {"bytes": rows * (4 * (d + 1) + 2 * table_bytes * d) + 4 * _ids_read(touched),
            "flops": 3 * d * rows + (SR_HASH_OPS * d * rows if salts else 0),
            "rows": rows}


def _lib():
    lib = build.load(_LIB)
    fn = lib.k4_row_update
    if fn.argtypes is None:
        P, I, F, U = _args.P, _args.I, _args.F, _args.U32
        S = ctypes.POINTER(_RowSet)
        fn.argtypes = ([P, P, P, P, P, P, P, P, P, F, I, I, I, I, I, I, U, U, U, U]
                       + [P, U, S, P, U, S, P])
        fn.restype = I
        lib.k4_scatter_rows.argtypes = [P, P, P, P, I, I, P]
        lib.k4_scatter_rows.restype = I
        lib.k4_finalize_rows.argtypes = [P, P, F, I, I, I, I, I, U, U, P, U, S, P]
        lib.k4_finalize_rows.restype = I
    return lib
