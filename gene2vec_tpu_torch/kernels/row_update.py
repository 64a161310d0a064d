"""K4 — (V, D+1) accumulators and the combiner finalize
(source: ``csrc/k4_row_update.cu``).

Replaces ``gene2vec_tpu/sgns/step.py:143-172, 229-263`` as used at
:800-851.  Scatter-adds [d_center | 1] by center id into ``acc_emb`` and
[g_pos·v | 1] by context id into ``acc_ctx`` (which already holds K2's
and K3's noise rows), then finalizes both tables in place::

    table -= lr · acc[:, :D] / divisor(acc[:, D])

with divisor 1 (``sum``), max(w, 1) (``mean``) or max(max(w, 1)/32, 1)
(``capped``).  The finalize visits every row: untouched rows have
acc = 0 and keep their values exactly.

The generic entry points serve the other noise modes and hierarchical
softmax: :func:`scatter_rows` adds [grads | weights] rows into an
accumulator (``_scatter_accumulator``, step.py:229-245) and
:func:`finalize_rows` finalizes one table, of any row count, against
its accumulator (``_finalize_row_updates``, step.py:248-263).

Tables are float32 or bfloat16; accumulators are float32.  A bfloat16
table is read as float32, ``new = t − lr·update`` is computed in float32,
and the result is written back by stochastic rounding when the caller
gives the table's two salt words (``_stochastic_round_bf16``,
step.py:179-226: a salted murmur-finalizer hash of the flat element index
r·D + c supplies the 16 bits added below the bf16 mantissa), else by
round-to-nearest-even (XLA's ``astype``).  A float32 table ignores salts.
"""

from __future__ import annotations

import torch

from gene2vec_tpu_torch.kernels import _args, build

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


def stochastic_round_bf16(x: torch.Tensor, salts) -> torch.Tensor:
    """float32 ``x`` → bfloat16 by the reference's stochastic rounding with
    the salt words ``salts`` = (s0, s1): add the low 16 bits of the hash of
    each element's flat index below the bf16 mantissa, then truncate.  Bit
    for bit ``_stochastic_round_bf16`` given the same salts."""
    s0, s1 = (int(w) for w in salts)
    bits = x.contiguous().view(torch.int32).to(torch.int64) & _MASK32
    flat = torch.arange(x.numel(), dtype=torch.int64, device=x.device).reshape(x.shape)
    top = ((bits + (sr_hash(flat, s0, s1) & 0xFFFF)) & 0xFFFF0000) >> 16
    return torch.where(top >= 0x8000, top - 0x10000, top).to(torch.int16).view(torch.bfloat16)


def write_back(table: torch.Tensor, new: torch.Tensor, salts=None) -> None:
    """Store float32 ``new`` into ``table``: as is (float32), by stochastic
    rounding with ``salts`` or nearest-even without (bfloat16)."""
    if table.dtype == torch.bfloat16 and salts is not None:
        table.copy_(stochastic_round_bf16(new, salts))
    else:
        table.copy_(new)


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


def row_update_plain(emb, ctx, acc_emb, acc_ctx, centers, contexts, d_center, v,
                     g_pos, lr, combiner, salts=None):
    ones = torch.ones((centers.shape[0], 1), dtype=torch.float32, device=emb.device)
    acc_emb.index_add_(0, centers, torch.cat([d_center, ones], dim=1))
    acc_ctx.index_add_(0, contexts, torch.cat([g_pos[:, None] * v, ones], dim=1))
    for i, (table, acc) in enumerate(((emb, acc_emb), (ctx, acc_ctx))):
        finalize_rows_plain(table, acc, lr, combiner, None if salts is None else salts[i])


def row_update(emb, ctx, acc_emb, acc_ctx, centers, contexts, d_center, v, g_pos,
               lr: float, combiner: str, salts=None) -> None:
    """``salts``: (2, 2) uint32 words, emb's row then ctx's, for stochastic
    rounding of bfloat16 tables; None rounds them to nearest-even."""
    if combiner not in COMBINERS:
        raise ValueError(f"unknown combiner {combiner!r}")
    if _args.on_cpu(emb, ctx, acc_emb, acc_ctx, centers, contexts, d_center, v,
                    g_pos):
        return row_update_plain(emb, ctx, acc_emb, acc_ctx, centers, contexts,
                                d_center, v, g_pos, lr, combiner, salts)
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
    lib = _lib()
    status = lib.k4_row_update(
        _args.ptr(emb), _args.ptr(ctx), _args.ptr(acc_emb), _args.ptr(acc_ctx),
        _args.ptr(centers), _args.ptr(contexts), _args.ptr(d_center),
        _args.ptr(v), _args.ptr(g_pos), float(lr), COMBINERS[combiner],
        e, v_size, d, bf16, sr, s0e, s1e, s0c, s1c, _args.stream(emb),
    )
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


def finalize_rows_plain(table, acc, lr, combiner, salts=None):
    d = table.shape[1]
    update = acc[:, :d] / row_divisor(acc[:, d], combiner)[:, None]
    write_back(table, table.float() - lr * update, salts)


def finalize_rows(table, acc, lr: float, combiner: str, salts=None) -> None:
    """table −= lr · acc[:, :D] / divisor(acc[:, D]), in place; a bfloat16
    table rounds stochastically with ``salts`` (s0, s1), else nearest-even."""
    if combiner not in COMBINERS:
        raise ValueError(f"unknown combiner {combiner!r}")
    if _args.on_cpu(table, acc):
        return finalize_rows_plain(table, acc, lr, combiner, salts)
    v_rows, d = table.shape
    bf16 = _args.table_bf16((table,), ("table",), ((v_rows, d),))
    _args.expect(acc, "acc", torch.float32, (v_rows, d + 1))
    sr, s0, s1 = _write_mode(table, salts)
    lib = _lib()
    status = lib.k4_finalize_rows(_args.ptr(table), _args.ptr(acc), float(lr),
                                  COMBINERS[combiner], v_rows, d, bf16, sr, s0, s1,
                                  _args.stream(table))
    build.check(lib, status, "K4 finalize_rows launch")
    launches["row_finalize", _variant(bf16, sr)] += 1


def _lib():
    lib = build.load(_LIB)
    fn = lib.k4_row_update
    if fn.argtypes is None:
        P, I, F, U = _args.P, _args.I, _args.F, _args.U32
        fn.argtypes = [P, P, P, P, P, P, P, P, P, F, I, I, I, I, I, I, U, U, U, U, P]
        fn.restype = I
        lib.k4_scatter_rows.argtypes = [P, P, P, P, I, I, P]
        lib.k4_scatter_rows.restype = I
        lib.k4_finalize_rows.argtypes = [P, P, F, I, I, I, I, I, U, U, P]
        lib.k4_finalize_rows.restype = I
    return lib
