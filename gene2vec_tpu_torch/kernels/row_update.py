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
its accumulator (``_finalize_row_updates``, step.py:248-263, float32).
"""

from __future__ import annotations

import torch

from gene2vec_tpu_torch.kernels import _args, build

#: kernel launches made through :func:`row_update`
launches = 0
#: kernel launches made through :func:`scatter_rows`
scatter_launches = 0
#: kernel launches made through :func:`finalize_rows`
finalize_launches = 0

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


def row_update_plain(emb, ctx, acc_emb, acc_ctx, centers, contexts, d_center, v,
                     g_pos, lr, combiner):
    d = emb.shape[1]
    ones = torch.ones((centers.shape[0], 1), dtype=emb.dtype, device=emb.device)
    acc_emb.index_add_(0, centers, torch.cat([d_center, ones], dim=1))
    acc_ctx.index_add_(0, contexts, torch.cat([g_pos[:, None] * v, ones], dim=1))
    for table, acc in ((emb, acc_emb), (ctx, acc_ctx)):
        update = acc[:, :d] / row_divisor(acc[:, d], combiner)[:, None]
        table -= lr * update


def row_update(emb, ctx, acc_emb, acc_ctx, centers, contexts, d_center, v, g_pos,
               lr: float, combiner: str) -> None:
    if combiner not in COMBINERS:
        raise ValueError(f"unknown combiner {combiner!r}")
    if _args.on_cpu(emb, ctx, acc_emb, acc_ctx, centers, contexts, d_center, v,
                    g_pos):
        return row_update_plain(emb, ctx, acc_emb, acc_ctx, centers, contexts,
                                d_center, v, g_pos, lr, combiner)
    v_size, d = emb.shape
    e = centers.shape[0]
    _args.expect(emb, "emb", torch.float32, (v_size, d))
    _args.expect(ctx, "ctx", torch.float32, (v_size, d))
    _args.expect(acc_emb, "acc_emb", torch.float32, (v_size, d + 1))
    _args.expect(acc_ctx, "acc_ctx", torch.float32, (v_size, d + 1))
    _args.expect(centers, "centers", torch.int32, (e,))
    _args.expect(contexts, "contexts", torch.int32, (e,))
    _args.expect(d_center, "d_center", torch.float32, (e, d))
    _args.expect(v, "v", torch.float32, (e, d))
    _args.expect(g_pos, "g_pos", torch.float32, (e,))
    lib = _lib()
    status = lib.k4_row_update(
        _args.ptr(emb), _args.ptr(ctx), _args.ptr(acc_emb), _args.ptr(acc_ctx),
        _args.ptr(centers), _args.ptr(contexts), _args.ptr(d_center),
        _args.ptr(v), _args.ptr(g_pos), float(lr), COMBINERS[combiner],
        e, v_size, d, _args.stream(emb),
    )
    build.check(lib, status, "K4 row_update launch")
    global launches
    launches += 1


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
    global scatter_launches
    scatter_launches += 1


def finalize_rows_plain(table, acc, lr, combiner):
    d = table.shape[1]
    table -= lr * (acc[:, :d] / row_divisor(acc[:, d], combiner)[:, None])


def finalize_rows(table, acc, lr: float, combiner: str) -> None:
    """table −= lr · acc[:, :D] / divisor(acc[:, D]), in place."""
    if combiner not in COMBINERS:
        raise ValueError(f"unknown combiner {combiner!r}")
    if _args.on_cpu(table, acc):
        return finalize_rows_plain(table, acc, lr, combiner)
    v_rows, d = table.shape
    _args.expect(table, "table", torch.float32, (v_rows, d))
    _args.expect(acc, "acc", torch.float32, (v_rows, d + 1))
    lib = _lib()
    status = lib.k4_finalize_rows(_args.ptr(table), _args.ptr(acc), float(lr),
                                  COMBINERS[combiner], v_rows, d, _args.stream(table))
    build.check(lib, status, "K4 finalize_rows launch")
    global finalize_launches
    finalize_launches += 1


def _lib():
    lib = build.load(_LIB)
    fn = lib.k4_row_update
    if fn.argtypes is None:
        P, I, F = _args.P, _args.I, _args.F
        fn.argtypes = [P, P, P, P, P, P, P, P, P, F, I, I, I, I, P]
        fn.restype = I
        lib.k4_scatter_rows.argtypes = [P, P, P, P, I, I, P]
        lib.k4_scatter_rows.restype = I
        lib.k4_finalize_rows.argtypes = [P, P, F, I, I, I, P]
        lib.k4_finalize_rows.restype = I
    return lib
