"""K9r — exact rescore tail, and its row gather (source:
``csrc/k9r_rescore.cu``).

:func:`rescore` replaces ``gene2vec_tpu/serve/ann.py:452-467``
(``_rescore_topk``): gather the float32 unit rows of each query's ``r``
candidates, take the exact dot with the normalized query, drop the
candidates whose approximate score is not finite (the reference's
``approx_ok``: list padding and rows ≥ ``valid`` carry −inf), and
return the top-``k`` (scores, rows) with masked candidates at −inf and
row 0, ties broken by candidate position: one launch a call where the
list fits a block or cluster (``_topk.plan_list`` route 0), else the
chunked runs and a final launch.

:func:`row_gather` is the kernel's gather loop on its own —
``out[i] = table[idx[i]]`` for float32 and bfloat16 tables, the
counterpart of the Pallas row-gather probes
(``experiments/test_pallas_gather.py:31`` ``pallas_gather`` and
``experiments/test_dma2.py:95`` ``make_gather``).
"""

from __future__ import annotations

import torch

from gene2vec_tpu_torch.kernels import _args, _topk, build

#: kernel launches made through :func:`rescore` and :func:`row_gather`
launches = {("rescore", ""): 0, ("row_gather", ""): 0}

_LIB = "k9r_rescore"


def rescore_plain(qn, unit, ri, approx, k: int):
    ok = torch.isfinite(approx)
    pos = torch.where(ok, ri, 0)
    cand = unit[pos.long()]                                  # (B, r, D)
    exact = (cand @ qn[:, :, None])[:, :, 0]
    exact = torch.where(ok, exact, float("-inf"))
    fs, fi = _topk.topk_plain(exact, min(k, exact.shape[1]))
    return fs, torch.gather(pos, 1, fi.long()).to(torch.int32)


def rescore(qn, unit, ri, approx, k: int):
    """(scores (B, min(k, r)) float32, rows int32) from the candidates
    ``ri`` (B, r) int32 and their approximate scores ``approx``."""
    if _args.on_cpu(qn, unit, ri, approx):
        return rescore_plain(qn, unit, ri, approx, k)
    v_rows, d = unit.shape
    b, r = ri.shape
    _args.expect(qn, "qn", torch.float32, (b, d))
    _args.expect(unit, "unit", torch.float32, (v_rows, d))
    _args.expect(ri, "ri", torch.int32, (b, r))
    _args.expect(approx, "approx", torch.float32, (b, r))
    k = min(k, r)
    lib = _lib()
    p = plan(qn, unit, r, k)
    scr = _topk.list_scratch(p, b, r, qn.device)
    scores = torch.empty((b, k), dtype=torch.float32, device=qn.device)
    rows = torch.empty((b, k), dtype=torch.int32, device=qn.device)
    status = launch(lib, qn, unit, ri, approx, k, p, scr, scores, rows)
    build.check(lib, status, "K9r rescore launch")
    launches["rescore", ""] += 1
    return scores, rows


def plan(qn, unit, r: int, k: int) -> _topk.ListPlan:
    """The ``_topk.plan_list`` of a call over ``r`` candidates, top-``k``."""
    d = unit.shape[1]
    return _topk.plan_list(r, k, qn.shape[0], d, "float32",
                           _topk.list_word(d, "float32", unit.data_ptr()), 0,
                           _args.sm_count(qn))


def launch(lib, qn, unit, ri, approx, k, p, scr, scores, rows) -> int:
    """``k9r_rescore`` of ``lib`` on checked tensors and a plan; returns its
    status (a CUDA error code)."""
    b, r = ri.shape
    ptr = _args.ptr
    return lib.k9r_rescore(
        ptr(qn), ptr(unit), ptr(ri), ptr(approx), unit.shape[1], b, r, k, p.route, p.share,
        p.nseg, p.lanes, p.word, p.slot, p.stride, *_topk.list_scratch_ptrs(scr, b * p.stride),
        ptr(scores), ptr(rows), _args.stream(qn),
    )


def row_gather_plain(table, idx):
    return table.index_select(0, idx.long())


def row_gather(table, idx):
    """(E, D) rows ``table[idx]`` of a float32 or bfloat16 (V, D) table."""
    if _args.on_cpu(table, idx):
        return row_gather_plain(table, idx)
    v_rows, d = table.shape
    e = idx.shape[0]
    if table.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"table: expected float32 or bfloat16, got {table.dtype}")
    _args.expect(table, "table", table.dtype, (v_rows, d))
    _args.expect(idx, "idx", torch.int32, (e,))
    out = torch.empty((e, d), dtype=table.dtype, device=table.device)
    lib = _lib()
    status = lib.k9r_row_gather(
        _args.ptr(table), _args.ptr(idx), _args.ptr(out), e, d * table.element_size(),
        _args.stream(table),
    )
    build.check(lib, status, "K9r row_gather launch")
    launches["row_gather", ""] += 1
    return out


def _lib():
    return bind(build.load(_LIB))


def bind(lib):
    """``lib`` (a build of ``csrc/k9r_rescore.cu``) with its entry points'
    argument types set."""
    if lib.k9r_rescore.argtypes is None:
        P, I = _args.P, _args.I
        lib.k9r_rescore.argtypes = [P, P, P, P] + [I] * 11 + [P] * 8
        lib.k9r_rescore.restype = I
        lib.k9r_row_gather.argtypes = [P, P, P, I, I, P]
        lib.k9r_row_gather.restype = I
    return lib
