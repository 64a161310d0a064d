"""K7 — exact cosine top-k (source: ``csrc/k7_topk_exact.cu``).

Replaces ``gene2vec_tpu/serve/engine.py:43-59`` (``_topk_cosine``):
normalize the queries (``q / max(‖q‖, 1e-12)``), score them against the
(V, D) float32 unit matrix, set rows ≥ ``valid`` to −inf and return the
top-``kb`` (scores, int32 rows) in ``lax.top_k``'s order.  Two launches
a call, and the (B, V) score matrix never reaches device memory: blocks
stage chunks of rows in shared memory once for the whole batch and keep
each query's top-``kb`` of their chunk; a final block a query selects
across chunks and sorts only those.
"""

from __future__ import annotations

from typing import Optional

import torch

from gene2vec_tpu_torch.kernels import _args, _topk, build

#: kernel launches made through :func:`topk_exact`
launches = {("topk_exact", ""): 0}

_LIB = "k7_topk_exact"


def topk_exact_plain(unit, queries, kb: int, valid: Optional[int] = None):
    qn = _topk.normalize_plain(queries)
    scores = qn @ unit.T
    if valid is not None and valid < unit.shape[0]:
        scores[:, valid:] = float("-inf")
    return _topk.topk_plain(scores, kb)


def topk_exact(unit, queries, kb: int, valid: Optional[int] = None):
    """(scores (B, kb) float32, rows (B, kb) int32)."""
    if _args.on_cpu(unit, queries):
        return topk_exact_plain(unit, queries, kb, valid)
    v_rows, d = unit.shape
    b = queries.shape[0]
    _args.expect(unit, "unit", torch.float32, (v_rows, d))
    _args.expect(queries, "queries", torch.float32, (b, d))
    valid = v_rows if valid is None else min(int(valid), v_rows)
    lib = _lib()
    p = _topk.plan_staged(v_rows, kb, b, d, "float32", sms=_args.sm_count(unit))
    scr = _topk.scratch(p, unit.device)
    scores = torch.empty((b, kb), dtype=torch.float32, device=unit.device)
    rows = torch.empty((b, kb), dtype=torch.int32, device=unit.device)
    status = lib.k7_topk_exact(
        _args.ptr(unit), _args.ptr(queries), v_rows, d, b, valid, kb,
        p.tile, p.qb, p.rows, p.dslice, p.slot, p.stride,
        _args.ptr(scr[0]), _args.ptr(scr[1]), _args.ptr(scr[2]),
        _args.ptr(scr[3]), _args.ptr(scores), _args.ptr(rows), _args.stream(unit),
    )
    build.check(lib, status, "K7 topk_exact launch")
    launches["topk_exact", ""] += 1
    return scores, rows


def work(n_rows: int, d: int, batch: int, kb: int) -> dict:
    """What K7's function needs for ``batch`` queries over ``n_rows`` unit
    rows (``_work.py``): the table and queries read once, (score, id) of
    the top ``kb`` written; a dot of D products a (query, row)."""
    return {"bytes": 4 * (n_rows * d + batch * d) + 8 * batch * kb,
            "flops": 2.0 * batch * n_rows * d}


def _lib():
    lib = build.load(_LIB)
    fn = lib.k7_topk_exact
    if fn.argtypes is None:
        P, I = _args.P, _args.I
        fn.argtypes = [P, P] + [I] * 11 + [P] * 7
        fn.restype = I
    return lib
