"""K9 — IVF probe and candidate scan (source: ``csrc/k9_ivf_scan.cu``).

Replaces ``gene2vec_tpu/serve/ann.py:429-449`` (``_gathered_approx``)
and the probe half of ``make_ivf_kernel`` (``:550-571``): score the
normalized queries against the (C, D) centroids and take the top-
``nprobe`` lists (``lax.top_k``'s order); gather the lists' candidate
ids (``-1``-padded; ids ≥ ``valid`` masked); gather those candidates'
int8 rows and scales, take the int8 dot and rescale as K8 does; return
the top-``r`` (r = min(rb, nprobe·L)) among each query's candidates as
(approximate scores, int32 rows), masked candidates at −inf with row 0,
ties broken by candidate position.
"""

from __future__ import annotations

from typing import Optional

import torch

from gene2vec_tpu_torch.kernels import _args, _topk, build
from gene2vec_tpu_torch.kernels.quant_scan import int_dot, quantize_queries_plain

#: kernel launches made through :func:`ivf_scan`
launches = 0

_LIB = "k9_ivf_scan"


def gathered_scores_plain(qn, table_q, scale, pos):
    """(B, N) approximate scores of explicit candidates ``pos`` (B, N) —
    ``_gathered_approx``."""
    rows = table_q[pos.long()]                        # (B, N, D)
    if table_q.dtype == torch.int8:
        qq, qs = quantize_queries_plain(qn)
        acc = int_dot(qq[:, None, :], rows)[:, 0, :]
        return acc.to(torch.float32) * qs * scale[pos.long()]
    q = qn.to(table_q.dtype).float()[:, None, :]
    return (q @ rows.float().transpose(1, 2))[:, 0, :]


def ivf_scan_plain(qn, centroids, lists, table_q, scale, nprobe: int, rb: int,
                   valid: Optional[int] = None):
    b = qn.shape[0]
    _, ci = _topk.topk_plain(qn @ centroids.T, nprobe)
    cand = lists[ci.long()].reshape(b, -1)
    ok = cand >= 0
    if valid is not None and valid < table_q.shape[0]:
        ok &= cand < valid
    pos = torch.where(ok, cand, 0)
    approx = gathered_scores_plain(qn, table_q, scale, pos)
    approx = torch.where(ok, approx, float("-inf"))
    rs, rpos = _topk.topk_plain(approx, min(rb, approx.shape[1]))
    return rs, torch.gather(pos, 1, rpos.long()).to(torch.int32)


def ivf_scan(qn, centroids, lists, table_q, scale, nprobe: int, rb: int,
             valid: Optional[int] = None):
    """(approximate scores (B, r) float32, rows (B, r) int32)."""
    if _args.on_cpu(qn, centroids, lists, table_q, scale):
        return ivf_scan_plain(qn, centroids, lists, table_q, scale, nprobe, rb, valid)
    if table_q.dtype != torch.int8:
        raise NotImplementedError(
            f"K9 scans int8 tables on the card; a {table_q.dtype} table has "
            "only the plain version"
        )
    v_rows, d = table_q.shape
    c, lst = lists.shape
    b = qn.shape[0]
    _args.expect(qn, "qn", torch.float32, (b, d))
    _args.expect(centroids, "centroids", torch.float32, (c, d))
    _args.expect(lists, "lists", torch.int32, (c, lst))
    _args.expect(table_q, "table_q", torch.int8, (v_rows, d))
    _args.expect(scale, "scale", torch.float32, (v_rows,))
    if not 1 <= nprobe <= c:
        raise ValueError(f"nprobe must be in [1, {c}], got {nprobe}")
    valid = v_rows if valid is None else min(int(valid), v_rows)
    n = nprobe * lst
    r = min(rb, n)
    lib = _lib()
    sms = _args.sm_count(qn)
    pc = _topk.plan(c, nprobe, b, 4 * d, per_query=False, sms=sms)
    pn = _topk.plan(n, r, b, d + 8, per_query=True, sms=sms)
    scr_c, scr_n = _topk.scratch(pc, qn.device), _topk.scratch(pn, qn.device)
    probe = torch.empty((b, nprobe), dtype=torch.int32, device=qn.device)
    probe_scores = torch.empty((b, nprobe), dtype=torch.float32, device=qn.device)
    scores = torch.empty((b, r), dtype=torch.float32, device=qn.device)
    rows = torch.empty((b, r), dtype=torch.int32, device=qn.device)
    status = lib.k9_ivf_scan(
        _args.ptr(qn), _args.ptr(centroids), _args.ptr(lists), _args.ptr(table_q),
        _args.ptr(scale), c, lst, v_rows, d, b, nprobe, valid, r,
        pc.tile, pc.qb, pn.tile,
        _args.ptr(scr_c[0]), _args.ptr(scr_c[1]), _args.ptr(scr_c[2]), _args.ptr(scr_c[3]),
        _args.ptr(scr_n[0]), _args.ptr(scr_n[1]), _args.ptr(scr_n[2]), _args.ptr(scr_n[3]),
        _args.ptr(probe_scores), _args.ptr(probe), _args.ptr(scores), _args.ptr(rows),
        _args.stream(qn),
    )
    build.check(lib, status, "K9 ivf_scan launch")
    global launches
    launches += 1
    return scores, rows


def _lib():
    lib = build.load(_LIB)
    fn = lib.k9_ivf_scan
    if fn.argtypes is None:
        P, I = _args.P, _args.I
        fn.argtypes = [P, P, P, P, P] + [I] * 11 + [P] * 12 + [P]
        fn.restype = I
    return lib
