"""K9 — IVF probe and candidate scan (source: ``csrc/k9_ivf_scan.cu``).

Replaces ``gene2vec_tpu/serve/ann.py:429-449`` (``_gathered_approx``)
and the probe half of ``make_ivf_kernel`` (``:550-571``): score the
normalized queries against the (C, D) centroids and take the top-
``nprobe`` lists (``lax.top_k``'s order); gather the lists' candidate
ids (``-1``-padded; ids ≥ ``valid`` masked); gather those candidates'
int8 rows and scales, take the int8 dot and rescale as K8 does; return
the top-``r`` (r = min(rb, nprobe·L)) among each query's candidates as
(approximate scores, int32 rows), masked candidates at −inf with row 0,
ties broken by candidate position.  A bf16 table takes K8's bf16
scorer (the query rounded to bf16, float32 sums).

Two launches a call: the probe, and the scan with its select
(``_topk.plan_list`` route 0); lists past what a block holds add the
chunked select's final launch.
"""

from __future__ import annotations

from typing import Optional

import torch

from gene2vec_tpu_torch.kernels import _args, _topk, build
from gene2vec_tpu_torch.kernels.quant_scan import int_dot, quantize_queries_plain

#: kernel launches made through :func:`ivf_scan`
launches = {("ivf_scan", ""): 0}

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
    bf16 = _args.table_kind(table_q, "table_q")
    v_rows, d = table_q.shape
    c, lst = lists.shape
    b = qn.shape[0]
    _args.expect(qn, "qn", torch.float32, (b, d))
    _args.expect(centroids, "centroids", torch.float32, (c, d))
    _args.expect(lists, "lists", torch.int32, (c, lst))
    _args.expect(table_q, "table_q", table_q.dtype, (v_rows, d))
    _args.expect(scale, "scale", torch.float32, (v_rows,))
    if not 1 <= nprobe <= c:
        raise ValueError(f"nprobe must be in [1, {c}], got {nprobe}")
    valid = v_rows if valid is None else min(int(valid), v_rows)
    n = nprobe * lst
    r = min(rb, n)
    lib = _lib()
    pp, pl = plans(qn, centroids, table_q, nprobe, rb, lst)
    probe = torch.empty((b, nprobe), dtype=torch.int32, device=qn.device)
    scr = _topk.list_scratch(pl, b, n, qn.device)
    scores = torch.empty((b, r), dtype=torch.float32, device=qn.device)
    rows = torch.empty((b, r), dtype=torch.int32, device=qn.device)
    status = launch(lib, qn, centroids, lists, table_q, scale, nprobe, valid, r, pp, pl, probe,
                    scr, scores, rows)
    build.check(lib, status, "K9 ivf_scan launch")
    launches["ivf_scan", ""] += 1
    return scores, rows


def plans(qn, centroids, table_q, nprobe: int, rb: int, list_len: int):
    """(probe plan, scan plan) of a call: ``_topk.plan_probe`` and
    ``_topk.plan_list`` for these tensors."""
    c, d = centroids.shape
    b = qn.shape[0]
    kind = "bfloat16" if table_q.dtype == torch.bfloat16 else "int8"
    n = nprobe * list_len
    sms = _args.sm_count(qn)
    pp = _topk.plan_probe(c, nprobe, b, d, centroids.data_ptr() % 16 == 0, sms)
    pl = _topk.plan_list(n, min(rb, n), b, d, kind, _topk.list_word(d, kind, table_q.data_ptr()),
                         4 * nprobe, sms)
    return pp, pl


def launch(lib, qn, centroids, lists, table_q, scale, nprobe, valid, r, pp, pl, probe, scr,
           scores, rows) -> int:
    """``k9_ivf_scan`` of ``lib`` on checked tensors and plans; returns its
    status (a CUDA error code)."""
    c, lst = lists.shape
    b, d = qn.shape
    n = nprobe * lst
    ptr = _args.ptr
    return lib.k9_ivf_scan(
        ptr(qn), ptr(centroids), ptr(lists), ptr(table_q), ptr(scale),
        int(table_q.dtype == torch.bfloat16), c, lst, d, b, nprobe, valid, r,
        pp.qg, pp.qpt, pp.share, pp.cluster, pp.rows, pp.tstride, pp.cp, pp.smem,
        pl.route, pl.share, pl.nseg, pl.lanes, pl.word, pl.slot, pl.stride,
        ptr(probe), *_topk.list_scratch_ptrs(scr, b * pl.stride), ptr(scores), ptr(rows),
        _args.stream(qn),
    )


def _lib():
    return bind(build.load(_LIB))


def bind(lib):
    """``lib`` (a build of ``csrc/k9_ivf_scan.cu``) with its entry point's
    argument types set."""
    fn = lib.k9_ivf_scan
    if fn.argtypes is None:
        P, I = _args.P, _args.I
        fn.argtypes = [P, P, P, P, P] + [I] * 23 + [P] * 8 + [P]
        fn.restype = I
    return lib
