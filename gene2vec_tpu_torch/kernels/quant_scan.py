"""K8 — int8 compressed-domain scan (source: ``csrc/k8_quant_scan.cu``).

Replaces ``gene2vec_tpu/serve/ann.py:397-426`` (``_quantize_queries``,
``_approx_scores``) and the scan half of ``make_quant_kernel``
(``:476-497``): quantize each normalized query per row (scale
``max(max|q|/127, 1e-12)``, round half to even, clip to ±127), take the
int8·int8 → int32 dot against the int8 table, rescale as
``float(acc) * qs * scale[row]``, mask rows ≥ ``valid`` to −inf and
return the top-``rb`` (approximate scores, int32 rows).

The int32 sum is exact (on the card: int8 tensor cores, ``mma.sync``
s8 x s8 -> s32) and the rescale runs in the reference's order, so the
approximate scores are bitwise the reference's, on the CPU and on the
card alike.  A bf16 table (``build_index(quant_dtype="bf16")``) is
scanned by the same staged kernel with a SIMT bf16 scorer: the query rounded to
bf16, exact bf16 products summed in float32 (the reference's
``preferred_element_type=f32`` dot), equal to the plain version up to
the order of the float32 sum.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from gene2vec_tpu_torch.kernels import _args, _topk, build

#: kernel launches made through :func:`quant_scan`
launches = {("quant_scan", ""): 0}

_LIB = "k8_quant_scan"


#: float32 1/127.  The reference's ``max|q| / 127.0`` compiles to a
#: product with this constant (XLA folds division by a constant), so the
#: scales are ``max|q| * fl(1/127)`` — which is also what a division by a
#: Python scalar would give on the card, but not on the CPU.
_INV127 = float(np.float32(1.0) / np.float32(127.0))


def quantize_queries_plain(qn):
    """(int8 queries, float32 scales (B, 1)) — ``_quantize_queries``."""
    qs = torch.clamp_min(torch.amax(qn.abs(), dim=1) * _INV127, _topk._EPS)
    qq = torch.clamp(torch.round(qn / qs[:, None]), -127, 127).to(torch.int8)
    return qq, qs[:, None]


def int_dot(a, b):
    """Exact int8·int8 sums as int32: float64 holds every partial sum
    exactly, and PyTorch has no integer matrix product on the card."""
    return (a.to(torch.float64) @ b.to(torch.float64).transpose(-1, -2)).to(torch.int32)


def quant_scores_plain(qn, table_q, scale):
    """(B, V) approximate scores — ``_approx_scores``."""
    if table_q.dtype == torch.int8:
        qq, qs = quantize_queries_plain(qn)
        return int_dot(qq, table_q).to(torch.float32) * qs * scale[None, :]
    return qn.to(table_q.dtype).float() @ table_q.float().T


def quant_scan_plain(qn, table_q, scale, rb: int, valid: Optional[int] = None):
    approx = quant_scores_plain(qn, table_q, scale)
    total = table_q.shape[0]
    if valid is not None and valid < total:
        approx[:, valid:] = float("-inf")
    return _topk.topk_plain(approx, min(rb, total))


def quant_scan(qn, table_q, scale, rb: int, valid: Optional[int] = None):
    """(approximate scores (B, rb) float32, rows (B, rb) int32)."""
    if _args.on_cpu(qn, table_q, scale):
        return quant_scan_plain(qn, table_q, scale, rb, valid)
    bf16 = _args.table_kind(table_q, "table_q")
    v_rows, d = table_q.shape
    b = qn.shape[0]
    _args.expect(qn, "qn", torch.float32, (b, d))
    _args.expect(table_q, "table_q", table_q.dtype, (v_rows, d))
    _args.expect(scale, "scale", torch.float32, (v_rows,))
    valid = v_rows if valid is None else min(int(valid), v_rows)
    rb = min(rb, v_rows)
    lib = _lib()
    kind = "bfloat16" if bf16 else "int8"
    p = _topk.plan_staged(v_rows, rb, b, d, kind, sms=_args.sm_count(qn))
    scr = _topk.scratch(p, qn.device)
    scores = torch.empty((b, rb), dtype=torch.float32, device=qn.device)
    rows = torch.empty((b, rb), dtype=torch.int32, device=qn.device)
    status = lib.k8_quant_scan(
        _args.ptr(qn), _args.ptr(table_q), _args.ptr(scale), int(bf16), v_rows, d, b, valid,
        rb, p.tile, p.qb, p.rows, p.dslice, p.slot, p.stride,
        _args.ptr(scr[0]), _args.ptr(scr[1]), _args.ptr(scr[2]),
        _args.ptr(scr[3]), _args.ptr(scores), _args.ptr(rows), _args.stream(qn),
    )
    build.check(lib, status, "K8 quant_scan launch")
    launches["quant_scan", ""] += 1
    return scores, rows


def _lib():
    lib = build.load(_LIB)
    fn = lib.k8_quant_scan
    if fn.argtypes is None:
        P, I = _args.P, _args.I
        fn.argtypes = [P, P, P] + [I] * 12 + [P] * 7
        fn.restype = I
    return lib
