"""K5a — per-example noise (source: ``csrc/k5_per_example.cu``).

Replaces ``gene2vec_tpu/sgns/step.py:97-130`` (``sgns_loss_and_grads``,
its noise half) and the ctx scatter of ``_step_per_example``
(``:289-334``): K alias draws per example, gensim's estimator, and the
reference's one fused scatter of the positive contexts and the draws::

    neg_logit = v · ctx[negs]ᵀ                   (E, K)
    mask      = negs != contexts[e]
    loss_neg  = Σ_k mask·softplus(neg_logit)
    g_neg     = σ(neg_logit)·mask
    d_center  = g_pos·u + Σ_k g_neg·ctx[negs]
    acc_ctx[contexts ++ negs] += [g_pos·v | 1] ++ [g_neg·v | mask]

Returns (d_center, loss_neg); ``acc_ctx`` is updated in place.  The
centers' rows and the finalize go through K4's generic entry points.
``ctx`` is float32 or bfloat16; the drawn rows are upcast to float32.
"""

from __future__ import annotations

import torch

from gene2vec_tpu_torch.kernels import _args, _work, build
from gene2vec_tpu_torch.kernels.pos_logit import softplus

#: kernel launches made through :func:`per_example`, by table width
#: ("" float32, "bf16")
launches = {("per_example", ""): 0, ("per_example", "bf16"): 0}

_LIB = "k5_per_example"


def per_example_plain(v, u, g_pos, contexts, negs, ctx, acc_ctx):
    d = v.shape[1]
    u_neg = ctx[negs.long()].float()                           # (E, K, D)
    neg_logit = torch.einsum("ed,ekd->ek", v, u_neg)
    mask = (negs != contexts[:, None]).to(v.dtype)
    loss_neg = torch.sum(mask * softplus(neg_logit), dim=-1)
    g_neg = torch.sigmoid(neg_logit) * mask
    d_center = g_pos[:, None] * u + torch.einsum("ek,ekd->ed", g_neg, u_neg)
    d_neg = g_neg[:, :, None] * v[:, None, :]
    ids = torch.cat([contexts, negs.reshape(-1)]).long()
    grads = torch.cat([g_pos[:, None] * v, d_neg.reshape(-1, d)])
    weights = torch.cat([torch.ones_like(g_pos), mask.reshape(-1)])
    acc_ctx.index_add_(0, ids, torch.cat([grads, weights[:, None]], dim=1))
    return d_center, loss_neg


def per_example(v, u, g_pos, contexts, negs, ctx, acc_ctx):
    if _args.on_cpu(v, u, g_pos, contexts, negs, ctx, acc_ctx):
        return per_example_plain(v, u, g_pos, contexts, negs, ctx, acc_ctx)
    e, d = v.shape
    k = negs.shape[1]
    v_size = ctx.shape[0]
    _args.expect(v, "v", torch.float32, (e, d))
    _args.expect(u, "u", torch.float32, (e, d))
    _args.expect(g_pos, "g_pos", torch.float32, (e,))
    _args.expect(contexts, "contexts", torch.int32, (e,))
    _args.expect(negs, "negs", torch.int32, (e, k))
    bf16 = _args.table_bf16((ctx,), ("ctx",), ((v_size, d),))
    _args.expect(acc_ctx, "acc_ctx", torch.float32, (v_size, d + 1))
    loss_neg = torch.empty((e,), dtype=torch.float32, device=v.device)
    d_center = torch.empty((e, d), dtype=torch.float32, device=v.device)
    lib = _lib()
    status = lib.k5_per_example(
        _args.ptr(v), _args.ptr(u), _args.ptr(g_pos), _args.ptr(contexts),
        _args.ptr(negs), _args.ptr(ctx), _args.ptr(loss_neg), _args.ptr(d_center),
        _args.ptr(acc_ctx), e, k, d, bf16, _args.stream(v),
    )
    build.check(lib, status, "K5a per_example launch")
    launches["per_example", "bf16" if bf16 else ""] += 1
    return d_center, loss_neg


def work(contexts, negs, d: int, table_bytes: int = 4) -> dict:
    """What K5a's function needs for (E, K) draws ``negs`` (``_work.py``):
    v, u, d_center, g_pos, the contexts, the draws and the loss once, each
    distinct drawn row once, and each accumulator row it adds to (the
    draws' and the positive contexts') read and written once; 5 float32
    operations a draw and column (dot, and the d_center and accumulator
    FMAs) and 2 a column for the positive context's row."""
    e, k = (int(s) for s in negs.shape)
    n_neg = _work.distinct(negs)
    n_acc = _work.distinct(negs, contexts)
    return {"bytes": 4 * (2 * e * d + 2 * e + e * k + 2 * n_acc * (d + 1) + e * d + e)
            + table_bytes * n_neg * d,
            "flops": 5 * e * k * d + 2 * e * d, "draw_rows": n_neg, "acc_rows": n_acc}


def _lib():
    lib = build.load(_LIB)
    fn = lib.k5_per_example
    if fn.argtypes is None:
        P, I = _args.P, _args.I
        fn.argtypes = [P, P, P, P, P, P, P, P, P, I, I, I, I, P]
        fn.restype = I
    return lib
