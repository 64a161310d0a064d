"""K2 — exact noise head (source: ``csrc/k2_noise_head.cu``).

Replaces ``gene2vec_tpu/sgns/step.py:736-746, 782-786, 828-831``: the
negative term's expectation over the H most frequent rows, computed
exactly against ``ctx[:H]``::

    logit     = v @ ctx[:H]ᵀ                         (E, H)
    mask      = j != contexts[e]
    g_head    = K·q_j·σ(logit)·mask
    loss_head = K·Σ_j q_j·mask·softplus(logit)
    d_center  = g_pos·u + g_head @ ctx[:H]
    acc_ctx[:H, :D] += g_headᵀ @ v
    acc_ctx[:H,  D] += K·q_j·Σ_e mask                (σ-free row load)

Returns (d_center, loss_head); ``acc_ctx`` is updated in place.  ``ctx``
is float32 or bfloat16; its head rows are upcast to float32.  On the card
the products run on the tensor cores through a 3xTF32 split (two passes
where the operand is a bfloat16 row), in two launches.
"""

from __future__ import annotations

import torch

from gene2vec_tpu_torch.kernels import _args, build
from gene2vec_tpu_torch.kernels.pos_logit import softplus, sum_tn

#: kernel launches made through :func:`noise_head`, by table width
#: ("" float32, "bf16")
launches = {("noise_head", ""): 0, ("noise_head", "bf16"): 0}

_LIB = "k2_noise_head"


def noise_head_plain(v, u, g_pos, contexts, ctx, q, head, k_neg, acc_ctx):
    d = v.shape[1]
    k = float(k_neg)
    ctx_head = ctx[:head].float()
    q_head = q[:head]
    logit = v @ ctx_head.T
    mask = (
        torch.arange(head, device=v.device)[None, :] != contexts[:, None]
    ).to(v.dtype)
    g_head = k * q_head[None, :] * torch.sigmoid(logit) * mask
    loss_head = k * torch.sum(q_head[None, :] * mask * softplus(logit), dim=-1)
    d_center = g_pos[:, None] * u + g_head @ ctx_head
    acc_ctx[:head, :d] += sum_tn(g_head, v)
    acc_ctx[:head, d] += k * q_head * torch.sum(mask, dim=0)
    return d_center, loss_head


def noise_head(v, u, g_pos, contexts, ctx, q, head, k_neg, acc_ctx):
    if _args.on_cpu(v, u, g_pos, contexts, ctx, q, acc_ctx):
        return noise_head_plain(v, u, g_pos, contexts, ctx, q, head, k_neg, acc_ctx)
    e, d = v.shape
    v_size = ctx.shape[0]
    head = int(head)
    if not 0 < head <= v_size:
        raise ValueError(f"head={head} outside (0, {v_size}]")
    _args.expect(v, "v", torch.float32, (e, d))
    _args.expect(u, "u", torch.float32, (e, d))
    _args.expect(g_pos, "g_pos", torch.float32, (e,))
    _args.expect(contexts, "contexts", torch.int32, (e,))
    bf16 = _args.table_bf16((ctx,), ("ctx",), ((v_size, d),))
    _args.expect(q, "q", torch.float32, (None,))
    _args.expect(acc_ctx, "acc_ctx", torch.float32, (v_size, d + 1))
    if q.shape[0] < head:
        raise ValueError(f"q has {q.shape[0]} rows, fewer than head={head}")
    lib = _lib()
    dev = v.device
    hp = _args.padded_slab(head)
    g_scratch = torch.empty((e, hp), dtype=torch.float32, device=dev)
    hits = torch.empty((head,), dtype=torch.int32, device=dev)
    loss_head = torch.empty((e,), dtype=torch.float32, device=dev)
    d_center = torch.empty((e, d), dtype=torch.float32, device=dev)
    splits = _args.noise_ranges(-(-head // 128) * -(-d // 256), e, v)
    status = lib.k2_noise_head(
        _args.ptr(v), _args.ptr(u), _args.ptr(g_pos), _args.ptr(contexts),
        _args.ptr(ctx), _args.ptr(q), float(k_neg), _args.ptr(g_scratch),
        _args.ptr(hits), _args.ptr(loss_head), _args.ptr(d_center),
        _args.ptr(acc_ctx), e, d, head, hp, splits, bf16, _args.stream(v),
    )
    build.check(lib, status, "K2 noise_head launch")
    launches["noise_head", "bf16" if bf16 else ""] += 1
    return d_center, loss_head


def _lib():
    lib = build.load(_LIB)
    fn = lib.k2_noise_head
    if fn.argtypes is None:
        P, I, F = _args.P, _args.I, _args.F
        fn.argtypes = [P, P, P, P, P, P, F, P, P, P, P, P, I, I, I, I, I, I, P]
        fn.restype = I
    return lib
