"""K5b — the shared grouped noise pool (source: ``csrc/k5_shared.cu``).

Replaces ``gene2vec_tpu/sgns/step.py:337-442`` (``_step_shared``, its
noise half).  G groups of E/G consecutive examples, each against its own
P/G slice of the pool of P alias draws::

    neg_logit = (G, E/G, D) × (G, D, P/G)
    mask      = pool id != contexts[e]
    scale     = K·G/P
    loss_neg  = scale·Σ mask·softplus(neg_logit)
    g_neg     = scale·σ(neg_logit)·mask
    d_center  = g_pos·u + g_neg @ u_pool
    acc_ctx[pool] += [g_negᵀ @ v_g | scale·Σ_e mask]   (float32 count)

Returns (d_center, loss_neg); ``acc_ctx`` is updated in place.  ``ctx``
is float32 or bfloat16; the pool rows are upcast to float32.  On the card
the products run on the tensor cores through K2/K3's 3xTF32 split (two
passes where the operand is a bfloat16 row), in two launches, with each
group's pool rows gathered into the staged slab.
"""

from __future__ import annotations

import numpy as np
import torch

from gene2vec_tpu_torch.kernels import _args, build
from gene2vec_tpu_torch.kernels.pos_logit import softplus, sum_tn

#: kernel launches made through :func:`shared_pool`, by table width
#: ("" float32, "bf16")
launches = {("shared_pool", ""): 0, ("shared_pool", "bf16"): 0}

_LIB = "k5_shared"


def pool_scale(k_neg: int, groups: int, pool_size: int) -> float:
    """K·G/P rounded to float32, as the reference's ``jnp.asarray``."""
    return float(np.float32(k_neg * groups / pool_size))


def shared_pool_plain(v, u, g_pos, contexts, pool, ctx, k_neg, groups, acc_ctx):
    e, d = v.shape
    p, g = pool.shape[0], groups
    u_negg = ctx[pool.long()].float().reshape(g, p // g, d)
    vg = v.reshape(g, e // g, d)
    neg_logit = torch.bmm(vg, u_negg.transpose(1, 2))          # (G, E/G, P/G)
    mask = (pool.reshape(g, 1, p // g) != contexts.reshape(g, e // g, 1)).to(v.dtype)
    scale = pool_scale(k_neg, g, p)
    loss_neg = scale * torch.sum(mask * softplus(neg_logit), dim=-1).reshape(e)
    g_neg = scale * torch.sigmoid(neg_logit) * mask
    d_center = g_pos[:, None] * u + torch.bmm(g_neg, u_negg).reshape(e, d)
    d_negrow = sum_tn(g_neg, vg).reshape(p, d)
    weights = scale * mask.sum(dim=1).reshape(p)
    acc_ctx.index_add_(0, pool.long(), torch.cat([d_negrow, weights[:, None]], dim=1))
    return d_center, loss_neg


def shared_pool(v, u, g_pos, contexts, pool, ctx, k_neg: int, groups: int, acc_ctx):
    if _args.on_cpu(v, u, g_pos, contexts, pool, ctx, acc_ctx):
        return shared_pool_plain(v, u, g_pos, contexts, pool, ctx, k_neg, groups, acc_ctx)
    e, d = v.shape
    p = pool.shape[0]
    v_size = ctx.shape[0]
    g = int(groups)
    if g <= 0 or e % g or p % g:
        raise ValueError(f"groups={g} must divide E={e} and P={p}")
    _args.expect(v, "v", torch.float32, (e, d))
    _args.expect(u, "u", torch.float32, (e, d))
    _args.expect(g_pos, "g_pos", torch.float32, (e,))
    _args.expect(contexts, "contexts", torch.int32, (e,))
    _args.expect(pool, "pool", torch.int32, (p,))
    bf16 = _args.table_bf16((ctx,), ("ctx",), ((v_size, d),))
    _args.expect(acc_ctx, "acc_ctx", torch.float32, (v_size, d + 1))
    lib = _lib()
    dev = v.device
    s = p // g
    sp = _args.padded_slab(s)
    g_scratch = torch.empty((e, sp), dtype=torch.float32, device=dev)
    hits = torch.empty((g, s), dtype=torch.int32, device=dev)
    loss_neg = torch.empty((e,), dtype=torch.float32, device=dev)
    d_center = torch.empty((e, d), dtype=torch.float32, device=dev)
    splits = _args.noise_ranges(g * -(-s // 128) * -(-d // 256), e // g, v)
    status = lib.k5_shared(
        _args.ptr(v), _args.ptr(u), _args.ptr(g_pos), _args.ptr(contexts),
        _args.ptr(ctx), _args.ptr(pool), pool_scale(k_neg, g, p), _args.ptr(g_scratch),
        _args.ptr(hits), _args.ptr(loss_neg), _args.ptr(d_center), _args.ptr(acc_ctx),
        e, d, g, s, sp, splits, bf16, _args.stream(v),
    )
    build.check(lib, status, "K5b shared_pool launch")
    launches["shared_pool", "bf16" if bf16 else ""] += 1
    return d_center, loss_neg


def _lib():
    lib = build.load(_LIB)
    fn = lib.k5_shared
    if fn.argtypes is None:
        P, I, F = _args.P, _args.I, _args.F
        fn.argtypes = [P, P, P, P, P, P, F, P, P, P, P, P, I, I, I, I, I, I, I, P]
        fn.restype = I
    return lib
