"""K1 — positive gather and logit (source: ``csrc/k1_pos_logit.cu``).

Replaces ``gene2vec_tpu/sgns/step.py:705-734``: v = emb[centers],
u = ctx[contexts], pos_logit = Σ v·u, g_pos = σ(pos_logit) − 1 and the
loss term softplus(−pos_logit).  v and u are returned because K2-K4
reuse them.
"""

from __future__ import annotations

import torch

from gene2vec_tpu_torch.kernels import _args, build

#: kernel launches made through :func:`pos_logit`
launches = 0

_LIB = "k1_pos_logit"


def softplus(x: torch.Tensor) -> torch.Tensor:
    """jax.nn.softplus = logaddexp(x, 0)."""
    return torch.clamp_min(x, 0.0) + torch.log1p(torch.exp(-x.abs()))


def pos_logit_plain(emb, ctx, centers, contexts):
    v = emb.index_select(0, centers)
    u = ctx.index_select(0, contexts)
    logit = torch.sum(v * u, dim=-1)
    return v, u, torch.sigmoid(logit) - 1.0, softplus(-logit)


def pos_logit(emb, ctx, centers, contexts):
    """(v (E, D), u (E, D), g_pos (E,), loss_pos (E,))."""
    if _args.on_cpu(emb, ctx, centers, contexts):
        return pos_logit_plain(emb, ctx, centers, contexts)
    v_size, d = emb.shape
    e = centers.shape[0]
    _args.expect(emb, "emb", torch.float32, (v_size, d))
    _args.expect(ctx, "ctx", torch.float32, (v_size, d))
    _args.expect(centers, "centers", torch.int32, (e,))
    _args.expect(contexts, "contexts", torch.int32, (e,))
    v = torch.empty((e, d), dtype=torch.float32, device=emb.device)
    u = torch.empty_like(v)
    g_pos = torch.empty((e,), dtype=torch.float32, device=emb.device)
    loss_pos = torch.empty_like(g_pos)
    lib = _lib()
    status = lib.k1_pos_logit(
        _args.ptr(emb), _args.ptr(ctx), _args.ptr(centers), _args.ptr(contexts),
        _args.ptr(v), _args.ptr(u), _args.ptr(g_pos), _args.ptr(loss_pos),
        e, d, _args.stream(emb),
    )
    build.check(lib, status, "K1 pos_logit launch")
    global launches
    launches += 1
    return v, u, g_pos, loss_pos


def _lib():
    lib = build.load(_LIB)
    fn = lib.k1_pos_logit
    if fn.argtypes is None:
        P, I = _args.P, _args.I
        fn.argtypes = [P, P, P, P, P, P, P, P, I, I, P]
        fn.restype = I
    return lib
