"""K1 — positive gather and logit (source: ``csrc/k1_pos_logit.cu``).

Replaces ``gene2vec_tpu/sgns/step.py:705-734``: v = emb[centers],
u = ctx[contexts], pos_logit = Σ v·u, g_pos = σ(pos_logit) − 1 and the
loss term softplus(−pos_logit).  v and u are returned because K2-K4
reuse them.  The tables are float32 or bfloat16 (both of one type); the
gathered rows are upcast to float32 (the reference's
``.astype(compute_dtype)``), so v, u, g_pos and the loss are float32.
"""

from __future__ import annotations

import torch

from gene2vec_tpu_torch.kernels import _args, build

#: kernel launches made through :func:`pos_logit`, by table width
#: ("" float32, "bf16")
launches = {("pos_logit", ""): 0, ("pos_logit", "bf16"): 0}

_LIB = "k1_pos_logit"


def softplus(x: torch.Tensor) -> torch.Tensor:
    """jax.nn.softplus = logaddexp(x, 0)."""
    return torch.clamp_min(x, 0.0) + torch.log1p(torch.exp(-x.abs()))


#: the longest stretch of a reduction over examples that the plain versions
#: hand to one GEMM (:func:`sum_tn`)
TN_CHUNK = 1024


def sum_tn(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """aᵀ @ b over the examples axis (-2) of (K, M) and (K, N), or of
    batches (G, K, M) and (G, K, N), for the plain versions: the products of
    chunks of at most :data:`TN_CHUNK` rows, one ``bmm``, added in chunk
    order.  A CPU GEMM with a long reduction may split it across threads,
    and its error then depends on torch's thread count (MKL at K = 8,192:
    ~3 ulps of the result's largest entry at 1-4 threads, ~20 at 8); one
    batched product of short chunks keeps the error of a short sum."""
    flat = a.dim() == 2
    if flat:
        a, b = a[None], b[None]
    g, k, m = a.shape
    n = b.shape[2]
    c = max(1, -(-k // TN_CHUNK))
    if c > 1 and k % TN_CHUNK:
        pad = c * TN_CHUNK - k  # zero rows add exact zeros
        a = torch.nn.functional.pad(a, (0, 0, 0, pad))
        b = torch.nn.functional.pad(b, (0, 0, 0, pad))
    parts = torch.bmm(a.reshape(g * c, -1, m).transpose(1, 2),
                      b.reshape(g * c, -1, n)).reshape(g, c, m, n)
    out = parts[:, 0]
    for i in range(1, c):
        out = out + parts[:, i]
    return out[0] if flat else out


def pos_logit_plain(emb, ctx, centers, contexts):
    v = emb.index_select(0, centers).float()
    u = ctx.index_select(0, contexts).float()
    logit = torch.sum(v * u, dim=-1)
    return v, u, torch.sigmoid(logit) - 1.0, softplus(-logit)


def pos_logit(emb, ctx, centers, contexts):
    """(v (E, D), u (E, D), g_pos (E,), loss_pos (E,))."""
    if _args.on_cpu(emb, ctx, centers, contexts):
        return pos_logit_plain(emb, ctx, centers, contexts)
    v_size, d = emb.shape
    e = centers.shape[0]
    bf16 = _args.table_bf16((emb, ctx), ("emb", "ctx"), ((v_size, d), (v_size, d)))
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
        e, d, bf16, _args.stream(emb),
    )
    build.check(lib, status, "K1 pos_logit launch")
    launches["pos_logit", "bf16" if bf16 else ""] += 1
    return v, u, g_pos, loss_pos


def _lib():
    lib = build.load(_LIB)
    fn = lib.k1_pos_logit
    if fn.argtypes is None:
        P, I = _args.P, _args.I
        fn.argtypes = [P, P, P, P, P, P, P, P, I, I, I, P]
        fn.restype = I
    return lib
