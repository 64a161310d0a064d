"""K3 — stratified tail blocks (source: ``csrc/k3_noise_tail.cu``).

Replaces ``gene2vec_tpu/sgns/step.py:748-777, 785, 833-847`` and
``_aggregate_tail_blocks`` (598-627).  Each group g of ``group_size``
consecutive examples scores one drawn block of S contiguous ctx rows at
start_g = min(head + blocks[g]·S, V − S) (the last block clamps and
overlaps its neighbour)::

    logit     = v_g @ ctx[start_g : start_g+S]ᵀ        (E/G, S)
    w         = K·tail_w[row],  mask = row != contexts[e]
    g_tail    = w·σ(logit)·mask
    loss_tail = Σ_s w·mask·softplus(logit)
    d_center += g_tail @ block
    acc_ctx[start_g : start_g+S] += [g_tailᵀ @ v_g | w·Σ_e mask]

Each group's (S, D+1) payload goes straight into ``acc_ctx`` (no (nb, G)
one-hot).  Returns loss_tail; ``d_center`` and ``acc_ctx`` are updated in
place.  ``ctx`` is float32 or bfloat16; the block rows are upcast to
float32.  On the card the products run on the tensor cores through a
3xTF32 split (two passes where the operand is a bfloat16 row), in two
launches.
"""

from __future__ import annotations

import torch

from gene2vec_tpu_torch.kernels import _args, _work, build
from gene2vec_tpu_torch.kernels.pos_logit import softplus, sum_tn

#: kernel launches made through :func:`noise_tail`, by table width
#: ("" float32, "bf16")
launches = {("noise_tail", ""): 0, ("noise_tail", "bf16"): 0}

_LIB = "k3_noise_tail"


def block_starts(blocks, head: int, block: int, v_noise: int):
    return torch.clamp_max(head + blocks.to(torch.int64) * block, v_noise - block)


def noise_tail_plain(v, contexts, ctx, tail_w, blocks, head, block, group_size,
                     k_neg, d_center, acc_ctx):
    e, d = v.shape
    g = e // group_size
    k = float(k_neg)
    starts = block_starts(blocks, head, block, tail_w.shape[0])
    rows = starts[:, None] + torch.arange(block, device=v.device)[None, :]  # (G, S)
    ctx_blk = ctx[rows].float()                                             # (G, S, D)
    w_blk = tail_w[rows]                                                    # (G, S)
    vg = v.reshape(g, group_size, d)
    cg = contexts.reshape(g, group_size)
    logit = torch.bmm(vg, ctx_blk.transpose(1, 2))                          # (G, Eg, S)
    mask = (rows[:, None, :] != cg[:, :, None]).to(v.dtype)
    w_tail = k * w_blk[:, None, :]
    g_tail = w_tail * torch.sigmoid(logit) * mask
    loss_tail = torch.sum(w_tail * mask * softplus(logit), dim=-1).reshape(e)
    d_center += torch.bmm(g_tail, ctx_blk).reshape(e, d)
    d_rows = sum_tn(g_tail, vg)                                             # (G, S, D)
    u_tail = w_tail[:, 0, :] * torch.sum(mask, dim=1)
    payload = torch.cat([d_rows, u_tail[:, :, None]], dim=2)
    acc_ctx.index_add_(0, rows.reshape(-1), payload.reshape(-1, d + 1))
    return loss_tail


def noise_tail(v, contexts, ctx, tail_w, blocks, head, block, group_size, k_neg,
               d_center, acc_ctx):
    if _args.on_cpu(v, contexts, ctx, tail_w, blocks, d_center, acc_ctx):
        return noise_tail_plain(v, contexts, ctx, tail_w, blocks, head, block,
                                group_size, k_neg, d_center, acc_ctx)
    e, d = v.shape
    v_size = ctx.shape[0]
    v_noise = tail_w.shape[0]
    head, block, group_size = int(head), int(block), int(group_size)
    if group_size <= 0 or e % group_size:
        raise ValueError(f"group_size={group_size} does not divide E={e}")
    if not (0 < block <= v_noise <= v_size) or head < 0:
        raise ValueError(f"bad geometry head={head} block={block} V={v_noise}")
    g = e // group_size
    _args.expect(v, "v", torch.float32, (e, d))
    _args.expect(contexts, "contexts", torch.int32, (e,))
    bf16 = _args.table_bf16((ctx,), ("ctx",), ((v_size, d),))
    _args.expect(tail_w, "tail_w", torch.float32, (v_noise,))
    _args.expect(blocks, "blocks", torch.int32, (g,))
    _args.expect(d_center, "d_center", torch.float32, (e, d))
    _args.expect(acc_ctx, "acc_ctx", torch.float32, (v_size, d + 1))
    lib = _lib()
    dev = v.device
    sp = _args.padded_slab(block)
    g_scratch = torch.empty((e, sp), dtype=torch.float32, device=dev)
    hits = torch.empty((g, block), dtype=torch.int32, device=dev)
    loss_tail = torch.empty((e,), dtype=torch.float32, device=dev)
    splits = _args.noise_ranges(g * -(-block // 128) * -(-d // 256), group_size, v)
    status = lib.k3_noise_tail(
        _args.ptr(v), _args.ptr(contexts), _args.ptr(ctx), _args.ptr(tail_w),
        _args.ptr(blocks), float(k_neg), _args.ptr(g_scratch), _args.ptr(hits),
        _args.ptr(loss_tail), _args.ptr(d_center), _args.ptr(acc_ctx),
        e, d, g, block, sp, head, v_noise, splits, bf16, _args.stream(v),
    )
    build.check(lib, status, "K3 noise_tail launch")
    launches["noise_tail", "bf16" if bf16 else ""] += 1
    return loss_tail


def block_rows(blocks, head: int, block: int, v_noise: int) -> torch.Tensor:
    """(G, S) ctx rows of the drawn tail blocks."""
    starts = block_starts(torch.as_tensor(blocks), head, block, v_noise)
    return starts[:, None] + torch.arange(block, device=starts.device)[None, :]


def work(blocks, e: int, head: int, block: int, v_noise: int, d: int,
         table_bytes: int = 4) -> dict:
    """What K3's function needs for ``e`` examples in ``len(blocks)``
    groups, each against its drawn block of ``block`` rows (``_work.py``):
    v, the contexts, the draws, d_center read and written, the loss, each
    distinct block row and its accumulator row once; the three (E, S, D)
    products as 3xTF32 passes (``simt_flops``: on the SIMT route)."""
    g = _work.count(blocks)
    distinct = _work.distinct(block_rows(blocks, head, block, v_noise))
    passes = _work.TF32_PASSES[table_bytes == 2]
    return {"bytes": 4 * (e * d + e + g + distinct + 2 * e * d + 2 * distinct * (d + 1) + e)
            + table_bytes * distinct * d,
            "flops": 0.0, "tf32_ops": sum(passes) * 2 * e * block * d,
            "simt_flops": 3 * 2 * e * block * d, "block_rows": distinct}


def _lib():
    lib = build.load(_LIB)
    fn = lib.k3_noise_tail
    if fn.argtypes is None:
        P, I, F = _args.P, _args.I, _args.F
        fn.argtypes = [P, P, P, P, P, F, P, P, P, P, P, I, I, I, I, I, I, I, I, I, P]
        fn.restype = I
    return lib
