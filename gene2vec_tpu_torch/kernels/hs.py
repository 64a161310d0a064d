"""K6 — hierarchical softmax (source: ``csrc/k6_hs.cu``).

Replaces ``gene2vec_tpu/sgns/cbow_hs.py:65-101`` (``hs_loss_and_grads``)
and the shallow half of ``hs_step`` (``:149-160, 197-209``).  With
v = emb[inputs] and each target's padded Huffman path (``points``,
``codes``, ``lengths``; the deep remainders when ``shallow`` is given)::

    logit      = v · node[points[t, l]]         (E, L), mask l < lengths[t]
    loss_deep  = Σ_l mask·softplus(−(1 − 2·code)·logit)
    g          = (σ(logit) − (1 − code))·mask
    d_input    = Σ_l g·node[points[t, l]]
    acc_node[points[t, l]] += [g·v | mask]

and, with ``shallow`` (a :class:`~gene2vec_tpu_torch.sgns.huffman.ShallowPaths`
of tensors: per token its shallow node ids in [0, Ns) and their ±1 signs,
level order, 0 past the path) — the reference's dense shallow levels
over the node prefix ``node[:Ns]``, whose zero signs feed nothing, visited
on the path alone::

    s            = signs[t],  n = ids[t]                    (E, Ls)
    logit_s      = v · node[n]
    loss_shallow = Σ |s|·softplus(−s·logit_s)
    g_s          = |s|·(σ(logit_s) − (1 + s)/2)
    d_input     += Σ g_s·node[n]
    acc_node[n] += [g_s·v | |s|]

Returns (d_input, loss_deep, loss_shallow or None); ``acc_node`` is
updated in place.  ``emb`` and ``node`` are float32 or bfloat16 (both of
one type); their rows are upcast to float32.  The step's loss is
mean(loss_deep) + mean(loss_shallow), as the reference's (cbow_hs.py:159).

On the card one launch scores every path entry, a warp an example, 16
examples a block; the top ``hot_levels`` levels' accumulator rows are
reduced in each block's shared memory before they reach ``acc_node``
(fewer levels where a wide row leaves no room for them).  Rows of any
width: past 512 columns each entry walks its rows in 512-column parts.
"""

from __future__ import annotations

import torch

from gene2vec_tpu_torch.kernels import _args, build
from gene2vec_tpu_torch.kernels.pos_logit import softplus

#: kernel launches made through :func:`hs`, by table width
#: ("" float32, "bf16")
launches = {("hs", ""): 0, ("hs", "bf16"): 0}

#: tree levels whose accumulator rows a block reduces in shared memory
#: (chip_smoke.py times each count in HS_HOT_SWEEP at the bench shapes)
HOT_LEVELS = 4

#: examples a block (two a warp)
PER_BLOCK = 16

_LIB = "k6_hs"


def hs_plain(emb, node, inputs, targets, points, codes, lengths, shallow, acc_node):
    d = emb.shape[1]
    v = emb[inputs.long()].float()
    t = targets.long()

    def path(pts, signs, mask):
        # one sigmoid per path entry: (loss, d_input part); acc_node updated
        w = node[pts].float()                                   # (E, L, D)
        logit = torch.einsum("ed,eld->el", v, w)
        loss = torch.sum(mask * softplus(-signs * logit), dim=-1)
        g = mask * (torch.sigmoid(logit) - (1.0 + signs) / 2.0)
        d_node = g[:, :, None] * v[:, None, :]
        acc_node.index_add_(0, pts.reshape(-1),
                            torch.cat([d_node.reshape(-1, d), mask.reshape(-1, 1)], dim=1))
        return loss, torch.einsum("el,eld->ed", g, w)

    mask = (torch.arange(points.shape[1], device=emb.device)[None, :]
            < lengths[t][:, None]).float()
    loss_deep, d_input = path(points[t].long(), 1.0 - 2.0 * codes[t], mask)
    if shallow is None:
        return d_input, loss_deep, None
    s = shallow.signs[t].float()
    loss_shallow, d_shallow = path(shallow.ids[t].long(), s, s.abs())
    return d_input + d_shallow, loss_deep, loss_shallow


def hs(emb, node, inputs, targets, points, codes, lengths, shallow, acc_node, *,
       hot_levels: int = HOT_LEVELS):
    tensors = [emb, node, inputs, targets, points, codes, lengths, acc_node]
    if shallow is not None:
        tensors += [shallow.ids, shallow.signs]
    if _args.on_cpu(*tensors):
        return hs_plain(emb, node, inputs, targets, points, codes, lengths, shallow,
                        acc_node)
    v_size, d = emb.shape
    n_nodes = node.shape[0]
    e = inputs.shape[0]
    l_max = points.shape[1]
    bf16 = _args.table_bf16((emb, node), ("emb", "node"), ((v_size, d), (n_nodes, d)))
    _args.expect(inputs, "inputs", torch.int32, (e,))
    _args.expect(targets, "targets", torch.int32, (e,))
    _args.expect(points, "points", torch.int32, (v_size, l_max))
    _args.expect(codes, "codes", torch.float32, (v_size, l_max))
    _args.expect(lengths, "lengths", torch.int32, (v_size,))
    _args.expect(acc_node, "acc_node", torch.float32, (n_nodes, d + 1))
    if acc_node.data_ptr() % 16:  # the float4 atomics
        raise ValueError("acc_node: must start on a 16-byte boundary")
    ls = 0
    if shallow is not None:
        ls = shallow.ids.shape[1]
        _args.expect(shallow.ids, "shallow.ids", torch.int32, (v_size, ls))
        _args.expect(shallow.signs, "shallow.signs", torch.int8, (v_size, ls))
        if shallow.n_shallow > n_nodes:
            raise ValueError(f"{shallow.n_shallow} shallow nodes, the table {n_nodes} rows")
    if not 0 <= hot_levels <= 7:
        raise ValueError(f"hot_levels={hot_levels} outside 0..7")
    lib = _lib()
    dev = emb.device
    d_input = torch.empty((e, d), dtype=torch.float32, device=dev)
    loss_deep = torch.empty((e,), dtype=torch.float32, device=dev)
    loss_shallow = torch.empty((e,), dtype=torch.float32, device=dev)
    status = lib.k6_hs(
        _args.ptr(emb), _args.ptr(node), _args.ptr(inputs), _args.ptr(targets),
        _args.ptr(points), _args.ptr(codes), _args.ptr(lengths), l_max,
        _args.ptr(shallow.ids) if shallow is not None else None,
        _args.ptr(shallow.signs) if shallow is not None else None, ls,
        _args.ptr(d_input), _args.ptr(loss_deep), _args.ptr(loss_shallow),
        _args.ptr(acc_node), e, d, hot_levels, PER_BLOCK, bf16, _args.stream(emb),
    )
    build.check(lib, status, "K6 hs launch")
    launches["hs", "bf16" if bf16 else ""] += 1
    return d_input, loss_deep, (loss_shallow if shallow is not None else None)


def _lib():
    lib = build.load(_LIB)
    fn = lib.k6_hs
    if fn.argtypes is None:
        P, I = _args.P, _args.I
        fn.argtypes = [P, P, P, P, P, P, P, I, P, P, I, P, P, P, P, I, I, I, I, I, P]
        fn.restype = I
    return lib
