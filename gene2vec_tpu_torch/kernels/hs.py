"""K6 — hierarchical softmax (source: ``csrc/k6_hs.cu``).

Replaces ``gene2vec_tpu/sgns/cbow_hs.py:65-101`` (``hs_loss_and_grads``)
and the shallow half of ``hs_step`` (``:149-160, 197-209``).  With
v = emb[inputs] and each target's padded Huffman path (``points``,
``codes``, ``lengths``; the deep remainders when ``sign`` is given)::

    logit      = v · node[points[t, l]]         (E, L), mask l < lengths[t]
    loss_deep  = Σ_l mask·softplus(−(1 − 2·code)·logit)
    g          = (σ(logit) − (1 − code))·mask
    d_input    = Σ_l g·node[points[t, l]]
    acc_node[points[t, l]] += [g·v | mask]

and, with ``sign`` (V, Ns) int8 — the dense shallow levels over the node
prefix ``node[:Ns]``::

    logit_s      = v @ node[:Ns]ᵀ,  s = sign[targets]
    loss_shallow = Σ |s|·softplus(−s·logit_s)
    g_s          = |s|·(σ(logit_s) − (1 + s)/2)
    d_input     += g_s @ node[:Ns]
    acc_node[:Ns] += [g_sᵀ @ v | Σ_e |s|]

Returns (d_input, loss_deep, loss_shallow or None); ``acc_node`` is
updated in place.  ``emb`` and ``node`` are float32 or bfloat16 (both of
one type); their rows are upcast to float32.  The step's loss is mean(loss_deep) +
mean(loss_shallow), as the reference's (cbow_hs.py:159).
"""

from __future__ import annotations

import torch

from gene2vec_tpu_torch.kernels import _args, build
from gene2vec_tpu_torch.kernels.pos_logit import softplus

#: kernel launches made through :func:`hs`, by table width
#: ("" float32, "bf16")
launches = {("hs", ""): 0, ("hs", "bf16"): 0}

_LIB = "k6_hs"


def hs_plain(emb, node, inputs, targets, points, codes, lengths, sign, acc_node):
    d = emb.shape[1]
    v = emb[inputs.long()].float()
    t = targets.long()
    pts = points[t].long()                                      # (E, L)
    cds = codes[t]
    mask = (torch.arange(points.shape[1], device=emb.device)[None, :]
            < lengths[t][:, None]).float()
    w = node[pts].float()                                       # (E, L, D)
    logit = torch.einsum("ed,eld->el", v, w)
    loss_deep = torch.sum(mask * softplus(-(1.0 - 2.0 * cds) * logit), dim=-1)
    g = (torch.sigmoid(logit) - (1.0 - cds)) * mask
    d_input = torch.einsum("el,eld->ed", g, w)
    d_node = g[:, :, None] * v[:, None, :]
    acc_node.index_add_(0, pts.reshape(-1),
                        torch.cat([d_node.reshape(-1, d), mask.reshape(-1, 1)], dim=1))
    if sign is None:
        return d_input, loss_deep, None
    ns = sign.shape[1]
    w_s = node[:ns].float()
    s = sign[t].float()
    a = s.abs()
    logit_s = v @ w_s.T
    loss_shallow = torch.sum(a * softplus(-s * logit_s), dim=-1)
    g_s = a * (torch.sigmoid(logit_s) - (1.0 + s) / 2.0)
    d_input = d_input + g_s @ w_s
    acc_node[:ns, :d] += g_s.T @ v
    acc_node[:ns, d] += torch.sum(a, dim=0)
    return d_input, loss_deep, loss_shallow


def hs(emb, node, inputs, targets, points, codes, lengths, sign, acc_node):
    tensors = [emb, node, inputs, targets, points, codes, lengths, acc_node]
    if _args.on_cpu(*tensors, *([] if sign is None else [sign])):
        return hs_plain(emb, node, inputs, targets, points, codes, lengths, sign,
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
    ns = 0
    if sign is not None:
        ns = sign.shape[1]
        _args.expect(sign, "sign", torch.int8, (v_size, ns))
        if ns > n_nodes:
            raise ValueError(f"sign has {ns} shallow nodes, the table {n_nodes} rows")
    lib = _lib()
    dev = emb.device
    v = torch.empty((e, d), dtype=torch.float32, device=dev)
    d_input = torch.empty((e, d), dtype=torch.float32, device=dev)
    loss_deep = torch.empty((e,), dtype=torch.float32, device=dev)
    loss_shallow = torch.zeros((e,), dtype=torch.float32, device=dev)
    g_scratch = torch.empty((e, max(ns, 1)), dtype=torch.float32, device=dev)
    hits = torch.zeros((max(ns, 1),), dtype=torch.int32, device=dev)
    splits = _args.split_k(-(-d // 64) * -(-ns // 64), 1, e, dev) if ns else 1
    status = lib.k6_hs(
        _args.ptr(emb), _args.ptr(node), _args.ptr(inputs), _args.ptr(targets),
        _args.ptr(points), _args.ptr(codes), _args.ptr(lengths), l_max,
        _args.ptr(sign) if sign is not None else None, ns, _args.ptr(v),
        _args.ptr(d_input), _args.ptr(loss_deep), _args.ptr(loss_shallow),
        _args.ptr(g_scratch), _args.ptr(hits), _args.ptr(acc_node), e, d, splits,
        bf16, _args.stream(emb),
    )
    build.check(lib, status, "K6 hs launch")
    launches["hs", "bf16" if bf16 else ""] += 1
    return d_input, loss_deep, (loss_shallow if sign is not None else None)


def _lib():
    lib = build.load(_LIB)
    fn = lib.k6_hs
    if fn.argtypes is None:
        P, I = _args.P, _args.I
        fn.argtypes = [P, P, P, P, P, P, P, I, P, I, P, P, P, P, P, P, P, I, I, I, I, P]
        fn.restype = I
    return lib
