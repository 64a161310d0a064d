#!/usr/bin/env python3
"""GPU smoke run of the PyTorch port (``gene2vec_tpu_torch``) on one card.

    python3 chip_smoke.py            # from the root of a checkout

Phases, each of which exits non-zero on failure (nothing is caught):

1. device and build — prints the card's name and power limit, builds the
   training kernels (K1-K6), the serving kernels (K7, K8, K9, K9r) and
   the streaming probe K12 from ``gene2vec_tpu_torch/kernels/csrc`` with
   nvcc for sm_90a, one compiler per source, all at once;
2. kernel check — each kernel at the default configuration's shapes
   (E = 8192 examples, D = 200, V = 24,447, H = 256, S = 512, 32 groups)
   against its plain PyTorch version on the same card and inputs, within
   the stated tolerance; times the kernel, the plain version and, where
   one PyTorch call computes the same function, that call (CUDA events,
   median of repeats, L2 flushed before each); one whole step on the
   card against the plain step on the CPU, at a small ragged shape and
   at full width; then the other objectives' kernels at the same width —
   K5a (per-example draws), K5b (the auto-sized shared pool, G = 256,
   P/G = 128), K6 (hierarchical softmax at hs_dense_depth 10, both
   phases) and K4's generic scatter and finalize — and one whole step of
   each of per_example, shared, sg_hs and cbow_hs card vs CPU at both
   shapes; (2e) every training kernel again on bfloat16 tables — K4 once
   per write-back, stochastic rounding and nearest-even, bitwise on
   identical accumulators — and the same whole steps with bf16 tables and
   SR, card vs CPU (each element within one bf16 ulp or the float32
   error of its new value, at most ULP_SHARE of touched elements
   differing, loss within 1e-6);
   profiled windows of full-width steps of the default configuration at
   float32 and bfloat16 in turns (f32, bf16, bf16, f32) and of those four
   (pairs/s over each window's wall, device busy time by kernel, idle
   share; Chrome traces to ``chip_smoke_profile/``; the widths' medians
   on a ``{"table_widths": ...}`` line); K12 ``stream_scale`` at the streaming
   probe's 25, 100 and 400 MB (bitwise; GB/s beside ``torch.mul``); the serving kernels
   at serving width (V = 24,447, D = 200, B in {1, 64}, kb in {16, 512},
   rb = 4 kb, the default IVF geometry) against their plain versions —
   K7/K9r ids exact except stated near-ties and scores within 1e-6,
   K8/K9 approximate scores bitwise — K8 and K9 on a bf16 index (B in
   {1, 64}, kb = 16; scores within 1e-6, near-ties counted), K8 at
   B = 64, rb = 16,384 (bitwise), and K9r's row gather at the Pallas
   gather probes' shapes against ``table[idx]``;
3. training at full width — a Zipf pair corpus (V = 24,447, 4,000,000
   pairs) written as pair files and trained through the CLI with the
   default configuration for 3 iterations: the loss must be finite and
   falling, every export must verify, and every kernel must have launched
   once per step of the run; then (3b) a 1,000,000-pair corpus trained
   for 2 iterations through the CLI once per ``--negative-mode
   per_example``, ``--negative-mode shared``, ``--objective sg_hs``,
   ``--objective cbow_hs`` and ``--objective cbow``, with the same checks
   and each run's kernels launched once per step (no other kernel); then
   (3c) ``--table-dtype bfloat16`` for the default configuration, sg_hs,
   per_example and shared, each export stamped ``bfloat16`` and each
   kernel's bf16 instantiation launched once per step;
4. quality — the planted-cluster corpus (10 cliques of 20 genes) must
   separate (intra-cluster cosine > 0.95, inter-cluster < 0.6) under the
   default configuration, each of those five and bf16 tables with SR;
   bf16 with nearest-even write-back (default and per_example) is
   reported, not gated, and is the main path of K4's nearest-even rows;
5. serving at full width — phase 3's export, then a clustered export of
   the same width (V = 24,447, D = 200, 1,000 groups of ~24 genes),
   each served through ``cli/serve.py`` in a subprocess on the card once
   per ``--index exact|quant|ivf``: requests that fill batch buckets
   1..64, then 400 gene and vector queries (k in {1, 10, 100, 256}) from
   16 clients; every answer is checked against the exact cosine on the
   host (scores within 1e-5; exact mode ids the oracle's except stated
   near-ties) and each mode's kernels must have launched
   (``kernel_launches_total`` on ``/metrics``).  Quant/ivf recall@10
   against ``exact_oracle`` must reach 0.99 on the clustered export; on
   phase 3's export it is reported only, since a structureless Zipf
   corpus trains near-parallel rows whose neighbor ranks differ by less
   than the int8 scan's error.  QPS and p50/p99 latency per export and
   mode go to ``{"serving": ...}`` lines.  It runs right after phase 3.

The last lines are the card's ``nvidia-smi`` name and power limit, one
JSON object ``{"kernels": [...]}`` (launches: phase 3's training run's
for K1-K4, phase 3b's runs' for K5a, K5b, K6 and K4's generic entry
points ``row_scatter`` / ``row_finalize``, phase 3c's for the ``_bf16``
rows, phase 4's nearest-even runs' for ``_bf16_rn``, the servers' for
K7-K9r; ``stream_scale`` phase 3's, 0: it is on no path; the script
fails if any other kernel launched no time on its path) and the result line
``{"ok": true, "device": {...}}``.  Without a CUDA device the script exits
with code 2 and prints no result.
"""

from __future__ import annotations

import csv
import itertools
import json
import os
import statistics
import subprocess
import sys
import tempfile
import time

import numpy as np

HBM_BYTES_PER_S = 3.35e12   # H100 SXM data sheet
F32_FLOP_PER_S = 67e12      # H100 SXM float32, outside the tensor cores
INT8_OP_PER_S = 1979e12     # H100 SXM int8 tensor cores, dense
BF16_FLOP_PER_S = 989e12    # H100 SXM bf16 tensor cores, dense

V, D, B, K = 24447, 200, 4096, 5
E = 2 * B
HEAD, BLOCK, GROUP = 256, 512, 256
NUM_PAIRS, ITERS = 4_000_000, 3
DEVICE = "cuda"
STEP_KERNELS = ("pos_logit", "noise_head", "noise_tail", "row_update")
TIMED_REPS = 20         # CUDA-event-timed launches per kernel (median)
PROFILED_STEPS = 200    # full-width steps per epoch in the profiled window


def log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def nvidia_smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()
    return out[0]


# -- phase 2: kernels against their plain versions ----------------------------


class Timer:
    """Median kernel time by CUDA events, with the L2 flushed before each
    launch (the step's tables and accumulators exceed the 50 MB L2)."""

    def __init__(self, torch, reps: int):
        self.torch = torch
        self.reps = reps
        self.flush = torch.empty(256 << 20, dtype=torch.uint8, device="cuda")

    def __call__(self, fn) -> float:
        torch = self.torch
        fn()  # warm-up
        times = []
        for _ in range(self.reps):
            self.flush.zero_()
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            a.record()
            fn()
            b.record()
            b.synchronize()
            times.append(a.elapsed_time(b))
        return statistics.median(times)


def zipf_ids(rng, n, v):
    p = 1.0 / np.arange(1, v + 1)
    p /= p.sum()
    return rng.choice(v, size=n, p=p).astype(np.int32)


def bound(bytes_moved: float, flops: float, int8_ops: float = 0.0, bf16_ops: float = 0.0):
    """(ms, "bytes" | "operations"): the larger of the bytes over the HBM
    rate and the operations over the peak rate for their type."""
    t_bytes = bytes_moved / HBM_BYTES_PER_S
    t_ops = (flops / F32_FLOP_PER_S + int8_ops / INT8_OP_PER_S
             + bf16_ops / BF16_FLOP_PER_S)
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations")


REL_TOL = 2e-5     # kernel vs plain: float32 sums in another order, atomics
TABLE_ATOL = 2e-6  # updated tables, the one-step bar of the parity tests
ULP_SHARE = 1e-3   # bf16 tables: touched elements one ulp from the plain version
F32_ULPS = 4       # bf16 tables: float32 ulps of new = t − lr·update apart, at most


def compare(name, outputs):
    """Max abs error over ``outputs``, a list of (label, got, want, rule).
    Rules: "rows" — each row's max error within REL_TOL x that row's
    max|want| (an all-zero row must match exactly); "elems" — each element
    within REL_TOL x |want|; "max" — within REL_TOL x the output's
    max|want|; "abs" — within TABLE_ATOL.  Row and element scales hold
    small rows (rare tokens, small weights) as tightly as large ones."""
    worst = 0.0
    for label, g, w, rule in outputs:
        diff = (g - w).abs()
        if rule == "rows":
            err = diff.reshape(diff.shape[0], -1).amax(1)
            limit = REL_TOL * w.abs().reshape(w.shape[0], -1).amax(1)
        elif rule == "elems":
            err, limit = diff, REL_TOL * w.abs()
        elif rule == "max":
            err, limit = diff.max(), REL_TOL * w.abs().max()
        else:
            err, limit = diff.max(), diff.new_tensor(TABLE_ATOL)
        bad = (err > limit).reshape(-1)
        if bool(bad.any()):
            i = int(bad.nonzero()[0])
            raise SystemExit(
                f"{name}: {label} ({rule}) error {float(err.reshape(-1)[i]):.3e} "
                f"exceeds its limit {float(limit.reshape(-1)[i]):.3e} at {i}"
            )
        worst = max(worst, float(diff.max()))
    return worst


def check_topk(name, got, want, score_of, tol):
    """A kernel's top-k (scores, ids) against its plain version's, both in
    ``lax.top_k``'s order.  Scores agree within ``tol`` position by
    position (equal -inf counts as agreement).  Ids agree, except at a
    near-tie: where the ids differ, the plain score of the kernel's id
    (``score_of(ids)``) lies within ``tol`` of the plain score at that
    position.  Returns (max abs score error, near-ties)."""
    (gs, gi), (ws, wi) = got, want
    diff = torch_where_equal(gs, ws)
    err = float(diff.max()) if diff.numel() else 0.0
    if not err <= tol:
        raise SystemExit(f"{name}: score error {err:.3e} exceeds {tol:g}")
    moved = gi != wi
    ties = int(moved.sum())
    if ties:
        near = torch_where_equal(score_of(gi.long()), ws) <= tol
        if not bool(near[moved].all()):
            b, j = (moved & ~near).nonzero()[0].tolist()
            raise SystemExit(f"{name}: query {b} position {j}: id {int(gi[b, j])} "
                             f"where the plain version has {int(wi[b, j])}, not a near-tie")
    return err, ties


def torch_where_equal(a, b):
    """|a - b|, with 0 where the two are equal (so -inf = -inf)."""
    return (a - b).abs().masked_fill(a == b, 0.0)


def acc_outputs(prefix, got, want, d):
    """An accumulator's [gradient | weight] columns, held separately."""
    return [(f"{prefix}[:, :D]", got[:, :d], want[:, :d], "rows"),
            (f"{prefix}[:, D]", got[:, d], want[:, d], "elems")]


SALTS = [[0x243F6A88, 0x85A308D3], [0x13198A2E, 0x03707344]]  # fixed SR salt words
SR_HASH_OPS = 8    # integer operations of the SR hash and carry, per element


def table_ulps(torch, a, b):
    """|a − b| in bf16 ulps, elementwise, across zero (bf16 tensors)."""
    def ordered(t):
        bits = t.contiguous().view(torch.int16).to(torch.int32)
        mag = bits & 0x7FFF
        return torch.where(bits < 0, -mag, mag)
    return (ordered(a) - ordered(b)).abs()


def compare_bf16_tables(torch, name, pairs, start):
    """bf16 tables written back from float32 sums taken in another order
    (atomics), each from its table ``start``: each element equal to the
    plain version's, one bf16 ulp from it, or within F32_ULPS float32 ulps
    of |t| + |t − new| (the float32 error of new = t − lr·update, with t
    the start and new the plain result; near zero, where the two cancel,
    that error spans several of the result's small bf16 ulps) — and at most
    ULP_SHARE of the touched elements (those of rows either side changed
    from ``start``) differing at all.  Returns (max abs error, the share
    that differs)."""
    worst, share = 0.0, 0.0
    for i, (label, g, w) in enumerate(pairs):
        ulps = table_ulps(torch, g, w)
        diff = (g.float() - w.float()).abs()
        t = start[i].float()
        f32_err = F32_ULPS * 2.0 ** -23 * (t.abs() + (t - w.float()).abs())
        far = (ulps > 1) & (diff > f32_err)
        if bool(far.any()):
            j = int(far.reshape(-1).nonzero()[0])
            raise SystemExit(f"{name}: {label} {int(ulps.reshape(-1)[j])} bf16 ulps "
                             f"({float(diff.reshape(-1)[j]):.3e}, float32 bar "
                             f"{float(f32_err.reshape(-1)[j]):.3e}) from the plain version "
                             f"at {j}")
        if int(ulps.max()) > 1:
            log(f"{name}: {label} {int((ulps > 1).sum())} elements more than one ulp "
                f"apart, each within {F32_ULPS} float32 ulps of |t| + |t - new| (at most "
                f"{float(diff[ulps > 1].max()):.2e} against "
                f"{float(f32_err[ulps > 1].min()):.2e})")
        touched = ((g != start[i]) | (w != start[i])).any(1)
        n = int(touched.sum()) * g.shape[1]
        off = int((ulps[touched] > 0).sum())
        if n and off > ULP_SHARE * n:
            raise SystemExit(f"{name}: {label} {off} of {n} touched elements one ulp apart "
                             f"(> {ULP_SHARE:g})")
        share = max(share, off / n if n else 0.0)
        worst = max(worst, float(diff.max()))
    return worst, share


def bitwise_tables(torch, name, pairs):
    for label, g, w in pairs:
        if not torch.equal(g.view(torch.int16), w.view(torch.int16)):
            n = int((g.view(torch.int16) != w.view(torch.int16)).sum())
            raise SystemExit(f"{name}: {label} not bitwise the plain version's ({n} elements)")


def k1_bytes(c_ids, x_ids, d: int, table_bytes: int) -> int:
    """What K1's function must move for ids ``c_ids`` / ``x_ids``: the ids,
    each distinct emb and ctx row read once (``table_bytes`` a column),
    and v, u, g_pos and the loss written as float32."""
    e = len(c_ids)
    rows = len(np.unique(c_ids)) + len(np.unique(x_ids))
    return 4 * (2 * e + 2 * e * d + 2 * e) + table_bytes * rows * d


def kernel_check(torch, reps: int, dtype=None):
    """K1-K4 at full width against their plain versions, on float32 tables
    or (``dtype`` bfloat16, phase 2e) bfloat16 ones: then K4 is timed and
    checked once per write-back, stochastic rounding (with SALTS) and
    nearest-even — its tables within one ulp of the plain version's (the
    scatter's atomics reorder the float32 sums), and bitwise when the
    finalize runs alone on identical accumulators."""
    from gene2vec_tpu_torch.data.negative_sampling import build_stratified_spec
    from gene2vec_tpu_torch.kernels import noise_head, noise_tail, pos_logit, row_update

    dtype = dtype or torch.float32
    bf16 = dtype == torch.bfloat16
    sfx = "_bf16" if bf16 else ""
    tb = 2 if bf16 else 4  # bytes per table element
    dev = torch.device(DEVICE)
    rng = np.random.RandomState(0)
    counts = np.bincount(zipf_ids(rng, 8_000_000, V), minlength=V) + 1
    counts = np.sort(counts)[::-1].copy()
    spec = build_stratified_spec(counts, HEAD, BLOCK, 0.75, device=dev)
    gen = torch.Generator().manual_seed(0)
    emb = (torch.randn((V, D), generator=gen) * 0.1).to(dev, dtype)
    ctx = (torch.randn((V, D), generator=gen) * 0.1).to(dev, dtype)
    c_ids, x_ids = zipf_ids(rng, E, V), zipf_ids(rng, E, V)
    centers, contexts = torch.from_numpy(c_ids).to(dev), torch.from_numpy(x_ids).to(dev)
    g = E // GROUP
    blk = rng.randint(0, spec.nb, g).astype(np.int32)
    blk[0], blk[2] = spec.nb - 1, blk[1]  # the clamped last block; a repeat
    blocks = torch.from_numpy(blk).to(dev)
    lr = 0.0125
    timer = Timer(torch, reps)
    rows = []

    def row(name, fn_src, replaces, err, t_k, t_p, t_lib, bytes_moved, flops,
            tolerance=None):
        b_ms, b_by = bound(bytes_moved, flops)
        rows.append({
            "name": name, "route": "cuda",
            "source": f"gene2vec_tpu_torch/kernels/csrc/{fn_src}",
            "replaces": replaces, "launches": None, "max_abs_err": err,
            "ms": t_k, "plain_ms": t_p, "bound_ms": b_ms, "bound_by": b_by,
            "library_ms": t_lib,
            "tolerance": tolerance or (f"{REL_TOL:g} x per-row / per-element |plain|; "
                                       f"tables {TABLE_ATOL:g}"),
        })
        log(f"{name}: max_abs_err {err:.3e}, kernel {t_k:.4f} ms, plain "
            f"{t_p:.4f} ms, library {t_lib} ms, bound {b_ms:.4f} ms ({b_by})")

    # K1
    got = pos_logit.pos_logit(emb, ctx, centers, contexts)
    want = pos_logit.pos_logit_plain(emb, ctx, centers, contexts)
    torch.cuda.synchronize()
    err = compare("K1" + sfx, [(lbl, g, w, "max") for lbl, g, w in
                               zip(("v", "u", "g_pos", "loss_pos"), got, want)])
    row("pos_logit" + sfx, "k1_pos_logit.cu", "gene2vec_tpu/sgns/step.py:705",
        err, timer(lambda: pos_logit.pos_logit(emb, ctx, centers, contexts)),
        timer(lambda: pos_logit.pos_logit_plain(emb, ctx, centers, contexts)),
        None, k1_bytes(c_ids, x_ids, D, tb), 2 * E * D)
    v, u, g_pos, _ = want

    # K2 (into a zeroed accumulator, as in the step)
    acc0 = torch.zeros((V, D + 1), device=dev)
    a_k, a_p = acc0.clone(), acc0.clone()
    dk, lk = noise_head.noise_head(v, u, g_pos, contexts, ctx, spec.q, HEAD, K, a_k)
    dp, lp = noise_head.noise_head_plain(v, u, g_pos, contexts, ctx, spec.q, HEAD, K, a_p)
    torch.cuda.synchronize()
    err = compare("K2" + sfx, [("d_center", dk, dp, "rows"), ("loss_head", lk, lp, "elems")]
                  + acc_outputs("acc_ctx", a_k, a_p, D))
    a_t = acc0.clone()
    row("noise_head" + sfx, "k2_noise_head.cu", "gene2vec_tpu/sgns/step.py:736",
        err,
        timer(lambda: noise_head.noise_head(v, u, g_pos, contexts, ctx, spec.q, HEAD, K, a_t)),
        timer(lambda: noise_head.noise_head_plain(v, u, g_pos, contexts, ctx, spec.q, HEAD, K, a_t)),
        None,
        4 * (2 * E * D + 3 * E + HEAD + 2 * HEAD * (D + 1) + E * D) + tb * HEAD * D,
        3 * 2 * E * HEAD * D)

    # K3
    d_k, d_p = dp.clone(), dp.clone()
    a_k, a_p = a_p.clone(), a_p.clone()
    lk = noise_tail.noise_tail(v, contexts, ctx, spec.tail_w, blocks, spec.head,
                               spec.block, GROUP, K, d_k, a_k)
    lp = noise_tail.noise_tail_plain(v, contexts, ctx, spec.tail_w, blocks, spec.head,
                                     spec.block, GROUP, K, d_p, a_p)
    torch.cuda.synchronize()
    err = compare("K3" + sfx, [("loss_tail", lk, lp, "elems"), ("d_center", d_k, d_p, "rows")]
                  + acc_outputs("acc_ctx", a_k, a_p, D))
    starts = np.minimum(spec.head + blk.astype(np.int64) * spec.block, V - spec.block)
    block_rows = set(itertools.chain.from_iterable(range(s, s + spec.block) for s in starts))
    distinct = len(block_rows)
    d_t, a_t = dp.clone(), a_p.clone()
    row("noise_tail" + sfx, "k3_noise_tail.cu", "gene2vec_tpu/sgns/step.py:748",
        err,
        timer(lambda: noise_tail.noise_tail(v, contexts, ctx, spec.tail_w, blocks, spec.head,
                                            spec.block, GROUP, K, d_t, a_t)),
        timer(lambda: noise_tail.noise_tail_plain(v, contexts, ctx, spec.tail_w, blocks,
                                                  spec.head, spec.block, GROUP, K, d_t, a_t)),
        None,
        4 * (E * D + E + g + distinct + 2 * E * D + 2 * distinct * (D + 1) + E)
        + tb * distinct * D,
        3 * 2 * E * spec.block * D)

    # K4 (library: one index_add_ of both tables' [grad | 1] rows — the
    # scatter half only; no single PyTorch call also finalizes).  Its bound
    # counts only the rows these inputs touch — distinct centers; head,
    # drawn blocks and distinct contexts — each read from its accumulator
    # and read and written in its table; untouched rows have acc = 0.
    emb_rows = len(np.unique(c_ids))
    ctx_rows = len(block_rows.union(range(HEAD), x_ids.tolist()))
    d_center, acc_ctx = d_p, a_p
    acc_emb = torch.zeros((V, D + 1), device=dev)
    both = torch.zeros((2 * V, D + 1), device=dev)
    idx = torch.cat([centers, contexts + V]).long()
    ones = torch.ones((E, 1), device=dev)
    payload = torch.cat([torch.cat([d_center, ones], 1),
                         torch.cat([g_pos[:, None] * v, ones], 1)])
    none = centers[:0]
    touched = emb_rows + ctx_rows
    k4_bytes = 4 * (2 * E + 2 * E * D + E + touched * (D + 1)) + 2 * tb * touched * D
    for mode, salts in ((("sr", SALTS), ("rn", None)) if bf16 else (("", None),)):
        name = f"row_update{sfx}" + (f"_{mode}" if mode else "")
        ins = [emb.clone(), ctx.clone(), acc_emb.clone(), acc_ctx.clone()]
        ref = [emb.clone(), ctx.clone(), acc_emb.clone(), acc_ctx.clone()]
        row_update.row_update(*ins, centers, contexts, d_center, v, g_pos, lr, "capped",
                              salts)
        row_update.row_update_plain(*ref, centers, contexts, d_center, v, g_pos, lr,
                                    "capped", salts)
        torch.cuda.synchronize()
        err = compare(name, acc_outputs("acc_emb", ins[2], ref[2], D)
                      + acc_outputs("acc_ctx", ins[3], ref[3], D))
        tol = None
        if bf16:
            e_t, share = compare_bf16_tables(
                torch, name, [("emb", ins[0], ref[0]), ("ctx", ins[1], ref[1])],
                start=(emb, ctx))
            err = max(err, e_t)
            # the finalize alone on identical accumulators: bitwise
            fin = [emb.clone(), ctx.clone(), ref[2].clone(), ref[3].clone()]
            fin_p = [emb.clone(), ctx.clone(), ref[2].clone(), ref[3].clone()]
            row_update.row_update(*fin, none, none, d_center[:0], v[:0], g_pos[:0], lr,
                                  "capped", salts)
            row_update.row_update_plain(*fin_p, none, none, d_center[:0], v[:0], g_pos[:0],
                                        lr, "capped", salts)
            torch.cuda.synchronize()
            bitwise_tables(torch, name + " finalize", [("emb", fin[0], fin_p[0]),
                                                       ("ctx", fin[1], fin_p[1])])
            tol = (f"accumulators {REL_TOL:g} x per-row / per-element |plain|; tables "
                   f"within one bf16 ulp or {F32_ULPS} float32 ulps of |t| + |t - new|, "
                   f"differing on <= {ULP_SHARE:g} "
                   f"of touched elements (here {share:.2e}); finalize on identical "
                   "accumulators bitwise")
        else:
            err = max(err, compare(name, [("emb", ins[0], ref[0], "abs"),
                                          ("ctx", ins[1], ref[1], "abs")]))
        t_in = [emb.clone(), ctx.clone(), acc_emb.clone(), acc_ctx.clone()]
        row(name, "k4_row_update.cu", "gene2vec_tpu/sgns/step.py:229", err,
            timer(lambda: row_update.row_update(*t_in, centers, contexts, d_center, v,
                                                g_pos, lr, "capped", salts)),
            timer(lambda: row_update.row_update_plain(*t_in, centers, contexts, d_center, v,
                                                      g_pos, lr, "capped", salts)),
            timer(lambda: both.index_add_(0, idx, payload)),
            k4_bytes,
            2 * E * (D + 1) + 3 * D * touched + (SR_HASH_OPS * D * touched if salts else 0),
            tol)
    log(f"row_update{sfx} touches {emb_rows} emb rows and {ctx_rows} ctx rows of {V}")
    return rows


# -- phase 2b: the serving kernels against their plain versions ----------------

SERVE_BATCHES = (1, 64)      # one query; a full batch bucket (max_batch)
SERVE_KBS = (16, 512)        # k-buckets of k = 10 and k = 256 (+1: the self-hit)
RESCORE_MULT = 4             # the server's default rb = 4 kb
SERVE_TOL = 1e-6             # K7/K9r scores against their plain versions
MAIN_SHAPE = (64, 16)        # (B, kb) whose times the kernels line carries
#: (probe, rows, D, E, dtype) of the Pallas row-gather probes; callg
#: gathers one dynamic row broadcast to (8, D): E = 8 copies of one id
GATHER_PROBES = (
    ("experiments/test_pallas_gather.py:31 pallas_gather", 32768, 256, 32768, "float32"),
    ("experiments/test_pallas_gather.py:31 pallas_gather", 32768, 256, 32768, "bfloat16"),
    ("experiments/test_dma2.py:95 make_gather", 24576, 256, 8192, "float32"),
    ("experiments/test_dma2.py:95 make_gather", 24576, 256, 32768, "float32"),
    ("experiments/test_dma_min.py:55,85,119,173 call1-call4", 24576, 256, 4096, "float32"),
    ("experiments/test_vmem_dma.py:49 dma_gather", 24576, 256, 32768, "float32"),
    ("experiments/test_dma2.py:56 callg", 24576, 256, 8, "float32"),
)


def probe_near_ties(torch, qn, centroids, nprobe):
    """Queries whose nprobe-th and next centroid scores lie within
    SERVE_TOL: there the kernel may probe another list than the plain
    version (float32 sums in another order), so their candidate sets are
    not compared."""
    cs = torch.sort(qn @ centroids.T, dim=1, descending=True).values
    if nprobe >= cs.shape[1]:
        return torch.zeros(qn.shape[0], dtype=torch.bool, device=qn.device)
    return (cs[:, nprobe - 1] - cs[:, nprobe]) <= SERVE_TOL


def serving_table(rng):
    """The serving checks' full-width table: 600 clusters, V x D unit rows."""
    cent = rng.randn(600, D).astype(np.float32)
    x = cent[rng.randint(0, 600, V)] + 0.5 * rng.randn(V, D).astype(np.float32)
    return (x / np.linalg.norm(x, axis=1, keepdims=True)).astype(np.float32)


def serving_kernel_check(torch, reps):
    """K7, K8, K9 and K9r at serving width — V = 24,447, D = 200, the IVF
    geometry default_clusters gives — for B in SERVE_BATCHES and kb in
    SERVE_KBS, each against its plain version on the same card and
    inputs: K7/K9r ids exact except stated near-ties, scores within
    SERVE_TOL; K8/K9 approximate scores and ids bitwise.  Returns the
    kernels-line rows (times at MAIN_SHAPE, errors over every shape) and
    one record per (kernel, shape)."""
    from gene2vec_tpu_torch.kernels import _topk, ivf_scan, quant_scan, rescore, topk_exact
    from gene2vec_tpu_torch.serve import ann

    dev = torch.device(DEVICE)
    rng = np.random.RandomState(5)
    unit_np = serving_table(rng)
    t0 = time.perf_counter()
    index = ann.build_index(unit_np, "ivf", device=dev)
    log(f"IVF index at V {V}: {index.n_clusters} lists of {index.list_len} slots, "
        f"built in {time.perf_counter() - t0:.1f}s")
    unit = torch.from_numpy(unit_np).to(dev)
    c, lst = index.n_clusters, index.list_len
    timer = Timer(torch, reps)
    records, worst, ties = [], {}, {}

    def record(name, b, kb, err, t_k, t_p, t_lib, bytes_moved, flops, int8_ops=0.0):
        b_ms, b_by = bound(bytes_moved, flops, int8_ops)
        records.append({"name": name, "batch": b, "kb": kb, "max_abs_err": err, "ms": t_k,
                        "plain_ms": t_p, "library_ms": t_lib, "bound_ms": b_ms,
                        "bound_by": b_by})
        worst[name] = max(worst.get(name, 0.0), err)
        log(f"{name} B {b} kb {kb}: max_abs_err {err:.3e}, kernel {t_k:.4f} ms, plain "
            f"{t_p:.4f} ms, library {t_lib} ms, bound {b_ms:.4f} ms ({b_by})")

    def bitwise(name, got, want, rows):
        gs, gi = got[0][rows], got[1][rows]
        ws, wi = want[0][rows], want[1][rows]
        if not (torch.equal(gs.view(torch.int32), ws.view(torch.int32))
                and torch.equal(gi, wi)):
            bad = (gs.view(torch.int32) != ws.view(torch.int32)) | (gi != wi)
            raise SystemExit(f"{name}: approximate scores or ids not bitwise the plain "
                             f"version's at {bad.nonzero()[0].tolist()}")

    for b in SERVE_BATCHES:
        q_np = unit_np[rng.choice(V, b, replace=False)] * 3.0      # gene rows
        q_np[1::2] += 0.05 * rng.randn(len(q_np[1::2]), D).astype(np.float32)  # vectors
        q = torch.from_numpy(q_np).to(dev)
        qn = _topk.normalize_plain(q)

        def exact_of(ids):
            return (qn[:, None, :] * unit[ids]).sum(-1)

        for kb in SERVE_KBS:
            rb = min(RESCORE_MULT * kb, V)
            nprobe = min(max(8, -(-kb // lst)), c)
            # K7
            got = topk_exact.topk_exact(unit, q, kb)
            want = topk_exact.topk_exact_plain(unit, q, kb)
            torch.cuda.synchronize()
            err, n = check_topk("K7", got, want, exact_of, SERVE_TOL)
            ties["topk_exact"] = ties.get("topk_exact", 0) + n
            record("topk_exact", b, kb, err,
                   timer(lambda: topk_exact.topk_exact(unit, q, kb)),
                   timer(lambda: topk_exact.topk_exact_plain(unit, q, kb)),
                   timer(lambda: torch.topk(torch.mm(qn, unit.T), kb)),
                   4 * (V * D + b * D) + 8 * b * kb, 2.0 * b * V * D)
            # K8
            g8 = quant_scan.quant_scan(qn, index.table_q, index.scale, rb)
            w8 = quant_scan.quant_scan_plain(qn, index.table_q, index.scale, rb)
            torch.cuda.synchronize()
            bitwise("K8", g8, w8, slice(None))
            record("quant_scan", b, kb, 0.0,
                   timer(lambda: quant_scan.quant_scan(qn, index.table_q, index.scale, rb)),
                   timer(lambda: quant_scan.quant_scan_plain(qn, index.table_q, index.scale,
                                                             rb)),
                   None, V * D + 4 * V + 4 * b * D + 8 * b * rb, 0.0, 2.0 * b * V * D)
            # K9: ids and scores bitwise where the probe is not a near-tie
            args9 = (qn, index.centroids, index.lists, index.table_q, index.scale, nprobe, rb)
            g9 = ivf_scan.ivf_scan(*args9)
            w9 = ivf_scan.ivf_scan_plain(*args9)
            torch.cuda.synchronize()
            tied = probe_near_ties(torch, qn, index.centroids, nprobe)
            ties["ivf_scan"] = ties.get("ivf_scan", 0) + int(tied.sum())
            bitwise("K9", g9, w9, ~tied)
            _, ci = _topk.topk_plain(qn @ index.centroids.T, nprobe)
            cand = index.lists[ci.long()].reshape(b, -1)
            cand = cand[cand >= 0]
            n_cand, n_rows = int(cand.numel()), int(torch.unique(cand).numel())
            record("ivf_scan", b, kb, 0.0, timer(lambda: ivf_scan.ivf_scan(*args9)),
                   timer(lambda: ivf_scan.ivf_scan_plain(*args9)), None,
                   4 * c * D + 4 * b * D + 4 * b * nprobe * lst + n_rows * (D + 4)
                   + 8 * b * g9[0].shape[1],
                   2.0 * b * c * D, 2.0 * n_cand * D)
            # K9r on both candidate sets; timed on the quant path's
            err = 0.0
            for label, (rs, ri) in (("quant", w8), ("ivf", w9)):
                got = rescore.rescore(qn, unit, ri, rs, kb)
                want = rescore.rescore_plain(qn, unit, ri, rs, kb)
                torch.cuda.synchronize()
                e, n = check_topk(f"K9r ({label})", got, want, exact_of, SERVE_TOL)
                err = max(err, e)
                ties["rescore"] = ties.get("rescore", 0) + n
            rs, ri = w8
            fin = torch.isfinite(rs)
            n_fin, n_rows = int(fin.sum()), int(torch.unique(ri[fin]).numel())
            record("rescore", b, kb, err,
                   timer(lambda: rescore.rescore(qn, unit, ri, rs, kb)),
                   timer(lambda: rescore.rescore_plain(qn, unit, ri, rs, kb)), None,
                   8 * b * rb + 4 * b * D + 4 * n_rows * D + 8 * b * kb, 2.0 * n_fin * D)
    log(f"serving kernels: near-ties {ties} (stated: float32 sums in another order)")
    sources = {
        "topk_exact": ("k7_topk_exact.cu", "gene2vec_tpu/serve/engine.py:43"),
        "quant_scan": ("k8_quant_scan.cu", "gene2vec_tpu/serve/ann.py:407"),
        "ivf_scan": ("k9_ivf_scan.cu", "gene2vec_tpu/serve/ann.py:429"),
        "rescore": ("k9r_rescore.cu", "gene2vec_tpu/serve/ann.py:452"),
    }
    rows = []
    for name, (src, replaces) in sources.items():
        main = next(r for r in records if r["name"] == name
                    and (r["batch"], r["kb"]) == MAIN_SHAPE)
        rows.append({
            "name": name, "route": "cuda", "source": f"gene2vec_tpu_torch/kernels/csrc/{src}",
            "replaces": replaces, "launches": None, "max_abs_err": worst[name],
            "ms": main["ms"], "plain_ms": main["plain_ms"], "bound_ms": main["bound_ms"],
            "bound_by": main["bound_by"], "library_ms": main["library_ms"],
            "shape": {"batch": MAIN_SHAPE[0], "kb": MAIN_SHAPE[1], "V": V, "D": D},
            "tolerance": ("bitwise" if name in ("quant_scan", "ivf_scan")
                          else f"ids exact except near-ties; scores {SERVE_TOL:g}"),
            "near_ties": ties.get(name, 0),
        })
    return rows, records


def gather_probes(torch, reps):
    """K9r's row gather alone at the Pallas gather probes' shapes, against
    ``table[idx]``; library call: ``torch.index_select`` (which the plain
    version also is)."""
    from gene2vec_tpu_torch.kernels import rescore

    dev = torch.device(DEVICE)
    gen = torch.Generator(device=dev).manual_seed(0)
    timer = Timer(torch, reps)
    out = []
    for probe, rows, d, e, dtype in GATHER_PROBES:
        table = torch.randn((rows, d), device=dev, generator=gen).to(getattr(torch, dtype))
        idx = torch.randint(0, rows, (e,), device=dev, generator=gen, dtype=torch.int32)
        if probe.endswith("callg"):
            idx = idx[:1].expand(e).contiguous()  # one row, broadcast to (8, D)
        idx_l = idx.long()
        got = rescore.row_gather(table, idx)
        torch.cuda.synchronize()
        if not torch.equal(got, table[idx_l]):
            raise SystemExit(f"row_gather ({rows}, {d}) {dtype} E {e}: differs from table[idx]")
        row_bytes = d * table.element_size()
        distinct = int(torch.unique(idx).numel())
        b_ms, b_by = bound(4 * e + (distinct + e) * row_bytes, 0.0)
        rec = {"name": "row_gather", "probe": probe, "table": [rows, d], "dtype": dtype, "E": e,
               "max_abs_err": 0.0, "ms": timer(lambda: rescore.row_gather(table, idx)),
               "plain_ms": timer(lambda: rescore.row_gather_plain(table, idx)),
               "library_ms": timer(lambda: torch.index_select(table, 0, idx_l)),
               "bound_ms": b_ms, "bound_by": b_by}
        out.append(rec)
        log(f"row_gather [{probe}] ({rows}, {d}) {dtype} E {e}: kernel {rec['ms']:.4f} ms, plain "
            f"{rec['plain_ms']:.4f} ms, index_select {rec['library_ms']:.4f} ms, bound "
            f"{b_ms:.4f} ms ({b_by})")
    return out


#: the streaming probe's sizes (experiments/test_bw.py:63-73): MiB of input
STREAM_MB = (25, 100, 400)
STREAM_MAIN_MB = 100       # the size whose times the kernels line carries


def stream_probes(torch, reps):
    """K12 (``stream_scale``) at the Pallas streaming probe's sizes — (n, 256)
    float32, n = MB·2²⁰/4/256 — bitwise against its plain version
    ``x * 1.0000001``, which is also the library call (``torch.mul``).
    Returns (the kernels-line row at STREAM_MAIN_MB, one record per size
    with achieved GB/s: bytes read and written over the kernel's time)."""
    from gene2vec_tpu_torch.kernels import stream_scale

    dev = torch.device(DEVICE)
    gen = torch.Generator(device=dev).manual_seed(0)
    timer = Timer(torch, reps)
    records, main_row = [], None
    for mb in STREAM_MB:
        n = mb * 1024 * 1024 // 4 // 256
        x = torch.randn((n, 256), device=dev, generator=gen)
        got, want = stream_scale.stream_scale(x), stream_scale.stream_scale_plain(x)
        torch.cuda.synchronize()
        if not torch.equal(got.view(torch.int32), want.view(torch.int32)):
            raise SystemExit(f"stream_scale {mb} MB: not bitwise x * {stream_scale.SCALE}")
        nbytes = 2 * 4 * n * 256
        b_ms, b_by = bound(nbytes, float(n * 256))
        rec = {"name": "stream_scale", "probe": "experiments/test_bw.py:39 pallas_copy_loop",
               "mb": mb, "shape": [n, 256], "max_abs_err": 0.0,
               "ms": timer(lambda: stream_scale.stream_scale(x)),
               "plain_ms": timer(lambda: stream_scale.stream_scale_plain(x)),
               "library_ms": timer(lambda: torch.mul(x, stream_scale.SCALE)),
               "bound_ms": b_ms, "bound_by": b_by}
        rec["gb_per_s"] = nbytes / rec["ms"] / 1e6
        rec["library_gb_per_s"] = nbytes / rec["library_ms"] / 1e6
        records.append(rec)
        log(f"stream_scale {mb} MB: kernel {rec['ms']:.4f} ms ({rec['gb_per_s']:.1f} GB/s), "
            f"plain {rec['plain_ms']:.4f} ms, torch.mul {rec['library_ms']:.4f} ms "
            f"({rec['library_gb_per_s']:.1f} GB/s), bound {b_ms:.4f} ms ({b_by})")
        if mb == STREAM_MAIN_MB:
            main_row = {
                "name": "stream_scale", "route": "cuda",
                "source": "gene2vec_tpu_torch/kernels/csrc/k12_stream_scale.cu",
                "replaces": "experiments/test_bw.py:39", "launches": None,
                "max_abs_err": 0.0, "ms": rec["ms"], "plain_ms": rec["plain_ms"],
                "bound_ms": b_ms, "bound_by": b_by, "library_ms": rec["library_ms"],
                "shape": {"rows": n, "cols": 256, "mb": mb}, "tolerance": "bitwise",
            }
        del x, got, want
    return main_row, records


def step_verdict(torch, label, out, start, bf16):
    """A whole step's card result against the CPU's: float32 tables within
    TABLE_ATOL and the loss within rtol 1e-5; bfloat16 tables as
    compare_bf16_tables holds them and the loss within rtol 1e-6."""
    (lc, ec, cc), (lg, eg, cg) = out["cpu"], out["cuda"]
    rel = abs(lc - lg) / abs(lc)
    if bf16:
        err, share = compare_bf16_tables(torch, label, [("emb", eg, ec), ("out table", cg, cc)],
                                         start=start)
        log(f"{label}: loss rel {rel:.2e}, tables max abs {err:.2e}, differing on "
            f"{share:.2e} of touched elements")
        if rel > 1e-6:
            raise SystemExit(f"{label}: loss rel {rel:.2e} > 1e-6")
        return
    errs = (rel, float((ec - eg).abs().max()), float((cc - cg).abs().max()))
    log(f"{label}: loss rel {errs[0]:.2e}, emb {errs[1]:.2e}, out table {errs[2]:.2e}")
    if not (errs[0] <= 1e-5 and errs[1] <= TABLE_ATOL and errs[2] <= TABLE_ATOL):
        raise SystemExit(f"{label} failed: {errs}")


def step_parity(torch, v, d, b, head, block, group, full_tables, dtype=None):
    """One whole step on the card (kernels) against the plain step on the
    CPU, same inputs: loss within rtol 1e-5, tables within TABLE_ATOL.
    ``full_tables`` starts from random (V, D) tables, as mid-training;
    otherwise from the initial emb with ctx = 3 emb.  ``dtype`` bfloat16:
    bfloat16 tables written back by stochastic rounding with SALTS, held
    as ``step_verdict`` says."""
    from gene2vec_tpu_torch.data.negative_sampling import build_stratified_spec
    from gene2vec_tpu_torch.sgns.model import SGNSParams, init_params_numpy
    from gene2vec_tpu_torch.sgns.step import sgns_step

    rng = np.random.RandomState(3)
    pairs = np.stack([zipf_ids(rng, b, v), zipf_ids(rng, b, v)], 1)
    counts = np.sort(np.bincount(pairs.reshape(-1), minlength=v) + 1)[::-1].copy()
    dtype = dtype or torch.float32
    bf16 = dtype == torch.bfloat16
    gen = torch.Generator().manual_seed(3)
    if full_tables:
        tables = ((torch.randn((v, d), generator=gen) * 0.1).to(dtype),
                  (torch.randn((v, d), generator=gen) * 0.1).to(dtype))
    else:
        p = init_params_numpy(0, v, d, dtype=dtype)
        tables = (p.emb, (p.emb.float() * 3.0).to(dtype))
    out = {}
    for dev in ("cpu", "cuda"):
        spec = build_stratified_spec(counts, head, block, 0.75, device=dev)
        # a copy on each device: the step updates its tables in place
        p = SGNSParams(tables[0].to(dev, copy=True), tables[1].to(dev, copy=True))
        blk = np.random.RandomState(4).randint(0, spec.nb, 2 * b // group)
        blk[0], blk[2] = spec.nb - 1, blk[1]  # the clamped last block; a repeat
        blocks = torch.from_numpy(blk.astype(np.int32)).to(dev)
        p, loss = sgns_step(p, torch.from_numpy(pairs).to(dev), 0.025, stratified=spec,
                            blocks=blocks, strat_group=group,
                            sr_salts=SALTS if bf16 else None)
        out[dev] = (float(loss), p.emb.cpu(), p.ctx.cpu())
    step_verdict(torch, f"whole-step parity card vs CPU{' bf16' if bf16 else ''} (V {v}, "
                 f"D {d}, E {2 * b})", out, tables, bf16)


# -- phase 2c: the other objectives' kernels (K4 generic, K5a, K5b, K6) -------

HS_DEPTH = 10               # the default hs_dense_depth
OBJECTIVE_KERNELS = ("per_example", "shared_pool", "hs", "row_scatter", "row_finalize")


def full_width_inputs(torch, dev):
    """The default configuration's step inputs, as ``kernel_check`` makes
    them: bench-recipe Zipf counts (sorted), random tables, Zipf ids."""
    rng = np.random.RandomState(0)
    counts = np.bincount(zipf_ids(rng, 8_000_000, V), minlength=V) + 1
    counts = np.sort(counts)[::-1].copy()
    gen = torch.Generator().manual_seed(0)
    emb = (torch.randn((V, D), generator=gen) * 0.1).to(dev)
    ctx = (torch.randn((V, D), generator=gen) * 0.1).to(dev)
    c_ids, x_ids = zipf_ids(rng, E, V), zipf_ids(rng, E, V)
    return counts, emb, ctx, c_ids, x_ids


def hs_work(split, c_ids, x_ids, d: int, table_bytes: int = 4) -> dict:
    """What K6's function needs for inputs ``c_ids`` and targets ``x_ids``
    under ``split`` (a ``ShallowSplit``): bytes (distinct input rows and
    touched node rows read once, the accumulator's touched rows read and
    written once, the sign rows of the distinct targets) and float32
    operations.  Only on-path entries count: a zero sign multiplies the
    loss, g_s and the weight column, so the dense shallow products off
    the path feed nothing.  ``table_bytes``: bytes per table element."""
    e = len(x_ids)
    targets = np.unique(x_ids)
    deep_entries = int(split.lengths_deep[x_ids].sum())
    shallow_entries = int(np.abs(split.sign[x_ids].astype(np.int64)).sum())
    deep_nodes = np.unique(np.concatenate(
        [split.points_deep[t, :split.lengths_deep[t]] for t in targets]))
    shallow_nodes = np.unique(np.nonzero(split.sign[targets])[1])
    n_in, n_tg = len(np.unique(c_ids)), len(targets)
    n_nodes = len(shallow_nodes) + len(deep_nodes)
    l_deep = split.points_deep.shape[1]
    return {
        "bytes": 4 * (2 * e + n_tg * (l_deep * 2 + 1) + e * d + 2 * e
                      + 2 * n_nodes * (d + 1)) + n_tg * split.n_shallow
                 + table_bytes * (n_in + n_nodes) * d,
        "flops": 3 * 2 * shallow_entries * d + 5 * deep_entries * d,
        "deep_entries": deep_entries, "shallow_entries": shallow_entries,
        "deep_nodes": len(deep_nodes), "shallow_nodes": len(shallow_nodes),
    }


def objective_kernel_check(torch, reps: int, dtype=None):
    """K5a (per-example draws), K5b (the shared pool), K6 (hierarchical
    softmax, both phases, hs_dense_depth 10) and K4's generic scatter and
    finalize at the default configuration's full width, each against its
    plain version on the same card and inputs, timed as ``kernel_check``
    times.  Bounds count what these inputs need: distinct rows read once,
    touched accumulator rows read and written once.  With ``dtype``
    bfloat16 (phase 2e) the tables are bfloat16 and K4's finalize runs
    once per write-back (SALTS stochastic rounding, nearest-even), bitwise
    against its plain version; the scatter takes no table and is not
    repeated."""
    from gene2vec_tpu_torch.data.negative_sampling import (
        build_alias_table, noise_distribution, sample_negatives)
    from gene2vec_tpu_torch.kernels import hs, per_example, pos_logit, row_update, shared_pool
    from gene2vec_tpu_torch.sgns.huffman import build_huffman_tree, split_shallow
    from gene2vec_tpu_torch.sgns.step import shared_pool_layout

    dtype = dtype or torch.float32
    bf16 = dtype == torch.bfloat16
    sfx = "_bf16" if bf16 else ""
    tb = 2 if bf16 else 4  # bytes per table element
    dev = torch.device(DEVICE)
    counts, emb, ctx, c_ids, x_ids = full_width_inputs(torch, dev)
    emb, ctx = emb.to(dtype), ctx.to(dtype)
    centers, contexts = torch.from_numpy(c_ids).to(dev), torch.from_numpy(x_ids).to(dev)
    v, u, g_pos, _ = pos_logit.pos_logit_plain(emb, ctx, centers, contexts)
    noise = build_alias_table(noise_distribution(counts), device=dev)
    dgen = torch.Generator(device=dev).manual_seed(0)
    timer = Timer(torch, reps)
    rows = []

    def distinct(t):
        return int(torch.unique(t).numel())

    def row(name, src, replaces, err, fn_k, fn_p, fn_lib, bytes_moved, flops,
            tolerance=None):
        b_ms, b_by = bound(bytes_moved, flops)
        t_k, t_p = timer(fn_k), timer(fn_p)
        t_lib = timer(fn_lib) if fn_lib is not None else None
        rows.append({
            "name": name, "route": "cuda", "source": f"gene2vec_tpu_torch/kernels/csrc/{src}",
            "replaces": replaces, "launches": None, "max_abs_err": err,
            "ms": t_k, "plain_ms": t_p, "bound_ms": b_ms, "bound_by": b_by,
            "library_ms": t_lib,
            "tolerance": tolerance or (f"{REL_TOL:g} x per-row / per-element |plain|; "
                                       f"tables {TABLE_ATOL:g}"),
        })
        log(f"{name}: max_abs_err {err:.3e}, kernel {t_k:.4f} ms, plain {t_p:.4f} ms, "
            f"library {t_lib} ms, bound {b_ms:.4f} ms ({b_by})")

    acc0 = torch.zeros((V, D + 1), device=dev)
    # K5a: K alias draws per example
    negs = sample_negatives(noise, dgen, (E, K))
    a_k, a_p = acc0.clone(), acc0.clone()
    dk, lk = per_example.per_example(v, u, g_pos, contexts, negs, ctx, a_k)
    dp, lp = per_example.per_example_plain(v, u, g_pos, contexts, negs, ctx, a_p)
    torch.cuda.synchronize()
    err = compare("K5a" + sfx, [("d_center", dk, dp, "rows"), ("loss_neg", lk, lp, "elems")]
                  + acc_outputs("acc_ctx", a_k, a_p, D))
    n_neg = distinct(negs)
    a_t = acc0.clone()
    row("per_example" + sfx, "k5_per_example.cu", "gene2vec_tpu/sgns/step.py:97", err,
        lambda: per_example.per_example(v, u, g_pos, contexts, negs, ctx, a_t),
        lambda: per_example.per_example_plain(v, u, g_pos, contexts, negs, ctx, a_t), None,
        4 * (2 * E * D + 2 * E + E * K + 2 * n_neg * (D + 1) + E * D + E) + tb * n_neg * D,
        5 * E * K * D)
    log(f"per_example{sfx}: {n_neg} distinct noise rows of {E * K} draws")
    acc_pe, d_center = a_p, dp

    # K5b: the auto-sized grouped pool
    g, per_group = shared_pool_layout(E, K)
    pool = sample_negatives(noise, dgen, (g * per_group,))
    a_k, a_p = acc0.clone(), acc0.clone()
    dk, lk = shared_pool.shared_pool(v, u, g_pos, contexts, pool, ctx, K, g, a_k)
    dp, lp = shared_pool.shared_pool_plain(v, u, g_pos, contexts, pool, ctx, K, g, a_p)
    torch.cuda.synchronize()
    err = compare("K5b" + sfx, [("d_center", dk, dp, "rows"), ("loss_neg", lk, lp, "elems")]
                  + acc_outputs("acc_ctx", a_k, a_p, D))
    n_pool = distinct(pool)
    a_t = acc0.clone()
    row("shared_pool" + sfx, "k5_shared.cu", "gene2vec_tpu/sgns/step.py:337", err,
        lambda: shared_pool.shared_pool(v, u, g_pos, contexts, pool, ctx, K, g, a_t),
        lambda: shared_pool.shared_pool_plain(v, u, g_pos, contexts, pool, ctx, K, g, a_t),
        None,
        4 * (2 * E * D + 2 * E + g * per_group + 2 * n_pool * (D + 1) + E * D + E)
        + tb * n_pool * D,
        3 * 2 * E * per_group * D)
    log(f"shared_pool{sfx}: G {g}, P/G {per_group}, {n_pool} distinct pool rows")

    # K6: sg_hs at hs_dense_depth 10 (input = center, path of the context)
    tree = build_huffman_tree(counts)
    split = split_shallow(tree, HS_DEPTH)
    ns, l_deep = split.n_shallow, split.points_deep.shape[1]
    pts, cds, lens, sign = (torch.from_numpy(a).to(dev) for a in (
        split.points_deep, split.codes_deep, split.lengths_deep, split.sign))
    node = (torch.randn((tree.num_nodes, D), generator=torch.Generator().manual_seed(2))
            * 0.1).to(dev, dtype)
    a0 = torch.zeros((tree.num_nodes, D + 1), device=dev)
    a_k, a_p = a0.clone(), a0.clone()
    args6 = (emb, node, centers, contexts, pts, cds, lens, sign)
    dk, ldk, lsk = hs.hs(*args6, a_k)
    dp, ldp, lsp = hs.hs_plain(*args6, a_p)
    torch.cuda.synchronize()
    err = compare("K6" + sfx, [("d_input", dk, dp, "rows"), ("loss_deep", ldk, ldp, "elems"),
                               ("loss_shallow", lsk, lsp, "elems")]
                  + acc_outputs("acc_node", a_k, a_p, D))
    work = hs_work(split, c_ids, x_ids, D, tb)
    a_t = a0.clone()
    row("hs" + sfx, "k6_hs.cu", "gene2vec_tpu/sgns/cbow_hs.py:65", err,
        lambda: hs.hs(*args6, a_t), lambda: hs.hs_plain(*args6, a_t), None,
        work["bytes"], work["flops"])
    lengths = tree.lengths.astype(np.float64)
    w = counts / counts.sum()
    log(f"hs{sfx} (depth {HS_DEPTH}): L {tree.points.shape[1]}, Ns {ns}, L_deep {l_deep}; "
        f"frequency-weighted mean path {float(w @ lengths):.2f}, deep "
        f"{float(w @ split.lengths_deep):.2f}; {work['deep_entries']} deep and "
        f"{work['shallow_entries']} shallow path entries in this batch, "
        f"{work['deep_nodes']} distinct deep and {work['shallow_nodes']} distinct "
        "shallow nodes")

    # K4's generic entry points, at the per-example step's shapes: the
    # center rows' scatter (library: one index_add_ of the same payload)
    # and ctx's finalize against K5a's accumulator
    touched = int((acc_pe[:, D] != 0).sum())
    if not bf16:
        ones = torch.ones((E,), device=dev)
        a_k, a_p = acc0.clone(), acc0.clone()
        row_update.scatter_rows(a_k, centers, d_center, ones)
        row_update.scatter_rows_plain(a_p, centers, d_center, ones)
        torch.cuda.synchronize()
        err_s = compare("K4 scatter_rows", acc_outputs("acc_emb", a_k, a_p, D))
        n_c = len(np.unique(c_ids))
        payload = torch.cat([d_center, ones[:, None]], 1)
        idx_l = centers.long()
        a_t = acc0.clone()
        row("row_scatter", "k4_row_update.cu", "gene2vec_tpu/sgns/step.py:229", err_s,
            lambda: row_update.scatter_rows(a_t, centers, d_center, ones),
            lambda: row_update.scatter_rows_plain(a_t, centers, d_center, ones),
            lambda: a_t.index_add_(0, idx_l, payload),
            4 * (E + E * D + E + 2 * n_c * (D + 1)), E * (D + 1))
    for mode, salts in ((("sr", SALTS[1]), ("rn", None)) if bf16 else (("", None),)):
        name = f"row_finalize{sfx}" + (f"_{mode}" if mode else "")
        t_k, t_p = ctx.clone(), ctx.clone()
        row_update.finalize_rows(t_k, acc_pe, 0.0125, "capped", salts)
        row_update.finalize_rows_plain(t_p, acc_pe, 0.0125, "capped", salts)
        torch.cuda.synchronize()
        if bf16:
            bitwise_tables(torch, name, [("ctx", t_k, t_p)])
            err_f, tol = float((t_k.float() - t_p.float()).abs().max()), "bitwise"
        else:
            err_f, tol = compare("K4 finalize_rows", [("ctx", t_k, t_p, "abs")]), None
        t_t = ctx.clone()
        row(name, "k4_row_update.cu", "gene2vec_tpu/sgns/step.py:248", err_f,
            lambda: row_update.finalize_rows(t_t, acc_pe, 0.0125, "capped", salts),
            lambda: row_update.finalize_rows_plain(t_t, acc_pe, 0.0125, "capped", salts),
            None, touched * (4 * (D + 1) + 2 * tb * D),
            3 * D * touched + (SR_HASH_OPS * D * touched if salts else 0), tol)
    log(f"row_finalize{sfx}: {touched} touched rows of {V}")
    return rows


def objective_step_parity(torch, v, d, b, kind, full_tables, dtype=None):
    """One whole step of ``kind`` (per_example, shared, sg_hs, cbow_hs at
    depth 10) on the card against the plain step on the CPU, same inputs
    and draws: loss within rtol 1e-5, tables within TABLE_ATOL; at
    ``dtype`` bfloat16 with SALTS, as ``step_verdict`` says."""
    from gene2vec_tpu_torch.sgns.cbow_hs import hs_step
    from gene2vec_tpu_torch.sgns.huffman import build_huffman_tree, split_shallow
    from gene2vec_tpu_torch.sgns.model import SGNSParams
    from gene2vec_tpu_torch.sgns.step import sgns_step, shared_pool_layout

    rng = np.random.RandomState(3)
    pairs = np.stack([zipf_ids(rng, b, v), zipf_ids(rng, b, v)], 1)
    counts = np.sort(np.bincount(pairs.reshape(-1), minlength=v) + 1)[::-1].copy()
    hs_kind = kind.endswith("_hs")
    if hs_kind:
        tree = build_huffman_tree(counts)
        split = split_shallow(tree, HS_DEPTH)
        out_rows = tree.num_nodes
    else:
        out_rows = v
        shape = ((np.prod(shared_pool_layout(2 * b, K)),) if kind == "shared"
                 else (2 * b, K))
        negs = zipf_ids(rng, int(np.prod(shape)), v).reshape(shape)
    dtype = dtype or torch.float32
    bf16 = dtype == torch.bfloat16
    gen = torch.Generator().manual_seed(3)
    scale = 0.1 if full_tables else 0.5 / d
    tables = ((torch.randn((v, d), generator=gen) * scale).to(dtype),
              (torch.randn((out_rows, d), generator=gen) * scale).to(dtype))
    salts = SALTS if bf16 else None
    out = {}
    for dev in ("cpu", "cuda"):
        p = SGNSParams(tables[0].to(dev, copy=True), tables[1].to(dev, copy=True))
        batch = torch.from_numpy(pairs).to(dev)
        if hs_kind:
            pts, cds, lens, sign = (torch.from_numpy(a).to(dev) for a in (
                split.points_deep, split.codes_deep, split.lengths_deep, split.sign))
            p, loss = hs_step(p, batch, pts, cds, lens, 0.025, cbow=kind == "cbow_hs",
                              shallow_sign=sign, n_shallow=split.n_shallow, sr_salts=salts)
        else:
            p, loss = sgns_step(p, batch, 0.025, negative_mode=kind,
                                negs=torch.from_numpy(negs).to(dev), sr_salts=salts)
        out[dev] = (float(loss), p.emb.cpu(), p.ctx.cpu())
    step_verdict(torch, f"whole-step parity {kind} card vs CPU{' bf16' if bf16 else ''} "
                 f"(V {v}, D {d}, E {2 * b})", out, tables, bf16)


# -- phase 2d: the serving repairs (bf16 tables; lists past 8,192) -------------

LONG_RB = 16384             # R2: k = 256 (kb 512) at --rescore-mult 32


def serving_repairs_check(torch, reps):
    """R1: K8 and K9 on a bf16 index (B in SERVE_BATCHES, kb = 16) against
    their plain versions — scores within SERVE_TOL, ids equal except
    counted near-ties.  R2: K8 at B = 64, kb = 512, rb = LONG_RB against
    its plain version, scores and ids bitwise.  Returns one record per
    (kernel, shape) for the ``serving_kernel_shapes`` line."""
    from gene2vec_tpu_torch.kernels import _topk, ivf_scan, quant_scan
    from gene2vec_tpu_torch.serve import ann

    dev = torch.device(DEVICE)
    unit_np = serving_table(np.random.RandomState(5))
    rng = np.random.RandomState(6)
    t0 = time.perf_counter()
    index = ann.build_index(unit_np, "ivf", quant_dtype="bf16", device=dev)
    log(f"bf16 IVF index built in {time.perf_counter() - t0:.1f}s")
    c, lst = index.n_clusters, index.list_len
    timer = Timer(torch, reps)
    records = []

    def record(name, b, kb, rb, err, ties, fn_k, fn_p, bytes_moved, flops, int8_ops=0.0,
               bf16_ops=0.0):
        b_ms, b_by = bound(bytes_moved, flops, int8_ops, bf16_ops)
        rec = {"name": name, "batch": b, "kb": kb, "rb": rb, "max_abs_err": err,
               "near_ties": ties, "ms": timer(fn_k), "plain_ms": timer(fn_p),
               "library_ms": None, "bound_ms": b_ms, "bound_by": b_by}
        records.append(rec)
        log(f"{name} B {b} kb {kb} rb {rb}: max_abs_err {err:.3e}, near-ties {ties}, kernel "
            f"{rec['ms']:.4f} ms, plain {rec['plain_ms']:.4f} ms, bound {b_ms:.4f} ms ({b_by})")

    for b in SERVE_BATCHES:
        q = torch.from_numpy(unit_np[rng.choice(V, b, replace=False)] * 3.0).to(dev)
        qn = _topk.normalize_plain(q)
        q16 = qn.to(torch.bfloat16).float()

        def bf16_of(ids):
            return (q16[:, None, :] * index.table_q[ids].float()).sum(-1)

        kb, rb = 16, 16 * RESCORE_MULT
        nprobe = min(max(8, -(-kb // lst)), c)
        a8 = (qn, index.table_q, index.scale, rb)
        got, want = quant_scan.quant_scan(*a8), quant_scan.quant_scan_plain(*a8)
        torch.cuda.synchronize()
        err, ties = check_topk("K8 bf16", got, want, bf16_of, SERVE_TOL)
        record("quant_scan_bf16", b, kb, rb, err, ties, lambda: quant_scan.quant_scan(*a8),
               lambda: quant_scan.quant_scan_plain(*a8),
               2 * V * D + 4 * b * D + 8 * b * rb, 0.0, bf16_ops=2.0 * b * V * D)
        a9 = (qn, index.centroids, index.lists, index.table_q, index.scale, nprobe, rb)
        got, want = ivf_scan.ivf_scan(*a9), ivf_scan.ivf_scan_plain(*a9)
        torch.cuda.synchronize()
        tied = probe_near_ties(torch, qn, index.centroids, nprobe)
        keep = ~tied
        err, ties = check_topk(
            "K9 bf16", (got[0][keep], got[1][keep]), (want[0][keep], want[1][keep]),
            lambda ids: (q16[keep][:, None, :] * index.table_q[ids].float()).sum(-1),
            SERVE_TOL)
        _, ci = _topk.topk_plain(qn @ index.centroids.T, nprobe)
        cand = index.lists[ci.long()].reshape(b, -1)
        cand = cand[cand >= 0]
        n_rows = int(torch.unique(cand).numel())
        record("ivf_scan_bf16", b, kb, rb, err, ties + int(tied.sum()),
               lambda: ivf_scan.ivf_scan(*a9), lambda: ivf_scan.ivf_scan_plain(*a9),
               4 * c * D + 4 * b * D + 4 * b * nprobe * lst + 2 * n_rows * D
               + 8 * b * got[0].shape[1], 2.0 * b * c * D, bf16_ops=2.0 * int(cand.numel()) * D)
    # R2 on the int8 index of the same table
    iq = ann.build_index(unit_np, "quant", device=dev)
    b = 64
    q = torch.from_numpy(unit_np[rng.choice(V, b, replace=False)] * 3.0).to(dev)
    qn = _topk.normalize_plain(q)
    a8 = (qn, iq.table_q, iq.scale, LONG_RB)
    got, want = quant_scan.quant_scan(*a8), quant_scan.quant_scan_plain(*a8)
    torch.cuda.synchronize()
    if not (torch.equal(got[0].view(torch.int32), want[0].view(torch.int32))
            and torch.equal(got[1], want[1])):
        raise SystemExit(f"K8 at rb {LONG_RB}: not bitwise the plain version's")
    record("quant_scan", b, 512, LONG_RB, 0.0, 0, lambda: quant_scan.quant_scan(*a8),
           lambda: quant_scan.quant_scan_plain(*a8),
           V * D + 4 * V + 4 * b * D + 8 * b * LONG_RB, 0.0, int8_ops=2.0 * b * V * D)
    return records


# -- phase 3: training through the CLI -----------------------------------------


def write_zipf_corpus(path: str, vocab_size: int, num_pairs: int, seed: int = 0):
    """The reference bench's Zipf recipe (bench.py synth_corpus), written
    as pair files."""
    rng = np.random.RandomState(seed)
    p = 1.0 / np.arange(1, vocab_size + 1)
    p /= p.sum()
    pairs = rng.choice(vocab_size, size=(num_pairs, 2), p=p).astype(np.int32)
    os.makedirs(path, exist_ok=True)
    names = np.array([f"G{i}" for i in range(vocab_size)], dtype=object)
    half = num_pairs // 2
    for part, rows in enumerate((pairs[:half], pairs[half:])):
        with open(os.path.join(path, f"pairs_{part}.txt"), "w") as f:
            f.write("\n".join(names[rows[:, 0]] + " " + names[rows[:, 1]]))
            f.write("\n")


def train_full_width(torch, work: str, smi: str):
    from gene2vec_tpu_torch import kernels
    from gene2vec_tpu_torch.cli import gene2vec
    from gene2vec_tpu_torch.resilience.snapshot import verify_manifest

    data, out = os.path.join(work, "corpus"), os.path.join(work, "export")
    t0 = time.perf_counter()
    write_zipf_corpus(data, V, NUM_PAIRS)
    log(f"corpus written in {time.perf_counter() - t0:.1f}s")
    kernels.reset_launch_counts()
    rc = gene2vec.main([data, out, "txt", "--iters", str(ITERS), "--device", DEVICE])
    torch.cuda.synchronize()
    counts = kernels.launch_counts()
    if rc != 0:
        raise SystemExit(f"CLI exited {rc}")
    with open(os.path.join(out, "training_log.csv")) as f:
        rows = list(csv.DictReader(f))
    losses = [float(r["loss"]) for r in rows]
    rates = [float(r["pairs_per_sec"]) for r in rows]
    if len(losses) != ITERS or not all(np.isfinite(losses)):
        raise SystemExit(f"bad losses {losses}")
    if not all(b < a for a, b in zip(losses, losses[1:])):
        raise SystemExit(f"loss not decreasing: {losses}")
    for it in range(1, ITERS + 1):
        res = verify_manifest(os.path.join(out, f"gene2vec_dim_{D}_iter_{it}"))
        if not res:
            raise SystemExit(f"iteration {it} export does not verify: {res.reason}")
    want = expected_launches(dict.fromkeys(STEP_KERNELS, 1), (NUM_PAIRS // B) * ITERS, counts)
    if counts != want:
        raise SystemExit(f"launch counts {counts}, expected {want}")
    log(f"training ({smi}): losses {losses}, pairs/s per iteration "
        f"{rates}, launches { {k: n for k, n in counts.items() if n} }")
    return counts


# -- phase 3b: every other objective and noise mode through the CLI ------------

OBJECTIVE_PAIRS, OBJECTIVE_ITERS = 1_000_000, 2
#: (label, CLI flags, {kernel: launches per step}) — every other kernel
#: must not launch in that run
OBJECTIVE_RUNS = (
    ("per_example", ["--negative-mode", "per_example"],
     {"pos_logit": 1, "per_example": 1, "row_scatter": 2, "row_finalize": 2}),
    ("shared", ["--negative-mode", "shared"],
     {"pos_logit": 1, "shared_pool": 1, "row_scatter": 2, "row_finalize": 2}),
    ("sg_hs", ["--objective", "sg_hs"], {"hs": 1, "row_scatter": 1, "row_finalize": 2}),
    ("cbow_hs", ["--objective", "cbow_hs"], {"hs": 1, "row_scatter": 1, "row_finalize": 2}),
    ("cbow", ["--objective", "cbow"],
     {"pos_logit": 1, "noise_head": 1, "noise_tail": 1, "row_update": 1}),
)
#: phase 3c: bfloat16 tables (stochastic rounding, the default) through the
#: CLI — the default configuration, sg_hs and the two sampled noise modes.
#: A variant's launches (``<name>_bf16...``) count in its total as well
_BF16 = ["--table-dtype", "bfloat16"]
BF16_RUNS = (
    ("bf16_stratified", _BF16,
     {"pos_logit_bf16": 1, "noise_head_bf16": 1, "noise_tail_bf16": 1,
      "row_update_bf16_sr": 1}),
    ("bf16_sg_hs", _BF16 + ["--objective", "sg_hs"],
     {"hs_bf16": 1, "row_scatter": 1, "row_finalize_bf16_sr": 2}),
    ("bf16_per_example", _BF16 + ["--negative-mode", "per_example"],
     {"pos_logit_bf16": 1, "per_example_bf16": 1, "row_scatter": 2,
      "row_finalize_bf16_sr": 2}),
    ("bf16_shared", _BF16 + ["--negative-mode", "shared"],
     {"pos_logit_bf16": 1, "shared_pool_bf16": 1, "row_scatter": 2,
      "row_finalize_bf16_sr": 2}),
)


def expected_launches(per_step: dict, steps: int, names) -> dict:
    """{name: launches} over ``names`` for a run of ``steps`` steps that
    launches ``per_step`` a step: each variant's launches also count in its
    total (``noise_head_bf16`` in ``noise_head``); every other name 0."""
    want = dict.fromkeys(names, 0)
    for name, n in per_step.items():
        want[name] += n * steps
        if "_bf16" in name:
            want[name.split("_bf16")[0]] += n * steps
    return want


def train_objectives(torch, work: str, smi: str, runs=OBJECTIVE_RUNS,
                     table_dtype: str = "float32"):
    """Each entry of ``runs`` trained through the CLI at full width
    (V = 24,447, D = 200, B = 4,096; OBJECTIVE_PAIRS pairs, OBJECTIVE_ITERS
    iterations): the loss finite and falling, every export verifying and
    stamped ``table_dtype``, the launch counts — zeroed just before the
    run and read just after — those of the run's kernels once per step,
    and no other kernel's.  Returns {label: launch counts}."""
    from gene2vec_tpu_torch import kernels
    from gene2vec_tpu_torch.cli import gene2vec
    from gene2vec_tpu_torch.resilience.snapshot import verify_manifest

    data = os.path.join(work, "corpus_objectives")
    if not os.path.isdir(data):
        write_zipf_corpus(data, V, OBJECTIVE_PAIRS, seed=1)
    steps = (OBJECTIVE_PAIRS // B) * OBJECTIVE_ITERS
    out_counts = {}
    for label, flags, per_step in runs:
        out = os.path.join(work, f"export_{label}")
        t0 = time.perf_counter()
        kernels.reset_launch_counts()
        rc = gene2vec.main([data, out, "txt", "--iters", str(OBJECTIVE_ITERS), "--device",
                            DEVICE, "--no-txt-output", *flags])
        torch.cuda.synchronize()
        counts = kernels.launch_counts()
        wall = time.perf_counter() - t0
        if rc != 0:
            raise SystemExit(f"{label}: CLI exited {rc}")
        with open(os.path.join(out, "training_log.csv")) as f:
            rows = list(csv.DictReader(f))
        losses = [float(r["loss"]) for r in rows]
        rates = [float(r["pairs_per_sec"]) for r in rows]
        if len(losses) != OBJECTIVE_ITERS or not all(np.isfinite(losses)):
            raise SystemExit(f"{label}: bad losses {losses}")
        if not all(b < a for a, b in zip(losses, losses[1:])):
            raise SystemExit(f"{label}: loss not decreasing: {losses}")
        for it in range(1, OBJECTIVE_ITERS + 1):
            prefix = os.path.join(out, f"gene2vec_dim_{D}_iter_{it}")
            res = verify_manifest(prefix)
            if not res:
                raise SystemExit(f"{label}: iteration {it} export does not verify: {res.reason}")
            with np.load(prefix + ".npz") as z:
                stamp = json.loads(str(z["meta"]))["table_dtype"]
            if stamp != table_dtype:
                raise SystemExit(f"{label}: iteration {it} stamped {stamp!r}, "
                                 f"not {table_dtype!r}")
        want = expected_launches(per_step, steps, counts)
        if counts != want:
            raise SystemExit(f"{label}: launch counts {counts}, expected {want}")
        out_counts[label] = counts
        log(f"training {label} ({smi}): losses {losses}, pairs/s per iteration {rates}, "
            f"{wall:.1f}s, launches { {k: n for k, n in counts.items() if n} }")
    return out_counts


# -- phase 4: planted clusters -------------------------------------------------


#: the objectives and noise modes phase 4 trains, as SGNSConfig fields
PLANTED_CONFIGS = (
    {}, {"negative_mode": "per_example"}, {"negative_mode": "shared"},
    {"objective": "sg_hs"}, {"objective": "cbow_hs"}, {"objective": "cbow"},
    {"table_dtype": "bfloat16"},
)
#: bfloat16 tables with nearest-even write-back, reported and not gated:
#: small-scale runs absorb sub-ulp updates (tests/test_stochastic_round.py);
#: these runs are the main path of K4's nearest-even write-backs
PLANTED_NEAREST = (
    {"table_dtype": "bfloat16", "bf16_stochastic_round": False},
    {"table_dtype": "bfloat16", "bf16_stochastic_round": False,
     "negative_mode": "per_example"},
)


def planted_quality(torch, gate: bool = True, **config_kw):
    """eval/planted.py's recipe and metric (10 cliques x 20 genes, 2000
    pairs each) with the reference bench's settings (dim 64, batch 1024,
    15 epochs), for the configuration ``config_kw`` selects; without
    ``gate`` the separation is reported only."""
    from gene2vec_tpu_torch.config import SGNSConfig
    from gene2vec_tpu_torch.data.pipeline import PairCorpus
    from gene2vec_tpu_torch.io.vocab import Vocab
    from gene2vec_tpu_torch.sgns.cbow_hs import make_trainer
    from gene2vec_tpu_torch.sgns.train import epoch_generator

    rng = np.random.RandomState(0)
    lines = []
    for c in range(10):
        genes = [f"C{c}G{i}" for i in range(20)]
        for _ in range(2000):
            a, b = rng.choice(20, 2, replace=False)
            lines.append((genes[a], genes[b]))
    vocab = Vocab.from_pairs(lines)
    cfg = SGNSConfig(dim=64, batch_pairs=1024, num_iters=15, **config_kw)
    tr = make_trainer(PairCorpus(vocab, vocab.encode_pairs(lines)), cfg, device=DEVICE)
    params = tr.init()
    for it in range(1, 16):
        params, loss = tr.train_epoch(params, generator=epoch_generator(cfg.seed, it))
    emb = params.emb.float().cpu().numpy()
    m = emb / (np.linalg.norm(emb, axis=1, keepdims=True) + 1e-9)
    idx = vocab.token_to_id
    crng = np.random.RandomState(1)
    intra, inter = [], []
    for c in range(10):
        ids = [idx[f"C{c}G{i}"] for i in range(8)]
        intra += [m[a] @ m[b] for a, b in itertools.combinations(ids, 2)]
    for _ in range(500):
        c1, c2 = crng.choice(10, 2, replace=False)
        inter.append(m[idx[f"C{c1}G{crng.randint(20)}"]] @ m[idx[f"C{c2}G{crng.randint(20)}"]])
    intra, inter = float(np.mean(intra)), float(np.mean(inter))
    log(f"planted clusters {config_kw or 'default'}: intra {intra:.4f} (> 0.95), inter "
        f"{inter:.4f} (< 0.6), last loss {float(loss):.4f}{'' if gate else ' (reported)'}")
    if not np.isfinite(float(loss)):
        raise SystemExit(f"planted clusters ({config_kw}): loss {float(loss)}")
    if gate and not (intra > 0.95 and inter < 0.6):
        raise SystemExit(f"planted clusters did not separate ({config_kw}): {intra}, {inter}")


# -- phase 5: serving through the CLI ------------------------------------------

ROOT = os.path.dirname(os.path.abspath(__file__))
SERVE_MODES = ("exact", "quant", "ivf")
SERVE_KS = (1, 10, 100, 256)
SERVE_NPROBE = 8            # the server's default
SERVE_REQUESTS = 400        # concurrent requests per mode
SERVE_CLIENTS = 16
SCORE_TOL = 1e-5            # served scores against the exact cosine (6 decimals)
RECALL_FLOOR = 0.99
#: kernels each index mode must launch, and those it must not
MODE_KERNELS = {
    "exact": (("topk_exact",), ("quant_scan", "ivf_scan", "rescore")),
    "quant": (("quant_scan", "rescore"), ("topk_exact", "ivf_scan")),
    "ivf": (("ivf_scan", "rescore"), ("topk_exact", "quant_scan")),
}


def start_server(export: str, mode: str, err_path: str):
    """``cli/serve.py`` in a subprocess on the card; returns (process,
    its stdout contract line)."""
    import selectors

    cmd = [sys.executable, "-m", "gene2vec_tpu_torch.cli.serve", "--export-dir", export,
           "--port", "0", "--index", mode, "--cache-size", "0", "--nprobe",
           str(SERVE_NPROBE), "--poll-interval", "3600"]
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [ROOT] + [p for p in os.environ.get("PYTHONPATH", "").split(os.pathsep) if p]))
    err = open(err_path, "w")
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=err, text=True, cwd=ROOT,
                            env=env)
    err.close()
    sel = selectors.DefaultSelector()
    sel.register(proc.stdout, selectors.EVENT_READ)
    ready = sel.select(timeout=300)
    sel.close()
    line = proc.stdout.readline() if ready else ""
    if not line:
        proc.kill()
        proc.wait()
        with open(err_path) as f:
            raise SystemExit(f"{mode} server did not start:\n{f.read()[-4000:]}")
    return proc, json.loads(line)


def stop_server(proc) -> None:
    import signal

    proc.send_signal(signal.SIGTERM)
    try:
        proc.wait(timeout=30)
    except subprocess.TimeoutExpired:
        proc.kill()
        proc.wait()


def request_plan(tokens, emb, rng):
    """(bucket-filling requests, concurrent requests): one POST of n genes
    for n = 1, 2, 4 .. 64 (each alone fills batch bucket n), then
    SERVE_REQUESTS of gene GETs, gene POSTs and vector POSTs, k cycling
    through SERVE_KS.  A vector query is a gene's row moved by 10% of the
    table's spread — a vector near the embedding, as callers send."""
    spread = 0.1 * float(emb.std())
    buckets = [("POST", "/v1/similar",
                {"genes": [str(g) for g in rng.choice(tokens, n, replace=False)], "k": 10})
               for n in (1, 2, 4, 8, 16, 32, 64)]
    mixed = []
    for i in range(SERVE_REQUESTS):
        k = SERVE_KS[i % len(SERVE_KS)]
        gene = str(tokens[rng.randint(len(tokens))])
        kind = (i // len(SERVE_KS)) % 3
        if kind == 0:
            mixed.append(("GET", f"/v1/similar?gene={gene}&k={k}", None))
        elif kind == 1:
            mixed.append(("POST", "/v1/similar", {"genes": [gene], "k": k}))
        else:
            vec = emb[rng.randint(len(tokens))] + spread * rng.randn(emb.shape[1])
            mixed.append(("POST", "/v1/similar",
                          {"vectors": [vec.astype(np.float32).tolist()], "k": k}))
    return buckets, mixed


def _send(conn, method, path, body):
    data = json.dumps(body).encode() if body is not None else None
    t0 = time.perf_counter()
    conn.request(method, path, body=data,
                 headers={"Content-Type": "application/json"} if data else {})
    resp = conn.getresponse()
    raw = resp.read()
    return resp.status, raw, time.perf_counter() - t0


def drive(url: str, buckets, mixed):
    """Bucket requests one at a time, then the mixed ones from
    SERVE_CLIENTS keep-alive clients.  Returns ([(request, status, body)],
    mixed-phase latencies in seconds, mixed-phase wall seconds)."""
    import http.client
    import threading
    from urllib.parse import urlparse

    u = urlparse(url)
    conn = http.client.HTTPConnection(u.hostname, u.port, timeout=120)
    done = [(r, *_send(conn, *r)[:2]) for r in buckets]
    conn.close()
    results = [None] * len(mixed)
    lat = [0.0] * len(mixed)

    def client(c):
        cn = http.client.HTTPConnection(u.hostname, u.port, timeout=120)
        for i in range(c, len(mixed), SERVE_CLIENTS):
            status, raw, dt = _send(cn, *mixed[i])
            results[i], lat[i] = (mixed[i], status, raw), dt
        cn.close()

    threads = [threading.Thread(target=client, args=(c,)) for c in range(SERVE_CLIENTS)]
    t0 = time.perf_counter()
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    wall = time.perf_counter() - t0
    return done + results, lat, wall


def check_answers(mode, answers, unit, token_id, gate_recall):
    """Every neighbor list against the exact cosine on the host: scores
    within SCORE_TOL; exact mode: ids those of the oracle except near-ties
    (the served gene's cosine within SCORE_TOL of the oracle's at that
    position); quant/ivf with ``gate_recall``: recall@10 against
    ``exact_oracle`` >= RECALL_FLOOR.  IVF may find fewer candidates than
    k; those slots are -inf, as in the reference, and are counted.
    Returns (queries, near-ties, recall@10, short slots)."""
    queries, qvecs, selves, got = [], [], [], []
    for (method, path, body), status, raw in answers:
        if status != 200:
            raise SystemExit(f"{mode}: {method} {path} answered {status}: {raw[:300]!r}")
        doc = json.loads(raw)
        if method == "GET":
            gene, k = path.split("gene=")[1].split("&k=")
            genes, vecs, k = [gene], None, int(k)
        else:
            genes, vecs, k = body.get("genes"), body.get("vectors"), body["k"]
        for j, res in enumerate(doc["results"]):
            if genes is not None:
                row = token_id[genes[j]]
                qvecs.append(unit[row])
                selves.append(row)
            else:
                v = np.asarray(vecs[j], np.float32)
                qvecs.append(v / np.linalg.norm(v))
                selves.append(None)
            got.append((k, [(token_id[n["gene"]], n["score"]) for n in res["neighbors"]]))
            queries.append(res["query"])
    scores = np.stack(qvecs) @ unit.T
    ties = short = hits = total = 0
    for i, (k, nbrs) in enumerate(got):
        s = scores[i].copy()
        if selves[i] is not None:
            s[selves[i]] = -np.inf
        oracle = np.argsort(-s, kind="stable")[:k]
        if len(nbrs) != k:
            raise SystemExit(f"{mode}: {len(nbrs)} neighbors for k = {k}")
        for p, (row, score) in enumerate(nbrs):
            if score == float("-inf"):
                if mode != "ivf":
                    raise SystemExit(f"{mode}: -inf score at position {p}")
                short += 1
                continue
            if abs(score - scores[i, row]) > SCORE_TOL:
                raise SystemExit(f"{mode}: served score {score} vs exact {scores[i, row]}")
            if mode == "exact" and row != oracle[p]:
                if abs(s[row] - s[oracle[p]]) > SCORE_TOL:
                    raise SystemExit(f"{mode}: query {queries[i]!r} position {p}: row {row}, "
                                     f"oracle {oracle[p]} — not a near-tie")
                ties += 1
        if k >= 10:
            hits += len({r for r, _ in nbrs[:10]} & set(oracle[:10].tolist()))
            total += 10
    recall = hits / total
    if gate_recall and mode != "exact" and recall < RECALL_FLOOR:
        raise SystemExit(f"{mode}: recall@10 {recall:.4f} < {RECALL_FLOOR}")
    return len(got), ties, recall, short


def scrape_launches(url: str):
    import re
    import urllib.request

    with urllib.request.urlopen(url + "/metrics", timeout=60) as r:
        text = r.read().decode()
    return {m.group(1): int(float(m.group(2))) for m in re.finditer(
        r'^kernel_launches_total\{kernel="([a-z_]+)"\} (\S+)$', text, re.M)}


def write_clustered_export(path: str, seed: int = 11):
    """A full-width export (V = 24,447, D = 200) with neighbor structure —
    1,000 groups of ~24 genes around seeded centres — written with the
    port's checkpoint writer."""
    from gene2vec_tpu_torch.io.checkpoint import save_iteration
    from gene2vec_tpu_torch.io.vocab import Vocab
    from gene2vec_tpu_torch.sgns.model import SGNSParams
    import torch

    rng = np.random.RandomState(seed)
    cent = rng.randn(1000, D).astype(np.float32)
    emb = cent[rng.randint(0, 1000, V)] + 0.35 * rng.randn(V, D).astype(np.float32)
    t = torch.from_numpy(emb)
    save_iteration(path, D, 1, SGNSParams(t, t), Vocab([f"G{i}" for i in range(V)],
                                                       np.ones(V, np.int64)),
                   txt_output=False)


def serve_full_width(export: str, work: str, smi: str, gate_recall: bool):
    """Serve one export through ``cli/serve.py`` once per index mode and
    check every answer; returns the kernel launches summed over the three
    servers."""
    from gene2vec_tpu_torch.serve.registry import discover_newest, l2_normalize

    dim, it, path = discover_newest(export)
    with np.load(path) as z:
        emb = np.asarray(z["emb"], np.float32)
    unit = l2_normalize(emb)
    with open(os.path.join(export, "vocab.tsv"), encoding="utf-8") as f:
        tokens = [line.split("\t")[0] for line in f if line.strip()]
    token_id = {t: i for i, t in enumerate(tokens)}
    # the table's geometry: near-parallel rows leave nothing for an
    # approximate scan to rank
    pick = np.random.RandomState(3).randint(0, len(unit), (2, 2000))
    geometry = {"median_pair_cosine": float(np.median(np.sum(unit[pick[0]] * unit[pick[1]], 1))),
                "mean_unit_row_norm": float(np.linalg.norm(unit.mean(0)))}
    log(f"{os.path.basename(export)}: {geometry}")
    launches = {}
    for mode in SERVE_MODES:
        t0 = time.perf_counter()
        proc, contract = start_server(export, mode, os.path.join(work, f"serve_{mode}.err"))
        try:
            up = time.perf_counter() - t0
            if not contract["device"].startswith("cuda") or contract["iteration"] != it:
                raise SystemExit(f"{mode} server contract {contract}")
            buckets, mixed = request_plan(tokens, emb, np.random.RandomState(7))
            answers, lat, wall = drive(contract["url"], buckets, mixed)
            counts = scrape_launches(contract["url"])
        finally:
            stop_server(proc)
        n, ties, recall, short = check_answers(mode, answers, unit, token_id, gate_recall)
        must, must_not = MODE_KERNELS[mode]
        if any(counts.get(k, 0) <= 0 for k in must) or any(counts.get(k, 0) for k in must_not):
            raise SystemExit(f"{mode}: kernel launches {counts}, expected {must} only")
        for k, v in counts.items():
            launches[k] = launches.get(k, 0) + v
        lat_ms = np.sort(np.asarray(lat)) * 1e3
        summary = {"export": os.path.basename(export), "mode": mode,
                   "requests": len(answers), "queries": n,
                   "clients": SERVE_CLIENTS, "qps": len(mixed) / wall,
                   "p50_ms": float(np.percentile(lat_ms, 50)),
                   "p99_ms": float(np.percentile(lat_ms, 99)), "recall_at_10": recall,
                   "near_ties": ties, "short_slots": short, "launches": counts,
                   "startup_s": up, "table": geometry, "card": smi}
        print(json.dumps({"serving": summary}), flush=True)
        log(f"serving {mode}: {summary}")
    return launches


UNPROFILED_EPOCHS = 3  # epochs per profile window timed on the host clock


def profile_steps(torch, steps: int, out_dir: str, smi: str, **config_kw):
    """A window of epochs of ``steps`` full-width training steps of the
    configuration ``config_kw`` selects: a warm-up, UNPROFILED_EPOCHS
    timed on the host clock, one under torch.profiler — device busy time
    by kernel.  Returns the window's pairs/s (all its timed steps' pairs
    over their whole wall), device busy ms/step and idle share (1 - busy
    / wall per step).  The Chrome trace lands in ``out_dir``."""
    from torch.profiler import ProfilerActivity, profile

    from gene2vec_tpu_torch.config import SGNSConfig
    from gene2vec_tpu_torch.data.pipeline import PairCorpus
    from gene2vec_tpu_torch.io.vocab import Vocab
    from gene2vec_tpu_torch.sgns.cbow_hs import make_trainer
    from gene2vec_tpu_torch.sgns.train import epoch_generator

    rng = np.random.RandomState(0)
    pairs = np.stack([zipf_ids(rng, steps * B, V), zipf_ids(rng, steps * B, V)], 1)
    counts = np.bincount(pairs.reshape(-1), minlength=V) + 1
    vocab = Vocab([f"G{i}" for i in range(V)], counts)
    tr = make_trainer(PairCorpus(vocab, pairs), SGNSConfig(**config_kw), device=DEVICE)
    params = tr.init()
    params, loss = tr.train_epoch(params, generator=epoch_generator(1, 0))
    float(loss)  # warm-up epoch
    walls = []
    for it in range(1, UNPROFILED_EPOCHS + 1):
        t0 = time.perf_counter()
        params, loss = tr.train_epoch(params, generator=epoch_generator(1, it))
        float(loss)
        walls.append(time.perf_counter() - t0)
    wall_plain = sum(walls) / len(walls)  # per epoch, over the whole window
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        params, loss = tr.train_epoch(params, generator=epoch_generator(1, 9))
        float(loss)
        wall_prof = time.perf_counter() - t0
    os.makedirs(out_dir, exist_ok=True)
    label = "_".join(str(v) for v in config_kw.values()) or "default"
    prof.export_chrome_trace(os.path.join(out_dir, f"train_steps_trace_{label}.json"))
    # device-side kernel records only (an aten op's own row repeats the
    # device time of the kernels it launched)
    by_name = {
        ev.key: ev.self_device_time_total / 1e3
        for ev in prof.key_averages()
        if ev.device_type == torch.autograd.DeviceType.CUDA
        and ev.self_device_time_total > 0
    }
    n = tr.num_batches
    busy = sum(by_name.values())
    window = {"config": label, "steps": n * len(walls),
              "pairs_per_s": n * B / wall_plain, "wall_ms_per_step": wall_plain * 1e3 / n,
              "busy_ms_per_step": busy / n, "idle_share": 1 - busy / (wall_plain * 1e3)}
    log(f"profile {label} ({smi}): {n} steps; epochs "
        f"{[round(w * 1e3 / n, 4) for w in walls]} ms/step, window "
        f"{window['wall_ms_per_step']:.4f} ms/step ({window['pairs_per_s']:.0f} pairs/s); "
        f"profiled epoch {wall_prof * 1e3 / n:.4f} ms/step; device busy "
        f"{busy / n:.4f} ms/step; idle share {window['idle_share']:.4f} of the window, "
        f"{1 - busy / (wall_prof * 1e3):.4f} of the profiled epoch")
    for name, ms in sorted(by_name.items(), key=lambda kv: -kv[1])[:12]:
        log(f"  {ms / n:9.4f} ms/step  {name[:90]}")
    return window


def compare_widths(windows, smi: str) -> dict:
    """The default step at bfloat16 against float32 over the profile
    windows: the median over each width's windows of pairs/s and of device
    busy ms/step, and their ratios; every window is listed."""
    med = {w: {k: statistics.median(x[k] for x in windows if x["config"] == w)
               for k in ("pairs_per_s", "busy_ms_per_step")}
           for w in ("default", "bfloat16")}
    return {"windows": windows, "median": med,
            "bf16_over_f32": {k: med["bfloat16"][k] / med["default"][k]
                              for k in ("pairs_per_s", "busy_ms_per_step")},
            "card": smi}


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        log("chip_smoke: no CUDA device available")
        return 2
    smi = nvidia_smi_line()
    log(f"device: {smi}")
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from gene2vec_tpu_torch.kernels import build

    t0 = time.perf_counter()
    paths = build.build_all()
    log(f"built {sorted(paths)} in {time.perf_counter() - t0:.1f}s")
    for name in sorted(paths):
        with open(os.path.join(build.BUILD_DIR, f"{name}.log")) as f:
            log(f.read().strip())

    t0 = time.perf_counter()
    rows = kernel_check(torch, TIMED_REPS)
    step_parity(torch, 613, 40, 512, 48, 80, 64, full_tables=False)  # ragged edges
    step_parity(torch, V, D, B, HEAD, BLOCK, GROUP, full_tables=True)
    rows += objective_kernel_check(torch, TIMED_REPS)
    for kind in ("per_example", "shared", "sg_hs", "cbow_hs"):
        objective_step_parity(torch, 613, 40, 512, kind, full_tables=False)
        objective_step_parity(torch, V, D, B, kind, full_tables=True)
    log(f"kernel check done in {time.perf_counter() - t0:.1f}s")
    # phase 2e: every training kernel on bfloat16 tables, then whole steps
    t0 = time.perf_counter()
    bf16 = torch.bfloat16
    rows += kernel_check(torch, TIMED_REPS, bf16)
    rows += objective_kernel_check(torch, TIMED_REPS, bf16)
    step_parity(torch, 613, 40, 512, 48, 80, 64, full_tables=False, dtype=bf16)
    step_parity(torch, V, D, B, HEAD, BLOCK, GROUP, full_tables=True, dtype=bf16)
    for kind in ("per_example", "shared", "sg_hs", "cbow_hs"):
        objective_step_parity(torch, 613, 40, 512, kind, full_tables=False, dtype=bf16)
        objective_step_parity(torch, V, D, B, kind, full_tables=True, dtype=bf16)
    log(f"bf16 kernel check done in {time.perf_counter() - t0:.1f}s")
    t0 = time.perf_counter()
    serve_rows, serve_shapes = serving_kernel_check(torch, TIMED_REPS)
    serve_shapes += serving_repairs_check(torch, TIMED_REPS)
    probes = gather_probes(torch, TIMED_REPS)
    stream_row, stream_recs = stream_probes(torch, TIMED_REPS)
    probes += stream_recs
    log(f"serving kernel check and probes done in {time.perf_counter() - t0:.1f}s")
    prof_dir = os.path.join(os.getcwd(), "chip_smoke_profile")
    # the default step at float32 and bfloat16, in turns (f32, bf16, bf16, f32)
    widths = compare_widths(
        [profile_steps(torch, PROFILED_STEPS, prof_dir, smi, **kw)
         for kw in ({}, {"table_dtype": "bfloat16"}, {"table_dtype": "bfloat16"}, {})], smi)
    log(f"default step, bf16 against f32: {widths['bf16_over_f32']}")
    for kw in PLANTED_CONFIGS[1:5]:
        profile_steps(torch, PROFILED_STEPS // 2, prof_dir, smi, **kw)

    with tempfile.TemporaryDirectory(prefix="chip_smoke_", dir=os.getcwd()) as work:
        t0 = time.perf_counter()
        counts = train_full_width(torch, work, smi)
        log(f"training phase done in {time.perf_counter() - t0:.1f}s")
        t0 = time.perf_counter()
        # phase 3's export: every score exact, exact-mode ids the oracle's;
        # its rows are near-parallel (structureless Zipf pairs), so recall
        # is reported, not gated — the clustered export gates it
        served = serve_full_width(os.path.join(work, "export"), work, smi, gate_recall=False)
        clustered = os.path.join(work, "clustered")
        write_clustered_export(clustered)
        for name, n in serve_full_width(clustered, work, smi, gate_recall=True).items():
            served[name] = served.get(name, 0) + n
        counts.update(served)
        log(f"serving phase done in {time.perf_counter() - t0:.1f}s")
        t0 = time.perf_counter()
        # each new kernel's launches: the runs of phase 3b that drive it
        for label, run in train_objectives(torch, work, smi).items():
            if label != "cbow":  # K1-K4's main path is phase 3
                for name in OBJECTIVE_KERNELS:
                    counts[name] = counts.get(name, 0) + run[name]
        log(f"objectives training phase done in {time.perf_counter() - t0:.1f}s")
        # phase 3c: each bf16 instantiation's launches are those of the
        # bfloat16 runs (stochastic rounding: the CLI's default)
        t0 = time.perf_counter()
        for run in train_objectives(torch, work, smi, BF16_RUNS, "bfloat16").values():
            for name, n in run.items():
                if "_bf16" in name:
                    counts[name] = counts.get(name, 0) + n
        log(f"bf16 training phase done in {time.perf_counter() - t0:.1f}s")

    t0 = time.perf_counter()
    for kw in PLANTED_CONFIGS:
        planted_quality(torch, **kw)
    # the nearest-even write-backs' main path: bf16 runs with SR off
    from gene2vec_tpu_torch import kernels

    kernels.reset_launch_counts()
    for kw in PLANTED_NEAREST:
        planted_quality(torch, gate=False, **kw)
    torch.cuda.synchronize()
    nearest = kernels.launch_counts()
    for name in ("row_update_bf16_rn", "row_finalize_bf16_rn"):
        counts[name] = nearest[name]
    log(f"quality phase done in {time.perf_counter() - t0:.1f}s")

    rows += serve_rows
    rows.append(stream_row)
    for r in rows:
        r["launches"] = counts[r["name"]]
    # stream_scale is a probe on no path the package runs: phase 3 reads 0
    missing = [r["name"] for r in rows if r["name"] != "stream_scale" and not r["launches"]]
    if missing:
        raise SystemExit(f"kernels not launched on their main path: {missing}")

    print(json.dumps({"serving_kernel_shapes": serve_shapes}))
    print(json.dumps({"probes": probes}))
    print(json.dumps({"table_widths": widths}))
    print(smi)
    print(json.dumps({"kernels": rows}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
