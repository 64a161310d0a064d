#!/usr/bin/env python3
"""GPU smoke run of the PyTorch port (``gene2vec_tpu_torch``) on one card.

    python3 chip_smoke.py            # from the root of a checkout

Phases, each of which exits non-zero on failure (nothing is caught):

1. device and build — prints the card's name and power limit, builds the
   step kernels (K1-K4) and the serving kernels (K7, K8, K9, K9r) from
   ``gene2vec_tpu_torch/kernels/csrc`` with nvcc for sm_90a, one compiler
   per source, all at once;
2. kernel check — each kernel at the default configuration's shapes
   (E = 8192 examples, D = 200, V = 24,447, H = 256, S = 512, 32 groups)
   against its plain PyTorch version on the same card and inputs, within
   the stated tolerance; times the kernel, the plain version and, where
   one PyTorch call computes the same function, that call (CUDA events,
   median of repeats, L2 flushed before each); one whole step on the
   card against the plain step on the CPU, at a small ragged shape and
   at full width; and a profiled window of
   full-width steps (device busy time by kernel, idle share; Chrome trace
   to ``chip_smoke_profile/``); the serving kernels at serving width
   (V = 24,447, D = 200, B in {1, 64}, kb in {16, 512}, rb = 4 kb, the
   default IVF geometry) against their plain versions — K7/K9r ids exact
   except stated near-ties and scores within 1e-6, K8/K9 approximate
   scores bitwise — and K9r's row gather at the Pallas gather probes'
   shapes against ``table[idx]``;
3. training at full width — a Zipf pair corpus (V = 24,447, 4,000,000
   pairs) written as pair files and trained through the CLI with the
   default configuration for 3 iterations: the loss must be finite and
   falling, every export must verify, and every kernel must have launched
   once per step of the run;
4. quality — the planted-cluster corpus (10 cliques of 20 genes) must
   separate (intra-cluster cosine > 0.95, inter-cluster < 0.6);
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
JSON object ``{"kernels": [...]}`` (launches: the training run's for
K1-K4, the three servers' for K7-K9r) and the result line
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


def bound(bytes_moved: float, flops: float, int8_ops: float = 0.0):
    """(ms, "bytes" | "operations"): the larger of the bytes over the HBM
    rate and the operations over the peak rate for their type."""
    t_bytes = bytes_moved / HBM_BYTES_PER_S
    t_ops = flops / F32_FLOP_PER_S + int8_ops / INT8_OP_PER_S
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations")


REL_TOL = 2e-5     # kernel vs plain: float32 sums in another order, atomics
TABLE_ATOL = 2e-6  # updated tables, the one-step bar of the parity tests


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


def kernel_check(torch, reps: int):
    from gene2vec_tpu_torch.data.negative_sampling import build_stratified_spec
    from gene2vec_tpu_torch.kernels import noise_head, noise_tail, pos_logit, row_update

    dev = torch.device(DEVICE)
    rng = np.random.RandomState(0)
    counts = np.bincount(zipf_ids(rng, 8_000_000, V), minlength=V) + 1
    counts = np.sort(counts)[::-1].copy()
    spec = build_stratified_spec(counts, HEAD, BLOCK, 0.75, device=dev)
    gen = torch.Generator().manual_seed(0)
    emb = (torch.randn((V, D), generator=gen) * 0.1).to(dev)
    ctx = (torch.randn((V, D), generator=gen) * 0.1).to(dev)
    c_ids, x_ids = zipf_ids(rng, E, V), zipf_ids(rng, E, V)
    centers, contexts = torch.from_numpy(c_ids).to(dev), torch.from_numpy(x_ids).to(dev)
    g = E // GROUP
    blk = rng.randint(0, spec.nb, g).astype(np.int32)
    blk[0], blk[2] = spec.nb - 1, blk[1]  # the clamped last block; a repeat
    blocks = torch.from_numpy(blk).to(dev)
    lr = 0.0125
    timer = Timer(torch, reps)
    rows = []

    def row(name, fn_src, replaces, err, t_k, t_p, t_lib, bytes_moved, flops):
        b_ms, b_by = bound(bytes_moved, flops)
        rows.append({
            "name": name, "route": "cuda",
            "source": f"gene2vec_tpu_torch/kernels/csrc/{fn_src}",
            "replaces": replaces, "launches": None, "max_abs_err": err,
            "ms": t_k, "plain_ms": t_p, "bound_ms": b_ms, "bound_by": b_by,
            "library_ms": t_lib,
            "tolerance": f"{REL_TOL:g} x per-row / per-element |plain|; tables {TABLE_ATOL:g}",
        })
        log(f"{name}: max_abs_err {err:.3e}, kernel {t_k:.4f} ms, plain "
            f"{t_p:.4f} ms, library {t_lib} ms, bound {b_ms:.4f} ms ({b_by})")

    # K1
    got = pos_logit.pos_logit(emb, ctx, centers, contexts)
    want = pos_logit.pos_logit_plain(emb, ctx, centers, contexts)
    torch.cuda.synchronize()
    err = compare("K1", [(lbl, g, w, "max") for lbl, g, w in
                         zip(("v", "u", "g_pos", "loss_pos"), got, want)])
    row("pos_logit", "k1_pos_logit.cu", "gene2vec_tpu/sgns/step.py:705",
        err, timer(lambda: pos_logit.pos_logit(emb, ctx, centers, contexts)),
        timer(lambda: pos_logit.pos_logit_plain(emb, ctx, centers, contexts)),
        None, 4 * (2 * E + 2 * E * D + 2 * E * D + 2 * E), 2 * E * D)
    v, u, g_pos, _ = want

    # K2 (into a zeroed accumulator, as in the step)
    acc0 = torch.zeros((V, D + 1), device=dev)
    a_k, a_p = acc0.clone(), acc0.clone()
    dk, lk = noise_head.noise_head(v, u, g_pos, contexts, ctx, spec.q, HEAD, K, a_k)
    dp, lp = noise_head.noise_head_plain(v, u, g_pos, contexts, ctx, spec.q, HEAD, K, a_p)
    torch.cuda.synchronize()
    err = compare("K2", [("d_center", dk, dp, "rows"), ("loss_head", lk, lp, "elems")]
                  + acc_outputs("acc_ctx", a_k, a_p, D))
    a_t = acc0.clone()
    row("noise_head", "k2_noise_head.cu", "gene2vec_tpu/sgns/step.py:736",
        err,
        timer(lambda: noise_head.noise_head(v, u, g_pos, contexts, ctx, spec.q, HEAD, K, a_t)),
        timer(lambda: noise_head.noise_head_plain(v, u, g_pos, contexts, ctx, spec.q, HEAD, K, a_t)),
        None,
        4 * (2 * E * D + 3 * E + HEAD * D + HEAD + 2 * HEAD * (D + 1) + E * D),
        3 * 2 * E * HEAD * D)

    # K3
    d_k, d_p = dp.clone(), dp.clone()
    a_k, a_p = a_p.clone(), a_p.clone()
    lk = noise_tail.noise_tail(v, contexts, ctx, spec.tail_w, blocks, spec.head,
                               spec.block, GROUP, K, d_k, a_k)
    lp = noise_tail.noise_tail_plain(v, contexts, ctx, spec.tail_w, blocks, spec.head,
                                     spec.block, GROUP, K, d_p, a_p)
    torch.cuda.synchronize()
    err = compare("K3", [("loss_tail", lk, lp, "elems"), ("d_center", d_k, d_p, "rows")]
                  + acc_outputs("acc_ctx", a_k, a_p, D))
    starts = np.minimum(spec.head + blk.astype(np.int64) * spec.block, V - spec.block)
    block_rows = set(itertools.chain.from_iterable(range(s, s + spec.block) for s in starts))
    distinct = len(block_rows)
    d_t, a_t = dp.clone(), a_p.clone()
    row("noise_tail", "k3_noise_tail.cu", "gene2vec_tpu/sgns/step.py:748",
        err,
        timer(lambda: noise_tail.noise_tail(v, contexts, ctx, spec.tail_w, blocks, spec.head,
                                            spec.block, GROUP, K, d_t, a_t)),
        timer(lambda: noise_tail.noise_tail_plain(v, contexts, ctx, spec.tail_w, blocks,
                                                  spec.head, spec.block, GROUP, K, d_t, a_t)),
        None,
        4 * (E * D + E + g + distinct * D + distinct + 2 * E * D
             + 2 * distinct * (D + 1) + E),
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
    ins = [emb.clone(), ctx.clone(), acc_emb.clone(), acc_ctx.clone()]
    ref = [emb.clone(), ctx.clone(), acc_emb.clone(), acc_ctx.clone()]
    row_update.row_update(*ins, centers, contexts, d_center, v, g_pos, lr, "capped")
    row_update.row_update_plain(*ref, centers, contexts, d_center, v, g_pos, lr, "capped")
    torch.cuda.synchronize()
    err = compare("K4", [("emb", ins[0], ref[0], "abs"), ("ctx", ins[1], ref[1], "abs")]
                  + acc_outputs("acc_emb", ins[2], ref[2], D)
                  + acc_outputs("acc_ctx", ins[3], ref[3], D))
    t_in = [emb.clone(), ctx.clone(), acc_emb.clone(), acc_ctx.clone()]
    both = torch.zeros((2 * V, D + 1), device=dev)
    idx = torch.cat([centers, contexts + V]).long()
    ones = torch.ones((E, 1), device=dev)
    payload = torch.cat([torch.cat([d_center, ones], 1),
                         torch.cat([g_pos[:, None] * v, ones], 1)])
    row("row_update", "k4_row_update.cu", "gene2vec_tpu/sgns/step.py:229",
        err,
        timer(lambda: row_update.row_update(*t_in, centers, contexts, d_center, v, g_pos,
                                            lr, "capped")),
        timer(lambda: row_update.row_update_plain(*t_in, centers, contexts, d_center, v,
                                                  g_pos, lr, "capped")),
        timer(lambda: both.index_add_(0, idx, payload)),
        4 * (2 * E + 2 * E * D + E + (emb_rows + ctx_rows) * (D + 1 + 2 * D)),
        2 * E * (D + 1) + 3 * D * (emb_rows + ctx_rows))
    log(f"row_update touches {emb_rows} emb rows and {ctx_rows} ctx rows of {V}")
    return rows


# -- phase 2b: the serving kernels against their plain versions ----------------

SERVE_BATCHES = (1, 64)      # one query; a full batch bucket (max_batch)
SERVE_KBS = (16, 512)        # k-buckets of k = 10 and k = 256 (+1: the self-hit)
RESCORE_MULT = 4             # the server's default rb = 4 kb
SERVE_TOL = 1e-6             # K7/K9r scores against their plain versions
MAIN_SHAPE = (64, 16)        # (B, kb) whose times the kernels line carries
#: (rows, D, E, dtype) of the Pallas row-gather probes
#: (experiments/test_pallas_gather.py, experiments/test_dma2.py)
GATHER_PROBES = (
    (32768, 256, 32768, "float32"), (32768, 256, 32768, "bfloat16"),
    (24576, 256, 8192, "float32"), (24576, 256, 32768, "float32"),
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
    cent = rng.randn(600, D).astype(np.float32)
    x = cent[rng.randint(0, 600, V)] + 0.5 * rng.randn(V, D).astype(np.float32)
    unit_np = (x / np.linalg.norm(x, axis=1, keepdims=True)).astype(np.float32)
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
    for rows, d, e, dtype in GATHER_PROBES:
        table = torch.randn((rows, d), device=dev, generator=gen).to(getattr(torch, dtype))
        idx = torch.randint(0, rows, (e,), device=dev, generator=gen, dtype=torch.int32)
        idx_l = idx.long()
        got = rescore.row_gather(table, idx)
        torch.cuda.synchronize()
        if not torch.equal(got, table[idx_l]):
            raise SystemExit(f"row_gather ({rows}, {d}) {dtype} E {e}: differs from table[idx]")
        row_bytes = d * table.element_size()
        distinct = int(torch.unique(idx).numel())
        b_ms, b_by = bound(4 * e + (distinct + e) * row_bytes, 0.0)
        rec = {"name": "row_gather", "table": [rows, d], "dtype": dtype, "E": e,
               "max_abs_err": 0.0, "ms": timer(lambda: rescore.row_gather(table, idx)),
               "plain_ms": timer(lambda: rescore.row_gather_plain(table, idx)),
               "library_ms": timer(lambda: torch.index_select(table, 0, idx_l)),
               "bound_ms": b_ms, "bound_by": b_by}
        out.append(rec)
        log(f"row_gather ({rows}, {d}) {dtype} E {e}: kernel {rec['ms']:.4f} ms, plain "
            f"{rec['plain_ms']:.4f} ms, index_select {rec['library_ms']:.4f} ms, bound "
            f"{b_ms:.4f} ms ({b_by})")
    return out


def step_parity(torch, v, d, b, head, block, group, full_tables):
    """One whole step on the card (kernels) against the plain step on the
    CPU, same inputs: loss within rtol 1e-5, tables within TABLE_ATOL.
    ``full_tables`` starts from random (V, D) tables, as mid-training;
    otherwise from the initial emb with ctx = 3 emb."""
    from gene2vec_tpu_torch.data.negative_sampling import build_stratified_spec
    from gene2vec_tpu_torch.sgns.model import SGNSParams, init_params_numpy
    from gene2vec_tpu_torch.sgns.step import sgns_step

    rng = np.random.RandomState(3)
    pairs = np.stack([zipf_ids(rng, b, v), zipf_ids(rng, b, v)], 1)
    counts = np.sort(np.bincount(pairs.reshape(-1), minlength=v) + 1)[::-1].copy()
    gen = torch.Generator().manual_seed(3)
    tables = (torch.randn((v, d), generator=gen) * 0.1,
              torch.randn((v, d), generator=gen) * 0.1)
    out = {}
    for dev in ("cpu", "cuda"):
        spec = build_stratified_spec(counts, head, block, 0.75, device=dev)
        if full_tables:
            # a copy on each device: the step updates its tables in place
            p = SGNSParams(tables[0].to(dev, copy=True), tables[1].to(dev, copy=True))
        else:
            p = init_params_numpy(0, v, d, device=dev)
            p.ctx.copy_(p.emb * 3.0)
        blk = np.random.RandomState(4).randint(0, spec.nb, 2 * b // group)
        blk[0], blk[2] = spec.nb - 1, blk[1]  # the clamped last block; a repeat
        blocks = torch.from_numpy(blk.astype(np.int32)).to(dev)
        p, loss = sgns_step(p, torch.from_numpy(pairs).to(dev), 0.025, stratified=spec,
                            blocks=blocks, strat_group=group)
        out[dev] = (float(loss), p.emb.cpu(), p.ctx.cpu())
    (lc, ec, cc), (lg, eg, cg) = out["cpu"], out["cuda"]
    errs = (abs(lc - lg) / abs(lc), float((ec - eg).abs().max()), float((cc - cg).abs().max()))
    log(f"whole-step parity card vs CPU (V {v}, D {d}, E {2 * b}): loss rel "
        f"{errs[0]:.2e}, emb {errs[1]:.2e}, ctx {errs[2]:.2e}")
    if not (errs[0] <= 1e-5 and errs[1] <= TABLE_ATOL and errs[2] <= TABLE_ATOL):
        raise SystemExit(f"whole-step parity failed at V {v}, D {d}: {errs}")


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
    expected = (NUM_PAIRS // B) * ITERS
    counts = {n: counts[n] for n in STEP_KERNELS}
    if any(n != expected for n in counts.values()):
        raise SystemExit(f"launch counts {counts} != num_batches x iterations = {expected}")
    log(f"training ({smi}): losses {losses}, pairs/s per iteration "
        f"{rates}, launches {counts}")
    return counts


# -- phase 4: planted clusters -------------------------------------------------


def planted_quality(torch):
    """eval/planted.py's recipe and metric (10 cliques x 20 genes, 2000
    pairs each) with the reference bench's settings (dim 64, batch 1024,
    15 epochs)."""
    from gene2vec_tpu_torch.config import SGNSConfig
    from gene2vec_tpu_torch.data.pipeline import PairCorpus
    from gene2vec_tpu_torch.io.vocab import Vocab
    from gene2vec_tpu_torch.sgns.train import SGNSTrainer, epoch_generator

    rng = np.random.RandomState(0)
    lines = []
    for c in range(10):
        genes = [f"C{c}G{i}" for i in range(20)]
        for _ in range(2000):
            a, b = rng.choice(20, 2, replace=False)
            lines.append((genes[a], genes[b]))
    vocab = Vocab.from_pairs(lines)
    cfg = SGNSConfig(dim=64, batch_pairs=1024, num_iters=15)
    tr = SGNSTrainer(PairCorpus(vocab, vocab.encode_pairs(lines)), cfg, device=DEVICE)
    params = tr.init()
    for it in range(1, 16):
        params, loss = tr.train_epoch(params, generator=epoch_generator(cfg.seed, it))
    emb = params.emb.cpu().numpy()
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
    log(f"planted clusters: intra {intra:.4f} (> 0.95), inter {inter:.4f} (< 0.6), "
        f"last loss {float(loss):.4f}")
    if not (intra > 0.95 and inter < 0.6):
        raise SystemExit(f"planted clusters did not separate: {intra}, {inter}")


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


def profile_steps(torch, steps: int, out_dir: str, smi: str):
    """Epochs of ``steps`` full-width training steps: one unprofiled, one
    under torch.profiler — device busy time by kernel, host wall per step
    and the device idle share (1 - busy/wall).  The Chrome trace lands in
    ``out_dir``."""
    from torch.profiler import ProfilerActivity, profile

    from gene2vec_tpu_torch.config import SGNSConfig
    from gene2vec_tpu_torch.data.pipeline import PairCorpus
    from gene2vec_tpu_torch.io.vocab import Vocab
    from gene2vec_tpu_torch.sgns.train import SGNSTrainer, epoch_generator

    rng = np.random.RandomState(0)
    pairs = np.stack([zipf_ids(rng, steps * B, V), zipf_ids(rng, steps * B, V)], 1)
    counts = np.bincount(pairs.reshape(-1), minlength=V) + 1
    vocab = Vocab([f"G{i}" for i in range(V)], counts)
    tr = SGNSTrainer(PairCorpus(vocab, pairs), SGNSConfig(), device=DEVICE)
    params = tr.init()
    params, loss = tr.train_epoch(params, generator=epoch_generator(1, 0))
    float(loss)  # warm-up epoch
    t0 = time.perf_counter()
    params, loss = tr.train_epoch(params, generator=epoch_generator(1, 1))
    float(loss)
    wall_plain = time.perf_counter() - t0
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        params, loss = tr.train_epoch(params, generator=epoch_generator(1, 2))
        float(loss)
        wall_prof = time.perf_counter() - t0
    os.makedirs(out_dir, exist_ok=True)
    prof.export_chrome_trace(os.path.join(out_dir, "train_steps_trace.json"))
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
    log(f"profile ({smi}): {n} steps; unprofiled epoch "
        f"{wall_plain * 1e3 / n:.4f} ms/step ({n * B / wall_plain:.0f} pairs/s); "
        f"profiled epoch {wall_prof * 1e3 / n:.4f} ms/step; device busy "
        f"{busy / n:.4f} ms/step; idle share {1 - busy / (wall_plain * 1e3):.4f} "
        f"of the unprofiled epoch, {1 - busy / (wall_prof * 1e3):.4f} of the profiled")
    for name, ms in sorted(by_name.items(), key=lambda kv: -kv[1])[:12]:
        log(f"  {ms / n:9.4f} ms/step  {name[:90]}")


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
    log(f"kernel check done in {time.perf_counter() - t0:.1f}s")
    t0 = time.perf_counter()
    serve_rows, serve_shapes = serving_kernel_check(torch, TIMED_REPS)
    probes = gather_probes(torch, TIMED_REPS)
    log(f"serving kernel check done in {time.perf_counter() - t0:.1f}s")
    profile_steps(torch, PROFILED_STEPS, os.path.join(os.getcwd(), "chip_smoke_profile"),
                  smi)

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
    rows += serve_rows
    for r in rows:
        r["launches"] = counts[r["name"]]

    t0 = time.perf_counter()
    planted_quality(torch)
    log(f"quality phase done in {time.perf_counter() - t0:.1f}s")

    print(json.dumps({"serving_kernel_shapes": serve_shapes}))
    print(json.dumps({"row_gather_probes": probes}))
    print(smi)
    print(json.dumps({"kernels": rows}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
