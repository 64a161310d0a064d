#!/usr/bin/env python3
"""GPU smoke run of the PyTorch port (``gene2vec_tpu_torch``) on one card.

    python3 chip_smoke.py            # from the root of a checkout

Phases, each of which exits non-zero on failure (nothing is caught):

1. device and build — prints the card's name and power limit, builds the
   step kernels (K1-K4) from ``gene2vec_tpu_torch/kernels/csrc`` with nvcc
   for sm_90a, one compiler per source, all at once;
2. kernel check — each kernel at the default configuration's shapes
   (E = 8192 examples, D = 200, V = 24,447, H = 256, S = 512, 32 groups)
   against its plain PyTorch version on the same card and inputs, within
   the stated tolerance; times the kernel, the plain version and, where
   one PyTorch call computes the same function, that call (CUDA events,
   median of repeats, L2 flushed before each); one whole step on the
   card against the plain step on the CPU, at a small ragged shape and
   at full width; and a profiled window of
   full-width steps (device busy time by kernel, idle share; Chrome trace
   to ``chip_smoke_profile/``);
3. training at full width — a Zipf pair corpus (V = 24,447, 4,000,000
   pairs) written as pair files and trained through the CLI with the
   default configuration for 3 iterations: the loss must be finite and
   falling, every export must verify, and every kernel must have launched
   once per step of the run;
4. quality — the planted-cluster corpus (10 cliques of 20 genes) must
   separate (intra-cluster cosine > 0.95, inter-cluster < 0.6).

The last lines are the card's ``nvidia-smi`` name and power limit, one
JSON object ``{"kernels": [...]}`` and the result line
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

V, D, B, K = 24447, 200, 4096, 5
E = 2 * B
HEAD, BLOCK, GROUP = 256, 512, 256
NUM_PAIRS, ITERS = 4_000_000, 3
DEVICE = "cuda"
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


def bound(bytes_moved: float, flops: float):
    t_bytes = bytes_moved / HBM_BYTES_PER_S
    t_ops = flops / F32_FLOP_PER_S
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
    profile_steps(torch, PROFILED_STEPS, os.path.join(os.getcwd(), "chip_smoke_profile"),
                  smi)

    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory(prefix="chip_smoke_", dir=os.getcwd()) as work:
        counts = train_full_width(torch, work, smi)
    log(f"training phase done in {time.perf_counter() - t0:.1f}s")
    for r in rows:
        r["launches"] = counts[r["name"]]

    t0 = time.perf_counter()
    planted_quality(torch)
    log(f"quality phase done in {time.perf_counter() - t0:.1f}s")

    print(smi)
    print(json.dumps({"kernels": rows}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
