#!/usr/bin/env python3
"""GPU smoke run of the PyTorch port (``gene2vec_tpu_torch``) on one card.

    python3 chip_smoke.py            # from the root of a checkout
    python3 chip_smoke.py --compare PARENT CHANGE CHANGE PARENT
                                     # each checkout's own K1-K6 checks, the row
                                     # gather, step windows (default, HS, shared,
                                     # per_example), the K12, K13 and K14 probes,
                                     # phase 3 run and K10c / K10 (each by launch),
                                     # cli.tsne and K11, K15, K16 and cli.plot,
                                     # in turns
    python3 chip_smoke.py --compare --parts umap PARENT CHANGE CHANGE PARENT
                                     # K15, K16 and cli.plot alone
    python3 chip_smoke.py --resilience
                                     # the build, then phase 8 alone
    python3 chip_smoke.py --fleet    # the build, then phase 9 alone

Phases, each of which exits non-zero on failure (nothing is caught):

1. device and build — prints the card's name and power limit, builds the
   training kernels (K1-K6), the serving kernels (K7, K8, K9, K9r), the
   pipeline's K10c, K10, K11, K15 and K16 and the Pallas probes'
   counterparts K12-K14 from
   ``gene2vec_tpu_torch/kernels/csrc`` with nvcc for sm_90a, one compiler
   per source, all at once;
2. kernel check — each kernel at the default configuration's shapes
   (E = 8192 examples, D = 200, V = 24,447, H = 256, S = 512, 32 groups)
   against its plain PyTorch version on the same card and inputs, within
   the stated tolerance; times the kernel, the plain version and, where
   the shortest sequence of PyTorch library calls that computes the same
   function (checked against the plain version; CUDA events, median of
   repeats, L2 flushed before each) — K2 and K3 (3xTF32 tensor cores,
   two launches a call) must each be no slower than their library
   sequence, their factors beside run 6D's on the ``{"redesign": ...}``
   line; one whole step on the
   card against the plain step on the CPU, at a small ragged shape and
   at full width; then the other objectives' kernels at the same width —
   K5a (per-example draws), K5b (the auto-sized shared pool, G = 256,
   P/G = 128; 3xTF32 tensor cores), K6 (hierarchical softmax at
   hs_dense_depth 10, every path entry: its device ms by launch in the
   row's ``device_ms``, its time at each count of shared-memory levels
   on a ``{"hs_hot_levels": ...}`` line) and K4's generic scatter and
   finalize — and one whole step of
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
   on a ``{"table_widths": ...}`` line), then windows of the per_example,
   shared, sg_hs and cbow_hs steps (``{"objective_windows": ...}``); K12 ``stream_scale`` at the streaming
   probe's 25, 100 and 400 MB (bitwise; GB/s beside ``torch.mul``); the serving kernels
   at serving width (V = 24,447, D = 200, B in {1, 64}, kb in {16, 512},
   rb = 4 kb, the default IVF geometry) against their plain versions —
   K7/K9r ids exact except stated near-ties and scores within 1e-6,
   K8/K9 approximate scores bitwise, with K7's and K8's time over their
   library sequences' beside run 5D's (a ``{"redesign": ...}`` line), K7-
   K9r's and their library sequences' device time and K7-K9r's launches
   by kernel at MAIN_SHAPE (torch.profiler; the kernels line's
   ``device_ms``) and each shape's route (``_topk`` plans) —
   then tie-heavy tables (duplicated rows straddling every keep-th place,
   a zero row, rows past ``valid`` at -inf; B in {1, 3, 64}, kb in {1, 16,
   512}) through K7, K8 (int8 and bf16), K9 and K9r, bitwise where the
   scores are — K8 and K9 on a bf16 index (B in
   {1, 64}, kb = 16; scores within 1e-6, near-ties counted; each timed
   beside its library sequence), K8 at
   B = 64, rb = 16,384 (bitwise), and K9r's row gather at the Pallas
   gather probes' shapes and the GGIPNN lookup's against ``table[idx]``;
   (2g) tables of D = 1,024 (past every narrow tile's limit): one whole
   step of the default stratified mode, per_example, shared, sg_hs and
   cbow_hs at V = 3,001 card vs CPU, float32 and bfloat16 with SR; those
   five steps at full vocabulary in short profiled windows (a
   ``{"wide_windows": ...}`` line); a clustered export of that width
   served in exact, quant and ivf modes as phase 5 serves (every answer
   checked, recall gated);
   (2f) the remaining Pallas probes' counterparts at the probes' shapes —
   K12 at scales 1.0000001, 2 and 1, float32 and bfloat16, bitwise; K13's
   lane gather and scatter, bitwise (the scatter sums in its plain
   version's order); K14's staged copy at the six feature
   probes, ``callh``'s 8-row tiles and ``vmem_probe``'s 8-60 MB with its
   tile swept to the card's opt-in shared-memory limit, bitwise — each
   with GB/s in the ``{"probes": ...}`` line; then one GGIPNN Adam step
   card vs CPU at full width (V = 24,447, D = 200, B = 128, table frozen
   and trained) and ``ggipnn_pairs_per_sec`` at B = 128 and 1024 with
   the device idle share (``{"ggipnn_rate": ...}`` lines);
3. training at full width — a Zipf pair corpus (V = 24,447, 4,000,000
   pairs) written as pair files and trained through the CLI with the
   default configuration for 2 iterations: the loss must be finite and
   falling, every export must verify, and every kernel must have launched
   once per step of the run (before it, and before each run of 3b and
   3c, ``touched_step_check``: one full-width step of that configuration
   with K4's wrappers watched — every accumulator row outside the rows
   the finalize visits all +0 bits, the tables bitwise every row's plain
   finalize); then (3b) a 500,000-pair corpus trained
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
   (4b) the quality tooling as the reference bench's gate runs it:
   ``train_epochs`` over ``eval/planted.py``'s corpus at dim 64 (batch
   1,024, 15 epochs) and at D = 200, each gated on INTRA_MIN, INTER_MAX
   and the loss escaping ln 2·(1 + K) − 1; the holdout protocol
   (``eval/holdout.py``) on a reference-format split written from a seed
   (its AUC printed, the band not asserted); one ``fit_epoch`` card vs
   CPU at full width (``{"quality_tooling": ...}``).  Every CLI training
   run of phases 3-3c is also held to the reference run's records
   (``check_run_records``: the manifest's config hash and goodput block,
   one step span an iteration, metrics.prom, each checkpoint's hash);
   (4c) kernel cost attribution (``kernel_attribution``); (4d) the run
   reports (``cli/obs.py``) over 4c's records: the report's pairs/s
   against the iteration spans, the Chrome trace's phase events against
   goodput's compute bucket, ``kernels``, ``list``, ``ledger --check``
   over the repo root, and the process's library loads against the
   libraries ``build`` holds (a ``{"run_reports": ...}`` line);
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
   than the int8 scan's error.  Each server's ``jit_compile_events_total``
   is read after the bucket requests and again at the end: equal, and
   above 0.  QPS and p50/p99 latency per export and
   mode go to ``{"serving": ...}`` lines.  It runs right after phase 3;
6. GGIPNN over the clustered export — a predictionData/ directory
   (262,144 / 16,384 / 32,768 pairs, half within one group, half random)
   trained through ``python -m gene2vec_tpu_torch.cli.ggipnn`` in process:
   the default (frozen table) at B = 128 and 1024 for 2 epochs, then
   ``--embed-train --run-dir`` (the step loop, checkpoints); the loss
   falls, the default run's test AUC reaches GG_AUC_FLOOR and
   ``row_gather`` launches once per forward pass (``{"ggipnn": ...}``
   lines); then the run's last checkpoint behind ``/v1/interaction`` of
   ``cli/serve.py``: 400 requests of 1-64 pairs from 16 clients, every
   score within 1e-5 of the host's CPU forward, ``trained_head`` true, an
   unknown gene 400, QPS and p50/p99 on a ``{"serving": ...}`` line.
7. the paper's pipeline — (7a) a GEO-style query directory made from a
   seed (26,000 ``ENSEMBL|SYMBOL`` genes, of which V = 24,447 survive the
   count filter and the symbol annotation; studies of 12 (dropped), 24,
   64 and 160 samples; 400 planted modules of 12 genes; 40 pairs a study
   planted at |corr| = 0.9) through ``python -m
   gene2vec_tpu_torch.cli.generate_pairs`` in process, serial and
   ``--parallel --num-workers 2`` (equal lines, K11 once per kept study);
   per study K11 against its plain version and the float64 product on the
   card (``k11_check``: bits may differ only within EPS_N = (n + 2)·2⁻²⁴
   of the threshold, counted; on the 24-sample study also at threshold
   0.3, where random pairs are dense) and the CLI's lines against the
   float64 oracle's; K11 and its plain version (also the library
   sequence) timed at n = 24 and 160; the host's unpack / nonzero /
   format split
   (``{"pipeline_corpus": ...}``); (7b) that corpus trained through
   ``cli.gene2vec`` for 2 iterations and scored by ``cli.evaluate``
   against a ``.gmt`` of the modules, ratio gated above 1
   (``{"pipeline_eval": ...}``); (7c) t-SNE over phase 5's clustered
   table (N = 24,447, PCA 50): K10c against its plain version (each P
   entry within K10C_RTOL) and on a (256, 60,000) slab through the
   long-row route, its two launches timed apart, the histogram of the
   bisection steps its rows took; one K10 iteration against the plain one
   from the start, 20 iterations on and 1,020 on (K10_TOL), K10's library
   sequence (``lib_tsne_step``) and its launches by kernel name; then
   ``cli.tsne --iters 250 1000``: files and labels complete, groups
   separated (inter over intra mean distance past TSNE_SEP), K10c's two
   launches and one K10 launch an iteration, ms an iteration beside P's
   bytes bound (``{"pipeline_tsne": ...}``); (7d) UMAP over the same table
   (PCA 50, k = 15): K15 against its plain version (``k15_check``: the same
   neighbours, weights within K15_ATOL, the sparse graph bitwise the plain
   union of the kernel's lists, densified only on the plain side), K16 on
   that graph against the plain iteration from
   ``viz.umap.start`` and from 200 kernel iterations on, the fast kernel
   and ``fast_kernel=False`` (``k16_check``: y′ within K16_TOL of its
   force's terms, clip flips and clipped coordinates counted), each beside
   its plain version and library sequence (the dense sequences, P
   densified outside the timed window); then ``cli.plot`` (where
   neither plotly nor matplotlib is installed it writes the json alone
   and logs that no image was drawn): the json holds every
   gene once with finite coordinates, the groups separate past UMAP_SEP,
   K15's five launches and one K16 launch an iteration
   (``{"pipeline_umap": ...}``).
8. resilience (run right after phase 1's build, before phase 2) — the
   port's CLIs as child processes through ``resilience/chaos.py``, on the
   card: a Zipf corpus (phase 3's recipe,
   1,000,000 pairs at V = 24,447) trained by ``cli.gene2vec`` at the
   default config for 4 iterations without the text export, (a) twice
   uninterrupted (the pair's gap is the card's run-to-run floor: K4 sums
   with float atomics), (b) SIGKILLed at "iteration 2 done" with
   ``--async-checkpoint`` (the newest verified iteration at most 2, its npz
   unchanged by the rerun, temp files ignored) and rerun, (c) SIGTERMed at
   "iteration 1 done" with ``--async-checkpoint`` (exit 113, the manifest
   ``interrupted`` with ``completed_iteration``, goodput's ``preempted``
   bucket above 0, the drained iterations verifying) and resumed — each
   resumed run within RESUME_BAR of the first uninterrupted run's largest
   |emb| and RESUME_LOSS_RTOL of its losses, every iteration verifying;
   (d) ``--objective cbow_hs`` SIGTERMed after iteration 1 and resumed;
   (e) ``cli.ggipnn --embed-train --run-dir`` over phase 6's clustered data
   SIGTERMed at its first ``step N:`` line (exit 113, the run manifest
   ``interrupted``, a checkpoint at the drained step, no test AUC); (f) the
   second uninterrupted export truncated, then a manifest CRC corrupted:
   discovery falls back each time; (g) ``SGNSTrainer.run`` in process sync
   then async at the budget's geometry (``obs/budgets.json``
   ``resilience.async_ckpt``: checkpoint spans under 0.02 of the iteration
   spans, gated) and at full width (reported, with pairs/s), each beside
   async with the disk half on the writer thread (the reference's design,
   ``thread_checkpoint``, reported only), in a fresh child process as a
   training run has one, before the drills write their exports; (h) an
   exact
   server with ``--faults FAULT_SPEC`` beside an unfaulted one: 64
   sequential ``GET /v1/similar`` statuses equal a CPU ``FaultInjector``'s
   prediction, ``serve_fault_error_total`` matches, ``/healthz`` stays
   clean and every clean answer is the unfaulted server's.  The children's
   launches come from their ``metrics.prom`` (``kernel_launches_total``)
   and the server's ``/metrics``; each of K1-K4, K6, ``row_gather`` and K7
   must have launched (``{"resilience": ...}`` line).
9. the serving fleet (run right after phase 8) — ``cli.fleet`` over a
   clustered full-width export (``write_clustered_export``, 24,447 × 200)
   with 3 replicas of ``cli.serve`` on the card, in two drills modelled on
   ``scripts/chaos_drill.py``.  (a) The fleet drill: replica 1 injects
   latency, 503s, resets and blackholes; FLEET_LOAD_S of closed-loop load
   from 4 workers through the port's ``ResilientClient``, replica 0
   SIGKILLed a third of the way in; gated at ``fleet.chaos``'s numbers
   (availability >= 0.99, no wrong answer — ids the host oracle's except
   near-ties, scores within SCORE_TOL — none mixing iterations, retry
   amplification <= 1.5), the supervisor's restart, ``/metrics/fleet``'s
   growth equal to the live replicas' own ``serve_requests_total`` and a
   trace reassembled from ``proxy_request`` through two or more
   ``client_attempt`` spans down to ``engine_topk``.  (b) The alerts drill:
   the default rules at a 0.25 s scrape, a clean warmup firing nothing, a
   byzantine replica (404s and latency) firing the availability burn-rate
   rule within 20 s, and the incident bundle verifying through ``python -m
   gene2vec_tpu_torch.cli.obs incident`` with a trace through the faulty
   replica's pid.  K7's launches are read from each live replica's
   ``kernel_launches_total`` before shutdown (a SIGKILLed replica's count
   is lost with it); one ``{"fleet": ...}`` line.

The last lines are the card's ``nvidia-smi`` name and power limit, one
JSON object ``{"kernels": [...]}`` (launches: phase 3's training run's
and phase 4b's for K1-K4, phase 3b's runs' for K5a, K5b, K6 and K4's generic entry
points ``row_scatter`` / ``row_finalize``, phase 3c's for the ``_bf16``
rows, phase 4's nearest-even runs' for ``_bf16_rn``, the servers' for
K7-K9r, phase 6's CLI runs and interaction server and phase 4b's
``fit_epoch`` for ``row_gather``,
phase 7's ``generate_pairs`` runs for K11, its ``cli.tsne`` run for
K10c and K10 and its ``cli.plot`` run for K15 and K16, and beside those
phase 8's for K1-K4, K6, K4's generic entry points, ``row_gather`` and K7,
and phase 9's live replicas' for K7;
the probes' counterparts in PROBE_ROWS phase 3's, 0: they are on no
path; the script fails if any other kernel launched no time on its path)
and the result line
``{"ok": true, "device": {...}}``; before them ``{"touched_rows": ...}``
(the rows each of K4's finalizes visited, and their share) and
``{"redesign": ...}`` (K2/K3's, K4's and the row gather's times over
their library calls, the Timer's floor).  Without a CUDA device the script exits
with code 2 and prints no result.
"""

from __future__ import annotations

import csv
import json
import os
import statistics
import subprocess
import sys
import tempfile
import time

import numpy as np

# Every bound comes from the kernel modules' ``work`` counts through
# ``gene2vec_tpu_torch/obs/profiler.py:bound`` (the H100's data-sheet rates
# live there), imported where used: ``--compare`` loads this file beside
# older trees' packages.

V, D, B, K = 24447, 200, 4096, 5
E = 2 * B
HEAD, BLOCK, GROUP = 256, 512, 256
NUM_PAIRS, ITERS = 4_000_000, 2
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


REL_TOL = 2e-5     # kernel vs plain: float32 sums in another order, atomics
TABLE_ATOL = 2e-6  # updated tables, the one-step bar of the parity tests
ULP_SHARE = 1e-3   # bf16 tables: touched elements one ulp from the plain version
F32_ULPS = 4       # bf16 tables: float32 ulps of new = t − lr·update apart, at most,
TABLE_ULPS = 80    # ... plus these of the table's largest |t − new| (compare_bf16_tables):
#                    twice the CPU's own float32 step's distance from a float64 one
#                    (tests/test_torch_wide.py::test_float32_step_error_model)


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


def same_bits(torch, got, want) -> bool:
    """Bitwise equality of two float32 or bfloat16 tensors."""
    return got.dtype == want.dtype and torch.equal(
        got.view(torch.int16), want.view(torch.int16))


def bf16_ulp(torch, t):
    """One bfloat16 ulp at each |t| (8 significant bits), as float32."""
    _, e = torch.frexp(t.float().abs())
    return torch.ldexp(torch.ones_like(t, dtype=torch.float32), e - 8)


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


def row_bar_share(torch, got, want) -> float:
    """The largest of each row's max |got − want| over its "rows" bar
    (REL_TOL × the row's max |want|): at most 1 where ``compare`` passes
    (an all-zero row: 0 when equal, inf otherwise)."""
    err = (got - want).abs().reshape(got.shape[0], -1).amax(1)
    bar = REL_TOL * want.abs().reshape(want.shape[0], -1).amax(1)
    share = torch.where(bar > 0, err / torch.where(bar > 0, bar, torch.ones_like(bar)),
                        torch.where(err > 0, float("inf"), 0.0))
    return float(share.max())


def acc_outputs(prefix, got, want, d):
    """An accumulator's [gradient | weight] columns, held separately."""
    return [(f"{prefix}[:, :D]", got[:, :d], want[:, :d], "rows"),
            (f"{prefix}[:, D]", got[:, d], want[:, d], "elems")]


SALTS = [[0x243F6A88, 0x85A308D3], [0x13198A2E, 0x03707344]]  # fixed SR salt words
#: rows K4's finalize visits, by check: {table: [rows, share of V]} and the
#: bound that counts them (the ``{"touched_rows": ...}`` line)
TOUCHED_SHARES = {}


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
    plain version's, one bf16 ulp from it, or within the float32 error of
    new = t − lr·update (t the start, new the plain result): F32_ULPS
    float32 ulps of |t| + |t − new| (the last operations' rounding) plus
    TABLE_ULPS of the table's largest |t − new| (the update's sums over the
    batch and its gradients' sigmoids, whose error follows the magnitudes
    summed and not this element's update: near zero, where t and lr·update
    cancel, that error spans several of the result's small bf16 ulps; a
    row's own largest update undercounts it where the row's gradients are
    small, as on a Huffman tree's deep nodes) — and at most ULP_SHARE of
    the touched elements (those of rows either side changed from
    ``start``) differing at all.  Returns (max abs error, the share that
    differs)."""
    worst, share = 0.0, 0.0
    for i, (label, g, w) in enumerate(pairs):
        ulps = table_ulps(torch, g, w)
        diff = (g.float() - w.float()).abs()
        t = start[i].float()
        upd = (t - w.float()).abs()
        own = F32_ULPS * 2.0 ** -23 * (t.abs() + upd)
        scale = 2.0 ** -23 * upd.max()
        bar = own + TABLE_ULPS * scale
        far = (ulps > 1) & (diff > bar)
        if bool(far.any()):
            j = int(far.reshape(-1).nonzero()[0])
            raise SystemExit(f"{name}: {label} {int(ulps.reshape(-1)[j])} bf16 ulps "
                             f"({float(diff.reshape(-1)[j]):.3e}, float32 bar "
                             f"{float(bar.reshape(-1)[j]):.3e}) from the plain version at {j}")
        apart = ulps > 1
        if bool(apart.any()):
            # the readings: the worst element against the whole bar, against
            # its own term alone, and in float32 ulps of the table's update
            use = float((diff / bar)[apart].max())
            own_x = float((diff / own)[apart].max())
            log(f"{name}: {label} {int(apart.sum())} elements more than one ulp apart, the "
                f"worst at {use:.3f} of its bar ({own_x:.2f}x the |t| + |t - new| term alone; "
                f"{float(diff[apart].max() / scale):.1f} float32 ulps of the table's largest "
                f"update; bar {F32_ULPS} and {TABLE_ULPS} ulps)")
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


def tf32_note(row, passes):
    """A row of a kernel on the tensor cores through a 3xTF32 split (K2, K3,
    K5b): its bound is the split's passes at the TF32 rate (or the bytes);
    the float32 SIMT route's figure goes in the row's note."""
    from gene2vec_tpu_torch.obs.profiler import F32_FLOP_PER_S, TF32_FLOP_PER_S, bound

    simt = row["work"]["simt_flops"]
    row["bound_route"] = (f"TF32 passes {passes} (logits, d_center, acc) at "
                          f"{TF32_FLOP_PER_S / 1e12:g} TFLOP/s")
    row["bound_note"] = (f"float32 SIMT route: {bound({'flops': simt})[0]:.4f} ms "
                         f"({simt / 1e9:.2f} GFLOP at {F32_FLOP_PER_S / 1e12:g} TFLOP/s)")


def kernel_check(torch, reps: int, dtype=None):
    """K1-K4 at full width against their plain versions, on float32 tables
    or (``dtype`` bfloat16, phase 2e) bfloat16 ones: then K4 is timed and
    checked once per write-back, stochastic rounding (with SALTS) and
    nearest-even — its tables within one ulp of the plain version's (the
    scatter's atomics reorder the float32 sums), and bitwise when the
    finalize runs alone on identical accumulators."""
    from gene2vec_tpu_torch.data.negative_sampling import build_stratified_spec
    from gene2vec_tpu_torch.kernels import _work, noise_head, noise_tail, pos_logit, row_update
    from gene2vec_tpu_torch.obs.profiler import bound

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

    def row(name, fn_src, replaces, err, t_k, t_p, t_lib, work, tolerance=None):
        b_ms, b_by = bound(work)
        rows.append({
            "name": name, "route": "cuda",
            "source": f"gene2vec_tpu_torch/kernels/csrc/{fn_src}",
            "replaces": replaces, "launches": None, "max_abs_err": err,
            "ms": t_k, "plain_ms": t_p, "bound_ms": b_ms, "bound_by": b_by,
            "library_ms": t_lib, "work": work,
            "tolerance": tolerance or (f"{REL_TOL:g} x per-row / per-element |plain|; "
                                       f"tables {TABLE_ATOL:g}"),
        })
        log(f"{name}: max_abs_err {err:.3e}, kernel {t_k:.4f} ms, plain "
            f"{t_p:.4f} ms, library {t_lib} ms, bound {b_ms:.4f} ms ({b_by})")


    # K1
    got = pos_logit.pos_logit(emb, ctx, centers, contexts)
    want = pos_logit.pos_logit_plain(emb, ctx, centers, contexts)
    c_l, x_l = centers.long(), contexts.long()
    library_check("K1" + sfx, lib_pos_logit(torch, emb, ctx, c_l, x_l), want)
    torch.cuda.synchronize()
    err = compare("K1" + sfx, [(lbl, g, w, "max") for lbl, g, w in
                               zip(("v", "u", "g_pos", "loss_pos"), got, want)])
    row("pos_logit" + sfx, "k1_pos_logit.cu", "gene2vec_tpu/sgns/step.py:705",
        err, timer(lambda: pos_logit.pos_logit(emb, ctx, centers, contexts)),
        timer(lambda: pos_logit.pos_logit_plain(emb, ctx, centers, contexts)),
        timer(lambda: lib_pos_logit(torch, emb, ctx, c_l, x_l)),
        pos_logit.work(c_ids, x_ids, D, tb))
    v, u, g_pos, _ = want

    # K2 (into a zeroed accumulator, as in the step)
    acc0 = torch.zeros((V, D + 1), device=dev)
    a_k, a_p = acc0.clone(), acc0.clone()
    dk, lk = noise_head.noise_head(v, u, g_pos, contexts, ctx, spec.q, HEAD, K, a_k)
    dp, lp = noise_head.noise_head_plain(v, u, g_pos, contexts, ctx, spec.q, HEAD, K, a_p)
    torch.cuda.synchronize()
    err = compare("K2" + sfx, [("d_center", dk, dp, "rows"), ("loss_head", lk, lp, "elems")]
                  + acc_outputs("acc_ctx", a_k, a_p, D))
    kq = K * spec.q[:HEAD]
    a_l = acc0.clone()
    library_check("K2" + sfx, [*lib_noise_head(torch, v, u, g_pos, x_l, ctx, kq, HEAD, a_l), a_l],
                  [dp, lp, a_p])
    a_t = acc0.clone()
    row("noise_head" + sfx, "k2_noise_head.cu", "gene2vec_tpu/sgns/step.py:736",
        err,
        timer(lambda: noise_head.noise_head(v, u, g_pos, contexts, ctx, spec.q, HEAD, K, a_t)),
        timer(lambda: noise_head.noise_head_plain(v, u, g_pos, contexts, ctx, spec.q, HEAD, K, a_t)),
        timer(lambda: lib_noise_head(torch, v, u, g_pos, x_l, ctx, kq, HEAD, a_t)),
        noise_head.work(E, HEAD, D, tb))
    tf32_note(rows[-1], _work.TF32_PASSES[bf16])

    # K3
    d_k, d_p, d_l = dp.clone(), dp.clone(), dp.clone()
    a_k, a_p, a_l = a_p.clone(), a_p.clone(), a_p.clone()
    lk = noise_tail.noise_tail(v, contexts, ctx, spec.tail_w, blocks, spec.head,
                               spec.block, GROUP, K, d_k, a_k)
    lp = noise_tail.noise_tail_plain(v, contexts, ctx, spec.tail_w, blocks, spec.head,
                                     spec.block, GROUP, K, d_p, a_p)
    torch.cuda.synchronize()
    err = compare("K3" + sfx, [("loss_tail", lk, lp, "elems"), ("d_center", d_k, d_p, "rows")]
                  + acc_outputs("acc_ctx", a_k, a_p, D))
    starts_t = noise_tail.block_starts(blocks, spec.head, spec.block, spec.tail_w.shape[0])
    blk_rows = starts_t[:, None] + torch.arange(spec.block, device=dev)[None, :]
    library_check("K3" + sfx, [lib_noise_tail(torch, v, x_l, ctx, spec.tail_w, blk_rows, float(K),
                                              d_l, a_l), d_l, a_l], [lp, d_p, a_p])
    d_t, a_t = dp.clone(), a_p.clone()
    row("noise_tail" + sfx, "k3_noise_tail.cu", "gene2vec_tpu/sgns/step.py:748",
        err,
        timer(lambda: noise_tail.noise_tail(v, contexts, ctx, spec.tail_w, blocks, spec.head,
                                            spec.block, GROUP, K, d_t, a_t)),
        timer(lambda: noise_tail.noise_tail_plain(v, contexts, ctx, spec.tail_w, blocks,
                                                  spec.head, spec.block, GROUP, K, d_t, a_t)),
        timer(lambda: lib_noise_tail(torch, v, x_l, ctx, spec.tail_w, blk_rows, float(K), d_t,
                                     a_t)),
        noise_tail.work(blocks, E, spec.head, spec.block, spec.tail_w.shape[0], D, tb))
    tf32_note(rows[-1], _work.TF32_PASSES[bf16])

    # K4 (library: the whole sequence — one index_add_ of both tables'
    # [grad | 1] rows into their accumulators, then lib_finalize on each
    # table; none for stochastic rounding, which no PyTorch call does).
    # The finalize visits the rows the step touched — emb: the centers;
    # ctx: the contexts, K2's head and K3's drawn blocks — as the step
    # passes them; its bound counts those rows, each read from its
    # accumulator and read and written in its table.
    from gene2vec_tpu_torch.kernels.row_update import Touched

    ctx_set = Touched(prefix=spec.head, blocks=blocks, block=spec.block,
                      limit=spec.tail_w.shape[0])
    sets = (Touched(), ctx_set)
    alone = (Touched(ids=centers), ctx_set._replace(ids=contexts))  # no scatter
    k4_work = {salted: row_update.work(centers, contexts, D, V, tb, sets, salted)
               for salted in (False, True)}
    emb_rows, ctx_rows = k4_work[False]["emb_rows"], k4_work[False]["ctx_rows"]
    TOUCHED_SHARES["stratified" + sfx] = {
        "emb": [emb_rows, emb_rows / V], "ctx": [ctx_rows, ctx_rows / V],
        "bound": f"row_update{sfx} bound_ms"}
    d_center, acc_ctx = d_p, a_p
    acc_emb = torch.zeros((V, D + 1), device=dev)
    both = torch.zeros((2 * V, D + 1), device=dev)
    idx = torch.cat([centers, contexts + V]).long()
    ones = torch.ones((E, 1), device=dev)
    payload = torch.cat([torch.cat([d_center, ones], 1),
                         torch.cat([g_pos[:, None] * v, ones], 1)])
    none = centers[:0]
    for mode, salts in ((("sr", SALTS), ("rn", None)) if bf16 else (("", None),)):
        name = f"row_update{sfx}" + (f"_{mode}" if mode else "")
        ins = [emb.clone(), ctx.clone(), acc_emb.clone(), acc_ctx.clone()]
        ref = [emb.clone(), ctx.clone(), acc_emb.clone(), acc_ctx.clone()]
        row_update.row_update(*ins, centers, contexts, d_center, v, g_pos, lr, "capped",
                              salts, sets)
        row_update.row_update_plain(*ref, centers, contexts, d_center, v, g_pos, lr,
                                    "capped", salts, sets)
        torch.cuda.synchronize()
        err = compare(name, acc_outputs("acc_emb", ins[2], ref[2], D)
                      + acc_outputs("acc_ctx", ins[3], ref[3], D))
        # the touched rows against every row, on the kernel's own
        # accumulators (its scatter's sums): bitwise
        every = [emb.clone(), ctx.clone()]
        for i in range(2):
            row_update.finalize_rows_plain(every[i], ins[2 + i], lr, "capped",
                                           None if salts is None else salts[i])
        bitwise_tables(torch, name + " touched rows vs every row",
                       [("emb", ins[0], every[0]), ("ctx", ins[1], every[1])])
        # the finalize alone (no examples; the touched rows named) on the
        # plain version's accumulators, against every row: bitwise
        fin = [emb.clone(), ctx.clone(), ref[2].clone(), ref[3].clone()]
        fin_p = [emb.clone(), ctx.clone(), ref[2].clone(), ref[3].clone()]
        row_update.row_update(*fin, none, none, d_center[:0], v[:0], g_pos[:0], lr,
                              "capped", salts, alone)
        row_update.row_update_plain(*fin_p, none, none, d_center[:0], v[:0], g_pos[:0],
                                    lr, "capped", salts)
        torch.cuda.synchronize()
        bitwise_tables(torch, name + " finalize", [("emb", fin[0], fin_p[0]),
                                                   ("ctx", fin[1], fin_p[1])])
        tol = (f"accumulators {REL_TOL:g} x per-row / per-element |plain|; tables "
               f"{TABLE_ATOL:g}; the touched rows bitwise every row's finalize on the same "
               "accumulators")
        if bf16:
            e_t, share = compare_bf16_tables(
                torch, name, [("emb", ins[0], ref[0]), ("ctx", ins[1], ref[1])],
                start=(emb, ctx))
            err = max(err, e_t)
            tol = (f"accumulators {REL_TOL:g} x per-row / per-element |plain|; tables "
                   f"within one bf16 ulp or {F32_ULPS} float32 ulps of |t| + |t - new|, "
                   f"differing on <= {ULP_SHARE:g} "
                   f"of touched elements (here {share:.2e}); the touched rows bitwise every "
                   "row's finalize on the same accumulators")
        else:
            err = max(err, compare(name, [("emb", ins[0], ref[0], "abs"),
                                          ("ctx", ins[1], ref[1], "abs")]))
        t_lib = None
        emb_l, ctx_l = emb.clone(), ctx.clone()
        if salts is None:
            lib_in = [emb.clone(), ctx.clone(), torch.cat([acc_emb, acc_ctx])]
            lib_row_update(torch, *lib_in, idx, payload, lr)
            library_check(name, [lib_in[0], lib_in[1], lib_in[2][:V], lib_in[2][V:]], ref,
                          rtol=1e-2 if bf16 else 1e-4)
            t_lib = timer(lambda: lib_row_update(torch, emb_l, ctx_l, both, idx, payload, lr))
        t_in = [emb.clone(), ctx.clone(), acc_emb.clone(), acc_ctx.clone()]
        row(name, "k4_row_update.cu", "gene2vec_tpu/sgns/step.py:229", err,
            timer(lambda: row_update.row_update(*t_in, centers, contexts, d_center, v,
                                                g_pos, lr, "capped", salts, sets)),
            timer(lambda: row_update.row_update_plain(*t_in, centers, contexts, d_center, v,
                                                      g_pos, lr, "capped", salts, sets)),
            t_lib, k4_work[salts is not None], tol)
        if t_lib is None:
            rows[-1]["library_note"] = "no PyTorch call rounds stochastically"
    log(f"row_update{sfx} touches {emb_rows} emb rows ({emb_rows / V:.3f}) and {ctx_rows} ctx "
        f"rows ({ctx_rows / V:.3f}) of {V}: the bound's rows")
    return rows


# -- library yardsticks: for each kernel, the shortest sequence of PyTorch
# library calls that computes its function on the same inputs (library_ms;
# timed and checked here, never called by the port) --------------------------


def lib_pos_logit(torch, emb, ctx, c_l, x_l):
    """K1: two embedding lookups, a row-wise dot, the two epilogues."""
    fn = torch.nn.functional
    v, u = fn.embedding(c_l, emb).float(), fn.embedding(x_l, ctx).float()
    logit = torch.linalg.vecdot(v, u)
    return v, u, torch.sigmoid(logit) - 1.0, fn.softplus(-logit)


def lib_noise_head(torch, v, u, g_pos, x_l, ctx, kq, head, acc):
    """K2: the head GEMM, its masked epilogue, the two back-GEMMs into
    d_center and the accumulator; ``kq`` = K · q[:H]."""
    fn = torch.nn.functional
    d = v.shape[1]
    ch = ctx[:head].float()
    logit = torch.mm(v, ch.T)
    w = torch.where(x_l[:, None] == torch.arange(head, device=v.device), 0.0, kq)
    g = torch.sigmoid(logit).mul_(w)
    loss = torch.sum(fn.softplus(logit).mul_(w), 1)
    d_center = torch.addmm(g_pos[:, None] * u, g, ch)
    acc[:head, :d].addmm_(g.T, v)
    acc[:head, d] += w.sum(0)
    return d_center, loss


def lib_noise_tail(torch, v, x_l, ctx, tail_w, rows, k, d_center, acc):
    """K3: the drawn blocks' rows (``rows`` (G, S)), batched GEMMs per
    group with the masked epilogue, the block-row payloads index-added."""
    fn = torch.nn.functional
    g_, _ = rows.shape
    e, d = v.shape
    blk = fn.embedding(rows, ctx).float()
    vg = v.view(g_, e // g_, d)
    logit = torch.bmm(vg, blk.transpose(1, 2))
    wm = torch.where(rows[:, None, :] == x_l.view(g_, -1, 1), 0.0, k * tail_w[rows][:, None, :])
    gt = torch.sigmoid(logit).mul_(wm)
    loss = torch.sum(fn.softplus(logit).mul_(wm), -1).reshape(e)
    d_center.view(g_, e // g_, d).baddbmm_(gt, blk)
    pay = torch.cat([torch.bmm(gt.transpose(1, 2), vg), wm.sum(1)[..., None]], 2)
    acc.index_add_(0, rows.reshape(-1), pay.reshape(-1, d + 1))
    return loss


def lib_finalize(torch, table, acc, lr, cap):
    """K4's capped finalize, nearest-even for a bfloat16 table."""
    d = table.shape[1]
    div = torch.clamp_min(acc[:, d:] / cap, 1.0)
    if table.dtype == torch.float32:
        return table.addcdiv_(acc[:, :d], div, value=-lr)
    return table.copy_(table.float().addcdiv_(acc[:, :d], div, value=-lr))


def lib_row_update(torch, emb, ctx, both, idx, payload, lr):
    """K4 row_update: one index_add_ of both tables' [grad | 1] rows into
    their stacked (2V, D+1) accumulators, then each table's capped
    finalize (nearest-even for bfloat16)."""
    from gene2vec_tpu_torch.kernels import row_update

    v = emb.shape[0]
    both.index_add_(0, idx, payload)
    lib_finalize(torch, emb, both[:v], lr, row_update._CAP)
    lib_finalize(torch, ctx, both[v:], lr, row_update._CAP)


def lib_per_example(torch, v, u, g_pos, x_l, negs_l, ctx, acc):
    """K5a: the (E, K, D) gather, batched dots, the masked epilogue, the
    positive contexts' and the noise rows' payloads in one index_add_."""
    fn = torch.nn.functional
    e, d = v.shape
    un = fn.embedding(negs_l, ctx).float()
    logit = torch.bmm(un, v[:, :, None])[..., 0]
    m = (negs_l != x_l[:, None]).float()
    loss = torch.sum(fn.softplus(logit).mul_(m), 1)
    g = torch.sigmoid(logit).mul_(m)
    d_center = torch.baddbmm(g_pos[:, None, None] * u[:, None, :], g[:, None, :], un)[:, 0]
    gw = torch.cat([g_pos[:, None], g], 1)
    acc.index_add_(0, torch.cat([x_l[:, None], negs_l], 1).reshape(-1), torch.cat(
        [(gw[..., None] * v[:, None, :]).reshape(-1, d),
         torch.cat([torch.ones_like(g_pos)[:, None], m], 1).reshape(-1, 1)], 1))
    return d_center, loss


def lib_shared_pool(torch, v, u, g_pos, x_l, pool_l, ctx, scale, groups, acc):
    """K5b: the pool's rows, grouped batched GEMMs with the masked
    epilogue, the pool rows' payloads index-added."""
    fn = torch.nn.functional
    e, d = v.shape
    p, g = pool_l.shape[0], groups
    un = fn.embedding(pool_l, ctx).float().view(g, p // g, d)
    vg = v.view(g, e // g, d)
    logit = torch.bmm(vg, un.transpose(1, 2))
    m = torch.where(pool_l.view(g, 1, -1) == x_l.view(g, -1, 1), 0.0, scale)
    loss = torch.sum(fn.softplus(logit) * m, -1).reshape(e)
    gn = torch.sigmoid(logit).mul_(m)
    d_center = torch.baddbmm(g_pos.view(g, -1, 1) * u.view(g, e // g, d), gn, un)
    pay = torch.cat([torch.bmm(gn.transpose(1, 2), vg).reshape(p, d), m.sum(1).reshape(p, 1)], 1)
    acc.index_add_(0, pool_l, pay)
    return d_center.reshape(e, d), loss


def lib_hs(torch, emb, node, in_l, t_l, points, codes, lengths, shallow, acc):
    """K6: every path entry's node row gathered (the shallow paths' and the
    deep remainders' side by side), batched dots and the sign epilogue,
    the payloads index-added."""
    fn = torch.nn.functional
    d = emb.shape[1]
    ls = shallow.ids.shape[1]
    v = fn.embedding(in_l, emb).float()
    pts = torch.cat([shallow.ids[t_l], points[t_l]], 1).long()
    sg = torch.cat([shallow.signs[t_l].float(), 1.0 - 2.0 * codes[t_l]], 1)
    mask = torch.cat([shallow.signs[t_l].abs().float(),
                      (torch.arange(points.shape[1], device=v.device)[None, :]
                       < lengths[t_l][:, None]).float()], 1)
    w = fn.embedding(pts, node).float()
    logit = torch.bmm(w, v[:, :, None])[..., 0]
    loss = fn.softplus(-sg * logit).mul_(mask)
    g = (torch.sigmoid(logit) - (1.0 + sg) / 2.0).mul_(mask)
    d_input = torch.bmm(g[:, None, :], w)[:, 0]
    acc.index_add_(0, pts.reshape(-1), torch.cat(
        [(g[..., None] * v[:, None, :]).reshape(-1, d), mask.reshape(-1, 1)], 1))
    return d_input, loss[:, ls:].sum(-1), loss[:, :ls].sum(-1)


def lib_quant_scan(torch, qn, table_q_pad, scale, v_rows, rb):
    """K8: query quantization, one int8 GEMM (``torch._int_mm``, which
    needs a row count that is a multiple of 8: ``table_q_pad``), the scale
    epilogue and ``torch.topk``."""
    from gene2vec_tpu_torch.kernels import quant_scan

    qq, qs = quant_scan.quantize_queries_plain(qn)
    s = torch._int_mm(qq, table_q_pad.T)[:, :v_rows]
    return torch.topk(s.float() * qs * scale[None, :], rb)


def lib_ivf_scan(torch, qn, centroids, lists, table_q, scale, nprobe, rb):
    """K9: centroid GEMM and top-nprobe, the probed lists' int8 rows
    gathered, batched dots (int8 products summed exactly in float32), the
    scale epilogue, padding masked, ``torch.topk``."""
    from gene2vec_tpu_torch.kernels import quant_scan

    b = qn.shape[0]
    _, ci = torch.topk(qn @ centroids.T, nprobe)
    cand = lists[ci].reshape(b, -1)
    ok = cand >= 0
    pos = cand.clamp_min(0).long()
    qq, qs = quant_scan.quantize_queries_plain(qn)
    dots = torch.bmm(table_q[pos].float(), qq.float()[:, :, None])[..., 0]
    approx = torch.where(ok, dots * qs * scale[pos], float("-inf"))
    rs, rp = torch.topk(approx, min(rb, approx.shape[1]))
    return rs, torch.gather(pos, 1, rp)


def lib_quant_scan_bf16(torch, qn, table_q, scale, rb):
    """K8 on a bf16 table: the query rounded to bf16, one float32 ``mm``
    against the table in float32, ``torch.topk``."""
    return torch.topk(torch.mm(qn.to(torch.bfloat16).float(), table_q.float().T), rb)


def lib_ivf_scan_bf16(torch, qn, centroids, lists, table_q, scale, nprobe, rb):
    """K9 on a bf16 table: centroid GEMM and top-nprobe, the probed lists'
    bf16 rows gathered, batched float32 dots with the bf16-rounded query,
    padding masked, ``torch.topk``."""
    b = qn.shape[0]
    _, ci = torch.topk(qn @ centroids.T, nprobe)
    cand = lists[ci].reshape(b, -1)
    ok = cand >= 0
    pos = cand.clamp_min(0).long()
    dots = torch.bmm(table_q[pos].float(), qn.to(torch.bfloat16).float()[:, :, None])[..., 0]
    rs, rp = torch.topk(dots.masked_fill_(~ok, float("-inf")), min(rb, dots.shape[1]))
    return rs, torch.gather(pos, 1, rp)


def lib_rescore(torch, qn, unit, ri, approx, k):
    """K9r: the candidates' unit rows gathered, batched exact dots, the
    non-finite candidates masked, ``torch.topk``."""
    ok = torch.isfinite(approx)
    pos = torch.where(ok, ri, 0).long()
    exact = torch.bmm(unit[pos], qn[:, :, None])[..., 0].masked_fill_(~ok, float("-inf"))
    s, p = torch.topk(exact, min(k, exact.shape[1]))
    return s, torch.gather(pos, 1, p)


def library_check(name, got, want, rtol=1e-4):
    """A yardstick's outputs against the plain version's (float32 sums in
    another order; top-k scores position by position): within ``rtol`` of
    each output's max |plain|."""
    for i, (g, w) in enumerate(zip(got, want)):
        diff = (g.float() - w.float()).abs().masked_fill(g == w, 0.0)
        scale = w.float().abs().masked_fill(~w.float().isfinite(), 0.0).max()
        if not float(diff.max()) <= rtol * float(scale):
            raise SystemExit(f"{name} library sequence: output {i} off by {float(diff.max()):.3e}")


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


#: the route of K7 and K8 (``_topk.plan_staged``) at every shape
STAGED_ROUTE = "staged tiles, chunks and a final launch"


def ivf_route(ivf_scan, qn, centroids, table_q, nprobe, rb, list_len) -> str:
    """K9's routes at a call's shapes: its probe's clusters and its scan's."""
    pp, pl = ivf_scan.plans(qn, centroids, table_q, nprobe, rb, list_len)
    return (f"probe: clusters of {pp.cluster} blocks for {pp.qg} queries; "
            f"scan: {pl.describe()}")


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
    from gene2vec_tpu_torch.obs.profiler import bound
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
    # torch._int_mm takes a row count that is a multiple of 8
    tq_pad = torch.cat([index.table_q, index.table_q.new_zeros(((-V) % 8, D))])
    timer = Timer(torch, reps)
    records, worst, ties, breakdown = [], {}, {}, {}

    def record(name, b, kb, err, t_k, t_p, t_lib, work, route=STAGED_ROUTE, launches=None):
        b_ms, b_by = bound(work)
        records.append({"name": name, "batch": b, "kb": kb, "max_abs_err": err, "ms": t_k,
                        "plain_ms": t_p, "library_ms": t_lib, "bound_ms": b_ms,
                        "bound_by": b_by, "route": route, "launches_by_kernel": launches})
        worst[name] = max(worst.get(name, 0.0), err)
        log(f"{name} B {b} kb {kb}: max_abs_err {err:.3e}, kernel {t_k:.4f} ms, plain "
            f"{t_p:.4f} ms, library {t_lib} ms, bound {b_ms:.4f} ms ({b_by}); {route}")

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
                   topk_exact.work(V, D, b, kb))
            if (b, kb) == MAIN_SHAPE:  # where the kernel's and library's time goes
                breakdown["topk_exact"] = breakdown_of(
                    torch, lambda: topk_exact.topk_exact(unit, q, kb),
                    lambda: torch.topk(torch.mm(qn, unit.T), kb))
            # K8 (library: torch._int_mm takes more than 16 query rows)
            g8 = quant_scan.quant_scan(qn, index.table_q, index.scale, rb)
            w8 = quant_scan.quant_scan_plain(qn, index.table_q, index.scale, rb)
            torch.cuda.synchronize()
            bitwise("K8", g8, w8, slice(None))
            t_lib = None
            if b > 16:
                library_check("K8", lib_quant_scan(torch, qn, tq_pad, index.scale, V, rb)[:1],
                              w8[:1], rtol=1e-6)
                t_lib = timer(lambda: lib_quant_scan(torch, qn, tq_pad, index.scale, V, rb))
            record("quant_scan", b, kb, 0.0,
                   timer(lambda: quant_scan.quant_scan(qn, index.table_q, index.scale, rb)),
                   timer(lambda: quant_scan.quant_scan_plain(qn, index.table_q, index.scale,
                                                             rb)),
                   t_lib, quant_scan.work(V, D, b, rb))
            if (b, kb) == MAIN_SHAPE:
                breakdown["quant_scan"] = breakdown_of(
                    torch, lambda: quant_scan.quant_scan(qn, index.table_q, index.scale, rb),
                    lambda: lib_quant_scan(torch, qn, tq_pad, index.scale, V, rb))
            # K9: ids and scores bitwise where the probe is not a near-tie
            args9 = (qn, index.centroids, index.lists, index.table_q, index.scale, nprobe, rb)
            g9 = ivf_scan.ivf_scan(*args9)
            w9 = ivf_scan.ivf_scan_plain(*args9)
            torch.cuda.synchronize()
            tied = probe_near_ties(torch, qn, index.centroids, nprobe)
            ties["ivf_scan"] = ties.get("ivf_scan", 0) + int(tied.sum())
            bitwise("K9", g9, w9, ~tied)
            cand = ivf_scan.probed(qn, index.centroids, index.lists, nprobe)
            library_check("K9", lib_ivf_scan(torch, *args9)[:1], w9[:1], rtol=1e-6)
            record("ivf_scan", b, kb, 0.0, timer(lambda: ivf_scan.ivf_scan(*args9)),
                   timer(lambda: ivf_scan.ivf_scan_plain(*args9)),
                   timer(lambda: lib_ivf_scan(torch, *args9)),
                   ivf_scan.work(b, D, c, nprobe, lst, g9[0].shape[1], int(cand.numel()),
                                 int(torch.unique(cand).numel())),
                   route=ivf_route(ivf_scan, qn, index.centroids, index.table_q, nprobe, rb, lst),
                   launches=launches_by_kernel(torch, lambda: ivf_scan.ivf_scan(*args9)))
            if (b, kb) == MAIN_SHAPE:
                breakdown["ivf_scan"] = breakdown_of(
                    torch, lambda: ivf_scan.ivf_scan(*args9), lambda: lib_ivf_scan(torch, *args9))
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
            library_check("K9r", lib_rescore(torch, qn, unit, ri, rs, kb)[:1],
                          rescore.rescore_plain(qn, unit, ri, rs, kb)[:1], rtol=SERVE_TOL)
            record("rescore", b, kb, err,
                   timer(lambda: rescore.rescore(qn, unit, ri, rs, kb)),
                   timer(lambda: rescore.rescore_plain(qn, unit, ri, rs, kb)),
                   timer(lambda: lib_rescore(torch, qn, unit, ri, rs, kb)),
                   rescore.work(b, D, rb, kb, *rescore.candidates(rs, ri)),
                   route=rescore.plan(qn, unit, ri.shape[1], min(kb, ri.shape[1])).describe(),
                   launches=launches_by_kernel(
                       torch, lambda: rescore.rescore(qn, unit, ri, rs, kb)))
            if (b, kb) == MAIN_SHAPE:
                breakdown["rescore"] = breakdown_of(
                    torch, lambda: rescore.rescore(qn, unit, ri, rs, kb),
                    lambda: lib_rescore(torch, qn, unit, ri, rs, kb))
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
            "route": main["route"],
            "tolerance": ("bitwise" if name in ("quant_scan", "ivf_scan")
                          else f"ids exact except near-ties; scores {SERVE_TOL:g}"),
            "near_ties": ties.get(name, 0),
        })
        if name in breakdown:
            rows[-1]["device_ms"] = breakdown[name]
            log(f"{name} at B {MAIN_SHAPE[0]} kb {MAIN_SHAPE[1]}, device ms a call by kernel: "
                f"{breakdown[name]}")
    return rows, records


#: kernel ms over library_ms at MAIN_SHAPE in run 5D (PERF.md), before the
#: staged-tile redesign of K7 and K8
FACTOR_5D = {"topk_exact": 1.85, "quant_scan": 1.63}


#: kernel ms over library_ms in run 6D (PERF.md), before the tensor-core
#: redesign of K2 and K3
FACTOR_6D = {"noise_head": 1.24, "noise_tail": 1.19, "noise_head_bf16": 1.07,
             "noise_tail_bf16": 1.09}


def noise_redesign(rows) -> dict:
    """K2 and K3 (float32 and bfloat16 tables) against their library
    sequences in this run, beside run 6D's factor; fails where a kernel is
    slower than its library sequence."""
    out = {}
    for name, old in FACTOR_6D.items():
        r = next(x for x in rows if x["name"] == name)
        factor = r["ms"] / r["library_ms"]
        out[name] = {"ms": r["ms"], "library_ms": r["library_ms"], "factor": factor,
                     "factor_6d": old, "bound_ms": r["bound_ms"]}
        log(f"{name}: {factor:.3f}x its library sequence (run 6D, old design: {old}x)")
        if factor > 1.0:
            raise SystemExit(f"{name}: {r['ms']:.4f} ms, slower than its library sequence "
                             f"({r['library_ms']:.4f} ms)")
    return out


#: kernel ms over library_ms in run 7D (PERF.md), before the touched-rows
#: redesign of K4
FACTOR_7D_K4 = {"row_update": 0.952, "row_update_bf16_rn": 0.619, "row_scatter": 0.931,
                "row_finalize": 1.036, "row_finalize_bf16_rn": 0.582}


def k4_redesign(rows) -> dict:
    """K4's entries against their library sequences in this run, beside run
    7D's factor; fails where row_finalize is slower than its addcdiv_."""
    out = {}
    for name, old in FACTOR_7D_K4.items():
        r = next(x for x in rows if x["name"] == name)
        factor = r["ms"] / r["library_ms"]
        out[name] = {"ms": r["ms"], "library_ms": r["library_ms"], "factor": factor,
                     "factor_7d": old, "bound_ms": r["bound_ms"]}
        log(f"{name}: {factor:.3f}x its library sequence (run 7D, all rows: {old}x)")
        if name.startswith("row_finalize") and factor > 1.0:
            raise SystemExit(f"{name}: {r['ms']:.4f} ms, slower than its library sequence "
                             f"({r['library_ms']:.4f} ms)")
    return out


def gather_redesign(records) -> dict:
    """The row gather against ``index_select`` at each probe and GGIPNN
    shape in this run, with its share of the bytes bound."""
    out = []
    for r in records:
        if r.get("name") != "row_gather":
            continue
        out.append({"probe": r["probe"], "dtype": r["dtype"], "E": r["E"], "ms": r["ms"],
                    "library_ms": r["library_ms"], "factor": r["ms"] / r["library_ms"],
                    "bound_ms": r["bound_ms"], "bound_share": r["bound_ms"] / r["ms"]})
        log(f"row_gather {r['dtype']} E {r['E']}: {out[-1]['factor']:.3f}x index_select, "
            f"{out[-1]['bound_share']:.3f} of its bytes bound")
    return {"row_gather": out}


def timer_floor(torch, reps) -> float:
    """The Timer's time for a one-element fill: the launch and event
    overhead inside every timed kernel, which the launch-bound shapes
    (a few hundred rows) are mostly made of."""
    x = torch.empty(1, device=DEVICE)
    return Timer(torch, reps)(lambda: x.fill_(1.0))


def redesign_factors(records) -> dict:
    """K7 and K8 against their library sequences in this run: at each
    timed shape, ms, library_ms and their ratio, beside run 5D's ratio at
    MAIN_SHAPE."""
    out = {}
    for name, old in FACTOR_5D.items():
        shapes = [{"batch": r["batch"], "kb": r["kb"], "ms": r["ms"],
                   "library_ms": r["library_ms"],
                   "factor": r["ms"] / r["library_ms"] if r["library_ms"] else None}
                  for r in records if r["name"] == name]
        out[name] = {"shapes": shapes, "factor_5d": old, "main_shape": list(MAIN_SHAPE)}
        main = next(x for x in shapes if (x["batch"], x["kb"]) == MAIN_SHAPE)
        log(f"{name}: {main['factor']:.3f}x its library sequence at B {MAIN_SHAPE[0]} kb "
            f"{MAIN_SHAPE[1]} (run 5D, old design: {old}x)")
    return out


def kernel_name(key: str) -> str:
    """A profiler event's kernel name without its return type, namespace
    prefixes or arguments: ``void (anonymous namespace)::hs_kernel<float,
    7, 1>(...)`` → ``hs_kernel``."""
    name = key.replace("(anonymous namespace)::", "").replace("void ", "", 1)
    return name.split("(")[0].split("<")[0].split("::")[-1] or key[:60]


#: profiler sessions device_breakdown tries before it reports no device time
BREAKDOWN_TRIES = 3


def device_breakdown(torch, fn, calls=10, launches=None) -> dict:
    """Device ms a call of ``fn`` by kernel name: torch.profiler over
    ``calls`` calls after a warm-up (the table stays in L2, unlike the
    Timer's flushed launches).  ``launches``, a dict, receives the
    launches a call by name.  The profiler may miss a launch or two of a
    window, so launches a call are the events over the calls rounded, and
    ms a call the mean of the events seen times that.  A session now and
    then records no device activity at all, for a cause not yet found
    (PERF.md §7, the profiler's empty sessions); rows read this (K10's
    ``launch_ms``, K6's and the serving kernels' ``device_ms``), so such
    a session is logged and run again, up to
    BREAKDOWN_TRIES in all, and the result is empty only where every one
    saw no device time."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    for attempt in range(1, BREAKDOWN_TRIES + 1):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(calls):
                fn()
            torch.cuda.synchronize()
        seen, counts = {}, {}
        events = prof.key_averages()
        for ev in events:
            if ev.device_type == torch.autograd.DeviceType.CUDA and ev.self_device_time_total > 0:
                name = kernel_name(ev.key)
                seen[name] = seen.get(name, 0.0) + ev.self_device_time_total / 1e3
                counts[name] = counts.get(name, 0) + ev.count
        if seen:
            break
        log(f"device_breakdown: session {attempt} saw no device time among its "
            f"{len(events)} events "
            f"({sum(ev.device_type == torch.autograd.DeviceType.CUDA for ev in events)} "
            f"device events)")
    out = {}
    for name, ms in seen.items():
        per_call = round(counts[name] / calls)
        out[name] = ms / counts[name] * per_call if per_call else ms / calls
        if launches is not None:
            launches[name] = per_call
    return out


def launches_by_kernel(torch, fn) -> dict:
    """Launches a call of ``fn`` makes, by kernel name (torch.profiler over
    ten calls)."""
    launches = {}
    device_breakdown(torch, fn, launches=launches)
    return launches


def breakdown_of(torch, kernel_fn, library_fn) -> dict:
    """A kernel's and its library sequence's device ms a call by kernel
    name (``device_breakdown``), with the kernel's launches a call by name."""
    launches = {}
    return {"kernel": device_breakdown(torch, kernel_fn, launches=launches),
            "kernel_launches": launches,
            "library": device_breakdown(torch, library_fn)}


def gather_probes(torch, reps):
    """K9r's row gather alone at the Pallas gather probes' shapes, against
    ``table[idx]``; library call: ``torch.index_select`` (which the plain
    version also is)."""
    from gene2vec_tpu_torch.kernels import rescore
    from gene2vec_tpu_torch.obs.profiler import bound

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
        b_ms, b_by = bound(rescore.gather_work(idx, d * table.element_size()))
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


#: K12's other instances at STREAM_MAIN_MB: (element type, scale)
STREAM_VARIANTS = (("float32", 2.0), ("float32", 1.0), ("bfloat16", 1.0000001),
                   ("bfloat16", 2.0), ("bfloat16", 1.0))


def stream_probes(torch, reps):
    """K12 (``stream_scale``) at the Pallas streaming probe's sizes — (n, 256)
    float32, n = MB·2²⁰/4/256, x · 1.0000001 — then at STREAM_MAIN_MB for
    each of STREAM_VARIANTS, each bitwise against its plain version
    ``x * scale``, which is also the library call (``torch.mul``).
    Returns (the kernels-line row at STREAM_MAIN_MB, one record per size
    and variant with achieved GB/s: bytes read and written over the
    kernel's time)."""
    from gene2vec_tpu_torch.kernels import stream_scale
    from gene2vec_tpu_torch.obs.profiler import bound

    dev = torch.device(DEVICE)
    gen = torch.Generator(device=dev).manual_seed(0)
    timer = Timer(torch, reps)
    records, main_row = [], None
    cases = [(mb, "float32", stream_scale.SCALE) for mb in STREAM_MB]
    cases += [(STREAM_MAIN_MB, dt, sc) for dt, sc in STREAM_VARIANTS]
    for mb, dtype, scale in cases:
        es = 2 if dtype == "bfloat16" else 4
        n = mb * 1024 * 1024 // es // 256
        x = torch.randn((n, 256), device=dev, generator=gen).to(getattr(torch, dtype))
        got = stream_scale.stream_scale(x, scale)
        want = stream_scale.stream_scale_plain(x, scale)
        torch.cuda.synchronize()
        if not same_bits(torch, got, want):
            raise SystemExit(f"stream_scale {mb} MB {dtype}: not bitwise x * {scale}")
        work = stream_scale.work(n * 256, es)
        nbytes = work["bytes"]
        b_ms, b_by = bound(work)
        rec = {"name": "stream_scale" + ("_bf16" if es == 2 else ""),
               "probe": "experiments/test_bw.py:39 pallas_copy_loop", "mb": mb,
               "dtype": dtype, "scale": scale, "shape": [n, 256], "max_abs_err": 0.0,
               "ms": timer(lambda: stream_scale.stream_scale(x, scale)),
               "plain_ms": timer(lambda: stream_scale.stream_scale_plain(x, scale)),
               "library_ms": timer(lambda: torch.mul(x, scale)),
               "bound_ms": b_ms, "bound_by": b_by}
        rec["gb_per_s"] = nbytes / rec["ms"] / 1e6
        rec["library_gb_per_s"] = nbytes / rec["library_ms"] / 1e6
        records.append(rec)
        log(f"stream_scale {mb} MB {dtype} x {scale}: kernel {rec['ms']:.4f} ms "
            f"({rec['gb_per_s']:.1f} GB/s), plain {rec['plain_ms']:.4f} ms, torch.mul "
            f"{rec['library_ms']:.4f} ms ({rec['library_gb_per_s']:.1f} GB/s), bound "
            f"{b_ms:.4f} ms ({b_by})")
        if mb == STREAM_MAIN_MB and dtype == "float32" and scale == stream_scale.SCALE:
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
    # the differences in float32 ulps of each table's largest update, the
    # unit of compare_bf16_tables' TABLE_ULPS
    ulps = [err / (2.0 ** -23 * max(float((t.float() - c).abs().max()), 1e-30))
            for err, c, t in ((errs[1], ec, start[0]), (errs[2], cc, start[1]))]
    log(f"{label}: loss rel {errs[0]:.2e}, emb {errs[1]:.2e}, out table {errs[2]:.2e} "
        f"({ulps[0]:.1f}, {ulps[1]:.1f} float32 ulps of the table's largest update)")
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
HS_HOT_SWEEP = (0, 2, 3, 4, 5, 6, 7)  # K6's tree levels reduced in shared memory, timed
HS_HOT = {}                 # {"hs" / "hs_bf16": {"default": n, "ms": {levels: ms}}}
K6_REPEATS = 100            # K6 launches held against the reference sum, per hot-levels case
K6_SHARES = {}              # {"hs" / "hs_bf16": {levels: the largest reading / the row bar}}
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
    from gene2vec_tpu_torch.kernels import (_work, hs, per_example, pos_logit, row_update,
                                            shared_pool)
    from gene2vec_tpu_torch.obs.profiler import bound
    from gene2vec_tpu_torch.sgns.cbow_hs import shallow_on
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

    def row(name, src, replaces, err, fn_k, fn_p, fn_lib, work, tolerance=None):
        b_ms, b_by = bound(work)
        t_k, t_p = timer(fn_k), timer(fn_p)
        t_lib = timer(fn_lib) if fn_lib is not None else None
        rows.append({
            "name": name, "route": "cuda", "source": f"gene2vec_tpu_torch/kernels/csrc/{src}",
            "replaces": replaces, "launches": None, "max_abs_err": err,
            "ms": t_k, "plain_ms": t_p, "bound_ms": b_ms, "bound_by": b_by,
            "library_ms": t_lib, "work": work,
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
    x_l, negs_l = contexts.long(), negs.long()
    a_l = acc0.clone()
    library_check("K5a" + sfx, [*lib_per_example(torch, v, u, g_pos, x_l, negs_l, ctx, a_l), a_l],
                  [dp, lp, a_p])
    a_t = acc0.clone()
    work = per_example.work(contexts, negs, D, tb)
    row("per_example" + sfx, "k5_per_example.cu", "gene2vec_tpu/sgns/step.py:97", err,
        lambda: per_example.per_example(v, u, g_pos, contexts, negs, ctx, a_t),
        lambda: per_example.per_example_plain(v, u, g_pos, contexts, negs, ctx, a_t),
        lambda: lib_per_example(torch, v, u, g_pos, x_l, negs_l, ctx, a_t), work)
    log(f"per_example{sfx}: {work['draw_rows']} distinct noise rows of {E * K} draws; "
        f"{work['acc_rows']} accumulator rows with the positive contexts'")
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
    pool_l, scale = pool.long(), shared_pool.pool_scale(K, g, pool.shape[0])
    a_l = acc0.clone()
    library_check("K5b" + sfx, [*lib_shared_pool(torch, v, u, g_pos, x_l, pool_l, ctx, scale, g,
                                                 a_l), a_l], [dp, lp, a_p])
    a_t = acc0.clone()
    work = shared_pool.work(E, pool, g, D, tb)
    row("shared_pool" + sfx, "k5_shared.cu", "gene2vec_tpu/sgns/step.py:337", err,
        lambda: shared_pool.shared_pool(v, u, g_pos, contexts, pool, ctx, K, g, a_t),
        lambda: shared_pool.shared_pool_plain(v, u, g_pos, contexts, pool, ctx, K, g, a_t),
        lambda: lib_shared_pool(torch, v, u, g_pos, x_l, pool_l, ctx, scale, g, a_t), work)
    tf32_note(rows[-1], _work.TF32_PASSES[bf16])
    log(f"shared_pool{sfx}: G {g}, P/G {per_group}, {work['pool_rows']} distinct pool rows")

    # K6: sg_hs at hs_dense_depth 10 (input = center, path of the context)
    tree = build_huffman_tree(counts)
    split = split_shallow(tree, HS_DEPTH)
    ns, l_deep = split.n_shallow, split.points_deep.shape[1]
    pts, cds, lens = (torch.from_numpy(a).to(dev) for a in (
        split.points_deep, split.codes_deep, split.lengths_deep))
    shallow = shallow_on(split, dev)
    node = (torch.randn((tree.num_nodes, D), generator=torch.Generator().manual_seed(2))
            * 0.1).to(dev, dtype)
    a0 = torch.zeros((tree.num_nodes, D + 1), device=dev)
    a_k, a_p = a0.clone(), a0.clone()
    args6 = (emb, node, centers, contexts, pts, cds, lens, shallow)
    dk, ldk, lsk = hs.hs(*args6, a_k)
    dp, ldp, lsp = hs.hs_plain(*args6, a_p)
    # acc_node's reference: the plain version's float32 terms summed in
    # float64 in one order.  The plain version on the card sums the same
    # terms by atomics too, so against its accumulator two run-to-run
    # orders would share the row bar; against this sum only the kernel's
    a_ref = hs.acc_reference(a0, hs.path_terms(*args6)).to(dev)
    torch.cuda.synchronize()
    err = compare("K6" + sfx, [("d_input", dk, dp, "rows"), ("loss_deep", ldk, ldp, "elems"),
                               ("loss_shallow", lsk, lsp, "elems")]
                  + acc_outputs("acc_node", a_k, a_ref, D))
    work = hs.work(centers, contexts, pts, lens, shallow, D, tb)
    args6_l = (emb, node, centers.long(), x_l, pts, cds, lens, shallow)
    a_l = a0.clone()
    library_check("K6" + sfx, [*lib_hs(torch, *args6_l, a_l), a_l], [dp, ldp, lsp, a_p])
    a_t = a0.clone()
    row("hs" + sfx, "k6_hs.cu", "gene2vec_tpu/sgns/cbow_hs.py:65", err,
        lambda: hs.hs(*args6, a_t), lambda: hs.hs_plain(*args6, a_t),
        lambda: lib_hs(torch, *args6_l, a_t), work)
    # K6's time by launch (torch.profiler, L2 warm), and its kernel time at
    # each count of tree levels reduced in shared memory, each count's
    # K6_REPEATS launches held against the plain version and the reference
    # sum (the largest reading, as a share of the row bar, in K6_SHARES)
    rows[-1]["device_ms"] = device_breakdown(torch, lambda: hs.hs(*args6, a_t))
    sweep, shares = {}, {}
    for hot in HS_HOT_SWEEP:
        for _ in range(K6_REPEATS):
            a_k = a0.clone()
            dk, ldk, lsk = hs.hs(*args6, a_k, hot_levels=hot)
            torch.cuda.synchronize()
            compare(f"K6{sfx} hot_levels {hot}", [
                ("d_input", dk, dp, "rows"), ("loss_deep", ldk, ldp, "elems"),
                ("loss_shallow", lsk, lsp, "elems")] + acc_outputs("acc_node", a_k, a_ref, D))
            shares[hot] = max(shares.get(hot, 0.0),
                              row_bar_share(torch, a_k[:, :D], a_ref[:, :D]))
        sweep[hot] = timer(lambda: hs.hs(*args6, a_t, hot_levels=hot))
    HS_HOT["hs" + sfx] = {"default": hs.HOT_LEVELS, "ms": sweep}
    K6_SHARES["hs" + sfx] = shares
    log(f"hs{sfx}: device ms by launch {rows[-1]['device_ms']}; ms by hot levels {sweep} "
        f"(default {hs.HOT_LEVELS}); acc_node against the reference sum over {K6_REPEATS} "
        f"launches a count, the largest row reading as a share of the bar: {shares}")
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
    # and ctx's finalize against K5a's accumulator over the rows the step
    # names (the contexts and the draws), bitwise every row's plain
    # finalize on the same accumulator (library: addcdiv_ over every row)
    from gene2vec_tpu_torch.kernels.row_update import Touched

    draws = Touched(ids=(contexts, negs))
    touched = int((acc_pe[:, D] != 0).sum())
    n_draws = row_update.visited_rows(draws, V)
    TOUCHED_SHARES["per_example_ctx_draws" + sfx] = {
        "ctx": [n_draws, n_draws / V], "bound": f"row_finalize{sfx} bound_ms"}
    if not bf16:
        ones = torch.ones((E,), device=dev)
        a_k, a_p = acc0.clone(), acc0.clone()
        row_update.scatter_rows(a_k, centers, d_center, ones)
        row_update.scatter_rows_plain(a_p, centers, d_center, ones)
        torch.cuda.synchronize()
        err_s = compare("K4 scatter_rows", acc_outputs("acc_emb", a_k, a_p, D))
        # the scattered rows: a finalize over their ids alone is bitwise
        # every row's on the same accumulator
        t_k, t_p = emb.clone(), emb.clone()
        row_update.finalize_rows(t_k, a_k, 0.0125, "capped", None, Touched(ids=centers))
        row_update.finalize_rows_plain(t_p, a_k, 0.0125, "capped")
        torch.cuda.synchronize()
        bitwise_tables(torch, "row_scatter rows", [("emb", t_k, t_p)])
        payload = torch.cat([d_center, ones[:, None]], 1)
        idx_l = centers.long()
        a_t = acc0.clone()
        row("row_scatter", "k4_row_update.cu", "gene2vec_tpu/sgns/step.py:229", err_s,
            lambda: row_update.scatter_rows(a_t, centers, d_center, ones),
            lambda: row_update.scatter_rows_plain(a_t, centers, d_center, ones),
            lambda: a_t.index_add_(0, idx_l, payload), row_update.scatter_work(centers, D),
            f"{REL_TOL:g} x per-row / per-element |plain|; a finalize over its ids "
            "bitwise every row's")
    for mode, salts in ((("sr", SALTS[1]), ("rn", None)) if bf16 else (("", None),)):
        name = f"row_finalize{sfx}" + (f"_{mode}" if mode else "")
        t_k, t_p = ctx.clone(), ctx.clone()
        row_update.finalize_rows(t_k, acc_pe, 0.0125, "capped", salts, draws)
        row_update.finalize_rows_plain(t_p, acc_pe, 0.0125, "capped", salts)
        torch.cuda.synchronize()
        bitwise_tables(torch, name + " touched rows vs every row", [("ctx", t_k, t_p)])
        err_f = float((t_k.float() - t_p.float()).abs().max())
        lib = None
        if salts is None:  # no PyTorch call rounds stochastically
            t_l = ctx.clone()
            library_check(name, [lib_finalize(torch, t_l, acc_pe, 0.0125, row_update._CAP)],
                          [t_p], rtol=1e-2 if bf16 else 1e-6)
            lib = lambda: lib_finalize(torch, t_t, acc_pe, 0.0125, row_update._CAP)  # noqa: E731
        t_t = ctx.clone()
        row(name, "k4_row_update.cu", "gene2vec_tpu/sgns/step.py:248", err_f,
            lambda: row_update.finalize_rows(t_t, acc_pe, 0.0125, "capped", salts, draws),
            lambda: row_update.finalize_rows_plain(t_t, acc_pe, 0.0125, "capped", salts, draws),
            lib, row_update.finalize_work(draws, V, D, tb, salts is not None),
            "bitwise every row's finalize on the same accumulator")
        if lib is None:
            rows[-1]["library_note"] = "no PyTorch call rounds stochastically"
    log(f"row_finalize{sfx}: {touched} touched rows of {V} ({touched / V:.3f}; the contexts "
        f"and draws name {n_draws}): the bound's rows")
    return rows


def objective_step_parity(torch, v, d, b, kind, full_tables, dtype=None):
    """One whole step of ``kind`` (per_example, shared, sg_hs, cbow_hs at
    depth 10) on the card against the plain step on the CPU, same inputs
    and draws: loss within rtol 1e-5, tables within TABLE_ATOL; at
    ``dtype`` bfloat16 with SALTS, as ``step_verdict`` says."""
    from gene2vec_tpu_torch.sgns.cbow_hs import hs_step, shallow_on
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
            pts, cds, lens = (torch.from_numpy(a).to(dev) for a in (
                split.points_deep, split.codes_deep, split.lengths_deep))
            p, loss = hs_step(p, batch, pts, cds, lens, 0.025, cbow=kind == "cbow_hs",
                              shallow=shallow_on(split, dev), sr_salts=salts)
        else:
            p, loss = sgns_step(p, batch, 0.025, negative_mode=kind,
                                negs=torch.from_numpy(negs).to(dev), sr_salts=salts)
        out[dev] = (float(loss), p.emb.cpu(), p.ctx.cpu())
    step_verdict(torch, f"whole-step parity {kind} card vs CPU{' bf16' if bf16 else ''} "
                 f"(V {v}, D {d}, E {2 * b})", out, tables, bf16)


#: the tie-heavy check's batches and k-buckets (phase 2b)
TIE_BATCHES = (1, 3, 64)
TIE_KBS = (1, 16, 512)


def tie_heavy_inputs(torch, dev, b, v=3001, d=40, bases=50, seed=3):
    """A table of `bases` distinct unit rows, each repeated ~v / bases
    times (equal scores straddle every keep-th place), a zero row, and
    `b` queries taken from the table's own rows."""
    rng = np.random.RandomState(seed)
    base = rng.randn(bases, d).astype(np.float32)
    base /= np.linalg.norm(base, axis=1, keepdims=True)
    unit = base[rng.randint(0, bases, v)]
    unit[11] = 0.0
    q = unit[rng.choice(np.arange(12, v), b)] * 2.0
    return torch.from_numpy(unit).to(dev), torch.from_numpy(q).to(dev)


def tie_heavy_check(torch, dev, b, kb):
    """Duplicated rows, a zero row and masked rows (valid < V, -inf) at
    batch b and k-bucket kb: K8 (int8) and K9 ids and scores bitwise the
    plain versions' (K9 where the probe is not a near-tie); K7, K8 on a
    bf16 table and K9r scores within SERVE_TOL and ids equal except
    near-ties — the lower row first among equal scores.  Returns the
    near-ties counted."""
    from gene2vec_tpu_torch.kernels import _topk, ivf_scan, quant_scan, rescore, topk_exact
    from gene2vec_tpu_torch.serve import ann

    unit, q = tie_heavy_inputs(torch, dev, b)
    v = unit.shape[0]
    valid = v - 17
    qn = _topk.normalize_plain(q)
    where = f"tie-heavy B {b} kb {kb}"

    def exact_of(ids):
        s = (qn[:, None, :] * unit[ids]).sum(-1)
        return s.masked_fill(ids >= valid, float("-inf"))

    def bitwise(name, got, want, rows=slice(None)):
        if not (torch.equal(got[0][rows].view(torch.int32), want[0][rows].view(torch.int32))
                and torch.equal(got[1][rows], want[1][rows])):
            raise SystemExit(f"{name} ({where}): not bitwise the plain version's")

    ties = 0
    got, want = topk_exact.topk_exact(unit, q, kb, valid), topk_exact.topk_exact_plain(
        unit, q, kb, valid)
    torch.cuda.synchronize()
    ties += check_topk(f"K7 ({where})", got, want, exact_of, SERVE_TOL)[1]
    index = ann.build_index(unit.cpu().numpy(), "ivf", device=dev)
    rb = min(RESCORE_MULT * kb, v)
    a8 = (qn, index.table_q, index.scale, rb, valid)
    got, want = quant_scan.quant_scan(*a8), quant_scan.quant_scan_plain(*a8)
    torch.cuda.synchronize()
    bitwise("K8", got, want)
    fs = rescore.rescore(qn, unit, got[1], got[0], kb)
    fw = rescore.rescore_plain(qn, unit, want[1], want[0], kb)
    torch.cuda.synchronize()
    ties += check_topk(f"K9r ({where})", fs, fw, exact_of, SERVE_TOL)[1]
    nprobe = min(max(8, -(-kb // index.list_len)), index.n_clusters)
    a9 = (qn, index.centroids, index.lists, index.table_q, index.scale, nprobe, rb, valid)
    got, want = ivf_scan.ivf_scan(*a9), ivf_scan.ivf_scan_plain(*a9)
    torch.cuda.synchronize()
    tied = probe_near_ties(torch, qn, index.centroids, nprobe)
    bitwise("K9", got, want, ~tied)
    ties += int(tied.sum())
    i16 = ann.build_index(unit.cpu().numpy(), "quant", quant_dtype="bf16", device=dev)
    q16 = qn.to(torch.bfloat16).float()

    def bf16_of(ids):
        s = (q16[:, None, :] * i16.table_q[ids].float()).sum(-1)
        return s.masked_fill(ids >= valid, float("-inf"))

    a16 = (qn, i16.table_q, i16.scale, rb, valid)
    got, want = quant_scan.quant_scan(*a16), quant_scan.quant_scan_plain(*a16)
    torch.cuda.synchronize()
    ties += check_topk(f"K8 bf16 ({where})", got, want, bf16_of, SERVE_TOL)[1]
    return ties


# -- phase 2d: the serving repairs (bf16 tables; lists past 8,192) -------------

LONG_RB = 16384             # R2: k = 256 (kb 512) at --rescore-mult 32


def serving_repairs_check(torch, reps):
    """R1: K8 and K9 on a bf16 index (B in SERVE_BATCHES, kb = 16) against
    their plain versions — scores within SERVE_TOL, ids equal except
    counted near-ties.  R2: K8 at B = 64, kb = 512, rb = LONG_RB against
    its plain version, scores and ids bitwise.  Returns one record per
    (kernel, shape) for the ``serving_kernel_shapes`` line."""
    from gene2vec_tpu_torch.kernels import _topk, ivf_scan, quant_scan
    from gene2vec_tpu_torch.obs.profiler import bound
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

    def record(name, b, kb, rb, err, ties, fn_k, fn_p, work, fn_lib=None, route=STAGED_ROUTE):
        b_ms, b_by = bound(work)
        rec = {"name": name, "batch": b, "kb": kb, "rb": rb, "max_abs_err": err,
               "near_ties": ties, "ms": timer(fn_k), "plain_ms": timer(fn_p),
               "library_ms": timer(fn_lib) if fn_lib else None, "bound_ms": b_ms,
               "bound_by": b_by, "route": route,
               "launches_by_kernel": launches_by_kernel(torch, fn_k)}
        records.append(rec)
        log(f"{name} B {b} kb {kb} rb {rb}: max_abs_err {err:.3e}, near-ties {ties}, kernel "
            f"{rec['ms']:.4f} ms, plain {rec['plain_ms']:.4f} ms, library {rec['library_ms']} "
            f"ms, bound {b_ms:.4f} ms ({b_by}); {route}")

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
        library_check("K8 bf16", lib_quant_scan_bf16(torch, *a8)[:1], want[:1], rtol=SERVE_TOL)
        record("quant_scan_bf16", b, kb, rb, err, ties, lambda: quant_scan.quant_scan(*a8),
               lambda: quant_scan.quant_scan_plain(*a8), quant_scan.work(V, D, b, rb, "bfloat16"),
               fn_lib=lambda: lib_quant_scan_bf16(torch, *a8))
        a9 = (qn, index.centroids, index.lists, index.table_q, index.scale, nprobe, rb)
        got, want = ivf_scan.ivf_scan(*a9), ivf_scan.ivf_scan_plain(*a9)
        torch.cuda.synchronize()
        tied = probe_near_ties(torch, qn, index.centroids, nprobe)
        keep = ~tied
        err, ties = check_topk(
            "K9 bf16", (got[0][keep], got[1][keep]), (want[0][keep], want[1][keep]),
            lambda ids: (q16[keep][:, None, :] * index.table_q[ids].float()).sum(-1),
            SERVE_TOL)
        cand = ivf_scan.probed(qn, index.centroids, index.lists, nprobe)
        library_check("K9 bf16", lib_ivf_scan_bf16(torch, *a9)[:1], want[:1], rtol=SERVE_TOL)
        record("ivf_scan_bf16", b, kb, rb, err, ties + int(tied.sum()),
               lambda: ivf_scan.ivf_scan(*a9), lambda: ivf_scan.ivf_scan_plain(*a9),
               ivf_scan.work(b, D, c, nprobe, lst, got[0].shape[1], int(cand.numel()),
                             int(torch.unique(cand).numel()), "bfloat16"),
               fn_lib=lambda: lib_ivf_scan_bf16(torch, *a9),
               route=ivf_route(ivf_scan, qn, index.centroids, index.table_q, nprobe, rb, lst))
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
           lambda: quant_scan.quant_scan_plain(*a8), quant_scan.work(V, D, b, LONG_RB))
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
    touched_step_check(torch, "stratified")
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
    check_run_records(out, ITERS, "phase 3")
    return counts


def touched_step_check(torch, label, **config_kw):
    """One full-width step of the configuration ``config_kw`` (B Zipf pairs,
    random tables at its width) through the trainer and the step's own
    producers, with K4's wrappers watched.  Before each finalize, every
    accumulator row outside the rows it visits — those the step names, and
    in row_update the rows it scatters into — must be all +0 bits
    (row_update: before its scatter and after); after it, the table must
    equal, bit for bit,
    every row's plain finalize of the same start table on the same
    accumulator.  Runs outside any timed region.  Returns the rows each
    finalize visited, {table: [rows, share]}, into TOUCHED_SHARES."""
    from gene2vec_tpu_torch.config import SGNSConfig
    from gene2vec_tpu_torch.data.pipeline import PairCorpus
    from gene2vec_tpu_torch.io.vocab import Vocab
    from gene2vec_tpu_torch.kernels import row_update as ru
    from gene2vec_tpu_torch.sgns import cbow_hs as ch
    from gene2vec_tpu_torch.sgns import step as st
    from gene2vec_tpu_torch.sgns.train import epoch_generator

    rng = np.random.RandomState(7)
    pairs = np.stack([zipf_ids(rng, B, V), zipf_ids(rng, B, V)], 1)
    counts = np.bincount(pairs.reshape(-1), minlength=V) + 1
    vocab = Vocab([f"G{i}" for i in range(V)], counts)
    tr = ch.make_trainer(PairCorpus(vocab, pairs), SGNSConfig(**config_kw), device=DEVICE)
    p = tr.init()
    gen = torch.Generator().manual_seed(7)
    params = type(p)(*((torch.randn(t.shape, generator=gen) * 0.1).to(t.device, t.dtype)
                       for t in p))
    shares = {}
    orig = st.row_update, st.finalize_rows, ch.finalize_rows

    def visited(acc, ids, touched):
        rows = torch.zeros(acc.shape[0], dtype=torch.bool, device=acc.device)
        if touched is None:
            return rows.fill_(True)
        for i in ids:
            rows[i.long()] = True
        rows[touched.rows(acc.device)] = True
        return rows

    def invariant(what, acc, rows):
        bad = (acc[~rows].view(torch.int32) != 0).any(1)
        if bool(bad.any()):
            r = int((~rows).nonzero()[int(bad.nonzero()[0])])
            raise SystemExit(f"touched rows, {label}: {what} row {r} is outside the rows the "
                             "finalize visits and is not all +0")

    def same_as_every_row(what, table, start, acc, lr, combiner, salts):
        want = start.clone()
        ru.finalize_rows_plain(want, acc, lr, combiner, salts)
        torch.cuda.synchronize()
        bitwise_tables(torch, f"touched rows, {label}: {what}", [("table", table, want)])

    def finalize(table, acc, lr, combiner, salts=None, touched=None):
        rows = visited(acc, [], touched)
        what = "emb" if not shares else "out table"
        invariant(f"{what} accumulator", acc, rows)
        start = table.clone()
        orig[1](table, acc, lr, combiner, salts, touched)
        same_as_every_row(f"finalize_rows {what}", table, start, acc, lr, combiner, salts)
        n = int(rows.sum())
        shares[what] = [n, n / table.shape[0]]

    def update(emb, ctx, acc_emb, acc_ctx, centers, contexts, d_center, v, g_pos, lr,
               combiner, salts=None, touched=None):
        te, tc = (None, None) if touched is None else touched
        sets = ((emb, acc_emb, visited(acc_emb, [centers], te), "emb"),
                (ctx, acc_ctx, visited(acc_ctx, [contexts], tc), "ctx"))
        for _, acc, rows, what in sets:
            invariant(f"{what} accumulator before the scatter", acc, rows)
        starts = emb.clone(), ctx.clone()
        orig[0](emb, ctx, acc_emb, acc_ctx, centers, contexts, d_center, v, g_pos, lr,
                combiner, salts, touched)
        for i, (table, acc, rows, what) in enumerate(sets):
            invariant(f"{what} accumulator after the scatter", acc, rows)
            same_as_every_row(f"row_update {what}", table, starts[i], acc, lr, combiner,
                              None if salts is None else salts[i])
            n = int(rows.sum())
            shares[what] = [n, n / table.shape[0]]

    st.row_update, st.finalize_rows, ch.finalize_rows = update, finalize, finalize
    try:
        tr.train_epoch(params, generator=epoch_generator(1, 0))
        torch.cuda.synchronize()
    finally:
        st.row_update, st.finalize_rows, ch.finalize_rows = orig
    if tr.num_batches != 1 or len(shares) != 2:
        raise SystemExit(f"touched rows, {label}: expected one step and two finalizes, got "
                         f"{tr.num_batches} steps and {sorted(shares)}")
    TOUCHED_SHARES[f"step {label}"] = shares
    log(f"touched rows, {label}: the finalizes visited {shares} (rows, share); every other "
        "accumulator row +0, tables bitwise every row's finalize")
    return shares


def config_of(flags) -> dict:
    """The SGNSConfig fields a run's CLI flags set ("--negative-mode x" →
    negative_mode="x")."""
    return {f[2:].replace("-", "_"): x for f, x in zip(flags[::2], flags[1::2])}


# -- phase 3b: every other objective and noise mode through the CLI ------------

OBJECTIVE_PAIRS, OBJECTIVE_ITERS = 500_000, 2
#: (label, CLI flags, {kernel: launches per step}) — every other kernel
#: must not launch in that run
OBJECTIVE_RUNS = (
    ("per_example", ["--negative-mode", "per_example"],
     {"pos_logit": 1, "per_example": 1, "row_scatter": 1, "row_finalize": 2}),
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
     {"pos_logit_bf16": 1, "per_example_bf16": 1, "row_scatter": 1,
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
        touched_step_check(torch, label, **config_of(flags))
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
        check_run_records(out, OBJECTIVE_ITERS, f"training {label}")
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
    from gene2vec_tpu_torch.eval import planted
    from gene2vec_tpu_torch.sgns.cbow_hs import make_trainer
    from gene2vec_tpu_torch.sgns.train import epoch_generator

    vocab, corpus = planted.planted_corpus()
    cfg = SGNSConfig(dim=64, batch_pairs=1024, num_iters=15, **config_kw)
    tr = make_trainer(corpus, cfg, device=DEVICE)
    params = tr.init()
    for it in range(1, 16):
        params, loss = tr.train_epoch(params, generator=epoch_generator(cfg.seed, it))
    intra, inter = planted.cluster_cosines(vocab, params.emb.float().cpu().numpy())
    log(f"planted clusters {config_kw or 'default'}: intra {intra:.4f} (> {planted.INTRA_MIN}), "
        f"inter {inter:.4f} (< {planted.INTER_MAX}), last loss {float(loss):.4f}"
        f"{'' if gate else ' (reported)'}")
    if not np.isfinite(float(loss)):
        raise SystemExit(f"planted clusters ({config_kw}): loss {float(loss)}")
    if gate and not (intra > planted.INTRA_MIN and inter < planted.INTER_MAX):
        raise SystemExit(f"planted clusters did not separate ({config_kw}): {intra}, {inter}")


# -- phase 4b: the quality tooling and the run records -------------------------

#: the holdout protocol's synthetic reference-format split: HOLDOUT_GENES
#: genes in HOLDOUT_GROUPS groups; HOLDOUT_PAIRS labelled pairs, half
#: within one group (label 1) and half at random (label 0); trained as the
#: reference gate trains (D, B, 50 epochs)
HOLDOUT_GENES, HOLDOUT_GROUPS, HOLDOUT_PAIRS, HOLDOUT_EPOCHS = 4000, 200, 60_000, 50
#: batches of the fit_epoch parity check (B = GG_B, full width)
FIT_EPOCH_BATCHES = 8


def write_holdout_split(path: str, seed: int = 15) -> None:
    """A ``train_text.txt`` / ``train_label.txt`` split in the reference's
    format (predictionData/'s), made from ``seed``."""
    rng = np.random.RandomState(seed)
    group = rng.randint(0, HOLDOUT_GROUPS, HOLDOUT_GENES)
    members = [np.flatnonzero(group == g) for g in range(HOLDOUT_GROUPS)]
    half = HOLDOUT_PAIRS // 2
    lines, labels = [], []
    for g in rng.randint(0, HOLDOUT_GROUPS, half):
        a, b = rng.choice(members[g], 2, replace=False)
        lines.append(f"G{a} G{b}")
        labels.append(1)
    for a, b in rng.randint(0, HOLDOUT_GENES, (half, 2)):
        lines.append(f"G{a} G{b}")
        labels.append(int(group[a] == group[b]))
    order = rng.permutation(len(lines))
    os.makedirs(path, exist_ok=True)
    with open(os.path.join(path, "train_text.txt"), "w") as f:
        f.write("".join(lines[i] + "\n" for i in order))
    with open(os.path.join(path, "train_label.txt"), "w") as f:
        f.write("".join(f"{labels[i]}\n" for i in order))


def fit_epoch_parity(torch, batches=FIT_EPOCH_BATCHES):
    """One ``GGIPNNTrainer.fit_epoch`` on the card against the CPU's from
    the same params, data and ``FitDraws`` (batch order and dropout
    masks), the table trained, at full width: each parameter tensor within
    GG_PARAM_RTOL of its max |CPU value| and the mean loss within
    GG_LOSS_RTOL (GGIPNN's bar); the accuracy is reported (a prediction
    within rounding of a tie may flip after several steps)."""
    from gene2vec_tpu_torch.config import GGIPNNConfig
    from gene2vec_tpu_torch.models.ggipnn import init_params_numpy
    from gene2vec_tpu_torch.models.ggipnn_train import FitDraws, GGIPNNTrainer

    v, d, b = V, D, GG_B
    cfg = GGIPNNConfig(embedding_dim=d, batch_size=b, embed_train=True)
    p0 = init_params_numpy(2, v, cfg)
    rng = np.random.RandomState(16)
    n = b * batches + b // 2  # a ragged tail the epoch leaves out
    x = rng.randint(0, v, (n, 2)).astype(np.int32)
    y = np.eye(2, dtype=np.float32)[rng.randint(0, 2, n)]
    draws = FitDraws(masks=[[rng.rand(b, h) < cfg.dropout_keep_prob for h in cfg.hidden_dims]
                            for _ in range(batches)],
                     orders=rng.permutation(batches)[None])
    out = {}
    for dev in ("cpu", DEVICE):
        tr = GGIPNNTrainer(cfg, ggipnn_vocab(v), device=dev)
        tr.init_state(params=p0)
        _, _, loss, acc = tr.fit_epoch(x, y, draws)
        out[dev] = (float(loss), float(acc), tr.model.to_flat())
    (lc, ac, pc), (lg, ag, pg) = out["cpu"], out[DEVICE]
    label = f"fit_epoch card vs CPU (V {v}, D {d}, B {b}, {batches} batches)"
    rel = abs(lc - lg) / abs(lc)
    worst = max(float(np.abs(pg[k] - pc[k]).max()) / float(np.abs(pc[k]).max()) for k in pc)
    if not (rel <= GG_LOSS_RTOL and worst <= GG_PARAM_RTOL):
        raise SystemExit(f"{label}: loss {lg} vs {lc} (rel {rel:.2e}), params max rel "
                         f"{worst:.2e}")
    log(f"{label}: loss rel {rel:.2e}, params max rel {worst:.2e}, accuracy {ag} vs {ac}")
    return {"loss_rel": rel, "max_param_rel": worst, "accuracy": [ag, ac]}


def quality_tooling(torch, work: str, smi: str) -> dict:
    """The port's quality tooling on the card, as the reference bench's
    gate runs it (bench.py:987-1084): ``train_epochs`` over
    ``eval/planted.py``'s corpus at the gate's settings (dim 64, batch
    min(B, 1024), 15 epochs) and at D = 200, each gated on INTRA_MIN,
    INTER_MAX and the loss escaping ln 2·(1 + K) − 1; the holdout protocol
    (``eval/holdout.py``) on a split written from a seed (its AUC
    printed, the band not asserted: the split is synthetic); one
    ``fit_epoch`` card vs CPU.  The launch counts, zeroed before and read
    after: K1-K4 once per step of every ``train_epochs`` run, ``row_gather``
    once per step of the card's ``fit_epoch``.  Returns them."""
    from gene2vec_tpu_torch import kernels
    from gene2vec_tpu_torch.config import SGNSConfig
    from gene2vec_tpu_torch.eval import holdout, planted
    from gene2vec_tpu_torch.sgns.train import train_epochs

    plateau = float(np.log(2.0) * (1 + K))
    kernels.reset_launch_counts()
    steps = 0
    out = {"card": smi}
    for dim in (64, D):
        t0 = time.perf_counter()
        vocab, corpus = planted.planted_corpus()
        cfg = SGNSConfig(dim=dim, batch_pairs=min(B, 1024))
        emb, losses = train_epochs(corpus, cfg, 15, device=DEVICE)
        steps += (corpus.num_pairs // cfg.batch_pairs) * 15
        intra, inter = planted.cluster_cosines(vocab, emb)
        rec = {"intra": intra, "inter": inter, "loss_first": losses[0],
               "loss_last": losses[-1], "s": time.perf_counter() - t0}
        out[f"planted_dim_{dim}"] = rec
        log(f"phase 4b: planted, dim {dim} ({smi}): {json.dumps(rec)}")
        if not (np.isfinite(emb).all() and intra > planted.INTRA_MIN
                and inter < planted.INTER_MAX and losses[-1] < plateau - 1.0):
            raise SystemExit(f"phase 4b: the planted gate failed at dim {dim}: {rec}")
    t0 = time.perf_counter()
    root = os.path.join(work, "holdout_data")
    write_holdout_split(root)
    corpus, split = holdout.load_holdout(root)
    emb, losses = train_epochs(corpus, SGNSConfig(dim=D, batch_pairs=B), HOLDOUT_EPOCHS,
                               device=DEVICE)
    steps += (corpus.num_pairs // min(B, corpus.num_pairs)) * HOLDOUT_EPOCHS
    if not (np.isfinite(emb).all() and np.isfinite(losses).all()):
        raise SystemExit(f"phase 4b: holdout training diverged: {losses[:3]}...")
    auc = holdout.holdout_cos_auc(corpus.vocab, emb, split)
    out["holdout"] = {"pairs": corpus.num_pairs, "held_out": len(split.hold_pairs),
                      "auc": auc, "in_gate_band": holdout.auc_in_gate_band(auc),
                      "loss_first": losses[0], "loss_last": losses[-1],
                      "s": time.perf_counter() - t0}
    log(f"phase 4b: holdout ({smi}): {json.dumps(out['holdout'])} (the band is reported: "
        "the split is synthetic)")
    out["fit_epoch"] = fit_epoch_parity(torch)
    torch.cuda.synchronize()
    counts = kernels.launch_counts()
    want = expected_launches(dict.fromkeys(STEP_KERNELS, 1), steps, STEP_KERNELS)
    want["row_gather"] = FIT_EPOCH_BATCHES
    got = {k: counts[k] for k in want}
    if got != want:
        raise SystemExit(f"phase 4b: launch counts {got}, expected {want}")
    print(json.dumps({"quality_tooling": out}))
    return got


# -- phase 4c: kernel cost attribution (obs/profiler.py) -----------------------

ATTR_PAIRS = 500_000        # the profiled training runs' corpus
K10_MEASURE_SHARE = 0.10    # KernelProfiler.measure against the Timer's K10 row (7c)
ATTR_ITERS = 2              # ... and iterations
ATTR_SPAN_SHARE = 0.02      # attributed seconds against the iteration spans
ATTR_NAMES = ("sgns_train_step", "cbow_hs_step", "ggipnn_step")
SERVE_BUCKETS = (1, 2, 4, 8, 16, 32, 64)   # the server's batch buckets (max_batch 64)


def attribution_records(run_dir: str, names) -> dict:
    """{name: record} of ``run_dir``'s kernels.jsonl: each of ``names`` with
    non-null flops, bytes_accessed, best_wall_s and utilization against
    the card's data-sheet peaks, its utilization at most 1.0 (past it a
    work count is wrong: a count fault to repair, not a bar to move)."""
    from gene2vec_tpu_torch.obs.profiler import read_kernels

    recs = {r["name"]: r for r in read_kernels(run_dir)}
    for name in names:
        r = recs.get(name)
        if r is None or any(r.get(k) is None for k in
                            ("flops", "bytes_accessed", "best_wall_s", "utilization")):
            raise SystemExit(f"kernels.jsonl in {run_dir}: {name} incomplete: {r}")
        if r["backend"].get("provenance") != "gpu-device-facts":
            raise SystemExit(f"{name}: peaks {r['backend']}, not the card's data sheet")
        if r["utilization"] > 1.0:
            raise SystemExit(f"{name}: utilization {r['utilization']:.3f} over 1.0 (a work "
                             "count is wrong)")
    return recs


def attribution_summary(rec: dict) -> dict:
    """A record's printed fields; the bound is utilization × best wall (the
    larger of the bytes' and the operations' least time)."""
    return {"best_wall_s": rec["best_wall_s"], "utilization": rec["utilization"],
            "bound": rec["bound"], "bound_ms": rec["utilization"] * rec["best_wall_s"] * 1e3,
            "flops": rec["flops"], "bytes_accessed": rec["bytes_accessed"],
            "calls": rec["calls"], "compile_s": rec["compile_s"],
            "peak_memory_bytes": rec["peak_memory_bytes"]}


def profiled_training(torch, work: str, objective: str, name: str, pairs, vocab) -> dict:
    """One ``run()`` of the default configuration at ``objective`` with
    ``kernel_profile`` over ``pairs`` (ATTR_ITERS iterations, no text
    export): its record of ``name``, the attributed seconds within
    ATTR_SPAN_SHARE of the iteration spans' sum, goodput's per-kernel
    breakdown summing to its compute bucket.  Returns the summary with the
    ``kernel_attribution`` span's seconds (the attributed epoch and its
    host pass of distinct-row counts)."""
    from gene2vec_tpu_torch.config import SGNSConfig
    from gene2vec_tpu_torch.data.pipeline import PairCorpus
    from gene2vec_tpu_torch.sgns.cbow_hs import make_trainer

    out = os.path.join(work, objective)
    cfg = SGNSConfig(objective=objective, num_iters=ATTR_ITERS, txt_output=False,
                     kernel_profile=True)
    tr = make_trainer(PairCorpus(vocab, pairs), cfg, device=DEVICE)
    t0 = time.perf_counter()
    tr.run(out, log=log)
    wall = time.perf_counter() - t0
    rec = attribution_records(out, (name,))[name]
    with open(os.path.join(out, "events.jsonl")) as f:
        ends = [e for e in map(json.loads, filter(str.strip, f)) if e["type"] == "span_end"]
    spans = sum(e["dur"] for e in ends if e["name"] == "iteration")
    if abs(rec["wall_s"] - spans) > ATTR_SPAN_SHARE * spans:
        raise SystemExit(f"{name}: attributed {rec['wall_s']:.4f}s, the iteration spans "
                         f"{spans:.4f}s")
    with open(os.path.join(out, "manifest.json")) as f:
        g = json.load(f)["goodput"]
    kernels_s = g.get("compute_kernels_s") or {}
    if name not in kernels_s or abs(sum(kernels_s.values()) - g["buckets_s"]["compute"]) > 1e-5:
        raise SystemExit(f"{name}: goodput's kernel breakdown {kernels_s} against its compute "
                         f"bucket {g['buckets_s']['compute']}")
    with open(os.path.join(out, "metrics.prom")) as f:
        series = parse_prometheus(f.read())
    if f'kernel_utilization{{kernel="{name}"}}' not in series:
        raise SystemExit(f"{name}: metrics.prom lacks its kernel_* gauges")
    attribution = next(e["dur"] for e in ends if e["name"] == "kernel_attribution")
    return {**attribution_summary(rec), "wall_s": rec["wall_s"], "iteration_spans_s": spans,
            "span_share": abs(rec["wall_s"] - spans) / spans, "run_wall_s": wall,
            "attribution_span_s": attribution, "pairs_per_epoch": tr.num_batches * cfg.batch_pairs,
            "goodput_kernels_s": kernels_s, "export": out}


def serve_attribution(torch, export: str, work: str) -> dict:
    """Each index mode's server (``cli/serve.py --kernel-profile``, a
    subprocess on the card): one POST filling each batch bucket, /metrics
    scraped before and after; every bucket's ``kernel_flops`` present and
    the requests' ``kernel_launches_total`` equal to what the same requests
    launch through an in-process ``ServeApp`` without the flag."""
    import http.client
    from urllib.parse import urlparse

    from gene2vec_tpu_torch import kernels
    from gene2vec_tpu_torch.obs.profiler import bound
    from gene2vec_tpu_torch.serve.registry import ModelRegistry
    from gene2vec_tpu_torch.serve.server import ServeApp, ServeConfig

    rng = np.random.RandomState(22)
    requests = [{"genes": [f"G{i}" for i in rng.choice(V, n, replace=False)], "k": 10}
                for n in SERVE_BUCKETS]
    out = {}
    for mode in SERVE_MODES:
        registry = ModelRegistry(export, index_mode=mode, device=DEVICE)
        if not registry.refresh():
            raise SystemExit(f"{export}: no export to serve")
        app = ServeApp(registry, ServeConfig(index=mode, cache_size=0,
                                             nprobe=SERVE_NPROBE)).start()
        try:
            torch.cuda.synchronize()
            before = kernels.launch_counts()
            for body in requests:
                status, _ = app.handle("POST", "/v1/similar", body)
                if status != 200:
                    raise SystemExit(f"{mode} in process: POST /v1/similar {status}")
            torch.cuda.synchronize()
            after = kernels.launch_counts()
            plain = {k: after[k] - before.get(k, 0) for k in after if after[k] != before.get(k, 0)}
            model = registry.model
            kb = app.engine.k_bucket(16, len(model))
            bounds = {b: bound(app.engine.bucket_work(
                b, kb, app.engine.r_bucket(kb, len(model)), len(model), model.dim, len(model),
                getattr(model, "ann", None)))[0] for b in SERVE_BUCKETS}
        finally:
            app.stop()
        proc, info = start_server(export, mode, os.path.join(work, f"attr_{mode}.err"),
                                  ("--kernel-profile",))
        try:
            u = urlparse(info["url"])
            conn = http.client.HTTPConnection(u.hostname, u.port, timeout=120)

            def scrape():
                status, raw, _ = _send(conn, "GET", "/metrics", None)
                if status != 200:
                    raise SystemExit(f"{mode} /metrics: {status}")
                return parse_prometheus(raw.decode())

            first = scrape()
            for body in requests:
                status, _, _ = _send(conn, "POST", "/v1/similar", body)
                if status != 200:
                    raise SystemExit(f"{mode} server: POST /v1/similar {status}")
            last = scrape()
            conn.close()
        finally:
            stop_server(proc)
        with open(os.path.join(work, f"attr_{mode}.err")) as f:
            said = [ln for ln in f if ln.startswith("kernel profile:")]
        key = 'kernel_launches_total{kernel="%s"}'
        served = {k: last.get(key % k, 0) - first.get(key % k, 0) for k in kernels.launch_counts()
                  if last.get(key % k, 0) != first.get(key % k, 0)}
        if served != plain:
            raise SystemExit(f"{mode}: launches with --kernel-profile {served}, without {plain}")
        flops = {b: last.get(f'kernel_flops{{kernel="serve_topk_{mode}/b{b}"}}')
                 for b in SERVE_BUCKETS}
        if not said or not all(flops.values()):
            raise SystemExit(f"{mode}: kernel_flops by bucket {flops}; stderr {said}")
        out[mode] = {"launches": served, "kernel_flops": flops, "bound_ms": bounds,
                     "kernel_bytes_accessed": {
                         b: last.get(f'kernel_bytes_accessed{{kernel="serve_topk_{mode}/b{b}"}}')
                         for b in SERVE_BUCKETS}}
        log(f"serve_topk_{mode}: {json.dumps(out[mode])}")
    return out


def kernel_attribution(torch, work: str, smi: str) -> dict:
    """Phase 4c: kernel cost attribution (``obs/profiler.py``) on the card —
    the default configuration's SGNS and CBOW-HS runs with
    ``kernel_profile`` (``profiled_training``), GGIPNN's step attributed at
    B = 1,024 (``GGIPNNTrainer.profile_kernel``) with one timed
    ``fit_epoch`` over 262,144 pairs observed, and a ``--kernel-profile``
    server in each index mode over the SGNS run's export
    (``serve_attribution``).  Every record carries the card's peaks and a
    utilization of at most 1.0.  A ``{"kernel_attribution": ...}`` stdout
    line with each name's best wall, utilization and bound."""
    from gene2vec_tpu_torch.config import GGIPNNConfig
    from gene2vec_tpu_torch.io.vocab import Vocab
    from gene2vec_tpu_torch.models.ggipnn_train import GGIPNNTrainer
    from gene2vec_tpu_torch.obs.profiler import KernelProfiler

    t_phase = time.perf_counter()
    rng = np.random.RandomState(21)
    pairs = np.stack([zipf_ids(rng, ATTR_PAIRS, V), zipf_ids(rng, ATTR_PAIRS, V)], 1)
    vocab = Vocab([f"G{i}" for i in range(V)], np.bincount(pairs.reshape(-1), minlength=V) + 1)
    out = {}
    for objective, name in (("sgns", "sgns_train_step"), ("cbow_hs", "cbow_hs_step")):
        out[name] = profiled_training(torch, work, objective, name, pairs, vocab)
        log(f"{name} ({smi}): {json.dumps(out[name])}")
    cfg = GGIPNNConfig(embedding_dim=D, batch_size=GG_B_LARGE)
    tr = GGIPNNTrainer(cfg, ggipnn_vocab(V), device=DEVICE)
    tr.init_state()
    x = rng.randint(0, V, (GG_RATE_PAIRS, 2)).astype(np.int32)
    y = np.eye(2, dtype=np.float32)[rng.randint(0, 2, GG_RATE_PAIRS)]
    gg_dir = os.path.join(work, "ggipnn")
    kp = KernelProfiler(run_dir=gg_dir, device=DEVICE)
    tr.profile_kernel(kp, None, None, x[:GG_B_LARGE], y[:GG_B_LARGE])
    xt, yt = tr._tensors(x, y)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    _, _, loss, _ = tr.fit_epoch(xt, yt)
    float(loss)
    kp.observe("ggipnn_step", time.perf_counter() - t0, calls=GG_RATE_PAIRS // GG_B_LARGE)
    kp.flush()
    out["ggipnn_step"] = attribution_summary(
        attribution_records(gg_dir, ("ggipnn_step",))["ggipnn_step"])
    log(f"ggipnn_step ({smi}): {json.dumps(out['ggipnn_step'])}")
    out["serving"] = serve_attribution(torch, out["sgns_train_step"]["export"], work)
    out["phase_s"] = time.perf_counter() - t_phase
    print(json.dumps({"kernel_attribution": out, "card": smi}), flush=True)
    log(f"kernel attribution phase: {out['phase_s']:.1f}s")
    return out


# -- phase 4d: the run reports on the card's own records (cli/obs.py) -----------

REPORT_RATE_TOL = 1e-9      # the report's pairs/s against the iteration spans (relative)
REPORT_BUCKET_SHARE = 0.01  # the trace's phase events against goodput's compute bucket
REPORT_PHASES = ("host_ingest", "dispatch", "compute", "ckpt_stage")  # the reference's


def obs_cli(argv) -> tuple:
    """(exit code, stdout, stderr) of one ``cli/obs.py`` call in process."""
    import contextlib
    import io

    from gene2vec_tpu_torch.cli.obs import main as obs_main

    out, err = io.StringIO(), io.StringIO()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
        rc = obs_main(argv)
    return rc, out.getvalue(), err.getvalue()


def report_check(run_dir: str, name: str) -> dict:
    """``report <run_dir> --json`` against the run's own files: pairs/s the
    iteration spans' pairs over their seconds (REPORT_RATE_TOL), goodput the
    manifest's block, ``name`` in the kernels block, the peak device bytes
    and compile events above 0; the text report renders."""
    rc, out, err = obs_cli(["report", run_dir, "--json"])
    if rc != 0:
        raise SystemExit(f"obs report {run_dir}: exit {rc}: {err}")
    s = json.loads(out)
    with open(os.path.join(run_dir, "events.jsonl")) as f:
        iters = [e for e in map(json.loads, filter(str.strip, f))
                 if e["type"] == "span_end" and e["name"] == "iteration"]
    want = sum(e["attrs"]["pairs"] for e in iters) / sum(e["dur"] for e in iters)
    rate_err = abs(s["pairs_per_sec"] - want) / want
    with open(os.path.join(run_dir, "manifest.json")) as f:
        goodput = json.load(f)["goodput"]
    top = [t["name"] for t in (s["kernels"] or {}).get("top", [])]
    peak = s["peak"]
    if (rate_err > REPORT_RATE_TOL or s["goodput"] != goodput or name not in top
            or not peak.get("hbm_bytes", 0) > 0 or not peak.get("jit_compiles", 0) > 0):
        raise SystemExit(f"obs report {run_dir}: pairs/s {s['pairs_per_sec']} against the "
                         f"spans' {want}; goodput equal {s['goodput'] == goodput}; kernels "
                         f"{top}; peak {peak}")
    rc, text, err = obs_cli(["report", run_dir])
    if rc != 0 or "throughput:" not in text:
        raise SystemExit(f"obs report {run_dir} (text): exit {rc}: {err}")
    return {"pairs_per_sec": s["pairs_per_sec"], "iteration_spans_rate": want,
            "rate_rel_err": rate_err, "kernels": top, "peak": peak,
            "phases": {k: v["count"] for k, v in s["phases"].items()}}


def timeline_check(run_dir: str, work: str) -> dict:
    """``timeline <run_dir> --out``: the reference's phase tracks, no X
    event of negative duration, one phase event a ``timeline.jsonl``
    record at its start (ts over 1e6 plus t0 within 1 us of its wall), and
    those events, back in seconds, give goodput's compute bucket within
    REPORT_BUCKET_SHARE of the manifest's."""
    from gene2vec_tpu_torch.obs import goodput
    from gene2vec_tpu_torch.obs.timeline import TIMELINE_NAME, read_timeline

    path = os.path.join(work, "sgns_trace.json")
    rc, _, err = obs_cli(["timeline", run_dir, "--out", path])
    if rc != 0:
        raise SystemExit(f"obs timeline {run_dir}: exit {rc}: {err}")
    with open(path) as f:
        doc = json.load(f)
    tracks = doc["otherData"]["phase_tracks"]
    xs = [e for e in doc["traceEvents"] if e["ph"] == "X"]
    phases = [e for e in xs if e["cat"] == "phase"]
    records = read_timeline(os.path.join(run_dir, TIMELINE_NAME))
    t0 = doc["otherData"]["t0_unix"]
    offset = max((abs(e["ts"] / 1e6 + t0 - r["wall"]) for e, r in zip(phases, records)),
                 default=0.0)
    with open(os.path.join(run_dir, "manifest.json")) as f:
        g = json.load(f)["goodput"]
    back = goodput.summarize([{"name": e["name"], "dur": e["dur"] / 1e6} for e in phases],
                             g["wall_s"])["buckets_s"]["compute"]
    share = abs(back - g["buckets_s"]["compute"]) / g["buckets_s"]["compute"]
    if (not set(REPORT_PHASES) <= set(tracks) or any(e["dur"] < 0 for e in xs)
            or len(phases) != len(records)
            or [e["name"] for e in phases] != [r["name"] for r in records]
            or offset > 1e-6 or share > REPORT_BUCKET_SHARE):
        raise SystemExit(f"obs timeline {run_dir}: tracks {tracks}, {len(phases)} phase "
                         f"events for {len(records)} records, offset {offset}, compute "
                         f"{back} against the manifest's {g['buckets_s']['compute']}")
    return {"phase_tracks": tracks, "x_events": len(xs), "phase_events": len(phases),
            "max_offset_s": offset, "compute_s": back,
            "manifest_compute_s": g["buckets_s"]["compute"], "compute_rel_err": share}


def run_reports(attribution: dict, work: str, smi: str) -> dict:
    """Phase 4d: ``cli/obs.py`` over phase 4c's records in ``work`` —
    ``report`` of the SGNS and CBOW-HS runs (``report_check``),
    ``timeline`` of the SGNS run (``timeline_check``), ``kernels`` and
    ``list`` of ``work``, ``ledger --check`` over the repo root (every
    matching artifact ingested, none in error); the process's library
    loads equal to the libraries ``build`` holds.  A ``{"run_reports":
    ...}`` stdout line with each reading, the servers' compile events
    (phases 2g and 5) and the phase's seconds."""
    from gene2vec_tpu_torch.kernels import build
    from gene2vec_tpu_torch.obs import ledger
    from gene2vec_tpu_torch.obs.probes import CompileWatcher

    t_phase = time.perf_counter()
    sgns = attribution["sgns_train_step"]["export"]
    cbow = attribution["cbow_hs_step"]["export"]
    out = {"report": {"sgns_train_step": report_check(sgns, "sgns_train_step"),
                      "cbow_hs_step": report_check(cbow, "cbow_hs_step")},
           "timeline": timeline_check(sgns, work)}
    rc, text, err = obs_cli(["kernels", work, "--json"])
    names = sorted({r["name"] for r in json.loads(text)}) if rc == 0 else []
    if not set(ATTR_NAMES) <= set(names) or obs_cli(["kernels", work])[0] != 0:
        raise SystemExit(f"obs kernels {work}: exit {rc}, names {names}: {err}")
    out["kernels"] = names
    rc, text, _ = obs_cli(["list", work])
    listed = text.splitlines()
    if rc != 0 or not {sgns, cbow} <= set(listed):
        raise SystemExit(f"obs list {work}: exit {rc}: {listed}")
    out["list"] = [os.path.relpath(d, work) for d in listed]
    path = os.path.join(work, "ledger.jsonl")
    rc, _, err = obs_cli(["ledger", ROOT, "--check", "--out", path])
    with open(path) as f:
        records = [json.loads(line) for line in f]
    matched = [n for n in os.listdir(ROOT)
               if os.path.isfile(os.path.join(ROOT, n)) and ledger.match_family(n)]
    errors = [r["source"] for r in records if r.get("error")]
    if rc != 0 or len(records) != len(matched) or errors:
        raise SystemExit(f"obs ledger --check: exit {rc}, {len(records)} records of "
                         f"{len(matched)} artifacts, errors {errors}: {err[-2000:]}")
    out["ledger"] = {"exit": rc, "records": len(records),
                     "families": len({r["family"] for r in records})}
    events = CompileWatcher.install().events
    if not events["library_load"] == len(build._libs) > 0:
        raise SystemExit(f"compile events {events}, libraries loaded {len(build._libs)}")
    out["compile_events"] = {**events, "libraries": len(build._libs)}
    out["server_compile_events"] = SERVER_COMPILES
    out["phase_s"] = time.perf_counter() - t_phase
    print(json.dumps({"run_reports": out, "card": smi}), flush=True)
    log(f"run reports phase: {out['phase_s']:.2f}s")
    return out


def parse_prometheus(text: str) -> dict:
    """{series: value} of a Prometheus text exposition (every line a
    comment or ``name{labels} value``); raises on a line that is neither."""
    out = {}
    for line in text.splitlines():
        if not line.strip() or line.startswith("#"):
            continue
        series, _, value = line.rpartition(" ")
        name = series.split("{", 1)[0]
        if not name or not name.replace("_", "a").replace(":", "a").isalnum():
            raise ValueError(f"metrics.prom: bad line {line!r}")
        out[series] = float(value.replace("+Inf", "inf"))
    return out


def check_run_records(out: str, iterations: int, label: str) -> dict:
    """The reference run's records in the export dir ``out``: manifest.json
    with ``config_hash`` (its own config's hash) and a goodput block whose
    buckets sum to ``wall_s``; events.jsonl with one ``iteration`` step
    span per iteration; metrics.prom that parses, ``pairs_total`` among its
    series; each checkpoint's meta with the manifest's ``config_hash``."""
    from gene2vec_tpu_torch.obs.run import config_hash

    with open(os.path.join(out, "manifest.json")) as f:
        manifest = json.load(f)
    g = manifest.get("goodput") or {}
    if manifest.get("config_hash") != config_hash(manifest.get("config")):
        raise SystemExit(f"{label}: manifest config_hash {manifest.get('config_hash')}")
    if not g or abs(sum(g["buckets_s"].values()) - g["wall_s"]) > 1e-5:
        raise SystemExit(f"{label}: goodput buckets do not sum to wall_s: {g}")
    with open(os.path.join(out, "events.jsonl")) as f:
        events = [json.loads(line) for line in f if line.strip()]
    steps = [e["attrs"]["iteration"] for e in events
             if e["type"] == "span_end" and e["name"] == "iteration"]
    if steps != list(range(1, iterations + 1)):
        raise SystemExit(f"{label}: iteration step spans {steps}")
    with open(os.path.join(out, "metrics.prom")) as f:
        series = parse_prometheus(f.read())
    if series.get("pairs_total", 0) <= 0:
        raise SystemExit(f"{label}: metrics.prom has no pairs_total")
    for it in range(1, iterations + 1):
        with np.load(os.path.join(out, f"gene2vec_dim_{D}_iter_{it}.npz")) as z:
            if json.loads(str(z["meta"])).get("config_hash") != manifest["config_hash"]:
                raise SystemExit(f"{label}: iteration {it} meta lacks the config_hash")
    rec = {"config_hash": manifest["config_hash"], "wall_s": g["wall_s"],
           "fractions": g["fractions"], "events": len(events), "series": len(series)}
    log(f"run records, {label}: {json.dumps(rec)}")
    return rec


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


def start_server(export: str, mode: str, err_path: str, extra=()):
    """``cli/serve.py`` in a subprocess on the card (``extra``: more
    flags); returns (process, its stdout contract line)."""
    import selectors

    cmd = [sys.executable, "-m", "gene2vec_tpu_torch.cli.serve", "--export-dir", export,
           "--port", "0", "--index", mode, "--cache-size", "0", "--nprobe",
           str(SERVE_NPROBE), "--poll-interval", "3600", *extra]
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


#: each server's compile events after its bucket requests and at its end,
#: by export and mode (phases 2g and 5; read into phase 4d's line)
SERVER_COMPILES: dict = {}


def scrape_compiles(url: str) -> int:
    """The server's ``jit_compile_events_total`` (0 before it has one)."""
    import re
    import urllib.request

    with urllib.request.urlopen(url + "/metrics", timeout=60) as r:
        text = r.read().decode()
    m = re.search(r"^jit_compile_events_total (\S+)$", text, re.M)
    return int(float(m.group(1))) if m else 0


def clustered_table(seed: int = 11, v: int = V, d: int = D, n_groups: int = 1000):
    """A (v, d) float32 table of ``n_groups`` groups of genes around seeded
    centres, and each gene's group."""
    rng = np.random.RandomState(seed)
    cent = rng.randn(n_groups, d).astype(np.float32)
    groups = rng.randint(0, n_groups, v)
    return cent[groups] + 0.35 * rng.randn(v, d).astype(np.float32), groups


def write_clustered_export(path: str, seed: int = 11, v: int = V, d: int = D,
                           n_groups: int = 1000):
    """An export (by default full width, V = 24,447, D = 200) with
    neighbor structure — ``n_groups`` groups of ~24 genes around seeded
    centres — written with the port's checkpoint writer.  Returns (the
    table, each gene's group)."""
    from gene2vec_tpu_torch.io.checkpoint import save_iteration
    from gene2vec_tpu_torch.io.vocab import Vocab
    from gene2vec_tpu_torch.sgns.model import SGNSParams
    import torch

    emb, groups = clustered_table(seed, v, d, n_groups)
    t = torch.from_numpy(emb)
    save_iteration(path, d, 1, SGNSParams(t, t), Vocab([f"G{i}" for i in range(v)],
                                                       np.ones(v, np.int64)),
                   txt_output=False)
    return emb, groups


def serve_full_width(export: str, work: str, smi: str, gate_recall: bool):
    """Serve one export through ``cli/serve.py`` once per index mode (the
    three servers started side by side, then driven one at a time, each
    stopped when its answers are in) and check every answer; each server's
    compile events (``jit_compile_events_total``) after the bucket requests
    equal those at its end, and are above 0 (once a mode has served each
    bucket, more traffic loads no kernel library).  Returns the kernel
    launches summed over the three servers."""
    from concurrent.futures import ThreadPoolExecutor

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
    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(SERVE_MODES)) as pool:
        futures = {mode: pool.submit(start_server, export, mode,
                                     os.path.join(work, f"serve_{mode}.err"))
                   for mode in SERVE_MODES}
    up = time.perf_counter() - t0
    servers = {mode: f.result() for mode, f in futures.items() if f.exception() is None}
    launches = {}
    try:
        for f in futures.values():
            if f.exception() is not None:
                raise f.exception()
        for mode in SERVE_MODES:
            proc, contract = servers[mode]
            try:
                if not contract["device"].startswith("cuda") or contract["iteration"] != it:
                    raise SystemExit(f"{mode} server contract {contract}")
                buckets, mixed = request_plan(tokens, emb, np.random.RandomState(7))
                answers = drive(contract["url"], buckets, [])[0]
                compiles = [scrape_compiles(contract["url"])]
                more, lat, wall = drive(contract["url"], [], mixed)
                answers += more
                counts = scrape_launches(contract["url"])
                compiles.append(scrape_compiles(contract["url"]))
            finally:
                stop_server(proc)
            SERVER_COMPILES[f"{os.path.basename(export)}/{mode}"] = compiles
            if not compiles[0] == compiles[1] > 0:
                raise SystemExit(f"{mode}: jit_compile_events_total {compiles} (after the "
                                 "buckets, at the end): not equal and above 0")
            n, ties, recall, short = check_answers(mode, answers, unit, token_id, gate_recall)
            must, must_not = MODE_KERNELS[mode]
            if (any(counts.get(k, 0) <= 0 for k in must)
                    or any(counts.get(k, 0) for k in must_not)):
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
                       "compile_events": compiles, "startup_s": up, "table": geometry,
                       "card": smi}
            print(json.dumps({"serving": summary}), flush=True)
            log(f"serving {mode}: {summary}")
    finally:
        for proc, _ in servers.values():
            if proc.poll() is None:
                stop_server(proc)
    return launches


# -- phase 2g: wide tables on the card ------------------------------------------

#: a small vocabulary (so that the CPU's plain steps stay quick) at a width
#: past every narrow tile's limit (K2/K3 584, K5b 432, K6 512, K7 792)
WIDE_V, WIDE_D = 3001, 1024
WIDE_KINDS = ("per_example", "shared", "sg_hs", "cbow_hs")


def wide_width_check(torch, work: str, smi: str):
    """Phase 2g: tables of WIDE_D columns, which the kernels' wide routes
    take.  One whole step of the default stratified mode and of each of
    WIDE_KINDS at V = WIDE_V, card vs CPU, float32 and bfloat16 with SR,
    held as ``step_verdict`` says.  Then the full-vocabulary default step
    and WIDE_KINDS' steps at that width in short profiled windows (wall and
    busy ms/step on a ``{"wide_windows": ...}`` line), and a clustered
    export of that width served through ``cli/serve.py`` in exact, quant
    and ivf modes, every answer checked as phase 5 checks, recall gated."""
    t0 = time.perf_counter()
    for dtype in (None, torch.bfloat16):
        step_parity(torch, WIDE_V, WIDE_D, B, HEAD, BLOCK, GROUP, full_tables=True, dtype=dtype)
        for kind in WIDE_KINDS:
            objective_step_parity(torch, WIDE_V, WIDE_D, B, kind, full_tables=True, dtype=dtype)
    prof_dir = os.path.join(os.getcwd(), "chip_smoke_profile")
    windows = [profile_steps(torch, PROFILED_STEPS // 4, prof_dir, smi, dim=WIDE_D, **kw)
               for kw in PLANTED_CONFIGS[:5]]
    print(json.dumps({"wide_windows": windows, "dim": WIDE_D, "card": smi}), flush=True)
    path = os.path.join(work, "wide")
    write_clustered_export(path, v=WIDE_V, d=WIDE_D, n_groups=WIDE_V // 24)
    serve_full_width(path, work, smi, gate_recall=True)
    log(f"wide tables (D {WIDE_D}) done in {time.perf_counter() - t0:.1f}s")


# -- phase 2f: the remaining Pallas probes (K12's new instances, K13, K14) -----

#: experiments/test_lane_gather.py: a transposed (D, V) table, 192 buckets
LANE_D, LANE_V = 256, 24576
#: K13's offset patterns (lane_offsets): the probe's random one and the
#: tie-heavy and out-of-range ones
LANE_PATTERNS = ("random", "identity", "reversed", "one_column", "twice", "clamped")
#: the remaining probe rows: on no path of either package (launches 0)
PROBE_ROWS = ("stream_scale", "stream_scale_bf16", "lane_gather", "lane_gather_bf16",
              "lane_scatter", "lane_scatter_bf16", "staged_copy")


def probe_row(name, src, replaces, rec, tolerance, shape):
    return {"name": name, "route": "cuda",
            "source": f"gene2vec_tpu_torch/kernels/csrc/{src}", "replaces": replaces,
            "launches": None, "max_abs_err": rec["max_abs_err"], "ms": rec["ms"],
            "plain_ms": rec["plain_ms"], "bound_ms": rec["bound_ms"],
            "bound_by": rec["bound_by"], "library_ms": rec["library_ms"], "shape": shape,
            "tolerance": tolerance}


def lane_offsets(pattern: str, nb: int, seed: int = 0):
    """(given, clamped): (8·nb, 128) int32 offsets of a LANE_PATTERNS
    pattern in rows 8b (the other rows random filler, which nothing reads),
    and the same clamped into [0, 128) — what the kernels use, and what
    the plain versions, which raise outside the range, are given.
    ``one_column``: a bucket's 128 offsets all one column; ``twice``: 64
    columns, each twice, in random order; ``clamped``: ~60% of them
    outside [0, 128)."""
    rng = np.random.RandomState(seed)
    offs = rng.randint(0, 128, (8 * nb, 128)).astype(np.int32)
    j = np.arange(128)
    if pattern == "random":
        rows = rng.randint(0, 128, (nb, 128))
    elif pattern == "identity":
        rows = np.tile(j, (nb, 1))
    elif pattern == "reversed":
        rows = np.tile(127 - j, (nb, 1))
    elif pattern == "one_column":
        rows = np.repeat(rng.randint(0, 128, (nb, 1)), 128, axis=1)
    elif pattern == "twice":
        rows = np.stack([rng.permutation(np.repeat(rng.permutation(128)[:64], 2))
                         for _ in range(nb)])
    elif pattern == "clamped":
        rows = rng.randint(-300, 428, (nb, 128))
    else:
        raise ValueError(f"unknown offset pattern {pattern!r}")
    offs[0::8] = rows
    return offs, np.clip(offs, 0, 127).astype(np.int32)


def lane_patterns_check(torch, d: int, v: int, dtype) -> None:
    """K13's gather and scatter at (d, v) on every LANE_PATTERNS pattern,
    bitwise their plain versions on the clamped offsets, one launch a
    call."""
    from gene2vec_tpu_torch.kernels import lane

    dev = torch.device(DEVICE)
    gen = torch.Generator(device=dev).manual_seed(d * 131 + v)
    t = torch.randn((d, v), device=dev, generator=gen).to(dtype)
    g = (torch.randn((d, v), device=dev, generator=gen) * 0.01).to(dtype)
    sfx = "bf16" if dtype == torch.bfloat16 else ""
    for i, pattern in enumerate(LANE_PATTERNS):
        given, clamped = (torch.from_numpy(x).to(dev) for x in lane_offsets(pattern, v // 128, i))
        for name, kern, plain in (
                ("lane_gather", lambda: lane.lane_gather(t, given),
                 lambda: lane.lane_gather_plain(t, clamped)),
                ("lane_scatter", lambda: lane.lane_scatter(t, g, given),
                 lambda: lane.lane_scatter_plain(t, g, clamped))):
            before = lane.launches[name, sfx]
            got = kern()
            launched = lane.launches[name, sfx] - before
            want = plain()
            torch.cuda.synchronize()
            if launched != 1 or not same_bits(torch, got, want):
                raise SystemExit(f"{name} {sfx or 'f32'} ({d}, {v}) {pattern}: {launched} "
                                 f"launches, bitwise {same_bits(torch, got, want)}")


def lane_probes(torch, reps):
    """K13 (``lane_gather``, ``lane_scatter``) and K12's ``stream_copy``
    instance at experiments/test_lane_gather.py's shapes, float32 and
    bfloat16, each bitwise its plain version (the scatter adds each
    column's contributors in the plain version's order), K13 also on
    every LANE_PATTERNS pattern (``lane_patterns_check``).  Library
    calls: ``torch.index_select`` (gather), ``torch.index_add``
    (scatter), ``torch.mul`` (copy).  Returns (kernels rows, records with
    GB/s)."""
    from gene2vec_tpu_torch.kernels import lane, stream_scale
    from gene2vec_tpu_torch.obs.profiler import bound

    dev = torch.device(DEVICE)
    gen = torch.Generator(device=dev).manual_seed(0)
    timer = Timer(torch, reps)
    offs = torch.randint(0, lane.BUCKET, (8 * LANE_V // lane.BUCKET, lane.BUCKET), device=dev,
                         generator=gen, dtype=torch.int32)
    cols = lane.global_columns(offs)
    rows, records = [], []
    src = "experiments/test_lane_gather.py"
    for dtype in (torch.float32, torch.bfloat16):
        bf16 = dtype == torch.bfloat16
        sfx, es = ("_bf16", 2) if bf16 else ("", 4)
        lane_patterns_check(torch, LANE_D, LANE_V, dtype)
        t = torch.randn((LANE_D, LANE_V), device=dev, generator=gen).to(dtype)
        g = (torch.randn((LANE_D, LANE_V), device=dev, generator=gen) * 0.01).to(dtype)
        shape = {"D": LANE_D, "V": LANE_V, "dtype": str(dtype).split(".")[1]}
        cases = (
            ("lane_gather", f"{src}:57 bucketed_gather", "k13_lane.cu",
             lambda: lane.lane_gather(t, offs), lambda: lane.lane_gather_plain(t, offs),
             lambda: torch.index_select(t, 1, cols), lane.gather_work(LANE_D, LANE_V, es)),
            ("lane_scatter", f"{src}:82 bucketed_scatter", "k13_lane.cu",
             lambda: lane.lane_scatter(t, g, offs), lambda: lane.lane_scatter_plain(t, g, offs),
             lambda: torch.index_add(t, 1, cols, g), lane.scatter_work(LANE_D, LANE_V, es)),
            ("stream_scale", f"{src}:100 stream_copy", "k12_stream_scale.cu",
             lambda: stream_scale.stream_scale(t), lambda: stream_scale.stream_scale_plain(t),
             lambda: torch.mul(t, stream_scale.SCALE), stream_scale.work(LANE_D * LANE_V, es)),
        )
        for name, probe, csrc, kern, plain, library, work in cases:
            got, want = kern(), plain()
            torch.cuda.synchronize()
            err = float((got.float() - want.float()).abs().max())
            ok, tol = same_bits(torch, got, want), "bitwise"
            if not ok:
                raise SystemExit(f"{name}{sfx} {probe}: error {err:.3e} beyond {tol}")
            b_ms, b_by = bound(work)
            nbytes = work["bytes"]
            rec = {"name": name + sfx, "probe": probe, **shape, "max_abs_err": err,
                   "ms": timer(kern), "plain_ms": timer(plain), "library_ms": timer(library),
                   "bound_ms": b_ms, "bound_by": b_by}
            rec["gb_per_s"] = nbytes / rec["ms"] / 1e6
            records.append(rec)
            log(f"{name}{sfx} [{probe}]: kernel {rec['ms']:.4f} ms ({rec['gb_per_s']:.1f} GB/s), "
                f"plain {rec['plain_ms']:.4f} ms, library {rec['library_ms']:.4f} ms, bound "
                f"{b_ms:.4f} ms ({b_by}), max abs err {err:.3e}")
            if name != "stream_scale" or bf16:  # f32 streaming is phase 2's 100 MB row
                rows.append(probe_row(name + sfx, csrc, probe.split(" ")[0], rec, tol, shape))
    return rows, records


#: experiments/test_feature_matrix.py's probes at (256, 256):
#: (function, scale, head: 0 / "all" / rows, offset argument)
FEATURE_PROBES = (
    ("experiments/test_feature_matrix.py:35 calla", 2.0, "all", "idx"),
    ("experiments/test_feature_matrix.py:62 callb", 1.0, 0, None),
    ("experiments/test_feature_matrix.py:79 callc", 2.0, 0, None),
    ("experiments/test_feature_matrix.py:96 calld", 1.0, 0, None),
    ("experiments/test_feature_matrix.py:114 calle", 1.0, 0, None),
    ("experiments/test_feature_matrix.py:132 callf", 1.0, 8, "sidx"),
)
#: experiments/test_vmem_dma.py:113: MB of input
VMEM_MB = (8, 16, 24, 32, 48, 56, 60)
VMEM_MAIN_MB = 32          # the size whose best tile the kernels line carries
STAGED_TILES = (8, 16, 32, 64, 128)   # rows; then the card's largest


def staged_probes(torch, reps):
    """K14 (``staged_copy``) at every staging probe's shape, bitwise its
    plain version: the six feature probes, ``callh``'s (1024, 256) in
    8-row tiles and ``vmem_probe``'s (n, 256) at VMEM_MB with its tile
    swept from 8 rows to the card's opt-in shared-memory limit.  Library
    call: ``torch.mul`` (x · 2), ``Tensor.copy_`` (copies) or
    ``torch.index_select`` (callf's shifted rows).  Returns (the kernels
    row: VMEM_MAIN_MB at its fastest tile, records)."""
    from gene2vec_tpu_torch.kernels import staged_copy as sc
    from gene2vec_tpu_torch.obs.profiler import bound

    dev = torch.device(DEVICE)
    gen = torch.Generator(device=dev).manual_seed(2)
    timer = Timer(torch, reps)
    records, main_row = [], None

    def run(probe, x, scale, tile, offset, head, library):
        got = sc.staged_copy(x, scale, tile, offset, head)
        want = sc.staged_copy_plain(x, scale, offset, head)
        torch.cuda.synchronize()
        if not same_bits(torch, got, want):
            raise SystemExit(f"staged_copy [{probe}] tile {tile}: not bitwise its plain version")
        n, d = x.shape
        work = sc.work(n, d)
        b_ms, b_by = bound(work)
        rec = {"name": "staged_copy", "probe": probe, "shape": [n, d], "scale": scale,
               "head": head, "tile_rows": tile, "max_abs_err": 0.0,
               "ms": timer(lambda: sc.staged_copy(x, scale, tile, offset, head)),
               "bound_ms": b_ms, "bound_by": b_by}
        if library is not None:
            rec["plain_ms"] = timer(lambda: sc.staged_copy_plain(x, scale, offset, head))
            rec["library_ms"] = timer(library)
        rec["gb_per_s"] = work["bytes"] / rec["ms"] / 1e6
        records.append(rec)
        log(f"staged_copy [{probe}] ({n}, {d}) tile {tile}: kernel {rec['ms']:.4f} ms "
            f"({rec['gb_per_s']:.1f} GB/s), plain {rec.get('plain_ms', float('nan')):.4f} ms, "
            f"library {rec.get('library_ms', float('nan')):.4f} ms, bound {b_ms:.4f} ms")
        return rec

    x = torch.randn((256, 256), device=dev, generator=gen)
    scalars = {"idx": torch.arange(256, dtype=torch.int32, device=dev),
               "sidx": torch.tensor([[3]], dtype=torch.int32, device=dev)}
    out = torch.empty_like(x)
    shifted = torch.cat([torch.arange(3, 11), torch.arange(0, 248)]).to(dev)
    for probe, scale, head, off in FEATURE_PROBES:
        h = x.shape[0] if head == "all" else head
        library = ((lambda: torch.index_select(x, 0, shifted)) if head == 8 else
                   (lambda: torch.mul(x, 2.0)) if scale == 2.0 else (lambda: out.copy_(x)))
        run(probe, x, scale, 8, scalars.get(off), h, library)
    xh = torch.randn((1024, 256), device=dev, generator=gen)
    run("experiments/test_dma2.py:83 callh", xh, 2.0, 8, None, 0, lambda: torch.mul(xh, 2.0))
    for mb in VMEM_MB:
        n = mb * 1024 * 1024 // 4 // 256
        xv = torch.randn((n, 256), device=dev, generator=gen)
        top = sc.max_tile_rows(xv, 256)
        sweep = [run(f"experiments/test_vmem_dma.py:24 vmem_probe {mb} MB", xv, 2.0, tile, None,
                     0, (lambda: torch.mul(xv, 2.0)) if tile == STAGED_TILES[0] else None)
                 for tile in (*STAGED_TILES, top)]
        best = min(sweep, key=lambda r: r["ms"])
        log(f"staged_copy vmem_probe {mb} MB: fastest tile {best['tile_rows']} rows "
            f"({best['ms']:.4f} ms; opt-in limit {top} rows)")
        if mb == VMEM_MAIN_MB:
            first = sweep[0]
            main_row = probe_row(
                "staged_copy", "k14_staged_copy.cu", "experiments/test_vmem_dma.py:24",
                {**best, "plain_ms": first["plain_ms"], "library_ms": first["library_ms"]},
                "bitwise", {"rows": n, "cols": 256, "mb": mb, "tile_rows": best["tile_rows"],
                            "max_tile_rows": top})
        del xv
    return main_row, records


# -- phase 6: GGIPNN (extrinsic evaluation) and /v1/interaction -----------------

GG_B, GG_B_LARGE = 128, 1024      # the default batch; bench.py's _ggipnn_rate batch
GG_TRAIN, GG_VALID, GG_TEST = 262_144, 16_384, 32_768
GG_EPOCHS = 2                     # the frozen runs' epochs (the loss must fall)
GG_LOSS_RTOL = 1e-5               # one step card vs CPU: the loss
GG_PARAM_RTOL = 1e-4              # ... each tensor, x its max |CPU value|
#: test AUC floor of the default run (frozen table, B = 128), from a CPU
#: rehearsal at a quarter of the data (65,536 training pairs, 2 epochs: AUC
#: 0.990); the B = 1024 and fine-tuning runs take 8x and 2x fewer steps and
#: learned nothing at that size (AUC 0.50), so theirs is reported
GG_AUC_FLOOR = 0.95
GG_RATE_PAIRS = 262_144           # bench.py's _ggipnn_rate data size
GG_PROFILED_STEPS = 256           # steps of the profiled window (the profiler
                                  # slows a whole 2,048-step epoch ~10x)
INTERACTION_REQUESTS = 400
INTERACTION_WARMUP = 32           # untimed requests first: each handler
                                  # thread's first CUDA work (cuBLAS handle)
INTERACTION_MAX_PAIRS = 64        # the server's max_queries_per_request


def ggipnn_vocab(v):
    from gene2vec_tpu_torch.models.ggipnn_data import PairTextVocab

    vocab = PairTextVocab()
    vocab.id_to_token = [f"G{i}" for i in range(v)]
    vocab.token_to_id = {t: i for i, t in enumerate(vocab.id_to_token)}
    return vocab


def ggipnn_step_parity(torch, v, d, b, embed_train):
    """One GGIPNN Adam step on the card against the CPU from the same
    params (``init_params_numpy``), batch (a repeated pair: duplicate ids
    in the lookup) and dropout masks: loss within GG_LOSS_RTOL, accuracy
    equal, each parameter tensor within GG_PARAM_RTOL of its max |CPU
    value| (Adam divides by sqrt(v) + eps); a frozen table bitwise
    unchanged on both."""
    from gene2vec_tpu_torch.config import GGIPNNConfig
    from gene2vec_tpu_torch.models.ggipnn import init_params_numpy
    from gene2vec_tpu_torch.models.ggipnn_train import GGIPNNTrainer

    cfg = GGIPNNConfig(embedding_dim=d, batch_size=b, embed_train=embed_train)
    p0 = init_params_numpy(0, v, cfg)
    rng = np.random.RandomState(1)
    x = rng.randint(0, v, (b, 2)).astype(np.int32)
    x[1] = x[0]
    y = np.eye(2, dtype=np.float32)[rng.randint(0, 2, b)]
    masks = [rng.rand(b, h) < cfg.dropout_keep_prob for h in cfg.hidden_dims]
    out = {}
    for dev in ("cpu", "cuda"):
        tr = GGIPNNTrainer(cfg, ggipnn_vocab(v), device=dev)
        tr.init_state(params=p0)
        loss, acc = tr.train_step(torch.from_numpy(x).to(dev), torch.from_numpy(y).to(dev),
                                  [torch.from_numpy(m).to(dev) for m in masks])
        out[dev] = (float(loss), float(acc), tr.model.to_flat())
    (lc, ac, pc), (lg, ag, pg) = out["cpu"], out["cuda"]
    rel = abs(lc - lg) / abs(lc)
    label = f"GGIPNN step card vs CPU (V {v}, D {d}, B {b}, embed_train {embed_train})"
    if rel > GG_LOSS_RTOL or ac != ag:
        raise SystemExit(f"{label}: loss {lg} vs {lc} (rel {rel:.2e}), accuracy {ag} vs {ac}")
    worst = 0.0
    for k in pc:
        if k == "embedding" and not embed_train:
            if not (np.array_equal(pg[k], p0[k]) and np.array_equal(pc[k], p0[k])):
                raise SystemExit(f"{label}: the frozen table changed")
            continue
        err = float(np.abs(pg[k] - pc[k]).max()) / float(np.abs(pc[k]).max())
        if err > GG_PARAM_RTOL:
            raise SystemExit(f"{label}: {k} off by {err:.3e} of its scale")
        worst = max(worst, err)
    log(f"{label}: loss rel {rel:.2e}, params max rel {worst:.2e}")
    return {"embed_train": embed_train, "loss_rel": rel, "max_param_rel": worst}


def ggipnn_gather_row(torch, reps):
    """K9r's row gather at the GGIPNN lookup's shapes — the (24,447, 200)
    float32 table, E = 2 B ids at B = 128 (the kernels line's) and 1024 —
    against ``table[idx]``; library call ``torch.index_select``."""
    from gene2vec_tpu_torch.kernels import rescore
    from gene2vec_tpu_torch.obs.profiler import bound

    dev = torch.device(DEVICE)
    gen = torch.Generator(device=dev).manual_seed(4)
    timer = Timer(torch, reps)
    table = torch.randn((V, D), device=dev, generator=gen)
    row, records = None, []
    for b in (GG_B, GG_B_LARGE):
        idx = torch.randint(0, V, (2 * b,), device=dev, generator=gen, dtype=torch.int32)
        idx_l = idx.long()
        if not torch.equal(rescore.row_gather(table, idx), table[idx_l]):
            raise SystemExit(f"row_gather GGIPNN lookup B {b}: differs from table[idx]")
        b_ms, b_by = bound(rescore.gather_work(idx, 4 * D))
        rec = {"name": "row_gather", "probe": "GGIPNN lookup (models/ggipnn.py)",
               "table": [V, D], "dtype": "float32", "E": 2 * b, "max_abs_err": 0.0,
               "ms": timer(lambda: rescore.row_gather(table, idx)),
               "plain_ms": timer(lambda: rescore.row_gather_plain(table, idx)),
               "library_ms": timer(lambda: torch.index_select(table, 0, idx_l)),
               "bound_ms": b_ms, "bound_by": b_by}
        records.append(rec)
        log(f"row_gather [GGIPNN lookup, B {b}]: kernel {rec['ms']:.4f} ms, plain "
            f"{rec['plain_ms']:.4f} ms, index_select {rec['library_ms']:.4f} ms, bound "
            f"{b_ms:.4f} ms ({b_by})")
        if b == GG_B:
            row = probe_row("row_gather", "k9r_rescore.cu",
                            "experiments/test_pallas_gather.py:31", rec, "bitwise",
                            {"table": [V, D], "E": 2 * b})
    return row, records


def ggipnn_rate(torch, batch, smi, n_pairs=GG_RATE_PAIRS):
    """bench.py's ``ggipnn_pairs_per_sec`` on the card: scanned-fit epochs
    of ``n_pairs`` random pairs at V = 24,447 with a random table — a
    warm-up epoch, UNPROFILED_EPOCHS timed on the host clock ending in a
    device sync — and a fit of GG_PROFILED_STEPS steps under
    torch.profiler for the device busy time a step, the kernels that take
    it and the host operations that cost most."""
    from torch.profiler import ProfilerActivity, profile

    from gene2vec_tpu_torch.config import GGIPNNConfig
    from gene2vec_tpu_torch.models.ggipnn_train import GGIPNNTrainer

    rng = np.random.RandomState(0)
    x = rng.randint(0, V, (n_pairs, 2)).astype(np.int32)
    y = np.eye(2, dtype=np.float32)[rng.randint(0, 2, n_pairs)]
    tr = GGIPNNTrainer(GGIPNNConfig(batch_size=batch), ggipnn_vocab(V), device=DEVICE)
    tr.init_state()
    quiet = lambda msg: None  # noqa: E731
    tr.fit(x, y, log=quiet)
    torch.cuda.synchronize()
    walls = []
    for _ in range(UNPROFILED_EPOCHS):
        t0 = time.perf_counter()
        tr.fit(x, y, log=quiet)
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
    n_prof = GG_PROFILED_STEPS * batch
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        tr.fit(x[:n_prof], y[:n_prof], log=quiet)
        torch.cuda.synchronize()
    # device-side kernel records only: a user annotation on the device
    # track (``Optimizer.step#Adam.step``) spans its kernels and the gaps
    # between them
    events = [ev for ev in prof.key_averages()
              if not getattr(ev, "is_user_annotation", False)]
    kernels_ms = {ev.key: ev.self_device_time_total / 1e3 for ev in events
                  if ev.device_type == torch.autograd.DeviceType.CUDA
                  and ev.self_device_time_total > 0}
    host_ms = {ev.key: ev.self_cpu_time_total / 1e3 for ev in events
               if ev.device_type == torch.autograd.DeviceType.CPU}
    busy = sum(kernels_ms.values()) / GG_PROFILED_STEPS
    steps = n_pairs // batch
    wall = statistics.median(walls)
    rec = {"batch": batch, "pairs": n_pairs, "steps_per_epoch": steps,
           "ggipnn_pairs_per_sec": n_pairs / wall, "epoch_walls_s": walls,
           "wall_ms_per_step": wall * 1e3 / steps, "busy_ms_per_step": busy,
           "idle_share": 1 - busy / (wall * 1e3 / steps),
           "kernels_per_step": sum(ev.count for ev in events
                                   if ev.device_type == torch.autograd.DeviceType.CUDA
                                   and ev.self_device_time_total > 0) / GG_PROFILED_STEPS,
           "card": smi}
    print(json.dumps({"ggipnn_rate": rec}), flush=True)
    log(f"ggipnn rate B {batch}: {rec['ggipnn_pairs_per_sec']:.0f} pairs/s, "
        f"{rec['wall_ms_per_step']:.4f} ms/step, device busy {busy:.4f} ms/step in "
        f"{rec['kernels_per_step']:.1f} kernels, idle share {rec['idle_share']:.4f}")
    for name, ms in sorted(kernels_ms.items(), key=lambda kv: -kv[1])[:8]:
        log(f"  device {ms / GG_PROFILED_STEPS:9.4f} ms/step  {name[:90]}")
    for name, ms in sorted(host_ms.items(), key=lambda kv: -kv[1])[:8]:
        log(f"  host   {ms / GG_PROFILED_STEPS:9.4f} ms/step  {name[:90]}")
    return rec


def write_prediction_data(path, groups, sizes=(GG_TRAIN, GG_VALID, GG_TEST), seed=12):
    """A ``predictionData/``-shaped directory over the clustered export's
    genes: in each split half the pairs lie within one group (label 1) and
    half are random pairs (label 0); the first V training pairs start at
    every gene once, so the training vocab is the export's."""
    rng = np.random.RandomState(seed)
    v = len(groups)
    names = np.array([f"G{i}" for i in range(v)], dtype=object)
    order = np.argsort(groups, kind="stable")
    sizes_g = np.bincount(groups)
    starts = np.concatenate([[0], np.cumsum(sizes_g)[:-1]])
    os.makedirs(path, exist_ok=True)
    for split, n in zip(("train", "valid", "test"), sizes):
        pos = n // 2
        a = rng.randint(0, v, pos)
        if split == "train":
            a[:v] = rng.permutation(v)
        b = order[starts[groups[a]] + rng.randint(0, 1 << 30, pos) % sizes_g[groups[a]]]
        neg = rng.randint(0, v, (n - pos, 2))
        pairs = np.concatenate([np.stack([a, b], 1), neg])
        labels = np.concatenate([np.ones(pos, np.int64), np.zeros(n - pos, np.int64)])
        with open(os.path.join(path, f"{split}_text.txt"), "w") as f:
            f.write("\n".join(names[pairs[:, 0]] + " " + names[pairs[:, 1]]) + "\n")
        with open(os.path.join(path, f"{split}_label.txt"), "w") as f:
            f.write("\n".join(map(str, labels)) + "\n")


def write_w2v(path, emb):
    with open(path, "w", encoding="utf-8") as f:
        f.write(f"{emb.shape[0]} {emb.shape[1]}\n")
        for i, row in enumerate(emb):
            f.write(f"G{i} " + " ".join(f"{x:.9g}" for x in row) + "\n")


def ggipnn_forward_calls(n_train, n_valid, n_test, b, epochs, step_loop, evaluate_every=200):
    """Forward passes (each one row-gather launch) of a run: its training
    steps and its evaluation batches — dev at each epoch's end (scanned
    fit) or every ``evaluate_every`` steps (step loop), then test."""
    steps = -(-n_train // b)
    dev = -(-n_valid // b)
    evals = (epochs * steps) // evaluate_every if step_loop else epochs
    return epochs * steps + evals * dev + -(-n_test // b)


def ggipnn_cli(torch, work, smi, emb, groups, device=DEVICE, sizes=(GG_TRAIN, GG_VALID, GG_TEST),
               auc_floor=None, checkpoint_every=1000):
    """GGIPNN through ``python -m gene2vec_tpu_torch.cli.ggipnn`` (in
    process, for the launch counts) on a predictionData/ directory over the
    clustered export, its table as the ``--emb`` word2vec file: the
    default (frozen table, scanned fit) at B = 128 and at B = 1024 for
    GG_EPOCHS epochs, then ``--embed-train --run-dir`` (the step loop with
    checkpoints) for one.  Gates: the loss falls (epoch means; the run
    dir's first against last 200 step losses), the default run's test AUC
    >= ``auc_floor``, ``row_gather`` launched once per forward pass and no
    other kernel.
    Returns (row_gather launches, the last checkpoint's path, records)."""
    import contextlib
    import io

    from gene2vec_tpu_torch import kernels
    from gene2vec_tpu_torch.cli import ggipnn

    data = os.path.join(work, "predictionData")
    write_prediction_data(data, groups, sizes)
    w2v = os.path.join(work, "clustered_w2v.txt")
    write_w2v(w2v, emb)
    run_dir = os.path.join(work, "ggipnn_run")
    n_train, n_valid, n_test = sizes
    runs = (("frozen_b128", GG_B, GG_EPOCHS, []),
            ("frozen_b1024", GG_B_LARGE, GG_EPOCHS, []),
            ("embed_train_run_dir", GG_B, 1, ["--embed-train", "--run-dir", run_dir,
                                              "--checkpoint-every", str(checkpoint_every)]))
    launches, records = 0, []
    for label, b, epochs, flags in runs:
        kernels.reset_launch_counts()
        buf = io.StringIO()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(buf):
            rc = ggipnn.main(["--data-dir", data, "--emb", w2v, "--device", device,
                              "--batch-size", str(b), "--num-epochs", str(epochs), *flags])
        if device == "cuda":
            torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = kernels.launch_counts()
        text = buf.getvalue()
        log(f"ggipnn {label}:\n{text.strip()}")
        if rc != 0:
            raise SystemExit(f"ggipnn {label}: CLI exited {rc}")
        step_loop = bool(flags)
        if step_loop:
            with open(os.path.join(run_dir, "summaries", "train", "metrics.csv")) as f:
                step_losses = [float(r["loss"]) for r in csv.DictReader(f)]
            losses = [float(np.mean(step_losses[:200])), float(np.mean(step_losses[-200:]))]
        else:
            losses = [float(line.split(": loss ")[1].split()[0]) for line in text.splitlines()
                      if line.startswith("epoch ")]
        auc = float(text.split("The AUC score is ")[1].split()[0])
        acc = float(text.split("test accuracy: ")[1].split()[0])
        if len(losses) < 2 or not all(np.isfinite(losses)) or not losses[-1] < losses[0]:
            raise SystemExit(f"ggipnn {label}: loss not falling {losses}")
        if label == "frozen_b128" and auc_floor is not None and auc < auc_floor:
            raise SystemExit(f"ggipnn {label}: test AUC {auc:.4f} < {auc_floor}")
        want = ggipnn_forward_calls(n_train, n_valid, n_test, b, epochs, step_loop)
        others = {k: n for k, n in counts.items() if n and not k.startswith("row_gather")}
        if device == "cuda" and (counts["row_gather"] != want or others):
            raise SystemExit(f"ggipnn {label}: launches {counts}, expected row_gather {want} "
                             "and nothing else")
        launches += counts["row_gather"]
        rec = {"run": label, "batch": b, "epochs": epochs, "train_pairs": n_train,
               "losses": losses, "test_auc": auc, "test_accuracy": acc, "wall_s": wall,
               "row_gather_launches": counts["row_gather"], "forward_calls": want,
               "card": smi}
        records.append(rec)
        print(json.dumps({"ggipnn": rec}), flush=True)
    ckpts = sorted((int(n.split("-")[1].split(".")[0]), n)
                   for n in os.listdir(os.path.join(run_dir, "checkpoints")))
    return launches, os.path.join(run_dir, "checkpoints", ckpts[-1][1]), records


def serve_interaction(torch, export, checkpoint, work, smi):
    """``/v1/interaction`` through ``cli/serve.py`` on the card with
    ``--ggipnn-checkpoint``: INTERACTION_REQUESTS requests of 1-64 pairs
    from SERVE_CLIENTS clients, timed after INTERACTION_WARMUP untimed
    ones (checked alike).  Every score within SCORE_TOL of the
    host's CPU forward of the same head on the same served rows,
    ``trained_head`` true everywhere, an unknown gene answered 400, and
    ``row_gather`` launched once per scored request (``/metrics``)."""
    from gene2vec_tpu_torch.models.ggipnn import GGIPNN
    from gene2vec_tpu_torch.models.ggipnn_obs import load_checkpoint
    from gene2vec_tpu_torch.serve.registry import discover_newest

    _, _, path = discover_newest(export)
    with np.load(path) as z:
        emb = np.asarray(z["emb"], np.float32)
    with open(os.path.join(export, "vocab.tsv"), encoding="utf-8") as f:
        tokens = [line.split("\t")[0] for line in f if line.strip()]
    host = GGIPNN(len(tokens), emb.shape[1])
    host.load_flat(load_checkpoint(checkpoint), head_only=True)
    with torch.no_grad():
        host.embedding.copy_(torch.from_numpy(emb))
    host.eval()
    rng = np.random.RandomState(9)
    mixed = []
    for _ in range(INTERACTION_WARMUP + INTERACTION_REQUESTS):
        ids = rng.randint(0, len(tokens), (rng.randint(1, INTERACTION_MAX_PAIRS + 1), 2))
        mixed.append(("POST", "/v1/interaction",
                      {"pairs": [[tokens[a], tokens[b]] for a, b in ids]}))
    warm, mixed = mixed[:INTERACTION_WARMUP], mixed[INTERACTION_WARMUP:]
    t0 = time.perf_counter()
    proc, contract = start_server(export, "exact", os.path.join(work, "serve_interaction.err"),
                                  extra=["--ggipnn-checkpoint", checkpoint])
    try:
        up = time.perf_counter() - t0
        unknown = drive(contract["url"], [("POST", "/v1/interaction",
                                           {"pairs": [[tokens[0], "NOT_A_GENE"]]})], [])[0][0]
        warm_answers, warm_lat, _ = drive(contract["url"], [], warm)
        answers, lat, wall = drive(contract["url"], [], mixed)
        counts = scrape_launches(contract["url"])
    finally:
        stop_server(proc)
    if unknown[1] != 400:
        raise SystemExit(f"/v1/interaction: unknown gene answered {unknown[1]}")
    index = {t: i for i, t in enumerate(tokens)}
    pairs, served = [], []
    for (_, _, body), status, raw in warm_answers + answers:
        if status != 200:
            raise SystemExit(f"/v1/interaction answered {status}: {raw[:300]!r}")
        doc = json.loads(raw)
        if doc["trained_head"] is not True or [r["pair"] for r in doc["scores"]] != body["pairs"]:
            raise SystemExit(f"/v1/interaction: bad answer {str(doc)[:300]}")
        pairs += [[index[a], index[b]] for a, b in body["pairs"]]
        served += [r["score"] for r in doc["scores"]]
    with torch.no_grad():
        logits = host(torch.tensor(pairs, dtype=torch.int32))
        want = torch.softmax(logits, dim=-1)[:, 1].numpy()
    err = float(np.abs(np.asarray(served) - want).max())
    if err > SCORE_TOL:
        raise SystemExit(f"/v1/interaction: score off the host's by {err:.3e}")
    if counts.get("row_gather", 0) != len(warm_answers) + len(answers):
        raise SystemExit(f"/v1/interaction: row_gather launches {counts}, expected "
                         f"{len(warm_answers) + len(answers)} (one per scored request)")
    lat_ms = np.sort(np.asarray(lat)) * 1e3
    summary = {"export": os.path.basename(export), "route": "/v1/interaction",
               "requests": len(answers), "pairs": len(pairs), "clients": SERVE_CLIENTS,
               "qps": len(mixed) / wall, "p50_ms": float(np.percentile(lat_ms, 50)),
               "p99_ms": float(np.percentile(lat_ms, 99)), "trained_head": True,
               "warmup_requests": len(warm_answers), "warmup_max_ms": max(warm_lat) * 1e3,
               "max_score_err": err, "unknown_gene_status": unknown[1], "launches": counts,
               "startup_s": up, "card": smi}
    print(json.dumps({"serving": summary}), flush=True)
    log(f"serving /v1/interaction: {summary}")
    return counts["row_gather"]


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


# -- phase 7: the paper's pipeline (corpus with K11, training and the
# intrinsic evaluation, t-SNE with K10c and K10) -------------------------------

PIPE_GENES = 26_000           # query genes; V = 24,447 survive the filters below
PIPE_LOW, PIPE_EMPTY = 600, 400   # genes below the count filter; empty symbols
#                                   (the remaining 553 share symbols, all dropped)
PIPE_STUDIES = (("SRP012", 12), ("SRP024", 24), ("SRP064", 64), ("SRP160", 160))
PIPE_MIN_SAMPLES = 20         # the CLI's default: the 12-sample study is dropped
PIPE_MODULES, PIPE_MODULE_GENES = 400, 12   # planted co-expression modules
PIPE_AT_THR = 40              # planted pairs at |corr| = PIPE_THR, a study
PIPE_THR = 0.9
PIPE_TRAIN_ITERS = 2
K11_MAIN_N = 160              # the study size whose K11 times the kernels line carries
K11_DENSE = (24, 0.3)         # study size, threshold of K11's dense check: 0.3 lies in
#                               the bulk of random pairs' |corr| (sd ~ n^-1/2 = 0.2)
#: K11's edges (n, g, threshold), checked in phase 7a beside the studies:
#: g at and past its 128-column tiles and 4-float row pitch, n about its
#: 8-sample stages, thresholds that set no bit, most bits and every bit
K11_EDGES = ((7, 127, 0.3), (9, 129, 0.0), (8, 257, 1.0), (24, 4097, 0.05), (1, 130, -0.5))
K10C_RTOL = 1e-4              # K10c against its plain version, each P entry
K10C_SLAB = (256, 60_000)     # rows × columns of the long-row route's check
K10_TOL = 1e-4                # K10 against its plain version, of its terms (k10_check)
TSNE_SNAPSHOTS = (250, 1000)
TSNE_SEP = 2.0                # inter-group over intra-group mean distance, at least
TSNE_PERPLEXITY = 30.0
UMAP_K = 15                   # UMAPConfig().n_neighbors
UMAP_ITERS = 400              # UMAPConfig().n_iters: K16's launches in cli.plot
UMAP_MID = 200                # K16 checked from the start and this many iterations on
#: K15's weights against its plain version's on the same d², absolute (w and
#: P lie in [0, 1]): σ moves with the row sum's last bits, w by at most
#: σ's relative change over e (the kernels module's docstring)
K15_ATOL = 1e-5
#: K16 against its plain version: each coordinate of y′ within K16_TOL of
#: lr·(|rowsum·y_i| + Σ_j |coef_ij|·|y_j|) + max|y′| (k16_check)
K16_TOL = 1e-5
UMAP_SEP = 2.0                # inter-group over intra-group mean distance, at least


def write_pipeline_query(root: str, seed: int = 14):
    """A GEO-style query directory made from ``seed``: PIPE_GENES
    ``ENSEMBL|SYMBOL`` genes (PIPE_LOW with zero counts, PIPE_EMPTY with
    empty symbols, the rest past V sharing symbols: V survive), the studies
    of PIPE_STUDIES, PIPE_MODULES modules of PIPE_MODULE_GENES genes
    (log-TPM = a study factor + 0.15 noise: |corr| ≈ 0.98), PIPE_AT_THR
    pairs a study planted at |corr| = PIPE_THR, and zeros (half-min
    replaced) elsewhere.  TPM is written to 9 significant digits, which
    moves a correlation by ~1e-8, far inside EPS_N.  Returns (the query
    directory, the modules as lists of symbols)."""
    import pandas as pd

    rng = np.random.RandomState(seed)
    n_dup = PIPE_GENES - V - PIPE_LOW - PIPE_EMPTY
    syms = ([f"G{i}" for i in range(V)] + [f"LOW{i}" for i in range(PIPE_LOW)]
            + [""] * PIPE_EMPTY + [f"DUP{i % (n_dup // 2)}" for i in range(n_dup)])
    syms = [syms[i] for i in rng.permutation(PIPE_GENES)]
    col = {s: j for j, s in enumerate(syms) if s.startswith("G")}
    total = sum(n for _, n in PIPE_STUDIES)
    logv = 3.0 + rng.randn(total, PIPE_GENES)
    size = PIPE_MODULE_GENES
    picked = rng.choice(V, PIPE_MODULES * size + 2 * PIPE_AT_THR * len(PIPE_STUDIES),
                        replace=False)
    modules = [[f"G{k}" for k in picked[m * size:(m + 1) * size]] for m in range(PIPE_MODULES)]
    pair_cols = [col[f"G{k}"] for k in picked[PIPE_MODULES * size:]]
    zeros = rng.rand(total, PIPE_GENES) < 5e-4
    zeros[:, [col[f"G{k}"] for k in picked]] = False
    r0 = 0
    for si, (_, n) in enumerate(PIPE_STUDIES):
        for genes in modules:
            cols = [col[g] for g in genes]
            logv[r0:r0 + n, cols] = (3.0 + rng.randn(n)[:, None]
                                     + 0.15 * rng.randn(n, len(cols)))
        for k in range(PIPE_AT_THR):
            a, b = pair_cols[2 * (si * PIPE_AT_THR + k)], pair_cols[2 * (si * PIPE_AT_THR + k) + 1]
            za = logv[r0:r0 + n, a] - logv[r0:r0 + n, a].mean()
            e = rng.randn(n)
            e -= e.mean()
            e -= za * (za @ e) / (za @ za)
            logv[r0:r0 + n, b] = 3.0 + (PIPE_THR * za / np.linalg.norm(za)
                                        + np.sqrt(1 - PIPE_THR ** 2) * e / np.linalg.norm(e))
        r0 += n
    tpm = np.exp2(logv)
    tpm[zeros] = 0.0
    samples = [f"SRR{i:07d}" for i in range(total)]
    ens = [f"ENSG{i:011d}" for i in range(PIPE_GENES)]
    data = os.path.join(root, "query", "data")
    os.makedirs(data)
    pd.DataFrame({"SRA Study": [s for s, n in PIPE_STUDIES for _ in range(n)]},
                 index=pd.Index(samples, name="Run")).to_csv(os.path.join(data, "SRARunTable.csv"))
    # the two wide CSVs by %-formatting whole rows: pandas' writer takes
    # ~5× as long at this width
    row_fmt = ",".join(["%.9g"] * PIPE_GENES)
    with open(os.path.join(data, "gene_counts_TPM.csv"), "w", encoding="utf-8") as f:
        f.write("run," + ",".join(ens) + "\n")
        for sample, row in zip(samples, tpm):
            f.write(f"{sample},{row_fmt % tuple(row)}\n")
    counts_row = {c: ",".join([str(c)] * total) for c in (0, 5)}
    low = {j for j, s in enumerate(syms) if s.startswith("LOW")}
    with open(os.path.join(data, "gene_counts.csv"), "w", encoding="utf-8") as f:
        f.write("gene_id," + ",".join(samples) + "\n")
        for j, (e, s) in enumerate(zip(ens, syms)):
            f.write(f"{e}|{s},{counts_row[0 if j in low else 5]}\n")
    return os.path.join(root, "query"), modules


def k11_check(torch, z64, thr):
    """K11 on the float32 cast of the (n, g) float64 standardized ``z64``
    (on the card) against its plain version and the float64 product: the
    masks may differ only on pairs whose float64 |corr| lies within
    EPS_N = (n + 2)·2⁻²⁴ of ``thr``; no bit past g.  Returns (the kernel's
    mask, the float64 mask, the mask of pairs within EPS_N, the
    kernel-vs-plain flips, the kernel-vs-float64 flips)."""
    from gene2vec_tpu_torch.kernels import coexpr_mask

    n, g = z64.shape
    z = z64.float().contiguous()
    words = coexpr_mask.coexpr_mask(z, thr)
    plain = coexpr_mask.coexpr_mask_plain(z, thr)
    torch.cuda.synchronize()
    if g % 32:
        tail = words[:, -1].long() & ~((1 << (g % 32)) - 1) & 0xFFFFFFFF
        if bool(tail.any()):
            raise SystemExit(f"K11 (n {n}, g {g}): bits set past column {g}")
    got, want = coexpr_mask.unpack(words, g), coexpr_mask.unpack(plain, g)
    corr64 = torch.clamp(torch.abs(z64.T @ z64) / (n - 1), 0.0, 1.0)
    near = (corr64 - thr).abs() <= coexpr_mask.eps_n(n)
    exact = corr64 > thr
    del corr64
    if not torch.equal(got, got.T):
        raise SystemExit(f"K11 (n {n}, g {g}): mask not symmetric")
    flips = []
    for label, other in (("plain", want), ("float64", exact)):
        diff = got != other
        if bool((diff & ~near).any()):
            raise SystemExit(f"K11 (n {n}, g {g}, thr {thr}): {int((diff & ~near).sum())} "
                             f"pairs differ from the {label} mask outside EPS_N")
        flips.append(int(diff.sum()))
    return got, exact, near, flips[0], flips[1]


def k11_study(torch, n: int):
    """A standardized (n, V) float64 study on the card, drawn from seed 3:
    K11's input in ``pipeline_kernel_times`` and ``kernel_split.py
    --kernel k11``."""
    gen = torch.Generator(device=DEVICE).manual_seed(3)
    x = torch.randn((n, V), generator=gen, device=DEVICE, dtype=torch.float64)
    return (x - x.mean(0)) / x.std(0)


def planted_study(torch, rng, n: int, g: int):
    """A standardized (n, g) float64 study on the host from ``rng``: column
    1 ≈ column 0 (|corr| ~ 0.99 for n > 2), column min(2, g − 1)
    constant (zero variance: all-zero after standardizing)."""
    x = rng.randn(n, g)
    if g > 1:
        x[:, 1] = x[:, 0] + 0.05 * rng.randn(n)
    x[:, min(2, g - 1)] = 3.0
    x = x - x.mean(0)
    std = x.std(0, ddof=1) if n > 1 else np.zeros(g)
    return torch.from_numpy(np.where(std > 0, x / np.where(std > 0, std, 1.0), 0.0))


def k11_edges(torch):
    """K11 at K11_EDGES (k11_check each on a planted_study):
    [{n, g, thr, pairs, within_eps, flips}]."""
    out = []
    for n, g, thr in K11_EDGES:
        z64 = planted_study(torch, np.random.RandomState(n + g), n, g).to(DEVICE)
        got, _, near, flips_plain, flips_64 = k11_check(torch, z64, thr)
        out.append({"n": n, "g": g, "thr": thr, "pairs": int(got.sum()),
                    "within_eps": int(near.sum()), "k11_vs_plain": flips_plain,
                    "k11_vs_float64": flips_64})
    return out


def k10c_check(torch, d2, perplexity, row0=0, rule="elems"):
    """K10c against its plain version on the same squared distances: the
    conditionals of an (R, N) slab from row ``row0`` (the route the size
    picks), and for a square d² the symmetrized P.  ``rule`` "elems": each
    entry within K10C_RTOL of the plain one; "rows": within K10C_RTOL of
    its row's largest entry (the weights a row gives the gradient), for
    rows long enough that the bisection's root itself moves with a float32
    sum's last bits (an entry's relative error then grows with its
    distance).  Returns (the kernel's result, the largest error under the
    rule, the largest per-entry relative error)."""
    from gene2vec_tpu_torch.kernels import tsne_calibrate as kc

    r, n = d2.shape
    if r == n and row0 == 0:
        got = kc.calibrate(d2, perplexity)
        want = kc.symmetrize_plain(kc.conditional_plain(d2, perplexity))
    else:
        got = kc.conditional(d2, perplexity, row0)
        want = kc.conditional_plain(d2, perplexity, row0)
    torch.cuda.synchronize()
    err = (got - want).abs()
    rel_elems = float((err / want.abs().masked_fill(want == 0, 1.0)).max())
    rel = rel_elems if rule == "elems" else \
        float((err / want.abs().amax(1, keepdim=True).clamp_min(1e-30)).max())
    zero_ok = bool(((got == 0) == (want == 0)).all())
    if not (rel <= K10C_RTOL and zero_ok):
        raise SystemExit(f"K10c (R {r}, N {n}, row0 {row0}): error {rel:.3e} ({rule}; limit "
                         f"{K10C_RTOL}), zeros agree {zero_ok}")
    return got, rel, rel_elems


def k10_terms(torch, p, y, gains, exaggeration, lr, z64=False):
    """(per element of vel, 4·lr·gains·(|rowsum_i·y_i| + Σ_j |g_ij|·|y_j|):
    the size of the terms whose float32 sums make the velocity's update;
    per element, |rowsum_i·y_i − Σ_j g_ij·y_j| over those terms without
    the factor: how near the gradient cancels to 0).  grad = 4(rowsum·y −
    g·y) cancels as the layout spreads, so two sum orders differ by a share
    of the terms, not of the result.  ``z64``: Z = Σnum − N summed in
    float64."""
    n = y.shape[0]
    sq = torch.sum(y * y, dim=1)
    d2 = sq[:, None] + sq[None, :] - 2.0 * (y @ y.T)
    num = 1.0 / (1.0 + torch.clamp_min(d2, 0.0))
    del d2
    z = (num.sum(dtype=torch.float64) - n).float() if z64 else num.sum() - n
    g = (exaggeration * p - num / z) * num
    del num
    rowsum = g.sum(1, keepdim=True)
    mag = (rowsum * y).abs() + g.abs() @ y.abs()
    ratio = (rowsum * y - g @ y).abs() / (mag + 1e-30)
    return 4.0 * lr * gains * mag, ratio


def step_plain_z64(torch, p, y, vel, gains, exaggeration, momentum, lr):
    """``tsne_step.step_plain`` with Z = Σnum − N summed in float64, as K10
    sums it: the plain iteration where its float32 Z cancels below
    float32's resolution of N (a layout spread so far that Σ_{i≠j} num <
    ulp(N); ROADMAP Queue C, F3)."""
    n, k = y.shape
    sq = torch.sum(y * y, dim=1)
    d2 = sq[:, None] + sq[None, :]
    for c in range(k):
        d2 = d2 - 2.0 * y[:, c:c + 1] * y[:, c]
    num = 1.0 / (1.0 + torch.clamp_min(d2, 0.0))
    z = (torch.sum(num, dtype=torch.float64) - n).float()
    g = (exaggeration * p - (1.0 / z) * num) * num
    gy_ext = torch.matmul(g, torch.cat([y, torch.ones((n, 1), dtype=y.dtype, device=y.device)], 1))
    grad = 4.0 * (gy_ext[:, k:] * y - gy_ext[:, :k])
    gains = torch.clamp_min(torch.where(torch.sign(grad) == torch.sign(vel), gains * 0.8,
                                        gains + 0.2), 0.01)
    vel = momentum * vel - lr * gains * grad
    y = y + vel
    return y - torch.mean(y, dim=0), vel, gains


def k10_check(torch, p, y, vel, gains, exaggeration, momentum, lr, ws=None, z64=False):
    """One K10 iteration (on copies) against the plain iteration from the
    same state: vel within K10_TOL of its update's terms (k10_terms), y
    within that plus K10_TOL of its largest entry (the centring's sum),
    gains equal except where the gradient cancels to within K10_TOL of its
    terms (its sign is then rounding's; such flips are counted).  ``z64``:
    the plain iteration and the terms with Z summed in float64
    (``step_plain_z64``), for a layout so spread that the float32 Z
    cancels (F3).  Returns (max |y − plain y| over max |y|, gains that
    differ)."""
    from gene2vec_tpu_torch.kernels import tsne_step

    yk, vk, gk = y.clone(), vel.clone(), gains.clone()
    tsne_step.step_(p, yk, vk, gk, exaggeration, momentum, lr, ws)
    if z64:
        yp, vp, gp = step_plain_z64(torch, p, y, vel, gains, exaggeration, momentum, lr)
    else:
        yp, vp, gp = tsne_step.step_plain(p, y, vel, gains, exaggeration, momentum, lr)
    torch.cuda.synchronize()
    terms, ratio = k10_terms(torch, p, y, torch.maximum(gk, gp), exaggeration, lr, z64)
    y_scale = float(yp.abs().max())
    same = gk == gp  # a flipped decision changes that element's step
    bad_flips = int((~same & (ratio > K10_TOL)).sum())
    v_err = float(((vk - vp).abs() / (terms + 1e-30))[same].max()) if bool(same.any()) else 0.0
    y_err = float(((yk - yp).abs() / (terms + y_scale + 1e-30))[same].max()) \
        if bool(same.any()) else 0.0
    if not (max(v_err, y_err) <= K10_TOL and bad_flips == 0):
        raise SystemExit(f"K10 (N {y.shape[0]}): vel / y errors {v_err:.3e} / {y_err:.3e} of "
                         f"their terms (limit {K10_TOL}), {bad_flips} gains differ where the "
                         f"gradient does not cancel")
    return float((yk - yp).abs().max()) / max(y_scale, 1e-30), int((~same).sum())


def lib_tsne_step(torch, p, y, vel, gains, exaggeration, momentum, lr):
    """K10's function as the shortest PyTorch sequence (timed as its
    ``library_ms``, used nowhere in the port): d² by one ``addmm`` and an
    in-place add, num by in-place clamp, add and ``reciprocal_``, Z by
    ``sum``, g by two in-place passes over a copy of P, [gy | rowsum] by
    one ``mm`` with [y | 1], then the (N, 2) epilogue.  Returns the new
    (y, vel, gains)."""
    n = y.shape[0]
    sq = torch.sum(y * y, dim=1)
    num = torch.addmm(sq[None, :], y, y.T, alpha=-2.0).add_(sq[:, None])
    num.clamp_min_(0.0).add_(1.0).reciprocal_()
    inv_z = 1.0 / (torch.sum(num) - n)
    g = torch.mul(p, exaggeration).sub_(num * inv_z).mul_(num)
    gy = torch.mm(g, torch.cat([y, torch.ones((n, 1), dtype=y.dtype, device=y.device)], 1))
    grad = 4.0 * (gy[:, 2:] * y - gy[:, :2])
    gains = torch.clamp_min(torch.where(torch.sign(grad) == torch.sign(vel), gains * 0.8,
                                        gains + 0.2), 0.01)
    vel = momentum * vel - lr * gains * grad
    y = y + vel
    return y - torch.mean(y, dim=0), vel, gains


def library_step_check(torch, p, y, vel, gains):
    """``lib_tsne_step`` against the plain iteration from the same state:
    max |y − plain y| over max |plain y| (at most K10_TOL: its sums run in
    another order)."""
    from gene2vec_tpu_torch.kernels import tsne_step

    got = lib_tsne_step(torch, p, y, vel, gains, 1.0, 0.8, 200.0)[0]
    want = tsne_step.step_plain(p, y, vel, gains, 1.0, 0.8, 200.0)[0]
    err = float((got - want).abs().max()) / max(float(want.abs().max()), 1e-30)
    if not err <= K10_TOL:
        raise SystemExit(f"K10's library sequence: y {err:.3e} of its scale from the plain "
                         f"iteration (limit {K10_TOL})")
    return err


def pipeline_row(name, src, replaces, ms, plain_ms, library_ms, bound_ms, bound_by, err,
                 tolerance, shape, **extra):
    return {"name": name, "route": "cuda",
            "source": f"gene2vec_tpu_torch/kernels/csrc/{src}", "replaces": replaces,
            "launches": None, "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": library_ms,
            "shape": shape, "tolerance": tolerance, **extra}


def k11_timed(torch, z64, timer, slow):
    """K11 and its plain version timed on one study's z; returns the
    kernels-line fields but the bound (``coexpr_mask.work``: ``--compare``
    runs this on older trees' kernels).  The plain version (``mm``, the
    epilogue, the packing) is also the shortest library sequence of K11's
    function, so its time is ``library_ms`` too."""
    from gene2vec_tpu_torch.kernels import coexpr_mask

    n, g = z64.shape
    z = z64.float().contiguous()
    plain_ms = slow(lambda: coexpr_mask.coexpr_mask_plain(z, PIPE_THR))
    return {"ms": timer(lambda: coexpr_mask.coexpr_mask(z, PIPE_THR)),
            "plain_ms": plain_ms, "library_ms": plain_ms, "n": n, "g": g}


def _run_spans(run_dir):
    """The serial build's spans: [(study, n_pairs, seconds)] and {span:
    seconds} of its other spans (load_inputs, write_output)."""
    with open(os.path.join(run_dir, "events.jsonl"), encoding="utf-8") as f:
        ends = [r for r in map(json.loads, filter(str.strip, f)) if r["type"] == "span_end"]
    return ([(r["attrs"]["study"], r["attrs"]["n_pairs"], r["dur"]) for r in ends
             if r["name"] == "study"],
            {r["name"]: r["dur"] for r in ends if r["name"] != "study"})


def pipeline_corpus(torch, work: str, smi: str, reps: int):
    """Phase 7a: the query directory through ``python -m
    gene2vec_tpu_torch.cli.generate_pairs`` (in process, for the launch
    counts), serial and ``--parallel --num-workers 2``: the same lines,
    K11 once per kept study.  Per kept study: V genes survive; K11 against
    its plain version and the float64 product on the card (k11_check); the
    CLI's lines against the float64 oracle's, which may differ only on
    pairs within EPS_N.  K11 timed at each kept study's n; the host's
    share (words to the host, unpack, nonzero, format) at the largest;
    then K11 at its tile edges (k11_edges).
    Returns (the serial pair file, the modules, K11's kernels-line row,
    K11's launches)."""
    import pandas as pd

    from gene2vec_tpu_torch import kernels
    from gene2vec_tpu_torch.cli import generate_pairs
    from gene2vec_tpu_torch.corpus import builder
    from gene2vec_tpu_torch.kernels import coexpr_mask
    from gene2vec_tpu_torch.obs.profiler import bound

    t0 = time.perf_counter()
    query, modules = write_pipeline_query(os.path.join(work, "pipeline"))
    log(f"phase 7a: query directory ({PIPE_GENES} genes, studies {PIPE_STUDIES}) written in "
        f"{time.perf_counter() - t0:.1f}s")
    kept = sum(n >= PIPE_MIN_SAMPLES for _, n in PIPE_STUDIES)
    runs, walls, launches = {}, {}, 0
    for label, extra in (("serial", []), ("parallel", ["--parallel", "--num-workers", "2"])):
        out, run_dir = os.path.join(work, f"pairs_{label}.txt"), os.path.join(work, f"run_{label}")
        kernels.reset_launch_counts()
        t0 = time.perf_counter()
        rc = generate_pairs.main(["--query", query, "--out", out, "--run-dir", run_dir, *extra])
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        n_k11 = kernels.launch_counts()["coexpr_mask"]
        if rc != 0 or n_k11 != kept:
            raise SystemExit(f"generate_pairs {label}: exit {rc}, K11 launched {n_k11} times "
                             f"for {kept} studies")
        launches += n_k11
        walls[label] = wall
        with open(out, encoding="utf-8") as f:
            runs[label] = f.read().split("\n")
        log(f"generate_pairs {label} ({smi}): {len(runs[label])} lines in {wall:.1f}s")
    if runs["serial"] != runs["parallel"]:
        raise SystemExit("generate_pairs: the parallel build's lines differ from the serial one's")

    data = pd.read_csv(os.path.join(query, "data", "gene_counts_TPM.csv"), index_col=0)
    counts = pd.read_csv(os.path.join(query, "data", "gene_counts.csv"))
    table = pd.read_csv(os.path.join(query, "data", "SRARunTable.csv"), index_col=0)
    data = data.loc[table.index.tolist()]
    ghm = builder.half_min(data.values)
    lines, pos, report = runs["serial"], 0, []
    timer, slow = Timer(torch, reps), Timer(torch, 3)
    timed = {}
    studies, other = _run_spans(os.path.join(work, "run_serial"))
    log(f"generate_pairs serial spans: {other}, studies "
        f"{[(st, round(sec, 3)) for st, _, sec in studies]}")
    for study, n_pairs, span_s in studies:
        ids = table.index[table["SRA Study"] == study].tolist()
        normed = builder.gene_annotated_data(data, counts, ids, global_half_min=ghm)
        genes, n = list(normed.columns), len(ids)
        if len(genes) != V:
            raise SystemExit(f"{study}: {len(genes)} genes survive the filters, not {V}")
        z64 = torch.from_numpy(np.ascontiguousarray(
            builder._standardized_columns(normed.values)[0])).to(DEVICE)
        got, exact, near, flips_plain, flips_64 = k11_check(torch, z64, PIPE_THR)
        # the CLI's lines for this study against the float64 oracle
        idx = {g: i for i, g in enumerate(genes)}
        pairs = np.array([[idx[a] for a in x.split(" ")] for x in lines[pos:pos + n_pairs]],
                         np.int64).reshape(-1, 2)
        pos += n_pairs
        cli = pairs[:, 0] * V + pairs[:, 1]
        if not (np.diff(cli) > 0).all():
            raise SystemExit(f"{study}: the CLI's pairs are not in row-major order")
        exact.fill_diagonal_(False)
        oracle = torch.nonzero(exact).cpu().numpy()
        oracle = oracle[:, 0] * V + oracle[:, 1]
        odd = np.setxor1d(cli, oracle)
        odd_t = torch.from_numpy(odd).to(DEVICE)
        if len(odd) and not bool(near[odd_t // V, odd_t % V].all()):
            raise SystemExit(f"{study}: the CLI's pairs differ from the float64 oracle's "
                             f"outside EPS_N")
        rec = {"study": study, "n": n, "g": V, "pairs": int(n_pairs), "cli_span_s": span_s,
               "within_eps": int(near.sum()),
               "k11_vs_plain": flips_plain, "k11_vs_float64": flips_64,
               "cli_vs_float64": int(len(odd))}
        if n == max(n for _, n in PIPE_STUDIES):
            # the host's share of one study: words to the host, unpack, nonzero, format
            split = {}
            t = time.perf_counter()
            words = coexpr_mask.coexpr_mask(z64.float().contiguous(), PIPE_THR)
            torch.cuda.synchronize()
            split["kernel_s"] = time.perf_counter() - t
            t = time.perf_counter()
            words_h = words.cpu()
            split["to_host_s"] = time.perf_counter() - t
            t = time.perf_counter()
            mask = coexpr_mask.unpack(words_h, V).numpy()
            split["unpack_s"] = time.perf_counter() - t
            t = time.perf_counter()
            rows, cols = mask.nonzero()
            split["nonzero_s"] = time.perf_counter() - t
            t = time.perf_counter()
            formatted = [f"{genes[r]} {genes[c]}" for r, c in zip(rows, cols) if r != c]
            split["format_s"] = time.perf_counter() - t
            if formatted != lines[pos - n_pairs:pos]:
                raise SystemExit(f"{study}: the host split's lines differ from the CLI's")
            rec["host_split"] = split
            del mask, words_h
        if n == K11_DENSE[0]:
            # at 0.9 only the planted pairs lie near the threshold; at 0.3
            # random pairs are dense around it, so products coarser than
            # float32 (TF32's ~1e-3, say) would flip ~10⁶ pairs outside EPS_N
            dense, _, near_d, d_plain, d_64 = k11_check(torch, z64, K11_DENSE[1])
            rec["dense"] = {"thr": K11_DENSE[1], "pairs": int(dense.sum()),
                            "within_eps": int(near_d.sum()), "k11_vs_plain": d_plain,
                            "k11_vs_float64": d_64}
            del dense, near_d
        if n in (24, K11_MAIN_N):
            timed[n] = k11_timed(torch, z64, timer, slow)
            # C = zᵀz is symmetric: one triangle's dots is all the function needs
            b_ms, b_by = bound(coexpr_mask.work(*z64.shape))
            timed[n].update(bound_ms=b_ms, bound_by=b_by)
            rec["timed"] = timed[n]
        report.append(rec)
        del got, exact, near, z64
        log(f"K11 {study} ({smi}): {json.dumps(rec)}")
    if pos != len(lines):
        raise SystemExit(f"generate_pairs: {len(lines) - pos} lines outside the studies' spans")
    edges = k11_edges(torch)
    print(json.dumps({"pipeline_corpus": report, "k11_edges": edges, "cli_spans": other,
                      "cli_s": walls, "card": smi}))
    main = timed[K11_MAIN_N]
    row = pipeline_row(
        "coexpr_mask", "k11_coexpr_mask.cu", "gene2vec_tpu/corpus/builder.py:145",
        main["ms"], main["plain_ms"], main["library_ms"], main["bound_ms"], main["bound_by"],
        float(any(r["k11_vs_plain"] for r in report)),
        "bits equal the plain version's and the float64 mask's except pairs within "
        "EPS_N = (n + 2)·2⁻²⁴ of the threshold (max_abs_err 1.0: some such bit differs)",
        {"n": K11_MAIN_N, "g": V}, n24=timed.get(24),
        within_eps_flips=sum(r["k11_vs_plain"] for r in report),
        dense=next(r["dense"] for r in report if "dense" in r))
    return os.path.join(work, "pairs_serial.txt"), modules, row, launches


def pipeline_train_eval(torch, work: str, smi: str, pairs_path: str, modules):
    """Phase 7b: the corpus of 7a trained through ``cli.gene2vec`` for
    PIPE_TRAIN_ITERS iterations (default configuration), then ``cli.evaluate``
    against a ``.gmt`` of the planted modules: the ratio must pass 1."""
    import shutil

    from gene2vec_tpu_torch.cli import evaluate, gene2vec

    data, export = os.path.join(work, "pipeline_corpus"), os.path.join(work, "pipeline_export")
    os.makedirs(data)
    shutil.copy(pairs_path, os.path.join(data, "pairs.txt"))
    t0 = time.perf_counter()
    rc = gene2vec.main([data, export, "txt", "--iters", str(PIPE_TRAIN_ITERS), "--device", DEVICE])
    torch.cuda.synchronize()
    if rc != 0:
        raise SystemExit(f"pipeline training exited {rc}")
    train_s = time.perf_counter() - t0
    gmt = os.path.join(work, "modules.gmt")
    with open(gmt, "w", encoding="utf-8") as f:
        for m, genes in enumerate(modules):
            f.write(f"MODULE_{m}\tplanted\t" + "\t".join(genes) + "\n")
    out = os.path.join(work, "intrinsic.json")
    emb = os.path.join(export, f"gene2vec_dim_{D}_iter_{PIPE_TRAIN_ITERS}_w2v.txt")
    if evaluate.main([emb, gmt, "--json", "--out", out]) != 0:
        raise SystemExit("cli.evaluate failed")
    with open(out, encoding="utf-8") as f:
        ratio = json.load(f)["trained_target_func_ratio"]
    rec = {"train_s": train_s, "iters": PIPE_TRAIN_ITERS, "ratio": ratio, "card": smi}
    print(json.dumps({"pipeline_eval": rec}))
    log(f"phase 7b: trained in {train_s:.1f}s, target-function ratio {ratio:.4f}")
    if not ratio > 1.0:
        raise SystemExit(f"intrinsic evaluation: ratio {ratio} not above 1")


def tsne_separation(torch, coords, groups, chunk=2048):
    """(mean intra-group distance, mean inter-group distance) over all
    pairs of the layout, on the card."""
    c = torch.from_numpy(np.asarray(coords, np.float64)).to(DEVICE)
    grp = torch.from_numpy(np.asarray(groups)).to(DEVICE)
    n = c.shape[0]
    intra = inter = 0.0
    n_intra = n_inter = 0
    for i in range(0, n, chunk):
        d = torch.cdist(c[i:i + chunk], c)
        same = grp[i:i + chunk, None] == grp[None, :]
        rows = torch.arange(i, min(i + chunk, n), device=c.device)
        same[rows - i, rows] = False
        other = ~same
        other[rows - i, rows] = False
        intra += float(d[same].sum())
        inter += float(d[other].sum())
        n_intra += int(same.sum())
        n_inter += int(other.sum())
    return intra / n_intra, inter / n_inter


def pipeline_tsne(torch, work: str, smi: str, reps: int):
    """Phase 7c: t-SNE at full width over a clustered export (phase 5's:
    V = 24,447, D = 200, 1,000 groups; PCA to 50): K10c against its plain
    version on the full (N, N) calibration and on an (R, 60,000) slab
    through the long-row route; one K10 iteration against the plain one
    from the start and from states 20 and 1,020 kernel iterations on; then
    ``cli.tsne --iters 250 1000`` on the export's matrix text (in process):
    both files written, every label, inter-group over intra-group mean
    distance past TSNE_SEP, K10c twice and K10 once an iteration.
    Returns (the K10c and K10 kernels-line rows, their launches)."""
    from gene2vec_tpu_torch import kernels
    from gene2vec_tpu_torch.obs.profiler import KernelProfiler, bound
    from gene2vec_tpu_torch.cli import tsne as tsne_cli
    from gene2vec_tpu_torch.config import TSNEConfig
    from gene2vec_tpu_torch.io.emb_io import write_matrix_txt
    from gene2vec_tpu_torch.kernels import tsne_calibrate as kc
    from gene2vec_tpu_torch.kernels import tsne_step as ks
    from gene2vec_tpu_torch.viz import tsne as viz

    t0 = time.perf_counter()
    emb, groups = write_clustered_export(os.path.join(work, "tsne_clustered"), v=V)
    tokens = [f"G{i}" for i in range(V)]
    emb_txt = os.path.join(work, "tsne_clustered.txt")
    write_matrix_txt(emb_txt, tokens, emb)
    log(f"phase 7c: clustered export and its matrix text written in "
        f"{time.perf_counter() - t0:.1f}s")
    timer, slow = Timer(torch, reps), Timer(torch, 3)
    x = torch.from_numpy(viz.pca_reduce(emb, 50)).to(DEVICE)
    d2 = viz._squared_distances(x)
    p, rel, _ = k10c_check(torch, d2, TSNE_PERPLEXITY)
    n = V
    steps = torch.zeros(n, dtype=torch.int32, device=DEVICE)
    p_cond = kc.conditional(d2, TSNE_PERPLEXITY, steps=steps)
    hist = {int(k): int(v) for k, v in enumerate(torch.bincount(steps.long()).tolist()) if v}
    b10c = bound(kc.work(n, n, int(steps.sum()) + n))
    k10c = {"ms": timer(lambda: kc.calibrate(d2, TSNE_PERPLEXITY)),
            "conditional_ms": timer(lambda: kc.conditional(d2, TSNE_PERPLEXITY)),
            "symmetrize_ms": timer(lambda: kc.symmetrize_(p_cond)),
            "plain_ms": slow(lambda: kc.symmetrize_plain(kc.conditional_plain(d2, TSNE_PERPLEXITY))),
            "rel_err": rel, "staged": kc.staged(n), "steps_histogram": hist,
            "mean_steps": float(steps.float().mean()),
            "bound_ms": b10c[0], "bound_by": b10c[1],
            "bound_51_passes_ms": bound(kc.work(n, n, 51 * n))[0]}
    del p_cond
    # the plain version is the shortest library sequence too: the bisection
    # is the function
    k10c["library_ms"] = k10c["plain_ms"]
    # the long-row route: rows past the staged limit read global memory.
    # Its points are drawn as the main path's are (groups of genes, PCA
    # 50).  At 60,000 columns the bisection's root moves with the sums'
    # last bits: entries far from a point, relative to themselves, moved
    # 6.9e-4 on such rows and 5.2e-3 on structureless Gaussian points (one
    # run each), so the slab holds each row to its own scale ("rows")
    slab_rows, slab_cols = K10C_SLAB
    wide, _ = clustered_table(seed=17, v=slab_cols, n_groups=slab_cols // 24)
    pts = torch.from_numpy(viz.pca_reduce(wide, 50)).to(DEVICE)
    row0 = slab_cols // 2
    sq = (pts * pts).sum(1)
    sub = pts[row0:row0 + slab_rows]
    # _squared_distances' order, for rows row0 .. row0 + R − 1 only
    slab = torch.clamp_min(sq[row0:row0 + slab_rows, None] - 2.0 * (sub @ pts.T) + sq[None, :],
                           0.0).contiguous()
    _, rel_long, elems_long = k10c_check(torch, slab, TSNE_PERPLEXITY, row0, rule="rows")
    slab_steps = torch.zeros(slab_rows, dtype=torch.int32, device=DEVICE)
    kc.conditional(slab, TSNE_PERPLEXITY, row0, steps=slab_steps)
    b_long = bound(kc.work(slab_rows, slab_cols, int(slab_steps.sum()) + slab_rows,
                           symmetrize=False))
    plain_long = slow(lambda: kc.conditional_plain(slab, TSNE_PERPLEXITY, row0))
    k10c["long_rows"] = {"rows": slab_rows, "cols": slab_cols, "staged": kc.staged(slab_cols),
                         "rows_err": rel_long, "elems_rel_err": elems_long,
                         "ms": timer(lambda: kc.conditional(slab, TSNE_PERPLEXITY, row0)),
                         # the plain version is the library sequence here too
                         "plain_ms": plain_long, "library_ms": plain_long,
                         "mean_steps": float(slab_steps.float().mean()),
                         "bound_ms": b_long[0], "bound_by": b_long[1]}
    del d2, slab, pts
    log(f"K10c ({smi}): {json.dumps(k10c)}; phase 7c at {time.perf_counter() - t0:.1f}s")
    # K10: from the start, from a state 20 kernel iterations on, and from
    # one 1,020 on (the reference's schedule: exaggeration and momentum
    # switch at 250), where g's attractive and repulsive parts nearly cancel
    rng = np.random.RandomState(0)
    y = torch.from_numpy((rng.randn(n, 2) * 1e-4).astype(np.float32)).to(DEVICE)
    vel, gains = torch.zeros_like(y), torch.ones_like(y)
    ws = ks.workspace(n, y.device)
    err0, flips0 = k10_check(torch, p, y, vel, gains, 12.0, 0.5, 200.0, ws)
    for _ in range(20):
        ks.step_(p, y, vel, gains, 12.0, 0.5, 200.0, ws)
    err1, flips1 = k10_check(torch, p, y, vel, gains, 12.0, 0.5, 200.0, ws)
    lib_ms = timer(lambda: lib_tsne_step(torch, p, y, vel, gains, 1.0, 0.8, 200.0))
    lib_err = library_step_check(torch, p, y, vel, gains)
    launch_ms = device_breakdown(torch, lambda: ks.step_(p, y, vel, gains, 1.0, 0.8, 200.0, ws))
    b10 = bound(ks.work(n))
    k10 = {"ms": timer(lambda: ks.step_(p, y, vel, gains, 1.0, 0.8, 200.0, ws)),
           "plain_ms": slow(lambda: ks.step_plain(p, y, vel, gains, 1.0, 0.8, 200.0)),
           "library_ms": lib_ms, "library_y_err": lib_err, "launch_ms": launch_ms,
           "bound_ms": b10[0], "bound_by": b10[1]}
    # the profiler's timing of the same iteration (CUDA events: torch.profiler
    # saw no time of this cooperative launch in some runs) against the Timer's
    best = KernelProfiler(device=DEVICE).measure(
        "tsne_step", lambda: ks.step_(p, y, vel, gains, 1.0, 0.8, 200.0, ws), iters=TIMED_REPS)
    k10["profiler_measure_ms"] = best * 1e3
    if not abs(best * 1e3 - k10["ms"]) <= K10_MEASURE_SHARE * k10["ms"]:
        raise SystemExit(f"K10: KernelProfiler.measure {best * 1e3:.4f} ms, the Timer "
                         f"{k10['ms']:.4f} ms (more than {K10_MEASURE_SHARE:g} apart)")
    cfg = TSNEConfig()
    viz._segment(cfg, p, y, vel, gains, 20, 1000)
    err2, flips2 = k10_check(torch, p, y, vel, gains, 1.0, cfg.momentum_final,
                             cfg.learning_rate, ws)
    k10.update({"y_err": [err0, err1, err2], "gains_flips": [flips0, flips1, flips2],
                "late_max_abs_y": float(y.abs().max())})
    log(f"K10 ({smi}): {json.dumps(k10)}; phase 7c at {time.perf_counter() - t0:.1f}s")
    del p, y, vel, gains
    torch.cuda.empty_cache()
    # the CLI
    out = os.path.join(work, "tsne_out")
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    rc = tsne_cli.main([emb_txt, out, "--iters", *map(str, TSNE_SNAPSHOTS)])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = kernels.launch_counts()
    want = {"tsne_calibrate": 2, "tsne_calibrate_sym": 1, "tsne_step": TSNE_SNAPSHOTS[-1]}
    if rc != 0 or any(counts[k] != v for k, v in want.items()):
        raise SystemExit(f"cli.tsne: exit {rc}, launches "
                         f"{ {k: counts[k] for k in want} }, expected {want}")
    with open(os.path.join(out, "labels.txt"), encoding="utf-8") as f:
        labels = f.read().split()
    if sorted(labels) != sorted(tokens):
        raise SystemExit("cli.tsne: labels.txt does not hold every gene once")
    sep = {}
    for it in TSNE_SNAPSHOTS:
        coords = np.loadtxt(os.path.join(out, f"tsne_iter_{it}.txt"))
        if coords.shape != (n, 2) or not np.isfinite(coords).all():
            raise SystemExit(f"cli.tsne: tsne_iter_{it}.txt has shape {coords.shape}")
        intra, inter = tsne_separation(torch, coords, groups[[int(t[1:]) for t in labels]])
        sep[it] = {"intra": intra, "inter": inter, "ratio": inter / intra}
    rec = {"cli_s": wall, "separation": sep, "ms_per_iteration": k10["ms"],
           "bound_ms_per_iteration": b10[0], "card": smi}
    print(json.dumps({"pipeline_tsne": rec, "k10c": k10c, "k10": k10}))
    log(f"phase 7c: cli.tsne {wall:.1f}s, separation {sep}, K10 {k10['ms']:.4f} ms an "
        f"iteration against {b10[0]:.4f}")
    if not sep[TSNE_SNAPSHOTS[-1]]["ratio"] > TSNE_SEP:
        raise SystemExit(f"cli.tsne: groups do not separate ({sep})")
    rows = [
        pipeline_row("tsne_calibrate", "k10c_tsne_calibrate.cu", "gene2vec_tpu/viz/tsne.py:52",
                     k10c["ms"], k10c["plain_ms"], k10c["library_ms"], b10c[0], b10c[1], rel,
                     f"each P entry within {K10C_RTOL} of the plain version's (relative); the "
                     f"long-row slab's within {K10C_RTOL} of its row's largest",
                     {"n": n, "long_rows": list(K10C_SLAB)}, long_rows=k10c["long_rows"],
                     launch_ms={"conditional": k10c["conditional_ms"],
                                "symmetrize": k10c["symmetrize_ms"]},
                     steps_histogram=hist),
        pipeline_row("tsne_step", "k10_tsne_step.cu", "gene2vec_tpu/viz/tsne.py:143",
                     k10["ms"], k10["plain_ms"], k10["library_ms"], b10[0], b10[1],
                     max(err0, err1, err2),
                     f"vel within {K10_TOL} of its update's terms, y within that plus "
                     f"{K10_TOL} of max|y|, gains equal but where the gradient cancels",
                     {"n": n}, gains_flips=[flips0, flips1, flips2], launch_ms=launch_ms),
    ]
    return rows, {"tsne_calibrate": counts["tsne_calibrate"], "tsne_step": counts["tsne_step"]}


def pipeline_kernel_times(torch, reps: int = TIMED_REPS) -> dict:
    """K11, K10c and K10 timed at phase 7's full-width shapes on inputs made
    from a seed (``--compare``, which runs the comparing checkout's copy of
    this function on each tree's kernels): K11 on standardized (160,
    24,447) and (24, 24,447) studies (``k11_study``), K10c on the
    clustered table's PCA-50 distances (whole, and each launch apart), K10
    on that P 20 iterations into a run (the CUDA-event time and its
    launches' device ms by kernel name), and the wall of ``cli.tsne
    --iters 250 1000`` on that table's matrix text."""
    from gene2vec_tpu_torch.cli import tsne as tsne_cli
    from gene2vec_tpu_torch.io.emb_io import write_matrix_txt
    from gene2vec_tpu_torch.kernels import tsne_calibrate as kc
    from gene2vec_tpu_torch.kernels import tsne_step as ks
    from gene2vec_tpu_torch.viz import tsne as viz

    timer = Timer(torch, reps)
    k11 = {n: k11_timed(torch, k11_study(torch, n), timer, Timer(torch, 3))
           for n in (K11_MAIN_N, 24)}
    emb, _ = clustered_table(v=V)
    d2 = viz._squared_distances(torch.from_numpy(viz.pca_reduce(emb, 50)).to(DEVICE))
    k10c = {"ms": timer(lambda: kc.calibrate(d2, TSNE_PERPLEXITY)),
            "conditional_ms": timer(lambda: kc.conditional(d2, TSNE_PERPLEXITY))}
    p_cond = kc.conditional(d2, TSNE_PERPLEXITY)
    k10c["symmetrize_ms"] = timer(lambda: kc.symmetrize_(p_cond))  # in place: timing only
    del p_cond
    p = kc.calibrate(d2, TSNE_PERPLEXITY)
    del d2
    y = torch.from_numpy((np.random.RandomState(0).randn(V, 2) * 1e-4).astype(np.float32))
    y = y.to(DEVICE)
    vel, gains = torch.zeros_like(y), torch.ones_like(y)
    ws = ks.workspace(V, y.device)
    for _ in range(20):
        ks.step_(p, y, vel, gains, 12.0, 0.5, 200.0, ws)

    def step():
        ks.step_(p, y, vel, gains, 1.0, 0.8, 200.0, ws)

    keep = ("ms", "plain_ms", "library_ms")
    out = {"coexpr_mask": {k: k11[K11_MAIN_N][k] for k in keep},
           "coexpr_mask_n24": {k: k11[24][k] for k in keep},
           "tsne_calibrate_ms": k10c["ms"], "tsne_calibrate": k10c,
           "tsne_step_ms": timer(step), "tsne_step_launch_ms": device_breakdown(torch, step)}
    del p, y, vel, gains, ws
    torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory(prefix="chip_smoke_", dir=os.getcwd()) as work:
        emb_txt = os.path.join(work, "emb.txt")
        write_matrix_txt(emb_txt, [f"G{i}" for i in range(V)], emb)
        t0 = time.perf_counter()
        rc = tsne_cli.main([emb_txt, os.path.join(work, "out"), "--iters",
                            *map(str, TSNE_SNAPSHOTS)])
        torch.cuda.synchronize()
        out["cli_tsne_s"] = time.perf_counter() - t0
    if rc != 0:
        raise SystemExit(f"cli.tsne exited {rc}")
    return out


def k15_check(torch, d2, k):
    """K15 against its plain version on the same squared distances (on the
    card a view of padded rows): each row's neighbours the same set (the
    same order counted too), each weight within K15_ATOL, the CSR union of
    the kernel's (idx, w) bitwise the plain union of the same (idx, w)
    (offsets, columns and values), and the densified P within 2·K15_ATOL of
    the plain graph's (densified on the plain side only).  Returns (the
    kernel's graph, a record of the errors)."""
    from gene2vec_tpu_torch.kernels import umap_graph as ug

    n = d2.shape[0]
    idx, w = ug.knn_weights(d2, k)
    g = ug.fuzzy_union(idx, w)
    idx_p, w_p = ug.knn_weights_plain(d2, k)
    torch.cuda.synchronize()
    sets = bool(torch.equal(idx.sort(1).values, idx_p.sort(1).values))
    order = bool(torch.equal(idx, idx_p))
    w_err = float((w - w_p).abs().max())
    gp = ug.fuzzy_union_plain(idx, w)
    union_bits = bool(torch.equal(g.rowptr, gp.rowptr) and torch.equal(g.col, gp.col)
                      and same_bits(torch, g.val, gp.val))
    del gp
    p_err = float((ug.to_dense(g) - ug.to_dense(ug.fuzzy_union_plain(idx_p, w_p))).abs().max())
    lens = g.rowptr[1:] - g.rowptr[:-1]
    rec = {"n": n, "k": k, "sets_equal": sets, "order_equal": order, "w_err": w_err,
           "union_bitwise": union_bits, "p_err": p_err, "nnz": g.nnz,
           "max_row": int(lens.max()) if n else 0, "route": ug.stages(n, k)}
    if not (sets and w_err <= K15_ATOL and union_bits and p_err <= 2 * K15_ATOL):
        raise SystemExit(f"K15 (N {n}, k {k}): {rec} (limits: w {K15_ATOL}, P {2 * K15_ATOL})")
    return g, rec


def k16_check(torch, g, y, c, lr, got=None, who="K16"):
    """One K16 iteration on the graph ``g`` (or ``got``, another
    sequence's y′ from the same state) against the plain one from the
    same state: every coordinate of y′ within K16_TOL of lr·terms +
    max|y′|, where terms = |rowsum_i·y_i| + Σ_j |coef_ij|·|y_j| in float64
    (the force cancels as the layout spreads, so two sum orders differ by
    a share of its terms); the plain side is the dense coef of the
    densified graph; the clip decisions that differ where the plain force
    lies within K16_TOL·terms of ±4 are counted.  Returns a record: the
    largest error over its bound's terms, the clip flips, the forces near
    ±4 and the clipped coordinates (where the force is clipped the check
    holds only its sign)."""
    from gene2vec_tpu_torch.kernels import umap_graph as ug
    from gene2vec_tpu_torch.kernels import umap_step as us

    got = us.step(g, y, c, lr) if got is None else got
    coef = us.coef_plain(ug.to_dense(g), y, c)
    n = y.shape[0]
    fr = torch.matmul(coef, torch.cat([y, torch.ones((n, 1), device=y.device)], 1))
    y64 = y.double()
    terms = (fr[:, 2:3].double() * y64).abs() + coef.abs().double() @ y64.abs()
    del coef
    force = fr[:, 2:3] * y - fr[:, :2]
    want = y - lr * torch.clamp(force, -4.0, 4.0)
    torch.cuda.synchronize()
    y_scale = float(want.abs().max())
    err = (got.double() - want.double()).abs()
    ratio = float((err / (lr * terms + y_scale)).max())
    near = ((force.double().abs() - 4.0).abs() <= K16_TOL * terms)
    slack = float(np.spacing(np.float32(y_scale))) / lr
    clipped_k = ((y64 - got.double()).abs() / lr) >= 4.0 - slack
    flips = int((near & (clipped_k != (force.abs() > 4.0))).sum())
    clipped = int((force.abs() > 4.0).sum())
    rec = {"n": n, "err_share": ratio, "clip_flips": flips, "near_clip": int(near.sum()),
           "clipped": clipped, "clipped_share": clipped / (2.0 * n), "max_abs_y": y_scale}
    if not ratio <= K16_TOL:
        raise SystemExit(f"{who} (N {n}, fast {c.fast_kernel}): {rec} (limit {K16_TOL})")
    return rec


def dense_union(torch, idx, w):
    """The first UMAP design's plain union, the dense (N, N) P = W + Wᵀ −
    W∘Wᵀ (timed in
    K15's library sequence only)."""
    n = idx.shape[0]
    dense = torch.zeros((n, n), dtype=torch.float32, device=w.device)
    rows = torch.arange(n, device=w.device)[:, None].expand_as(idx)
    dense[rows, idx.long()] = w
    return dense + dense.T - dense * dense.T


def lib_umap_graph(torch, d2, k):
    """K15's function as the shortest PyTorch sequence (timed as its
    ``library_ms``, used nowhere in the port): ``topk`` of the masked d²
    (its order of ties unspecified), the bisection in torch ops and the
    dense union."""
    from gene2vec_tpu_torch.kernels import umap_graph as ug

    masked = d2.clone()
    masked.diagonal().fill_(float("inf"))
    vals, idx = torch.topk(masked, k, dim=1, largest=False)
    del masked
    w = ug.smooth_knn_plain(torch.sqrt(vals.clamp_min_(0.0)), k)
    return dense_union(torch, idx, w)


def lib_umap_step(torch, p, y, c, lr):
    """K16's function as the shortest PyTorch sequence (timed as its
    ``library_ms``, used nowhere in the port) on a dense P (the caller
    densifies the graph outside the timed window): u by two broadcast
    differences squared in place, ub, q_inv, attract and repel by in-place
    passes, one ``mm`` with [y | 1], then the (N, 2) epilogue."""
    n = y.shape[0]
    u = torch.sub(y[:, :1], y[:, 0]).square_()
    u.add_(torch.sub(y[:, 1:], y[:, 1]).square_())
    um = u.clamp_min(1e-12)
    ub = um.rsqrt().rsqrt_().rsqrt_().mul_(um) if c.fast_kernel else um.pow(c.b)
    q = ub.mul(c.a).add_(1.0)
    attract = ub.mul_(c.two_ab).div_(um).div_(q).mul_(p)
    del um
    repel = u.add_(1e-3).mul_(q)
    del q
    torch.div(c.two_bg, repel, out=repel).mul_(torch.rsub(p, 1.0))
    coef = attract.sub_(repel)
    del repel
    coef.diagonal().zero_()
    fr = torch.mm(coef, torch.cat([y, torch.ones((n, 1), device=y.device)], 1))
    return y - lr * torch.clamp(fr[:, 2:3] * y - fr[:, :2], -4.0, 4.0)


#: K15's launches a graph build: the neighbours and weights, then the
#: union's count, scan, fill and sort
K15_LAUNCHES = 5


def umap_kernel_times(torch, reps: int = TIMED_REPS) -> dict:
    """K15 and K16 timed at phase 7d's full-width shapes on inputs made
    from a seed, and the wall of ``cli.plot`` (``--compare``, which runs
    the comparing checkout's copy of this function on each tree's
    modules): the tree's own distances of the clustered table's PCA-50
    points, its ``umap_graph.graph`` on them, and whatever that returns
    (the first design's dense P, or the sparse graph) handed straight to its
    ``umap_step.step`` 20 iterations into a run."""
    from gene2vec_tpu_torch.cli import plot as plot_cli
    from gene2vec_tpu_torch.io.emb_io import write_matrix_txt
    from gene2vec_tpu_torch.kernels import umap_graph as ug
    from gene2vec_tpu_torch.kernels import umap_step as us
    from gene2vec_tpu_torch.viz import tsne as viz
    from gene2vec_tpu_torch.viz import umap as umap_viz

    timer = Timer(torch, reps)
    emb, _ = clustered_table(v=V)
    x = viz.pca_reduce(emb, 50)
    d2 = umap_viz._squared_distances(torch.from_numpy(x).to(DEVICE))
    out = {"graph_ms": timer(lambda: ug.graph(d2, UMAP_K)),
           "knn_weights_ms": timer(lambda: ug.knn_weights(d2, UMAP_K))}
    idx, w = ug.knn_weights(d2, UMAP_K)
    out["union_ms"] = timer(lambda: ug.fuzzy_union(idx, w))
    p = ug.graph(d2, UMAP_K)
    del d2, idx, w
    torch.cuda.empty_cache()
    c, y = umap_viz.start(x, umap_viz.UMAPConfig(), DEVICE)
    spare = torch.empty_like(y)
    for it in range(20):
        y, spare = us.step(p, y, c, us.learning_rate(1.0, it, UMAP_ITERS), out=spare), y
    lr = us.learning_rate(1.0, 20, UMAP_ITERS)
    out["step_ms"] = timer(lambda: us.step(p, y, c, lr, out=spare))
    del p, y, spare
    torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory(prefix="chip_smoke_", dir=os.getcwd()) as work:
        emb_txt = os.path.join(work, "emb.txt")
        write_matrix_txt(emb_txt, [f"G{i}" for i in range(V)], emb)
        t0 = time.perf_counter()
        rc = plot_cli.main([emb_txt, os.path.join(work, "out", "gene2vec")])
        torch.cuda.synchronize()
        out["cli_plot_s"] = time.perf_counter() - t0
    if rc != 0:
        raise SystemExit(f"cli.plot exited {rc}")
    return out


def pipeline_umap(torch, work: str, smi: str, reps: int):
    """Phase 7d: UMAP at full width over phase 7c's clustered table (N =
    24,447, D = 200, 1,000 groups; PCA to 50, k = 15): K15 against its plain
    version (k15_check); K16 against the plain iteration from the start
    and from a state UMAP_MID kernel iterations on, the fast kernel (the
    main path's) and ``fast_kernel=False`` (k16_check); each timed beside
    its plain version and library sequence (the dense sequences, P
    densified outside the timed window); then ``cli.plot`` on the table's
    matrix text (phase 7c's, written here when 7d runs alone; in process):
    the json holds every gene once with finite coordinates, the groups
    separate (inter over intra mean distance past UMAP_SEP), K15's five
    launches and one K16 launch an iteration.  Returns (the K15 and K16
    kernels-line rows, their launches)."""
    import importlib.util

    from gene2vec_tpu_torch import kernels
    from gene2vec_tpu_torch.cli import plot as plot_cli
    from gene2vec_tpu_torch.kernels import umap_graph as ug
    from gene2vec_tpu_torch.kernels import umap_step as us
    from gene2vec_tpu_torch.obs.profiler import bound
    from gene2vec_tpu_torch.viz import tsne as viz
    from gene2vec_tpu_torch.viz import umap as umap_viz
    from gene2vec_tpu_torch.viz.umap import UMAPConfig
    from gene2vec_tpu_torch.viz.umap import start as umap_start

    t0 = time.perf_counter()
    emb, groups = clustered_table(v=V)  # phase 7c's table (write_clustered_export's seed)
    emb_txt = os.path.join(work, "tsne_clustered.txt")
    if not os.path.exists(emb_txt):  # phase 7d alone: no 7c before it
        from gene2vec_tpu_torch.io.emb_io import write_matrix_txt

        write_matrix_txt(emb_txt, [f"G{i}" for i in range(V)], emb)
    timer, slow = Timer(torch, reps), Timer(torch, 3)
    x = viz.pca_reduce(emb, 50)
    d2 = umap_viz._squared_distances(torch.from_numpy(x).to(DEVICE))
    n = V
    g, k15 = k15_check(torch, d2, UMAP_K)
    p_dense = ug.to_dense(g)  # the library sequences' P, outside their timed windows
    lib_p = lib_umap_graph(torch, d2, UMAP_K)
    library_check("umap_graph", [lib_p], [p_dense], rtol=2 * K15_ATOL)
    del lib_p
    b15 = bound(ug.work(n, UMAP_K, g.nnz))
    old = {"k15": bound(ug.dense_work(n))[0], "k16": bound(us.dense_work(n))[0]}
    k15.update({"ms": timer(lambda: ug.graph(d2, UMAP_K)),
                "knn_weights_ms": timer(lambda: ug.knn_weights(d2, UMAP_K)),
                "plain_ms": slow(lambda: ug.fuzzy_union_plain(
                    *ug.knn_weights_plain(d2, UMAP_K))),
                "library_ms": slow(lambda: lib_umap_graph(torch, d2, UMAP_K)),
                "bound_ms": b15[0], "bound_by": b15[1], "dense_p_bound_ms": old["k15"]})
    idx, w = ug.knn_weights(d2, UMAP_K)
    k15["union_ms"] = timer(lambda: ug.fuzzy_union(idx, w))
    del d2, idx, w
    torch.cuda.empty_cache()
    log(f"K15 ({smi}): {json.dumps(k15)}; phase 7d at {time.perf_counter() - t0:.1f}s")
    # K16 from umap_layout's start and UMAP_MID iterations on, the fast
    # kernel (the main path's) and pow: at the start nearly every force is
    # clipped, 200 iterations on most are inside ±4, so the mid checks hold
    # the force's value
    c, y = umap_start(x, UMAPConfig(), DEVICE)
    lr0 = us.learning_rate(1.0, 0, UMAP_ITERS)
    checks = {"start": k16_check(torch, g, y, c, lr0)}
    c_pow, y_pow = umap_start(x, UMAPConfig(fast_kernel=False), DEVICE)
    checks["start_pow"] = k16_check(torch, g, y_pow, c_pow, lr0)
    pow_ms = timer(lambda: us.step(g, y_pow, c_pow, lr0))
    spare = torch.empty_like(y)
    for it in range(UMAP_MID):
        y, spare = us.step(g, y, c, us.learning_rate(1.0, it, UMAP_ITERS), out=spare), y
    lr = us.learning_rate(1.0, UMAP_MID, UMAP_ITERS)
    checks["mid"] = k16_check(torch, g, y, c, lr)
    checks["mid_pow"] = k16_check(torch, g, y, c_pow, lr)
    # the library sequence held by K16's own measure at the mid state
    lib = k16_check(torch, g, y, c, lr, lib_umap_step(torch, p_dense, y, c, lr),
                    "K16's library sequence")
    b16 = bound(us.work(n, g.nnz))
    # no launch_ms: K16 is one launch a call, so the profiler's time of it
    # would only repeat ``ms``
    k16 = {"ms": timer(lambda: us.step(g, y, c, lr, out=spare)),
           "plain_ms": slow(lambda: us.step_plain(g, y, c, lr)),
           "library_ms": slow(lambda: lib_umap_step(torch, p_dense, y, c, lr)),
           "library_y_err": lib["err_share"], "pow_ms": pow_ms,
           "bound_ms": b16[0], "bound_by": b16[1],
           "pow_bound_ms": bound(us.work(n, g.nnz, False))[0],
           "dense_p_bound_ms": old["k16"], "checks": checks}
    log(f"K16 ({smi}): {json.dumps(k16)}; phase 7d at {time.perf_counter() - t0:.1f}s")
    del g, p_dense, y, spare, y_pow
    torch.cuda.empty_cache()
    # the CLI: cli.plot's default method (UMAP at 2 components); where
    # neither plotly nor matplotlib is installed it writes the json alone
    out_prefix = os.path.join(work, "umap_out", "gene2vec")
    images = [m for m in ("plotly", "matplotlib") if importlib.util.find_spec(m)]
    kernels.reset_launch_counts()
    t1 = time.perf_counter()
    rc = plot_cli.main([emb_txt, out_prefix])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t1
    counts = kernels.launch_counts()
    want = {"umap_graph": K15_LAUNCHES, "umap_graph_union": 1, "umap_graph_scan": 1,
            "umap_graph_fill": 1, "umap_graph_sort": 1, "umap_step": UMAP_ITERS}
    if rc != 0 or any(counts[k] != v for k, v in want.items()):
        raise SystemExit(f"cli.plot: exit {rc}, launches "
                         f"{ {k: counts[k] for k in want} }, expected {want}")
    with open(out_prefix + ".json", encoding="utf-8") as f:
        trace = json.load(f)["data"][0]
    labels = trace["customdata"]
    coords = np.stack([np.asarray(trace["x"], np.float64), np.asarray(trace["y"], np.float64)], 1)
    if labels != [f"G{i}" for i in range(n)] or coords.shape != (n, 2) \
            or not np.isfinite(coords).all():
        raise SystemExit(f"cli.plot: the json does not hold every gene once with finite "
                         f"coordinates ({len(labels)} labels, coords {coords.shape})")
    intra, inter = tsne_separation(torch, coords, groups[[int(t[1:]) for t in labels]])
    sep = {"intra": intra, "inter": inter, "ratio": inter / intra}
    written = sorted(os.listdir(os.path.dirname(out_prefix)))
    rec = {"images": images, "wall_s": wall, "files": written,
           "separation": sep, "ms_per_iteration": k16["ms"], "bound_ms_per_iteration": b16[0],
           "card": smi}
    print(json.dumps({"pipeline_umap": rec, "k15": k15, "k16": k16}))
    log(f"phase 7d: cli.plot {wall:.1f}s, separation {sep}, K16 {k16['ms']:.4f} ms an "
        f"iteration against {b16[0]:.4f}")
    if not sep["ratio"] > UMAP_SEP:
        raise SystemExit(f"cli.plot: groups do not separate ({sep})")
    err16 = max(r["err_share"] for r in checks.values())
    rows = [
        pipeline_row("umap_graph", "k15_umap_graph.cu", "gene2vec_tpu/viz/umap.py:114",
                     k15["ms"], k15["plain_ms"], k15["library_ms"], b15[0], b15[1],
                     max(k15["w_err"], k15["p_err"]),
                     f"neighbour sets equal, each weight within {K15_ATOL} and P within "
                     f"{2 * K15_ATOL} of the plain version's (absolute); the CSR bitwise the "
                     f"plain union of the same lists",
                     {"n": n, "k": UMAP_K, "nnz": k15["nnz"]},
                     launch_ms={"knn_weights": k15["knn_weights_ms"], "union": k15["union_ms"]},
                     library_note="the dense sequence (topk, the bisection, the dense "
                                  "union)", dense_p_bound_ms=old["k15"]),
        pipeline_row("umap_step", "k16_umap_step.cu", "gene2vec_tpu/viz/umap.py:188",
                     k16["ms"], k16["plain_ms"], k16["library_ms"], b16[0], b16[1], err16,
                     f"y′ within {K16_TOL} of lr·(|rowsum·y| + Σ|coef|·|y|) + max|y′|; clip "
                     f"flips counted where the force lies within that of ±4",
                     {"n": n, "nnz": k15["nnz"]},
                     clip_flips={k: r["clip_flips"] for k, r in checks.items()},
                     library_note="the dense sequence on P densified outside the timed "
                                  "window", dense_p_bound_ms=old["k16"]),
    ]
    return rows, {"umap_graph": counts["umap_graph"], "umap_step": counts["umap_step"]}


def pipeline(torch, smi: str, reps: int = TIMED_REPS):
    """Phase 7, the paper's pipeline on the card: corpus → training →
    intrinsic evaluation, t-SNE and UMAP.  Returns (the K10c, K10, K15, K16
    and K11 kernels-line rows, their launches on these paths)."""
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory(prefix="chip_smoke_", dir=os.getcwd()) as work:
        pairs, modules, k11_row, k11_launches = pipeline_corpus(torch, work, smi, reps)
        pipeline_train_eval(torch, work, smi, pairs, modules)
        rows, counts = pipeline_tsne(torch, work, smi, reps)
        umap_rows, umap_counts = pipeline_umap(torch, work, smi, reps)
    rows += umap_rows
    counts.update(umap_counts)
    counts["coexpr_mask"] = k11_launches
    log(f"pipeline phase done in {time.perf_counter() - t0:.1f}s")
    return rows + [k11_row], counts


#: what ``--compare`` runs in each tree, with that tree's own chip_smoke:
#: the K1-K4 kernel check and the objectives' check (K5a, K5b, K6, K4's
#: generic entries) at float32 and bfloat16 (the K1, K2/K3, K4, K5a, K5b
#: and K6 rows kept), the row gather at the probes' and the GGIPNN lookup's
#: shapes, the host time of K4's wrappers and of the step body per step
#: (host_times, below), the default step's profiled window at both widths,
#: the sg_hs, cbow_hs, shared and per_example steps' windows and their
#: kernels by name per step (step_kernels, below), the K12, K13 and K14
#: probes (stream_probes' sizes, lane_probes' gather, scatter and
#: stream_copy at (256, 24576), staged_probes' feature probes, callh and
#: vmem_probe sweep: their records), the serving kernels
#: K7-K9r at MAIN_SHAPE (their kernels-line rows), phase 3's training
#: run (pairs/s per iteration from its training log), and the pipeline's
#: K11, K10c and K10 and cli.tsne's wall (pipeline_kernel_times: the
#: comparing checkout's, whose path is this code's one argument, on this
#: tree's kernels, so every tree is timed by the same code), and K15, K16
#: and cli.plot's wall (umap_kernel_times, the comparing checkout's too:
#: whatever the tree's ``umap_graph.graph`` returns goes straight to its
#: ``umap_step.step``).  ``--parts umap`` runs the UMAP times alone.
COMPARE_RUN = """
import csv, importlib.util, json, os, sys, tempfile, time
sys.path.insert(0, os.getcwd())
import numpy as np
import torch
import chip_smoke as cs
smi = cs.nvidia_smi_line()
spec = importlib.util.spec_from_file_location("chip_smoke_comparing", sys.argv[1])
comparing = importlib.util.module_from_spec(spec)
spec.loader.exec_module(comparing)
if sys.argv[2] == "umap":
    print("COMPARE " + json.dumps({"tree": os.getcwd(), "card": smi,
                                   "umap": comparing.umap_kernel_times(torch)}))
    sys.exit(0)


def host_times(config_kw, epochs=3):
    # Host time per step on the host clock, over `epochs` epochs of
    # PROFILED_STEPS full-width steps after a warm-up: in K4's wrappers
    # (each call's own time, the launches asynchronous) and in the step
    # body (_step_stratified or _step_sampled: every wrapper of the step
    # and its glue), beside the whole wall per step.
    from gene2vec_tpu_torch.config import SGNSConfig
    from gene2vec_tpu_torch.data.pipeline import PairCorpus
    from gene2vec_tpu_torch.io.vocab import Vocab
    from gene2vec_tpu_torch.sgns import step as st
    from gene2vec_tpu_torch.sgns.cbow_hs import make_trainer
    from gene2vec_tpu_torch.sgns.train import epoch_generator

    rng = np.random.RandomState(0)
    n = cs.PROFILED_STEPS * cs.B
    pairs = np.stack([cs.zipf_ids(rng, n, cs.V), cs.zipf_ids(rng, n, cs.V)], 1)
    counts = np.bincount(pairs.reshape(-1), minlength=cs.V) + 1
    tr = make_trainer(PairCorpus(Vocab([f"G{i}" for i in range(cs.V)], counts), pairs),
                      SGNSConfig(**config_kw), device=cs.DEVICE)
    params = tr.init()
    names = ("row_update", "scatter_rows", "finalize_rows", "_step_stratified", "_step_sampled")
    spent = dict.fromkeys(names, 0)
    orig = {k: getattr(st, k) for k in names}

    def timed(k):
        def call(*a, **kw):
            t0 = time.perf_counter_ns()
            out = orig[k](*a, **kw)
            spent[k] += time.perf_counter_ns() - t0
            return out
        return call

    for k in names:
        setattr(st, k, timed(k))
    try:
        params, loss = tr.train_epoch(params, generator=epoch_generator(1, 0))
        float(loss)
        walls, k4, body = [], [], []
        for it in range(1, epochs + 1):
            for k in names:
                spent[k] = 0
            t0 = time.perf_counter()
            params, loss = tr.train_epoch(params, generator=epoch_generator(1, it))
            float(loss)
            walls.append((time.perf_counter() - t0) * 1e6 / tr.num_batches)
            k4.append(sum(spent[k] for k in names[:3]) / 1e3 / tr.num_batches)
            body.append(sum(spent[k] for k in names[3:]) / 1e3 / tr.num_batches)
    finally:
        for k in names:
            setattr(st, k, orig[k])
    return {"config": "_".join(str(v) for v in config_kw.values()) or "default",
            "wall_us_per_step": walls, "k4_wrappers_us_per_step": k4,
            "step_body_us_per_step": body}


def step_kernels(config_kw):
    # Device ms per step by kernel name over one profiled epoch of
    # PROFILED_STEPS full-width steps (after a warm-up epoch): K6's and
    # K5b's launches as the step makes them, whatever the tree's design.
    from torch.profiler import ProfilerActivity, profile

    from gene2vec_tpu_torch.config import SGNSConfig
    from gene2vec_tpu_torch.data.pipeline import PairCorpus
    from gene2vec_tpu_torch.io.vocab import Vocab
    from gene2vec_tpu_torch.sgns.cbow_hs import make_trainer
    from gene2vec_tpu_torch.sgns.train import epoch_generator

    rng = np.random.RandomState(0)
    n = cs.PROFILED_STEPS * cs.B
    pairs = np.stack([cs.zipf_ids(rng, n, cs.V), cs.zipf_ids(rng, n, cs.V)], 1)
    counts = np.bincount(pairs.reshape(-1), minlength=cs.V) + 1
    tr = make_trainer(PairCorpus(Vocab([f"G{i}" for i in range(cs.V)], counts), pairs),
                      SGNSConfig(**config_kw), device=cs.DEVICE)
    params = tr.init()
    params, loss = tr.train_epoch(params, generator=epoch_generator(1, 0))
    float(loss)
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        params, loss = tr.train_epoch(params, generator=epoch_generator(1, 1))
        float(loss)
    out = {}
    for ev in prof.key_averages():
        if ev.device_type == torch.autograd.DeviceType.CUDA and ev.self_device_time_total > 0:
            name = ev.key.replace("(anonymous namespace)::", "").replace("void ", "", 1)
            name = name.split("(")[0].split("<")[0].split("::")[-1] or ev.key[:60]
            out[name] = out.get(name, 0.0) + ev.self_device_time_total / 1e3 / tr.num_batches
    top = sorted(out.items(), key=lambda kv: -kv[1])[:8]
    return {"config": "_".join(str(v) for v in config_kw.values()), "ms_per_step": dict(top)}


rows = cs.kernel_check(torch, cs.TIMED_REPS) + cs.kernel_check(torch, cs.TIMED_REPS, torch.bfloat16)
rows += cs.objective_kernel_check(torch, cs.TIMED_REPS)
rows += cs.objective_kernel_check(torch, cs.TIMED_REPS, torch.bfloat16)
keep = ("name", "ms", "library_ms", "plain_ms", "bound_ms", "max_abs_err")
k1 = [{k: r[k] for k in keep} for r in rows if r["name"].startswith("pos_logit")]
noise = [{k: r[k] for k in keep} for r in rows if r["name"].startswith(("noise_head", "noise_tail"))]
k4 = [{k: r[k] for k in keep} for r in rows if r["name"].startswith(("row_update", "row_scatter",
                                                                     "row_finalize"))]
objectives = [{k: r[k] for k in keep} for r in rows
              if r["name"].startswith(("per_example", "shared_pool", "hs"))]
gather = [{k: r[k] for k in ("probe", "dtype", "E", "ms", "library_ms", "bound_ms")}
          for r in cs.gather_probes(torch, cs.TIMED_REPS) + cs.ggipnn_gather_row(torch, cs.TIMED_REPS)[1]]
host = [host_times(kw) for kw in ({}, {"table_dtype": "bfloat16"},
                                  {"negative_mode": "per_example"})]
windows = [cs.profile_steps(torch, cs.PROFILED_STEPS, "chip_smoke_profile", smi, **kw)
           for kw in ({}, {"table_dtype": "bfloat16"})]
# the HS, shared and per_example steps: windows (pairs/s, busy ms/step,
# idle) and the step's kernels by name
objective_kw = ({"objective": "sg_hs"}, {"objective": "cbow_hs"}, {"negative_mode": "shared"},
                {"negative_mode": "per_example"},
                {"objective": "sg_hs", "table_dtype": "bfloat16"},
                {"negative_mode": "shared", "table_dtype": "bfloat16"},
                {"negative_mode": "per_example", "table_dtype": "bfloat16"})
objective_windows = [cs.profile_steps(torch, cs.PROFILED_STEPS, "chip_smoke_profile", smi, **kw)
                     for kw in objective_kw]
kernels_by_step = [step_kernels(kw) for kw in objective_kw]
probe_keep = ("name", "probe", "mb", "dtype", "scale", "shape", "tile_rows", "ms", "plain_ms",
              "library_ms", "bound_ms", "gb_per_s")
probes = cs.stream_probes(torch, cs.TIMED_REPS)[1]
probes += cs.lane_probes(torch, cs.TIMED_REPS)[1]
probes += cs.staged_probes(torch, cs.TIMED_REPS)[1]
probes = [{k: r[k] for k in probe_keep if k in r} for r in probes]
serve_rows, serve_recs = cs.serving_kernel_check(torch, cs.TIMED_REPS)
serving = [dict({k: r[k] for k in keep}, **({"device_ms": r["device_ms"]} if "device_ms" in r
                                            else {})) for r in serve_rows]
serving_shapes = [{k: r.get(k) for k in ("name", "batch", "kb", "ms", "plain_ms", "library_ms",
                                         "bound_ms", "route", "launches_by_kernel")}
                  for r in serve_recs]
with tempfile.TemporaryDirectory(prefix="chip_smoke_", dir=os.getcwd()) as work:
    cs.train_full_width(torch, work, smi)
    with open(os.path.join(work, "export", "training_log.csv")) as f:
        rates = [float(r["pairs_per_sec"]) for r in csv.DictReader(f)]
# the pipeline's kernels (K10c, K10, K11) and cli.tsne, then UMAP's
pipeline = comparing.pipeline_kernel_times(torch)
umap = comparing.umap_kernel_times(torch)
print("COMPARE " + json.dumps({"tree": os.getcwd(), "card": smi, "k1": k1, "noise": noise,
                               "k4": k4,
                               "objectives": objectives, "gather": gather, "host": host,
                               "windows": windows, "objective_windows": objective_windows,
                               "step_kernels": kernels_by_step, "probes": probes,
                               "serving": serving, "serving_shapes": serving_shapes,
                               "cli_pairs_per_s": rates, "pipeline": pipeline,
                               "umap": umap}))
"""


def compare_trees(trees, parts: str = "all") -> int:
    """``python3 chip_smoke.py --compare [--parts umap] DIR [DIR ...]``:
    COMPARE_RUN in each checkout in the order given (parent, change,
    change, parent), each in its own process and with its own kernels, one
    ``{"compare": ...}`` line a run on stdout."""
    for tree in trees:
        out = subprocess.run([sys.executable, "-c", COMPARE_RUN, os.path.abspath(__file__), parts],
                             cwd=os.path.abspath(tree),
                             capture_output=True, text=True, timeout=1800)
        sys.stderr.write(out.stderr)
        lines = [x for x in out.stdout.splitlines() if x.startswith("COMPARE ")]
        if out.returncode != 0 or not lines:
            log(f"compare: {tree} exited {out.returncode}")
            return 1
        print(json.dumps({"compare": json.loads(lines[-1][len("COMPARE "):])}), flush=True)
    return 0


# -- phase 8: resilience -----------------------------------------------------------

RES_PAIRS, RES_ITERS = 1_000_000, 4   # the drills' Zipf corpus (V = 24,447) and iterations
RES_KILL_AT, RES_TERM_AT = 2, 1       # SIGKILL / SIGTERM at "iteration N done"
RES_CBOW_ITERS = 2
RESUME_BAR = 1e-4          # a resumed card run: max |Δemb| over the uninterrupted run's max |emb|
RESUME_LOSS_RTOL = 1e-5    # ... and each iteration's loss, relative
FAULT_SPEC = '{"seed": 7, "error_p": 0.5}'
FAULT_REQUESTS = 64
RES_KERNELS = STEP_KERNELS + ("hs", "row_gather", "topk_exact")


def res_env() -> dict:
    """The children's environment additions: the checkout on the path."""
    return {"PYTHONPATH": os.pathsep.join(
        [ROOT] + [p for p in os.environ.get("PYTHONPATH", "").split(os.pathsep) if p])}


def res_cli(argv, label: str, expect_rc: int, kill=None):
    """One CLI child through ``resilience/chaos.py`` — to its end, or
    ``kill = (pattern, signal)`` at the pattern's first line — which must
    exit ``expect_rc``.  Returns (its ChildResult, wall seconds)."""
    from gene2vec_tpu_torch.resilience import chaos

    t0 = time.perf_counter()
    if kill is None:
        r = chaos.run_cli(argv, timeout=600, env=res_env())
    else:
        r = chaos.run_cli_kill_on(argv, kill[0], sig=kill[1], timeout=600, env=res_env())
    wall = time.perf_counter() - t0
    if r.returncode != expect_rc:
        raise SystemExit(f"resilience {label}: exit {r.returncode}, expected {expect_rc}:\n"
                         f"{r.output[-3000:]}")
    log(f"resilience {label}: exit {r.returncode} in {wall:.1f}s"
        + (f" (signal at {r.matched_line!r})" if kill else ""))
    return r, wall


def child_launches(run_dir: str) -> dict:
    """{kernel: launches} that a child process left in its run's
    ``metrics.prom`` (``kernel_launches_total``)."""
    with open(os.path.join(run_dir, "metrics.prom")) as f:
        series = parse_prometheus(f.read())
    prefix = 'kernel_launches_total{kernel="'
    return {s[len(prefix):].split('"')[0]: int(v) for s, v in series.items()
            if s.startswith(prefix)}


def add_launches(total: dict, more: dict) -> None:
    for name, n in more.items():
        total[name] = total.get(name, 0) + n


def res_losses(export: str, iters: int):
    out = []
    for it in range(1, iters + 1):
        with np.load(os.path.join(export, f"gene2vec_dim_{D}_iter_{it}.npz")) as z:
            out.append(float(json.loads(str(z["meta"]))["loss"]))
    return out


def res_reasons(export: str, iters: int):
    """Each iteration's manifest verdict (``ok`` or the failure's reason)."""
    from gene2vec_tpu_torch.resilience import snapshot as snap

    snap.clear_verify_cache()
    return [snap.verify_manifest(os.path.join(export, f"gene2vec_dim_{D}_iter_{it}")).reason
            for it in range(1, iters + 1)]


def res_verified(export: str, iters: int):
    return [r == "ok" for r in res_reasons(export, iters)]


def res_gap(ref: str, export: str, iters: int, label: str, gate: bool = True) -> dict:
    """The last iteration's table of ``export`` against ``ref``'s: max
    |Δemb| over max |emb|, and each iteration's loss relative; with
    ``gate``, fails past RESUME_BAR / RESUME_LOSS_RTOL."""
    from gene2vec_tpu_torch.resilience import chaos

    a, b = chaos.load_table(ref, D, iters), chaos.load_table(export, D, iters)
    la, lb = res_losses(ref, iters), res_losses(export, iters)
    gap = {"max_abs_diff": float(np.abs(a - b).max()), "max_abs": float(np.abs(a).max()),
           "loss_rel": max(abs(x - y) / abs(x) for x, y in zip(la, lb)),
           "bitwise": bool(np.array_equal(a, b))}
    gap["rel"] = gap["max_abs_diff"] / gap["max_abs"]
    if gate and (not np.isfinite(b).all() or gap["rel"] > RESUME_BAR
                 or gap["loss_rel"] > RESUME_LOSS_RTOL):
        raise SystemExit(f"resilience {label}: resumed run off the uninterrupted one {gap}")
    return gap


def file_digest(path: str) -> str:
    import hashlib

    with open(path, "rb") as f:
        return hashlib.sha256(f.read()).hexdigest()


def res_argv(data: str, out: str, iters: int = RES_ITERS, **kw):
    from gene2vec_tpu_torch.resilience import chaos

    return chaos.gene2vec_argv(data, out, dim=D, iters=iters, no_txt_output=True,
                               device=DEVICE, **kw)


def res_sigkill(data: str, out: str, ref: str) -> tuple:
    """(b) SIGKILL at "iteration 2 done" with the background writer, then
    the rerun: (record, launches)."""
    import signal

    from gene2vec_tpu_torch.io import checkpoint as ckpt

    argv = res_argv(data, out, async_checkpoint=True)
    res_cli(argv, "SIGKILL", -signal.SIGKILL,
            kill=(rf"iteration {RES_KILL_AT} done", signal.SIGKILL))
    survivor = ckpt.latest_iteration(out, D)
    temps = sorted(n for n in os.listdir(out) if ".tmp" in n)
    if survivor > RES_KILL_AT:
        raise SystemExit(f"resilience SIGKILL: newest verified iteration {survivor} "
                         f"> {RES_KILL_AT}")
    point = os.path.join(out, f"gene2vec_dim_{D}_iter_{survivor}.npz")
    before = file_digest(point) if survivor else None
    r, _ = res_cli(argv, "SIGKILL rerun", 0)
    if survivor and f"resuming from iteration {survivor}" not in r.output:
        raise SystemExit(f"resilience SIGKILL rerun did not resume from {survivor}")
    kept = (file_digest(point) if survivor else None) == before
    reasons = res_reasons(out, RES_ITERS)
    # a kill between the first npz's rename and its manifest leaves an
    # unmanifested iteration 1, which discovery takes as a legacy export
    # (the reference's rule): the rerun resumes from its complete bytes
    legacy = survivor == 1 and reasons[0] == "missing-manifest"
    bad = [it for it, r in enumerate(reasons, 1) if r != "ok" and not (legacy and it == 1)]
    if not kept or bad:
        raise SystemExit(f"resilience SIGKILL rerun: resume point kept {kept}, "
                         f"manifests {reasons}")
    return {"at": RES_KILL_AT, "survivor": survivor, "survivor_unmanifested": legacy,
            "temp_files_left": temps, "resume_point_bytes_kept": kept, "manifests": reasons,
            "gap": res_gap(ref, out, RES_ITERS, "SIGKILL rerun")}, child_launches(out)


def res_sigterm(data: str, out: str, ref: str) -> tuple:
    """(c) SIGTERM at "iteration 1 done" with the background writer: exit
    113, the manifest stamped, the drained iterations verifying; then the
    resume: (record, launches)."""
    import re
    import signal

    from gene2vec_tpu_torch.io import checkpoint as ckpt
    from gene2vec_tpu_torch.resilience.preempt import EXIT_PREEMPTED

    argv = res_argv(data, out, async_checkpoint=True)
    r, _ = res_cli(argv, "SIGTERM", EXIT_PREEMPTED,
                   kill=(rf"iteration {RES_TERM_AT} done", signal.SIGTERM))
    with open(os.path.join(out, "manifest.json")) as f:
        manifest = json.load(f)
    drained = int(re.search(r"drained after iteration (\d+)", r.output).group(1))
    preempted_s = manifest["goodput"]["buckets_s"]["preempted"]
    verified = res_verified(out, drained)
    if (manifest.get("interrupted") is not True or manifest.get("completed_iteration") != drained
            or preempted_s <= 0 or not all(verified) or ckpt.latest_iteration(out, D) != drained):
        raise SystemExit(f"resilience SIGTERM: drained {drained}, manifest "
                         f"{ {k: manifest.get(k) for k in ('interrupted', 'completed_iteration')} }, "
                         f"preempted {preempted_s}, verified {verified}")
    launches = child_launches(out)
    res_cli(argv, "SIGTERM resume", 0)
    add_launches(launches, child_launches(out))
    return {"at": RES_TERM_AT, "exit": EXIT_PREEMPTED, "drained_after": drained,
            "preempted_s": preempted_s, "verified": res_verified(out, RES_ITERS),
            "gap": res_gap(ref, out, RES_ITERS, "SIGTERM resume")}, launches


def res_cbow(data: str, out: str) -> tuple:
    """(d) a CBOW-HS drain after iteration 1 and its resume (K6's main path
    here): (record, launches)."""
    import re
    import signal

    from gene2vec_tpu_torch.io import checkpoint as ckpt
    from gene2vec_tpu_torch.resilience.preempt import EXIT_PREEMPTED

    argv = res_argv(data, out, iters=RES_CBOW_ITERS, objective="cbow_hs")
    r, _ = res_cli(argv, "CBOW-HS SIGTERM", EXIT_PREEMPTED,
                   kill=(r"iteration 1 done", signal.SIGTERM))
    launches = child_launches(out)
    drained = int(re.search(r"drained after iteration (\d+)", r.output).group(1))
    res_cli(argv, "CBOW-HS resume", 0)
    add_launches(launches, child_launches(out))
    if ckpt.latest_iteration(out, D) != RES_CBOW_ITERS or not launches.get("hs"):
        raise SystemExit(f"resilience CBOW-HS: latest {ckpt.latest_iteration(out, D)}, "
                         f"launches {launches}")
    return {"exit": EXIT_PREEMPTED, "drained_after": drained, "hs_launches": launches["hs"],
            "losses": res_losses(out, RES_CBOW_ITERS)}, launches


def res_training(data: str, work: str) -> tuple:
    """(a) two uninterrupted runs side by side; then (b) SIGKILL, (c)
    SIGTERM and (d) CBOW-HS, each with its rerun, side by side — every
    child on the card; (f) corruption on the host.  Returns (record,
    launches)."""
    from concurrent.futures import ThreadPoolExecutor

    from gene2vec_tpu_torch.io import checkpoint as ckpt
    from gene2vec_tpu_torch.resilience import chaos
    from gene2vec_tpu_torch.resilience import snapshot as snap

    rec, launches = {}, {}
    refs = [os.path.join(work, f"uninterrupted_{i}") for i in (1, 2)]
    with ThreadPoolExecutor(2) as pool:
        walls = [f.result()[1] for f in [
            pool.submit(res_cli, res_argv(data, out), f"uninterrupted run {i + 1}", 0)
            for i, out in enumerate(refs)]]
    for i, out in enumerate(refs):
        add_launches(launches, child_launches(out))
        if not all(res_verified(out, RES_ITERS)):
            raise SystemExit(f"resilience: uninterrupted run {i + 1} export does not verify")
    with open(os.path.join(refs[0], "vocab.tsv")) as f:
        rec["vocab_size"] = sum(1 for _ in f)
    rec["uninterrupted"] = {"walls_s": walls, "losses": res_losses(refs[0], RES_ITERS),
                            "pair": res_gap(refs[0], refs[1], RES_ITERS, "pair", gate=False)}
    with ThreadPoolExecutor(3) as pool:
        futures = {
            "sigkill": pool.submit(res_sigkill, data, os.path.join(work, "sigkill"), refs[0]),
            "sigterm": pool.submit(res_sigterm, data, os.path.join(work, "sigterm"), refs[0]),
            "cbow_hs": pool.submit(res_cbow, data, os.path.join(work, "cbow_hs")),
        }
        for name, f in futures.items():
            rec[name], more = f.result()
            add_launches(launches, more)

    # (f) corruption on the host, over the second uninterrupted export
    out = refs[1]
    chaos.truncate_file(os.path.join(out, f"gene2vec_dim_{D}_iter_{RES_ITERS}.npz"))
    snap.clear_verify_cache()
    after_truncate = ckpt.latest_iteration(out, D)
    chaos.corrupt_manifest_crc(os.path.join(out, f"gene2vec_dim_{D}_iter_{RES_ITERS - 1}"))
    snap.clear_verify_cache()
    after_crc = ckpt.latest_iteration(out, D)
    if (after_truncate, after_crc) != (RES_ITERS - 1, RES_ITERS - 2):
        raise SystemExit(f"resilience corruption: fell back to {after_truncate}, {after_crc}")
    rec["corruption"] = {"truncated_newest_falls_back_to": after_truncate,
                         "corrupt_crc_falls_back_to": after_crc}
    return rec, launches


def res_ggipnn(work: str) -> tuple:
    """(e) SIGTERM ``cli.ggipnn --embed-train --run-dir`` over phase 6's
    clustered data at its first ``step N:`` line."""
    import re
    import signal

    from gene2vec_tpu_torch.resilience.preempt import EXIT_PREEMPTED

    emb, groups = clustered_table()
    data = os.path.join(work, "predictionData")
    write_prediction_data(data, groups)
    w2v = os.path.join(work, "clustered_w2v.txt")
    write_w2v(w2v, emb)
    run_dir = os.path.join(work, "ggipnn_run")
    argv = [sys.executable, "-m", "gene2vec_tpu_torch.cli.ggipnn", "--data-dir", data,
            "--emb", w2v, "--embedding-dim", str(D), "--device", DEVICE, "--batch-size",
            str(GG_B), "--num-epochs", "1", "--embed-train", "--run-dir", run_dir]
    r, wall = res_cli(argv, "GGIPNN SIGTERM", EXIT_PREEMPTED,
                      kill=(r"^step \d+:", signal.SIGTERM))
    step = int(re.search(r"drained after step (\d+)", r.output).group(1))
    with open(os.path.join(run_dir, "manifest.json")) as f:
        manifest = json.load(f)
    ckpts = sorted(os.listdir(os.path.join(run_dir, "checkpoints")))
    if (manifest.get("interrupted") is not True or f"model-{step}.npz" not in ckpts
            or "AUC" in r.output or "no resume path" not in r.output):
        raise SystemExit(f"resilience GGIPNN: drained at {step}, checkpoints {ckpts}, "
                         f"interrupted {manifest.get('interrupted')}:\n{r.output[-2000:]}")
    launches = child_launches(run_dir)
    return {"exit": EXIT_PREEMPTED, "signal_at": r.matched_line, "drained_after_step": step,
            "checkpoints": ckpts, "row_gather_launches": launches.get("row_gather", 0),
            "wall_s": wall}, launches


def thread_checkpoint(writer, saver, export_dir, cfg, it, params, vocab, meta):
    """The reference's disk half for comparison: ``save_iteration`` on the
    writer thread itself, over a host copy staged here (``saver`` unused)."""
    from gene2vec_tpu_torch.io import checkpoint as ckpt
    from gene2vec_tpu_torch.resilience import snapshot as snap
    from gene2vec_tpu_torch.sgns.model import SGNSParams

    if writer is None:
        ckpt.save_iteration(export_dir, cfg.dim, it, params, vocab,
                            txt_output=cfg.txt_output, meta=meta)
        return
    host = SGNSParams(params.emb.detach().to("cpu", copy=True),
                      params.ctx.detach().to("cpu", copy=True))

    def write():
        path = ckpt.save_iteration(export_dir, cfg.dim, it, host, vocab,
                                   txt_output=cfg.txt_output, meta=meta)
        return snap.manifest_bytes(snap.verify_manifest(path[: -len(".npz")]).manifest)

    writer.submit(write, iteration=it)


def res_overhead(torch, corpus, cfg_kw: dict, work: str, label: str) -> dict:
    """(g) ``SGNSTrainer.run`` in process, sync, async and async with the
    disk half on the writer thread (``thread_checkpoint``, the reference's
    design, for comparison only): the checkpoint spans over the iteration
    spans, and pairs/s (the median iteration's, and the run's pairs over
    both spans)."""
    from gene2vec_tpu_torch.config import SGNSConfig
    from gene2vec_tpu_torch.obs.trace import read_events
    from gene2vec_tpu_torch.sgns import train

    out = {}
    for mode in ("sync", "async", "async_thread"):
        cfg = SGNSConfig(**cfg_kw, async_checkpoint=mode != "sync")
        d = os.path.join(work, f"overhead_{label}_{mode}")
        tr = train.SGNSTrainer(corpus, cfg, device=DEVICE)
        inline = train.checkpoint_iteration
        if mode == "async_thread":
            train.checkpoint_iteration = thread_checkpoint
        try:
            tr.run(d, log=lambda s: None)
        finally:
            train.checkpoint_iteration = inline
        torch.cuda.synchronize()
        durs = {"iteration": [], "checkpoint": [], "ckpt_write": []}
        for e in read_events(os.path.join(d, "events.jsonl")):
            if e.get("type") == "span_end" and e.get("name") in durs:
                durs[e["name"]].append(float(e.get("dur", 0.0)))
        spans = {k: sum(v) for k, v in durs.items()}
        with open(os.path.join(d, "training_log.csv")) as f:
            rates = [float(r["pairs_per_sec"]) for r in csv.DictReader(f)]
        pairs = tr.num_batches * cfg.batch_pairs * cfg.num_iters
        out[mode] = {"overhead_fraction": spans["checkpoint"] / max(spans["iteration"], 1e-9),
                     "iteration_s": spans["iteration"], "checkpoint_s": spans["checkpoint"],
                     "pairs_per_sec_median": statistics.median(rates[1:]),
                     "pairs_per_sec_with_checkpoints":
                         pairs / (spans["iteration"] + spans["checkpoint"]),
                     **{f"{k}_ms": [round(x * 1e3, 3) for x in v] for k, v in durs.items()}}
    log(f"async overhead {label}: {json.dumps(out)}")
    return out


def overhead_records(data: str, work: str) -> dict:
    """(g) in this process: ``res_overhead`` at the budget's geometry
    (``obs/budgets.json`` ``resilience.async_ckpt``), then at full width
    over the drills' corpus.  Returns {"records": ..., "launches": the
    kernels' launches}."""
    import torch

    from gene2vec_tpu_torch import kernels
    from gene2vec_tpu_torch.data.pipeline import PairCorpus
    from gene2vec_tpu_torch.io.pair_reader import load_corpus
    from gene2vec_tpu_torch.io.vocab import Vocab

    with open(os.path.join(ROOT, "gene2vec_tpu_torch", "obs", "budgets.json")) as f:
        budget = json.load(f)["resilience"]["async_ckpt"]
    v = int(budget["vocab"])
    rng = np.random.RandomState(0)
    p = 1.0 / np.arange(1, v + 1)
    p /= p.sum()
    pairs = rng.choice(v, size=(int(budget["num_pairs"]), 2), p=p).astype(np.int32)
    counts = np.bincount(pairs.reshape(-1), minlength=v).astype(np.int64)
    small = PairCorpus(Vocab([f"G{i}" for i in range(v)], counts), pairs)
    kernels.reset_launch_counts()
    rec = {"budget": {k: budget[k] for k in ("dim", "vocab", "batch_pairs", "num_pairs",
                                             "num_iters", "max_overhead_fraction")}}
    rec["budget_geometry"] = res_overhead(torch, small, dict(
        dim=int(budget["dim"]), batch_pairs=int(budget["batch_pairs"]),
        num_iters=int(budget["num_iters"]), txt_output=bool(budget["txt_output"])),
        work, "budget")
    vocab, pairs = load_corpus(data, "txt")
    rec["full_width"] = res_overhead(torch, PairCorpus(vocab, pairs), dict(
        dim=D, num_iters=RES_ITERS, txt_output=False), work, "full width")
    torch.cuda.synchronize()
    return {"records": rec, "launches": kernels.launch_counts()}


def res_overhead_phase(data: str, work: str) -> tuple:
    """(g) ``overhead_records`` in a fresh child process, as a training run
    has one — not in this script's, which by phase 8 holds seven phases'
    state — gated at the budget's geometry.  Returns (records, K1-K4
    launches)."""
    code = ("import json\nimport chip_smoke\n"
            f"print(json.dumps(chip_smoke.overhead_records({data!r}, {work!r})))\n")
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT, stdout=subprocess.PIPE,
                         text=True, timeout=900, env=dict(os.environ, **res_env()))
    if res.returncode != 0:
        raise SystemExit(f"resilience: the overhead child exited {res.returncode}")
    out = json.loads(res.stdout.strip().splitlines()[-1])
    rec = out["records"]
    frac = rec["budget_geometry"]["async"]["overhead_fraction"]
    if not frac < float(rec["budget"]["max_overhead_fraction"]):
        raise SystemExit(f"resilience: async checkpoint overhead {frac:.5f} at the budget's "
                         f"geometry, budget {rec['budget']['max_overhead_fraction']}")
    return rec, out["launches"]


def res_faults(work: str, smi: str) -> tuple:
    """(h) one exact-mode server over phase 5's clustered export with
    ``--faults FAULT_SPEC`` beside an unfaulted one: FAULT_REQUESTS
    sequential ``GET /v1/similar`` statuses against a CPU injector's
    prediction, ``serve_fault_error_total``, a clean ``/healthz`` and every
    clean answer equal to the unfaulted server's."""
    import urllib.error
    import urllib.request
    from concurrent.futures import ThreadPoolExecutor

    from gene2vec_tpu_torch.resilience.faults import FaultInjector, FaultSpec

    export = os.path.join(work, "clustered")
    write_clustered_export(export)
    with ThreadPoolExecutor(2) as pool:
        futures = [pool.submit(start_server, export, "exact",
                               os.path.join(work, f"serve_{name}.err"), extra)
                   for name, extra in (("faulted", ("--faults", FAULT_SPEC)), ("clean", ()))]
        started = [f.result() for f in futures]
    (faulted, finfo), (clean, cinfo) = started

    def get(url, path):
        try:
            with urllib.request.urlopen(url + path, timeout=60) as r:
                return r.status, json.loads(r.read())
        except urllib.error.HTTPError as e:
            return e.code, json.loads(e.read())

    try:
        oracle = FaultInjector(FaultSpec.from_json(FAULT_SPEC))
        want = [503 if oracle.decide("/v1/similar") else 200 for _ in range(FAULT_REQUESTS)]
        got, mismatched = [], 0
        t0 = time.perf_counter()
        for i in range(FAULT_REQUESTS):
            path = f"/v1/similar?gene=G{(i * 379) % V}&k=10"
            status, doc = get(finfo["url"], path)
            got.append(status)
            if status == 200 and doc["results"] != get(cinfo["url"], path)[1]["results"]:
                mismatched += 1
        wall = time.perf_counter() - t0
        with urllib.request.urlopen(finfo["url"] + "/metrics", timeout=60) as r:
            series = parse_prometheus(r.read().decode())
        health = get(finfo["url"], "/healthz")
        launches = scrape_launches(finfo["url"])
    finally:
        stop_server(faulted)
        stop_server(clean)
    with open(os.path.join(work, "serve_faulted.err")) as f:
        active = "FAULT INJECTION ACTIVE" in f.read()
    errors = int(series.get("serve_fault_error_total", 0))
    rec = {"spec": json.loads(FAULT_SPEC), "requests": FAULT_REQUESTS,
           "statuses_match": got == want, "faulted": got.count(503),
           "serve_fault_error_total": errors, "clean_answers_mismatched": mismatched,
           "healthz": health[0], "stderr_announces": active,
           "topk_exact_launches": launches.get("topk_exact", 0), "wall_s": wall}
    if (got != want or errors != want.count(503) or mismatched or health[0] != 200
            or health[1].get("status") != "ok" or not active):
        raise SystemExit(f"resilience faults: {rec}, statuses {got}, predicted {want}")
    return rec, {"topk_exact": launches.get("topk_exact", 0)}


def resilience(torch, smi: str) -> tuple:
    """Phase 8: the port's CLIs killed, drained and resumed on the card, the
    async writer's overhead, corruption on the host and HTTP faults.
    Returns (the ``{"resilience": ...}`` record, the phase's launches)."""
    t0 = time.perf_counter()
    launches = {}
    with tempfile.TemporaryDirectory(prefix="chip_smoke_", dir=os.getcwd()) as work:
        data = os.path.join(work, "corpus")
        write_zipf_corpus(data, V, RES_PAIRS)
        # (g) first, while the file system holds no other writes of this run
        overhead, more = res_overhead_phase(data, work)
        add_launches(launches, more)
        rec, more = res_training(data, work)
        rec["async_overhead"] = overhead
        add_launches(launches, more)
        rec["ggipnn"], more = res_ggipnn(work)
        add_launches(launches, more)
        rec["faults"], more = res_faults(work, smi)
        add_launches(launches, more)
    missing = [k for k in RES_KERNELS if not launches.get(k)]
    if missing:
        raise SystemExit(f"resilience: kernels not launched on the phase's path: {missing}")
    rec["launches"] = {k: launches[k] for k in RES_KERNELS}
    rec["bars"] = {"resume_rel": RESUME_BAR, "loss_rtol": RESUME_LOSS_RTOL}
    rec["seconds"] = time.perf_counter() - t0
    rec["card"] = smi
    log(f"resilience phase done in {rec['seconds']:.1f}s")
    return rec, launches


# -- phase 9: the serving fleet ------------------------------------------------------

FLEET_REPLICAS = 3
FLEET_WORKERS = 4
FLEET_LOAD_S = 8.0           # the fleet drill's closed-loop load
FLEET_SEED = 9
FLEET_GENES = 64             # the drills' query genes (the oracle's keyspace)
FLEET_K = 10
FLEET_SUM_REQUESTS = 40      # sent between the two readings of the sums check
ALERTS_WARMUP_S = 6.0
#: ``fleet.chaos`` and ``alerts.detection`` of gene2vec_tpu/analysis/budgets.json, copied
FLEET_CHAOS = {"replicas": 3, "min_availability": 0.99, "max_retry_amplification": 1.5,
               "max_mixed_iteration_answers": 0, "max_wrong_answers": 0}
ALERTS_DETECTION = {"replicas": 3, "scrape_interval_s": 0.25, "proxy_attempts": 3,
                    "max_detection_latency_s": 20.0, "max_false_positives": 0}
ALERT_RULE = "availability-burn"
TRACE_HOPS = {"proxy_request", "client_attempt", "serve_request", "batch_item", "engine_topk"}


def start_fleet(export: str, err_path: str, extra=()):
    """``cli/fleet.py`` with FLEET_REPLICAS replicas of ``cli/serve.py``, all
    on the card (``extra``: more flags); returns (process, its stdout
    contract line)."""
    from gene2vec_tpu_torch.serve.fleet import read_contract_line

    argv = [sys.executable, "-m", "gene2vec_tpu_torch.cli.fleet", "--export-dir", export,
            "--replicas", str(FLEET_REPLICAS), "--port", "0", "--health-interval", "0.25",
            "--backoff-base", "0.3", "--proxy-timeout-ms", "4000", "--seed", str(FLEET_SEED),
            "--serve-arg=--cache-size", "--serve-arg=0", "--serve-arg=--poll-interval",
            "--serve-arg=3600", *extra]
    err = open(err_path, "w")
    proc = subprocess.Popen(argv, stdout=subprocess.PIPE, stderr=err, text=True, cwd=ROOT,
                            env=dict(os.environ, **res_env()))
    err.close()
    try:
        return proc, read_contract_line(proc, 300.0)
    except Exception as e:
        stop_server(proc)
        with open(err_path) as f:
            raise SystemExit(f"fleet did not start ({e!r}):\n{f.read()[-4000:]}")


def http_json(url: str, body=None, timeout: float = 15.0):
    """(status, document) of one GET, or POST of ``body``."""
    import urllib.error
    import urllib.request

    data = json.dumps(body).encode() if body is not None else None
    req = urllib.request.Request(url, data=data, headers={"Content-Type": "application/json"})
    try:
        with urllib.request.urlopen(req, timeout=timeout) as r:
            raw = r.read()
            status = r.status
    except urllib.error.HTTPError as e:
        raw, status = e.read(), e.code
    return status, raw


def fleet_oracle(emb) -> dict:
    """{gene: (its exact cosines, self excluded; the top FLEET_K rows)} for
    FLEET_GENES seeded genes of the clustered table, on the host."""
    from gene2vec_tpu_torch.serve.registry import l2_normalize

    unit = l2_normalize(emb)
    out = {}
    for row in np.random.RandomState(FLEET_SEED).choice(len(unit), FLEET_GENES, replace=False):
        s = unit @ unit[row]
        s[row] = -np.inf
        out[f"G{row}"] = (s, np.argsort(-s, kind="stable")[:FLEET_K])
    return out


def fleet_verdict(oracle, gene, doc) -> tuple:
    """("ok" | "wrong" | "mixed", near-ties) of one answer: the iteration
    served must be the export's one; ids those of the exact oracle except
    near-ties (cosines within SCORE_TOL), every score within SCORE_TOL."""
    if doc["model"]["iteration"] != 1:
        return "mixed", 0
    s, top = oracle[gene]
    nbrs = doc["results"][0]["neighbors"]
    if len(nbrs) != FLEET_K:
        return "wrong", 0
    ties = 0
    for p, n in enumerate(nbrs):
        row = int(n["gene"][1:])
        if abs(n["score"] - s[row]) > SCORE_TOL:
            return "wrong", ties
        if row != top[p]:
            if abs(s[row] - s[top[p]]) > SCORE_TOL:
                return "wrong", ties
            ties += 1
    return "ok", ties


def fleet_load(client, oracle, seconds, route="/v1/similar", kill=None, pace=0.0,
               halt=None) -> dict:
    """FLEET_WORKERS closed-loop workers through ``client`` for ``seconds``
    or until ``halt`` (an Event) is set (``kill``: a pid SIGKILLed a third
    of the way in).  Returns the counts, the trace log [(monotonic, trace
    id, ok)] and the kill's time."""
    import signal
    import threading

    genes = sorted(oracle)
    counts = {"ok": 0, "failed": 0, "wrong": 0, "mixed": 0, "attempts": 0, "retries": 0,
              "ties": 0}
    log_, lock = [], threading.Lock()
    stop_at = time.monotonic() + seconds

    def worker(w):
        rng = np.random.RandomState(FLEET_SEED + w)
        while time.monotonic() < stop_at and not (halt and halt.is_set()):
            g = genes[rng.randint(len(genes))]
            body = {"genes": [g], "k": FLEET_K} if route == "/v1/similar" else {"genes": [g]}
            r = client.request(route, body, timeout_s=6.0)
            verdict, ties = ("failed", 0) if not r.ok else (
                fleet_verdict(oracle, g, r.doc) if route == "/v1/similar" else ("ok", 0))
            with lock:
                counts["attempts"] += r.attempts
                counts["retries"] += r.retries
                counts[verdict] += 1
                counts["ties"] += ties
                log_.append((time.monotonic(), r.trace_id, r.ok))
            if pace:
                time.sleep(pace)

    threads = [threading.Thread(target=worker, args=(w,)) for w in range(FLEET_WORKERS)]
    for t in threads:
        t.start()
    t_kill = None
    if kill is not None:
        time.sleep(seconds / 3.0)
        os.kill(kill, signal.SIGKILL)
        t_kill = time.monotonic()
        log(f"fleet: SIGKILL replica 0 (pid {kill}) mid-load")
    for t in threads:
        t.join()
    return {"counts": counts, "log": log_, "t_kill": t_kill}


def trace_facts(doc) -> tuple:
    """(hop names, client_attempt count, pids) of a reassembled trace."""
    names, pids, attempts = set(), set(doc.get("processes") or []), [0]

    def walk(node):
        names.add(node.get("name"))
        attempts[0] += node.get("name") == "client_attempt"
        if node.get("pid"):
            pids.add(node["pid"])
        for sub in node.get("process_spans", []) + node.get("children", []):
            walk(sub)

    for root in doc.get("roots", []):
        walk(root)
    pids |= {r["pid"] for r in doc.get("flight", []) if r.get("pid")}
    return names, attempts[0], pids


def fleet_trace(export: str, run_dir: str, trace_log, t_kill) -> dict:
    """One answered request's trace reassembled across the fleet's processes
    down to the engine, with at least two client attempts (a retry or a
    failover): the candidates are the traces whose ``client_attempt``
    records in the front door's ``events.jsonl`` number two or more, the
    requests after the SIGKILL first; ``cli.obs trace`` renders it."""
    from gene2vec_tpu_torch.obs import flight
    from gene2vec_tpu_torch.obs.trace import read_events

    time.sleep(1.0)  # the last appends land
    attempts = {}
    for e in read_events(os.path.join(run_dir, "events.jsonl")):
        if e.get("name") == "client_attempt" and e.get("trace"):
            attempts[e["trace"]] = attempts.get(e["trace"], 0) + 1
    ok = [(ts >= t_kill, tid) for ts, tid, good in trace_log if good and tid]
    candidates = [tid for after, tid in sorted(ok, key=lambda x: not x[0])
                  if attempts.get(tid, 0) >= 2][:20]
    for tid in candidates:
        names, n_attempts, pids = trace_facts(flight.collect_trace(export, tid))
        if TRACE_HOPS <= names and n_attempts >= 2:
            rc, text, _ = obs_cli(["trace", export, tid])
            if rc != 0 or not all(h in text for h in TRACE_HOPS):
                raise SystemExit(f"fleet: cli.obs trace {tid}: exit {rc}:\n{text[-2000:]}")
            return {"trace_id": tid, "client_attempts": n_attempts, "processes": len(pids),
                    "hops": sorted(n for n in names if n), "candidates": len(candidates)}
    raise SystemExit(f"fleet: no answered request reassembled into {sorted(TRACE_HOPS)} with "
                     f">= 2 client attempts ({len(candidates)} candidates)")


def fleet_view(url: str) -> dict:
    """``/metrics/fleet`` once it holds still: two readings a scrape tick
    and more apart with the same ``fleet_requests``."""
    last = None
    for _ in range(40):
        status, raw = http_json(url + "/metrics/fleet")
        if status != 200:
            raise SystemExit(f"fleet: /metrics/fleet answered {status}")
        view = parse_prometheus(raw.decode())
        if last is not None and view.get("fleet_requests") == last.get("fleet_requests"):
            return view
        last = view
        time.sleep(1.0)
    raise SystemExit("fleet: /metrics/fleet never held still")


def replica_requests(urls) -> dict:
    return {u: parse_prometheus(http_json(u + "/metrics")[1].decode()).get(
        "serve_requests_total", 0.0) for u in urls}


def fleet_sums(url: str, client, oracle) -> dict:
    """``/metrics/fleet`` against the live replicas' own counters: the
    growth of ``fleet_requests`` over FLEET_SUM_REQUESTS requests equals the
    growth of the replicas' ``serve_requests_total`` summed (the
    aggregator keeps a killed replica's history, so the check is on the
    growth), and the answers are right."""
    status, raw = http_json(url + "/healthz")
    live = [r["url"] for r in json.loads(raw)["replicas"] if r["state"] == "up"]
    v0, r0 = fleet_view(url), replica_requests(live)
    genes = sorted(oracle)
    for i in range(FLEET_SUM_REQUESTS):
        g = genes[i % len(genes)]
        r = client.request("/v1/similar", {"genes": [g], "k": FLEET_K}, timeout_s=6.0)
        if not r.ok or fleet_verdict(oracle, g, r.doc)[0] != "ok":
            raise SystemExit(f"fleet sums: {g} answered {r.status} {r.error_class}")
    v1, r1 = fleet_view(url), replica_requests(live)
    fleet_delta = v1["fleet_requests"] - v0["fleet_requests"]
    replica_delta = sum(r1[u] - r0[u] for u in live)
    rec = {"live_replicas": len(live), "fleet_requests_delta": fleet_delta,
           "replica_requests_delta": replica_delta,
           "fleet_requests": v1["fleet_requests"], "replica_requests": sum(r1.values())}
    if len(live) != FLEET_REPLICAS or fleet_delta != replica_delta or fleet_delta < \
            FLEET_SUM_REQUESTS:
        raise SystemExit(f"fleet: /metrics/fleet sums against the replicas: {rec}")
    return rec


def live_k7(url: str) -> tuple:
    """(K7 launches summed over the live replicas' ``kernel_launches_total``,
    their count)."""
    status, raw = http_json(url + "/healthz")
    live = [r["url"] for r in json.loads(raw)["replicas"] if r["state"] == "up"]
    return sum(scrape_launches(u).get("topk_exact", 0) for u in live), len(live)


def fleet_drill(export: str, oracle, work: str) -> dict:
    """Phase 9a (``scripts/chaos_drill.py:drill_fleet``): 3 replicas, replica
    1 injecting latency, 503s, resets and blackholes; FLEET_LOAD_S of
    closed-loop load through the port's ``ResilientClient`` with replica 0
    SIGKILLed a third of the way in; the gates of ``fleet.chaos``, the
    restart, the sums and the cross-process trace."""
    from gene2vec_tpu_torch.resilience.faults import FaultSpec
    from gene2vec_tpu_torch.serve.client import ResilientClient, RetryPolicy

    faults = FaultSpec(seed=FLEET_SEED, latency_p=0.25, latency_ms=80.0, error_p=0.15,
                       error_status=503, reset_p=0.05, blackhole_p=0.03, blackhole_hold_s=1.5)
    t0 = time.perf_counter()
    proc, info = start_fleet(export, os.path.join(work, "fleet_drill.err"), (
        "--scrape-interval", "0.5", "--replica-arg", "1:--faults",
        "--replica-arg", f"1:{faults.to_json()}"))
    rec = {"startup_s": time.perf_counter() - t0, "faults": json.loads(faults.to_json())}
    url = info["url"]
    try:
        client = ResilientClient([url], RetryPolicy(max_attempts=3, default_timeout_s=6.0,
                                                    read_timeout_s=6.0, trace_sample=1.0))
        run = fleet_load(client, oracle, FLEET_LOAD_S, kill=info["replica_pids"][0])
        c = run["counts"]
        total = c["ok"] + c["failed"] + c["wrong"] + c["mixed"]
        prom = parse_prometheus(http_json(url + "/metrics")[1].decode())
        proxy_extra = prom.get("fleet_client_retries_total", 0) + prom.get(
            "fleet_client_hedges_total", 0)
        rec.update(requests=total, **c, availability=c["ok"] / max(total, 1),
                   retry_amplification=(c["attempts"] + proxy_extra) / max(total, 1),
                   proxy_retries=prom.get("fleet_client_retries_total", 0))
        rec["trace"] = fleet_trace(export, info["run_dir"], run["log"], run["t_kill"])
        deadline = time.monotonic() + 120.0
        while time.monotonic() < deadline:
            health = json.loads(http_json(url + "/healthz")[1])
            restarts = sum(r["restarts"] for r in health["replicas"])
            if restarts and health["replicas_up"] == FLEET_REPLICAS:
                break
            time.sleep(0.5)
        rec["replica_restarts"] = restarts
        rec["restart_s"] = time.monotonic() - run["t_kill"]
        if restarts:
            rec["sums"] = fleet_sums(url, client, oracle)
        rec["topk_exact_launches"], rec["replicas_read"] = live_k7(url)
    finally:
        stop_server(proc)
    rec["seconds"] = time.perf_counter() - t0
    gates = {"availability": rec["availability"] >= FLEET_CHAOS["min_availability"],
             "wrong": rec["wrong"] <= FLEET_CHAOS["max_wrong_answers"],
             "mixed": rec["mixed"] <= FLEET_CHAOS["max_mixed_iteration_answers"],
             "amplification": rec["retry_amplification"]
             <= FLEET_CHAOS["max_retry_amplification"],
             "restart": rec["replica_restarts"] >= 1, "sums": "sums" in rec,
             "requests": total >= FLEET_WORKERS * FLEET_LOAD_S}
    rec["gates"] = gates
    log(f"fleet drill: {json.dumps(rec)}")
    if not all(gates.values()):
        raise SystemExit(f"fleet drill: gates {gates}: {rec}")
    return rec


def alerts_drill(export: str, oracle, work: str) -> dict:
    """Phase 9b (``scripts/chaos_drill.py:drill_alerts``): the default rules
    at a 0.25 s scrape; a clean warmup on ``/v1/embedding`` fires nothing;
    a byzantine replica 1 (404s and latency on ``/v1/similar``) fires the
    availability burn-rate rule within the budget; the incident bundle
    verifies through ``python -m gene2vec_tpu_torch.cli.obs incident`` and
    holds a reassembled trace through the faulty replica's pid."""
    import glob
    import threading

    from gene2vec_tpu_torch.obs.alerts import collect_transitions
    from gene2vec_tpu_torch.resilience.faults import FaultSpec
    from gene2vec_tpu_torch.serve.client import ResilientClient, RetryPolicy

    faults = FaultSpec(seed=FLEET_SEED, route_prefix="/v1/similar", latency_p=0.5,
                       latency_ms=180.0, error_p=0.5, error_status=404)
    t0 = time.perf_counter()
    proc, info = start_fleet(export, os.path.join(work, "alerts_drill.err"), (
        "--scrape-interval", str(ALERTS_DETECTION["scrape_interval_s"]),
        "--alert-rules", "default", "--proxy-attempts", str(ALERTS_DETECTION["proxy_attempts"]),
        "--replica-arg", "1:--faults", "--replica-arg", f"1:{faults.to_json()}"))
    rec = {"startup_s": time.perf_counter() - t0, "faults": json.loads(faults.to_json())}
    url, run_dir, faulty = info["url"], info["run_dir"], info["replica_pids"][1]

    def firings():
        return [r for r in collect_transitions(run_dir) if r.get("to") == "firing"]

    try:
        client = ResilientClient([url], RetryPolicy(max_attempts=1, default_timeout_s=6.0,
                                                    read_timeout_s=6.0, trace_sample=1.0))
        gene = sorted(oracle)[0]
        for replica_url in info["replica_urls"]:  # each replica's first batch, off the books
            for _ in range(12):
                if http_json(replica_url + "/v1/similar", {"genes": [gene], "k": FLEET_K})[0] \
                        == 200:
                    break
        warm = fleet_load(client, oracle, ALERTS_WARMUP_S, route="/v1/embedding", pace=0.02)
        time.sleep(max(3 * ALERTS_DETECTION["scrape_interval_s"], 1.0))
        rec["warmup_requests"] = sum(warm["counts"][k] for k in ("ok", "failed"))
        rec["warmup_false_positives"] = len(firings())
        t_fault = time.time()
        holder, halt = {}, threading.Event()
        load = threading.Thread(target=lambda: holder.update(fleet_load(
            client, oracle, ALERTS_DETECTION["max_detection_latency_s"] + 5.0, halt=halt)))
        load.start()
        fired = None
        deadline = time.monotonic() + ALERTS_DETECTION["max_detection_latency_s"] + 5.0
        while fired is None and time.monotonic() < deadline:
            fired = next((r for r in firings() if r["rule"] == ALERT_RULE
                          and r.get("wall", 0.0) >= t_fault), None)
            time.sleep(0.2)
        time.sleep(2.0)  # more load, so the bundle's rings and trace window fill
        halt.set()
        load.join()
        rec["fault_requests"] = sum(holder["counts"][k] for k in ("ok", "failed", "wrong",
                                                                   "mixed"))
        rec["detection_latency_s"] = fired["wall"] - t_fault if fired else None
        rec["fired_rules"] = sorted({r["rule"] for r in firings()})
        bundle = None
        deadline = time.monotonic() + 45.0
        while bundle is None and time.monotonic() < deadline:
            found = sorted(os.path.dirname(m) for m in glob.glob(os.path.join(
                run_dir, "incidents", f"*_{ALERT_RULE}", "incident.MANIFEST.json")))
            bundle = found[0] if found else None
            time.sleep(0.5)
        rec["topk_exact_launches"], rec["replicas_read"] = live_k7(url)
    finally:
        stop_server(proc)
    if bundle is None:
        raise SystemExit(f"alerts drill: no {ALERT_RULE} incident bundle: {rec}")
    cli = subprocess.run([sys.executable, "-m", "gene2vec_tpu_torch.cli.obs", "incident", bundle],
                         capture_output=True, text=True, timeout=120, cwd=ROOT,
                         env=dict(os.environ, **res_env()))
    traces = {}
    for path in sorted(glob.glob(os.path.join(bundle, "trace-*.json"))):
        with open(path) as f:
            traces[os.path.basename(path)] = trace_facts(json.load(f))[2]
    dumps = glob.glob(os.path.join(bundle, "flightdump-*.json"))
    rec.update(bundle=os.path.relpath(bundle, export), bundle_verified=cli.returncode == 0
               and "VERIFIED" in cli.stdout, bundle_traces=len(traces),
               traces_through_faulty=sum(faulty in p for p in traces.values()),
               flight_dumps=len(dumps),
               metrics_window=os.path.exists(os.path.join(bundle, "metrics_window.json")),
               seconds=time.perf_counter() - t0)
    latency = rec["detection_latency_s"]
    gates = {"false_positives": rec["warmup_false_positives"]
             <= ALERTS_DETECTION["max_false_positives"],
             "detection": latency is not None
             and latency <= ALERTS_DETECTION["max_detection_latency_s"],
             "bundle_verified": rec["bundle_verified"],
             "trace_through_faulty": rec["traces_through_faulty"] >= 1,
             "flight_dumps": rec["flight_dumps"] >= FLEET_REPLICAS + 1,
             "metrics_window": rec["metrics_window"]}
    rec["gates"] = gates
    log(f"alerts drill: {json.dumps(rec)}")
    if not all(gates.values()):
        raise SystemExit(f"alerts drill: gates {gates}: {rec}\n{cli.stdout[-2000:]}"
                         f"{cli.stderr[-2000:]}")
    return rec


def fleet_phase(smi: str) -> tuple:
    """Phase 9: ``cli/fleet.py`` over the clustered full-width export with
    3 replicas on the card — the fleet drill, then the alerts drill.
    Returns (the ``{"fleet": ...}`` record, K7's launches read from the
    live replicas; a SIGKILLed replica's count is lost with it)."""
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory(prefix="chip_smoke_", dir=os.getcwd()) as work:
        rec = {}
        for name, drill in (("drill", fleet_drill), ("alerts", alerts_drill)):
            export = os.path.join(work, f"clustered_{name}")
            emb, _ = write_clustered_export(export)
            rec[name] = drill(export, fleet_oracle(emb), work)
    rec["budgets"] = {"fleet.chaos": FLEET_CHAOS, "alerts.detection": ALERTS_DETECTION}
    rec["seconds"] = time.perf_counter() - t0
    rec["card"] = smi
    launches = {"topk_exact": rec["drill"]["topk_exact_launches"]
                + rec["alerts"]["topk_exact_launches"]}
    if not launches["topk_exact"]:
        raise SystemExit("fleet: the replicas launched no K7")
    log(f"fleet phase done in {rec['seconds']:.1f}s")
    return rec, launches


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        log("chip_smoke: no CUDA device available")
        return 2
    if sys.argv[1:2] == ["--compare"]:
        args = sys.argv[2:]
        parts = "all"
        if args[:1] == ["--parts"]:
            parts, args = args[1], args[2:]
        if parts not in ("all", "umap"):
            raise SystemExit(f"chip_smoke: --parts takes all or umap, not {parts}")
        return compare_trees(args, parts)
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
    if sys.argv[1:2] == ["--fleet"]:
        fleet, _ = fleet_phase(smi)
        print(json.dumps({"fleet": fleet}))
        return 0
    # phase 8 first, on a file system that holds none of the other phases'
    # files: its async-overhead gate times checkpoint writes against epochs
    # of tens of ms.  The CLIs killed, drained and resumed (K1-K4, K6), the
    # GGIPNN drain (row_gather) and a server injecting faults (K7)
    res, res_counts = resilience(torch, smi)
    if sys.argv[1:2] == ["--resilience"]:
        print(json.dumps({"resilience": res}))
        return 0
    # phase 9: the serving fleet, 3 replicas of cli/serve.py on the card (K7)
    fleet, fleet_counts = fleet_phase(smi)

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
    # phase 2g: wide tables — each training mode's step and each serving mode
    with tempfile.TemporaryDirectory(prefix="chip_smoke_", dir=os.getcwd()) as work:
        wide_width_check(torch, work, smi)
    t0 = time.perf_counter()
    serve_rows, serve_shapes = serving_kernel_check(torch, TIMED_REPS)
    ties = sum(tie_heavy_check(torch, torch.device(DEVICE), b, kb)
               for b in TIE_BATCHES for kb in TIE_KBS)
    log(f"tie-heavy tables: K7-K9r held at B {TIE_BATCHES} x kb {TIE_KBS}, near-ties {ties}")
    redesign = redesign_factors(serve_shapes)
    redesign.update(noise_redesign(rows))
    serve_shapes += serving_repairs_check(torch, TIMED_REPS)
    probes = gather_probes(torch, TIMED_REPS)
    stream_row, stream_recs = stream_probes(torch, TIMED_REPS)
    probes += stream_recs
    lane_rows, lane_recs = lane_probes(torch, TIMED_REPS)
    staged_row, staged_recs = staged_probes(torch, TIMED_REPS)
    gather_row, gather_recs = ggipnn_gather_row(torch, TIMED_REPS)
    probes += lane_recs + staged_recs + gather_recs
    redesign.update(k4_redesign(rows))
    redesign.update(gather_redesign(probes))
    redesign["timer_floor_ms"] = timer_floor(torch, TIMED_REPS)
    log(f"timer floor (a one-element fill): {redesign['timer_floor_ms']:.4f} ms")
    log(f"serving kernel check and probes done in {time.perf_counter() - t0:.1f}s")
    t0 = time.perf_counter()
    # phase 6: GGIPNN — one step card vs CPU at full width, then the rates
    for embed_train in (False, True):
        ggipnn_step_parity(torch, V, D, GG_B, embed_train)
    for batch in (GG_B, GG_B_LARGE):
        ggipnn_rate(torch, batch, smi)
    log(f"GGIPNN step and rate done in {time.perf_counter() - t0:.1f}s")
    prof_dir = os.path.join(os.getcwd(), "chip_smoke_profile")
    # the default step at float32 and bfloat16, in turns (f32, bf16, bf16, f32)
    widths = compare_widths(
        [profile_steps(torch, PROFILED_STEPS, prof_dir, smi, **kw)
         for kw in ({}, {"table_dtype": "bfloat16"}, {"table_dtype": "bfloat16"}, {})], smi)
    log(f"default step, bf16 against f32: {widths['bf16_over_f32']}")
    # the other objectives' steps (per_example, shared, sg_hs, cbow_hs)
    objective_windows = [profile_steps(torch, PROFILED_STEPS // 2, prof_dir, smi, **kw)
                         for kw in PLANTED_CONFIGS[1:5]]

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
        emb, groups = write_clustered_export(clustered)
        for name, n in serve_full_width(clustered, work, smi, gate_recall=True).items():
            served[name] = served.get(name, 0) + n
        counts.update(served)
        log(f"serving phase done in {time.perf_counter() - t0:.1f}s")
        # phase 6: GGIPNN through the CLI over the clustered export, then
        # its run-dir head behind /v1/interaction: row_gather's main path
        t0 = time.perf_counter()
        gathers, checkpoint, _ = ggipnn_cli(torch, work, smi, emb, groups,
                                            auc_floor=GG_AUC_FLOOR)
        gathers += serve_interaction(torch, clustered, checkpoint, work, smi)
        counts["row_gather"] = gathers
        log(f"GGIPNN phase done in {time.perf_counter() - t0:.1f}s")
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
        # K4's nearest-even write-backs through the touched rows too
        for kw in ({}, {"negative_mode": "per_example"}):
            touched_step_check(torch, "bf16_rn " + (kw.get("negative_mode") or "stratified"),
                               table_dtype="bfloat16", bf16_stochastic_round=False, **kw)
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
    # phase 4b: the quality tooling (planted gate, holdout, fit_epoch); its
    # K1-K4 and row_gather launches count on the kernels line too
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory(prefix="chip_smoke_", dir=os.getcwd()) as work:
        for name, n in quality_tooling(torch, work, smi).items():
            counts[name] += n
    log(f"quality tooling phase done in {time.perf_counter() - t0:.1f}s")
    # phase 4c: kernel cost attribution (profiled runs, GGIPNN, the servers),
    # then (4d) the run reports over its records
    with tempfile.TemporaryDirectory(prefix="chip_smoke_", dir=os.getcwd()) as work:
        run_reports(kernel_attribution(torch, work, smi), work, smi)

    # phase 7: the paper's pipeline — the corpus (K11), training and the
    # intrinsic evaluation, t-SNE (K10c, K10)
    pipe_rows, pipe_counts = pipeline(torch, smi)
    counts.update(pipe_counts)
    add_launches(counts, res_counts)
    add_launches(counts, fleet_counts)

    rows += serve_rows
    rows.append(gather_row)
    rows.append(stream_row)
    rows += lane_rows
    rows.append(staged_row)
    rows += pipe_rows
    for r in rows:
        r["launches"] = counts[r["name"]]
    # the probes' counterparts are on no path the package runs: phase 3 reads 0
    missing = [r["name"] for r in rows if r["name"] not in PROBE_ROWS and not r["launches"]]
    if missing:
        raise SystemExit(f"kernels not launched on their main path: {missing}")

    print(json.dumps({"serving_kernel_shapes": serve_shapes}))
    print(json.dumps({"probes": probes}))
    print(json.dumps({"table_widths": widths}))
    print(json.dumps({"objective_windows": objective_windows, "card": smi}))
    print(json.dumps({"hs_hot_levels": HS_HOT, "card": smi}))
    print(json.dumps({"k6_acc_check": {"repeats": K6_REPEATS, "bar": REL_TOL,
                                       "largest_share": K6_SHARES}, "card": smi}))
    print(json.dumps({"redesign": redesign}))
    print(json.dumps({"touched_rows": TOUCHED_SHARES}))
    print(json.dumps({"resilience": res}))
    print(json.dumps({"fleet": fleet}))
    print(smi)
    print(json.dumps({"kernels": rows}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
