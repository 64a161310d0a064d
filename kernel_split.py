#!/usr/bin/env python3
"""Where a kernel's time goes, by builds with one part changed or compiled out.

    python3 kernel_split.py [--kernel k5|k9|k10|k10c|k11|k12|k13] [TREE ...]   # on a machine with a CUDA card

For the kernel named (default ``k5``) of each checkout given (default:
this one), builds its source as it is and as each entry of its variant
table makes it (edits matched by text, so a variant that does not apply to
a tree's source is skipped and says so), loads each build with ctypes and
times it with ``chip_smoke.Timer`` (CUDA events, L2 flushed, median).  One
``{"split": ...}`` line per tree on stdout, with each build's registers
(``ptxas -v``) and the card's name and power limit.

- ``k5``: K5a (``csrc/k5_per_example.cu``) with parts removed (its
  scatters, the hot-row sums: ``no_hot_rows`` sends every payload to global
  atomics) at the default configuration's full width (E = 8192, K = 5, D =
  200), on the inputs ``chip_smoke.objective_kernel_check`` makes, at
  float32 and bfloat16 tables.  The full build is also timed with uniform
  draws in place of the alias draws: equal times say the hottest rows'
  atomics do not contend.  A build with a part removed computes a wrong
  result; it is timed, never checked.
- ``k9``: K9 (``csrc/k9_ivf_scan.cu``) and K9r (``csrc/k9r_rescore.cu``)
  with parts compiled out — the probe only (K9's scan launch gone), the
  scan without the select (the leader selects and writes nothing), the
  select without the row loads (each row scored by its id alone) — each
  timed at the serving kernels' MAIN_SHAPE (B = 64, kb = 16: K9 over the
  default IVF geometry of ``chip_smoke.serving_table``, K9r over K8's
  top-64) on the inputs ``chip_smoke.serving_kernel_check`` makes.
- ``k12``: K12 (``csrc/k12_stream_scale.cu``) with one design choice
  changed (vectors a thread for float32 and bfloat16, evict-first cache
  hints on the loads or on both), each build checked bitwise against
  ``x * scale`` once and timed beside ``torch.mul`` at the kernels line's
  K12 shapes: ``pallas_copy_loop``'s 25, 100 and 400 MB (float32, x
  1.0000001), 100 MB bfloat16 and ``stream_copy``'s (256, 24576) float32
  and bfloat16.
- ``k13``: K13 (``csrc/k13_lane.cu``) with parts compiled out — no
  contributor-list build (each column its own j), the lists built and
  then replaced by that (``build_only``: the build's cost alone), no sum
  (one read of G a column), a plain copy (loads and stores only: neither,
  and the gather unpermuted), and the scatter without its register cap —
  for this design and for its first one (a warp a row, lists built
  serially: the ``first_`` entries), each timed at phase 2f's (256,
  24576) float32 and bfloat16 on random offsets, beside ``torch.mul``
  (a streaming pass, K12's rate) and the library calls ``index_select``
  / ``index_add``.  The whole build is checked bitwise against the plain
  versions, timed at every tile height it takes (``rows``; the uncapped
  build too) and, for the scatter, with every offset one column (one list
  of 128).
- ``k10``: K10 (``csrc/k10_tsne_step.cu``) at phase 7c's N = 24,447 (P of
  the clustered table's PCA-50 points at perplexity 30, a layout 20
  iterations in) with parts compiled out — P's loads (P a constant), the
  reciprocal (a plain multiply, or ``__frcp_rn`` where the design has its
  own), the arithmetic (the P stream alone) — and, for the first design
  (three launches: the ``first_`` entries), the Z pass and the centring.
  Each launch's device ms from ``torch.profiler`` beside each build's
  CUDA-event time.
- ``k10c``: K10c (``csrc/k10c_tsne_calibrate.cu``) on those distances,
  its two launches timed apart, with parts compiled out — the
  exponential (the product in its place), the diagonal select (put back
  where the design stages FLT_MAX; taken out of the first design), the
  block sums, the early exit (all 50 steps).
- ``k11``: K11 (``csrc/k11_coexpr_mask.cu``) on a standardized seeded
  (n, 24,447) z (``chip_smoke.k11_study``) at n = 160 and 24, threshold
  0.9, with one part changed: the mirrored words not written
  (``no_mirror``), the first design's division and clip in place of the
  compare with a* (``div_epilogue``, handed the threshold), no compare or
  packing (``no_epilogue``: the sums kept alive by one word a tile), one
  stage and no copy in flight (``single_buffer``).  Each tree's words and
  those of the builds that compute them are hashed (``words_sha256``);
  ``bitwise`` says whether each equals the first tree's ``full`` build, so
  ``kernel_split.py --kernel k11 PARENT CHANGE`` holds the change to the
  parent's bits.  ``no_operand_loads`` reads one sample row a stage (the
  FFMAs without their shared-memory loads; timed only).  The first
  design takes z as it is and the threshold.
"""

from __future__ import annotations

import ctypes
import hashlib
import json
import os
import re
import subprocess
import sys
import tempfile

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))
CSRC = os.path.join("gene2vec_tpu_torch", "kernels", "csrc")

_DRAWS = ("add_hot(hot, n[k], D, vs, g[k], 1.0f, lane);", ";"), \
    ("add_payload(acc, n[k], D, vs, g[k], 1.0f, lane);", ";")
_CONTEXTS = ("add_hot(hot, c, D, vs, gp, 1.0f, lane);", ";"), \
    ("add_payload(acc, c, D, vs, gp, 1.0f, lane);", ";")
_SCALAR_PAYLOADS = ("atomicAdd(&acc[static_cast<size_t>(nk[k]) * D1 + d], __fmul_rn(gk[k], vd));",
                    ";")
_LOADS_CS = ("v[k] = __ldg(x + i);", "v[k] = __ldcs(x + i);")
_STORES_CS = ("out[i] = g2v_scale_vec<T>(v[k], scale);",
              "__stcs(out + i, g2v_scale_vec<T>(v[k], scale));")

_K9_INCLUDE = '#include "topk_common.cuh"'
_K9_PROBE_ONLY = ("#define K9_SCAN 1", "#define K9_SCAN 0")

_K13_LISTS = ("#define K13_LISTS 1", "#define K13_LISTS 0")
_K13_SUM = ("#define K13_SUM 1", "#define K13_SUM 0")

# the first design: the serial list build (count, thread 0's prefix, fill)
# made an identity, its sum loop one read, its gather unpermuted
_FIRST_LISTS = [
    ("    int n = 0;\n    for (int j = 0; j < kBucket; ++j) n += s_offs[j] == c;\n"
     "    s_count[c] = n;", "    s_count[c] = 1;"),
    ("  if (threadIdx.x == 0) {\n    int run = 0;", "  if (false) {\n    int run = 0;"),
    ("    int k = s_start[c];\n    for (int j = 0; j < kBucket; ++j)\n"
     "      if (s_offs[j] == c) s_list[k++] = j;", "    s_start[c] = c;\n    s_list[c] = c;")]
_FIRST_SUM = ("      for (int i = s_start[c]; i < s_start[c] + s_count[c]; ++i)\n"
            "        acc += to_f32(seg[warp][s_list[i]]);", "      acc = to_f32(seg[warp][c]);")

_K10_FIRST_Z = ("  z_partials_kernel<<<", "  if (false) z_partials_kernel<<<")
_K10_FIRST_CENTER = ("  center_kernel<<<", "  if (false) center_kernel<<<")
_K10_FIRST_P = ("pv[r] = r < rows ? __ldg(prow[r] + j) : 0.0f;", "pv[r] = r < rows ? 1e-9f : 0.0f;")
_K10_FIRST_RCP = ("return __frcp_rn(__fadd_rn(1.0f, fmaxf(d, 0.0f)));",
                  "return __fmul_rn(0.5f, __fadd_rn(1.0f, fmaxf(d, 0.0f)));")
# the first K10c: one block a row, 50 steps, each with a two-level block sum
_K10C_FIRST_SUMS = ("""  a = g2v_warp_sum(a);
  b = g2v_warp_sum(b);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  if (lane == 0) {
    red[warp] = a;
    red[kWarps + warp] = b;
  }
  __syncthreads();
  if (warp == 0) {
    a = lane < kWarps ? red[lane] : 0.0f;
    b = lane < kWarps ? red[kWarps + lane] : 0.0f;
    a = g2v_warp_sum(a);
    b = g2v_warp_sum(b);
    if (lane == 0) {
      red[2 * kWarps] = a;
      red[2 * kWarps + 1] = b;
    }
  }
  __syncthreads();
  sw = red[2 * kWarps];
  sdw = red[2 * kWarps + 1];
  __syncthreads();  // red is reused by the next step
""", "  sw = a;\n  sdw = b;\n")

_K10C_ALL_STEPS = ("#define K10C_EARLY_EXIT 1", "#define K10C_EARLY_EXIT 0")

_K11_PASS = "const bool pass = fabsf(acc[r][h * 4 + c]) >= astar;"

#: kernel → (source files, variant → [(text, replacement)]); a variant
#: builds each source its edits all apply to.  K5a's first design (a
#: column a lane, scalar atomics, each noise row read twice) and its
#: register design name their parts differently
VARIANTS = {
    "k5": (("k5_per_example.cu",), {
        "no_payload_atomics": [_SCALAR_PAYLOADS],  # first design: the draws' g·v atomics
        "no_atomics": [  # first design: every atomic (payloads and counts)
            _SCALAR_PAYLOADS,
            ("atomicAdd(&acc[static_cast<size_t>(nk[k]) * D1 + D], 1.0f);", ";")],
        "no_noise_scatter": [*_DRAWS],  # the draws' payloads
        "no_context_scatter": [*_CONTEXTS],  # the positive contexts' payloads
        "no_scatter": [*_DRAWS, *_CONTEXTS],
        "no_hot_rows": [  # every payload by global atomics, none summed in shared memory
            ("if (n[k] < kHot) {", "if (false) {"), ("if (c < kHot) {", "if (false) {")],
    }),
    "k9": (("k9_ivf_scan.cu", "k9r_rescore.cu"), {
        "probe_only": [_K9_PROBE_ONLY],
        "probe_no_dots": [_K9_PROBE_ONLY, ("#define K9_PROBE_DOTS 1", "#define K9_PROBE_DOTS 0")],
        "probe_no_select": [_K9_PROBE_ONLY,
                            ("#define K9_PROBE_SELECT 1", "#define K9_PROBE_SELECT 0")],
        "no_select": [(_K9_INCLUDE, "#define G2V_LIST_SELECT 0\n" + _K9_INCLUDE)],
        "no_loads": [(_K9_INCLUDE, "#define G2V_LIST_LOADS 0\n" + _K9_INCLUDE)],
        "no_candidates": [(_K9_INCLUDE, "#define G2V_LIST_COMPACT 0\n" + _K9_INCLUDE)],
        "trace": [(_K9_INCLUDE, "#define G2V_TRACE 1\n" + _K9_INCLUDE)],
    }),
    "k12": (("k12_stream_scale.cu",), {
        "f32_unroll2": [("constexpr int kUnrollF32 = 1;", "constexpr int kUnrollF32 = 2;")],
        "f32_unroll4": [("constexpr int kUnrollF32 = 1;", "constexpr int kUnrollF32 = 4;")],
        "bf16_unroll1": [("constexpr int kUnrollBf16 = 4;", "constexpr int kUnrollBf16 = 1;")],
        "loads_evict_first": [_LOADS_CS],
        "evict_first": [_LOADS_CS, _STORES_CS],
    }),
    "k13": (("k13_lane.cu",), {
        "no_lists": [_K13_LISTS],
        "build_only": [("#define K13_LISTS 1", "#define K13_LISTS 2")],
        "no_register_cap": [("kRows * sizeof(T) <= 64 ? 6 : 1", "1")],
        "gather_one_stage": [("#define K13_GATHER_STAGES 2", "#define K13_GATHER_STAGES 1")],
        "no_sum": [_K13_SUM],
        "copy_only": [_K13_LISTS, _K13_SUM,
                      ("#define K13_PERMUTE 1", "#define K13_PERMUTE 0")],
        "first_no_lists": _FIRST_LISTS,
        "first_no_sum": [_FIRST_SUM],
        "first_copy_only": [*_FIRST_LISTS, _FIRST_SUM,
                            ("e[k] = seg[warp][s_offs[4 * lane + k]];",
                             "e[k] = seg[warp][4 * lane + k];")],
    }),
    "k10": (("k10_tsne_step.cu",), {
        "no_p_loads": [("#define K10_P_LOADS 1", "#define K10_P_LOADS 0")],
        "plain_rcp": [("#define K10_RCP 1", "#define K10_RCP 0")],
        "ieee_rcp": [("#define K10_RCP 1", "#define K10_RCP 2")],
        "stream_only": [("#define K10_ARITH 1", "#define K10_ARITH 0")],
        # one block an SM with up to 255 registers a thread, not two at 128
        "one_block_an_sm": [("__launch_bounds__(kThreads, 2)", "__launch_bounds__(kThreads, 1)")],
        "first_no_z": [_K10_FIRST_Z],
        "first_no_p_loads": [_K10_FIRST_P],
        "first_plain_rcp": [_K10_FIRST_RCP],
        "first_no_center": [_K10_FIRST_CENTER],
    }),
    "k10c": (("k10c_tsne_calibrate.cu",), {
        # the parts compiled out change the bisection's path, so those builds
        # take all 50 steps, as "all_steps" does
        "all_steps": [_K10C_ALL_STEPS],
        "no_exp": [_K10C_ALL_STEPS, ("#define K10C_EXP 1", "#define K10C_EXP 0")],
        "no_block_sums": [_K10C_ALL_STEPS,
                          ("#define K10C_BLOCK_SUMS 1", "#define K10C_BLOCK_SUMS 0")],
        "select": [("#define K10C_SELECT 0", "#define K10C_SELECT 1")],
        # exp(x) as ex2.approx(x·log2 e): 2 float32 instructions and MUFU.EX2
        # in place of expf's ~9 (timed only: its rounding is not expf's)
        "ex2_approx": [("  return expf(__fmul_rn(-d, beta));",
                        "  float r;\n  asm(\"ex2.approx.f32 %0, %1;\" : \"=f\"(r) : "
                        "\"f\"(__fmul_rn(__fmul_rn(-d, beta), 1.44269504f)));\n  return r;")],
        "first_no_exp": [("const float w = (j == diag) ? 0.0f : expf(__fmul_rn(-d, beta));",
                          "const float w = (j == diag) ? 0.0f : __fmul_rn(-d, beta);")],
        "first_no_select": [("(j == diag) ? 0.0f : expf(", "expf(")],
        "first_no_block_sums": [_K10C_FIRST_SUMS],
    }),
    "k11": (("k11_coexpr_mask.cu",), {
        "no_mirror": [("#define K11_MIRROR 1", "#define K11_MIRROR 0")],
        # astar holds the threshold in this build
        "div_epilogue": [(_K11_PASS, "const bool pass = fminf(fmaxf(__fdiv_rn(fabsf("
                                     "acc[r][h * 4 + c]), static_cast<float>(n - 1)), 0.0f), "
                                     "1.0f) > astar;")],
        "no_epilogue": [("#define K11_EPILOGUE 1", "#define K11_EPILOGUE 0")],
        "single_buffer": [("#define K11_STAGES 2", "#define K11_STAGES 1")],
        # every sample reads stage row 0: the loads leave the sample loop, the
        # FFMAs stay (timed only)
        "no_operand_loads": [("&sa[buf][kk][", "&sa[buf][0]["), ("&sb[buf][kk][", "&sb[buf][0][")],
    }),
}


def build(tree: str, kernel: str, work: str) -> dict:
    """{variant: ({source: library path}, registers by kernel)}, one nvcc
    a (variant, source), all started at once."""
    from gene2vec_tpu_torch.kernels import build as kb

    src_names, variants = VARIANTS[kernel]
    csrc = os.path.join(tree, CSRC)
    procs = {}
    for src_name in src_names:
        with open(os.path.join(csrc, src_name)) as f:
            text = f.read()
        sources = {"full": text}
        for name, edits in variants.items():
            if all(old in text for old, _ in edits):
                out = text
                for old, new in edits:
                    out = out.replace(old, new)
                sources[name] = out
        for name, body in sources.items():
            stem = f"{kernel}_{name}_{src_name[:-3]}"
            src = os.path.join(work, f"{stem}.cu")
            with open(src, "w") as f:
                f.write(body)
            lib = os.path.join(work, f"{stem}.so")
            procs[name, src_name] = (lib, subprocess.Popen(
                [kb.nvcc_path(), *kb.NVCC_FLAGS, "-I", csrc, "-o", lib, src],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    built = {}
    for (name, src_name), (lib, proc) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise SystemExit(f"{tree} {kernel} {name} {src_name}: nvcc exit {proc.returncode}\n"
                             f"{log}")
        paths, regs = built.setdefault(name, ({}, {}))
        paths[src_name] = lib
        fn = None
        for line in log.splitlines():
            m = re.search(r"Compiling entry function '(\S+)'", line)
            if m:
                fn = kernel_name(m.group(1))
                fn = fn and re.sub(r"N\d+_GLOBAL__N__\w+?_cu_[0-9a-f]+\d", "", fn)
            m = re.search(r"Used (\d+) registers", line)
            if m and fn:
                regs[fn] = int(m.group(1))
    return built


def kernel_name(mangled: str):
    """``name<template arguments>`` of the first ``*_kernel`` in a mangled
    name, read by its length prefixes (nvcc's per-file namespace holds
    digits too), or None."""
    i = 0
    while i < len(mangled):
        m = re.match(r"\d+", mangled[i:])
        if not m:
            i += 1
            continue
        j = i + len(m.group())
        name = mangled[j:j + int(m.group())]
        i = j + len(name)
        if name.endswith("_kernel") or name.startswith("g2v_"):
            rest = mangled[i:]
            args = rest[1:rest.index("EEv")] if rest.startswith("I") and "EEv" in rest else ""
            return f"{name}<{args}>"
    return None


def time_k5(torch, tree, built, timer, out):
    import chip_smoke as cs
    from gene2vec_tpu_torch.data.negative_sampling import (
        build_alias_table, noise_distribution, sample_negatives)
    from gene2vec_tpu_torch.kernels import _args
    from gene2vec_tpu_torch.kernels.pos_logit import pos_logit_plain

    dev = torch.device("cuda")
    counts, emb, ctx, c_ids, x_ids = cs.full_width_inputs(torch, dev)
    contexts = torch.from_numpy(x_ids).to(dev)
    noise = build_alias_table(noise_distribution(counts), device=dev)
    draws = {"alias": sample_negatives(noise, torch.Generator(device=dev).manual_seed(0),
                                       (cs.E, cs.K)),
             "uniform": torch.randint(0, cs.V, (cs.E, cs.K), dtype=torch.int32, device=dev,
                                      generator=torch.Generator(device=dev).manual_seed(0))}
    for dtype in (torch.float32, torch.bfloat16):
        table = ctx.to(dtype)
        v, u, g_pos, _ = pos_logit_plain(emb.to(dtype), table,
                                        torch.from_numpy(c_ids).to(dev), contexts)
        acc = torch.zeros((cs.V, cs.D + 1), device=dev)
        d_center = torch.empty_like(v)
        loss = torch.empty_like(g_pos)
        bf16 = int(dtype == torch.bfloat16)
        for name, (paths, _) in built.items():
            fn = ctypes.CDLL(paths["k5_per_example.cu"]).k5_per_example
            fn.argtypes = [ctypes.c_void_p] * 9 + [ctypes.c_int] * 4 + [ctypes.c_void_p]
            fn.restype = ctypes.c_int
            for kind, negs in draws.items():
                if kind == "uniform" and name != "full":
                    continue

                def call():
                    status = fn(*(_args.ptr(t) for t in (
                        v, u, g_pos, contexts, negs, table, loss, d_center, acc)),
                        cs.E, cs.K, cs.D, bf16, _args.stream(v))
                    if status:
                        raise SystemExit(f"{tree} {name}: CUDA error {status}")

                key = f"{name}{'_bf16' if bf16 else ''}" + ("_uniform" if kind == "uniform"
                                                          else "")
                out["ms"][key] = timer(call)
                cs.log(f"split {tree} {key}: {out['ms'][key]:.4f} ms")


def k12_cases(torch, gen):
    """(label, x) at the kernels line's K12 shapes."""
    dev = torch.device("cuda")
    for mb in (25, 100, 400):
        yield f"{mb}MB_f32", torch.randn((mb * 1024 * 1024 // 4 // 256, 256), device=dev,
                                         generator=gen)
    yield "100MB_bf16", torch.randn((100 * 1024 * 1024 // 2 // 256, 256), device=dev,
                                    generator=gen).to(torch.bfloat16)
    for dt in (torch.float32, torch.bfloat16):
        yield f"stream_copy_{str(dt)[6:]}", torch.randn((256, 24576), device=dev,
                                                        generator=gen).to(dt)


def time_k12(torch, tree, built, timer, out):
    import chip_smoke as cs
    from gene2vec_tpu_torch.kernels import _args
    from gene2vec_tpu_torch.kernels.stream_scale import SCALE

    gen = torch.Generator(device="cuda").manual_seed(0)
    for label, x in k12_cases(torch, gen):
        bf16 = int(x.dtype == torch.bfloat16)
        res = out["ms"][label] = {"library_ms": timer(lambda: torch.mul(x, SCALE))}
        dst = torch.empty_like(x)
        for name, (paths, _) in built.items():
            fn = ctypes.CDLL(paths["k12_stream_scale.cu"]).k12_stream_scale
            fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong,
                           ctypes.c_float, ctypes.c_int, ctypes.c_void_p]
            fn.restype = ctypes.c_int

            def call():
                status = fn(_args.ptr(x), _args.ptr(dst), x.numel(), SCALE, bf16,
                            _args.stream(x))
                if status:
                    raise SystemExit(f"{tree} {name}: CUDA error {status}")

            call()
            torch.cuda.synchronize()
            if not cs.same_bits(torch, dst, torch.mul(x, SCALE)):
                raise SystemExit(f"{tree} {name} {label}: not bitwise x * {SCALE}")
            res[name] = timer(call)
        cs.log(f"split {tree} {label}: {res}")
        del x, dst


def time_k9(torch, tree, built, timer, out):
    import chip_smoke as cs
    from gene2vec_tpu_torch.kernels import _topk, ivf_scan, quant_scan, rescore
    from gene2vec_tpu_torch.serve import ann

    dev = torch.device("cuda")
    rng = np.random.RandomState(5)
    unit_np = cs.serving_table(rng)
    index = ann.build_index(unit_np, "ivf", device=dev)
    unit = torch.from_numpy(unit_np).to(dev)
    b, kb = cs.MAIN_SHAPE
    rb = cs.RESCORE_MULT * kb
    q_np = unit_np[rng.choice(cs.V, b, replace=False)] * 3.0
    qn = _topk.normalize_plain(torch.from_numpy(q_np).to(dev))
    nprobe = min(max(8, -(-kb // index.list_len)), index.n_clusters)
    lst = index.list_len
    n = nprobe * lst
    r = min(rb, n)
    pp, pl = ivf_scan.plans(qn, index.centroids, index.table_q, nprobe, rb, lst)
    probe = torch.empty((b, nprobe), dtype=torch.int32, device=dev)
    scr9 = _topk.list_scratch(pl, b, n, dev)
    s9 = torch.empty((b, r), device=dev)
    r9 = torch.empty((b, r), dtype=torch.int32, device=dev)
    rs, ri = quant_scan.quant_scan_plain(qn, index.table_q, index.scale, rb)
    k = min(kb, ri.shape[1])
    pr = rescore.plan(qn, unit, ri.shape[1], k)
    scr_r = _topk.list_scratch(pr, b, ri.shape[1], dev)
    s_r = torch.empty((b, k), device=dev)
    r_r = torch.empty((b, k), dtype=torch.int32, device=dev)
    out["routes"] = {"ivf_scan": cs.ivf_route(ivf_scan, qn, index.centroids, index.table_q,
                                              nprobe, rb, lst),
                     "rescore": pr.describe()}
    for name, (paths, _) in built.items():
        for src_name, path in paths.items():
            if src_name.startswith("k9_"):
                lib = ivf_scan.bind(ctypes.CDLL(path))

                def call():
                    status = ivf_scan.launch(lib, qn, index.centroids, index.lists, index.table_q,
                                             index.scale, nprobe, cs.V, r, pp, pl, probe, scr9,
                                             s9, r9)
                    if status:
                        raise SystemExit(f"{tree} {name}: CUDA error {status}")
                key = f"ivf_scan_{name}"
            else:
                lib = rescore.bind(ctypes.CDLL(path))

                def call():
                    status = rescore.launch(lib, qn, unit, ri, rs, k, pr, scr_r, s_r, r_r)
                    if status:
                        raise SystemExit(f"{tree} {name}: CUDA error {status}")
                key = f"rescore_{name}"
            out["ms"][key] = timer(call)
            cs.log(f"split {tree} {key}: {out['ms'][key]:.4f} ms")
            if name == "trace":
                out.setdefault("phases", {}).update(trace_phases(torch, lib, call, key))


def trace_phases(torch, lib, call, key) -> dict:
    """A trace build's phase stamps after one call (``G2V_TRACE``): for each
    kernel, the median over its blocks of the cycles from the block's first
    stamp to each later one, and the largest."""
    lib.g2v_trace_read.argtypes = [ctypes.c_void_p]
    buf = np.zeros((2, 1024, 8), dtype=np.int64)
    if lib.g2v_trace_clear():
        raise SystemExit(f"{key}: g2v_trace_clear failed")
    call()
    torch.cuda.synchronize()
    if lib.g2v_trace_read(buf.ctypes.data):
        raise SystemExit(f"{key}: g2v_trace_read failed")
    out = {}
    for k, kernel in enumerate(("list_select", "probe")):
        blocks = buf[k][buf[k][:, 0] != 0]
        if not len(blocks):
            continue
        rel = {p: [int(b[p] - b[0]) for b in blocks if b[p]] for p in range(1, 8)}
        out[f"{key}:{kernel}"] = {
            "blocks": len(blocks),
            "median_cycles": {p: float(np.median(v)) for p, v in rel.items() if v},
            "max_cycles": {p: int(max(v)) for p, v in rel.items() if v}}
    return out


def time_k13(torch, tree, built, timer, out):
    import chip_smoke as cs
    from gene2vec_tpu_torch.kernels import _args, lane

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    d, v = cs.LANE_D, cs.LANE_V
    with open(os.path.join(tree, CSRC, "k13_lane.cu")) as f:
        tiled = "int rows" in f.read()  # this design's entry points take the tile's rows
    patterns = {"random": torch.randint(0, lane.BUCKET, (8 * v // lane.BUCKET, lane.BUCKET),
                                        device=dev, generator=gen, dtype=torch.int32),
                "one_column": torch.full((8 * v // lane.BUCKET, lane.BUCKET), 5,
                                         dtype=torch.int32, device=dev)}
    cols = lane.global_columns(patterns["random"])
    sms = _args.sm_count(cols)
    for dtype in (torch.float32, torch.bfloat16):
        sfx = "_bf16" if dtype == torch.bfloat16 else ""
        t = torch.randn((d, v), device=dev, generator=gen).to(dtype)
        g = (torch.randn((d, v), device=dev, generator=gen) * 0.01).to(dtype)
        res = out["ms"][f"lane{sfx}"] = {
            "mul": timer(lambda: torch.mul(t, 1.0000001)),
            "index_select": timer(lambda: torch.index_select(t, 1, cols)),
            "index_add": timer(lambda: torch.index_add(t, 1, cols, g))}
        es = t.element_size()
        if tiled:
            res["plan_rows"] = {fn: lane.plan(fn, d, v, es, sms) for fn in ("gather", "scatter")}
        dst = torch.empty_like(t)
        for name, (paths, _) in built.items():
            lib = ctypes.CDLL(paths["k13_lane.cu"])
            n_int = 4 if tiled else 3  # D, V, bf16 (, rows)
            lib.k13_lane_gather.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * n_int + [
                ctypes.c_void_p]
            lib.k13_lane_scatter.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * n_int + [
                ctypes.c_void_p]
            for fn in ("gather", "scatter"):
                heights = [None]
                if tiled:
                    heights = [lane.plan(fn, d, v, es, sms)]
                    if name in ("full", "no_register_cap", "gather_one_stage"):
                        heights = [8, 16, 32, 64]
                for rows in heights:
                    extra = [] if rows is None else [rows]
                    for kind, offs in patterns.items():
                        if kind != "random" and (name != "full" or fn == "gather"):
                            continue
                        if fn == "gather":
                            def call():
                                return lib.k13_lane_gather(
                                    _args.ptr(t), _args.ptr(offs), _args.ptr(dst), d, v,
                                    int(es == 2), *extra, _args.stream(t))
                            want = lane.lane_gather_plain(t, offs)
                        else:
                            def call():
                                return lib.k13_lane_scatter(
                                    _args.ptr(t), _args.ptr(g), _args.ptr(offs), _args.ptr(dst),
                                    d, v, int(es == 2), *extra, _args.stream(t))
                            want = lane.lane_scatter_plain(t, g, offs)
                        status = call()
                        if status == 1 and rows != heights[0]:
                            break  # cudaErrorInvalidValue: a height the kernel does not take
                        if status:
                            raise SystemExit(f"{tree} {name} {fn}{sfx} rows {rows}: CUDA error")
                        torch.cuda.synchronize()
                        if name == "full" and not cs.same_bits(torch, dst, want):
                            raise SystemExit(f"{tree} {fn}{sfx} rows {rows} {kind}: not "
                                             f"bitwise its plain version")
                        key = f"{fn}_{name}" + (f"_rows{rows}" if len(heights) > 1 else "") + (
                            f"_{kind}" if kind != "random" else "")
                        res[key] = timer(call)
        cs.log(f"split {tree} lane{sfx}: {res}")


def tsne_inputs(torch):
    """Phase 7c's t-SNE inputs at N = 24,447 (``chip_smoke.pipeline_tsne``'s
    clustered table, PCA 50): the squared distances, P of this checkout's
    calibration, and a layout, its velocity and gains 20 iterations in."""
    import chip_smoke as cs
    from gene2vec_tpu_torch.kernels import tsne_calibrate as kc
    from gene2vec_tpu_torch.kernels import tsne_step as ks
    from gene2vec_tpu_torch.viz import tsne as viz

    emb, _ = cs.clustered_table(v=cs.V)
    d2 = viz._squared_distances(torch.from_numpy(viz.pca_reduce(emb, 50)).to("cuda"))
    p = kc.calibrate(d2, cs.TSNE_PERPLEXITY)
    y = torch.from_numpy((np.random.RandomState(0).randn(cs.V, 2) * 1e-4).astype(np.float32))
    y = y.to("cuda")
    vel, gains = torch.zeros_like(y), torch.ones_like(y)
    ws = ks.workspace(cs.V, y.device)
    for _ in range(20):
        ks.step_(p, y, vel, gains, 12.0, 0.5, 200.0, ws)
    torch.cuda.synchronize()
    return d2, p, y, vel, gains


def p_layout(torch, p, pitched: bool):
    """P as a design takes it: rows contiguous (the first design) or an
    (N, N) view of rows padded to a multiple of 32 floats."""
    n = p.shape[0]
    if not pitched:
        return p.contiguous()
    pitch = -(-n // 32) * 32
    if p.stride() == (pitch, 1):
        return p
    buf = torch.zeros((n, pitch), dtype=p.dtype, device=p.device)
    buf[:, :n] = p
    return buf[:, :n]


def time_k10(torch, tree, built, timer, out):
    import chip_smoke as cs
    from gene2vec_tpu_torch.kernels import _args

    _, p, y0, vel0, gains0 = tsne_inputs(torch)
    n = y0.shape[0]
    for name, (paths, _) in built.items():
        lib = ctypes.CDLL(paths["k10_tsne_step.cu"])
        first = not hasattr(lib, "k10_grid")
        pv = p_layout(torch, p, not first)
        y, vel, gains = y0.clone(), vel0.clone(), gains0.clone()
        P, I, F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        fn = lib.k10_tsne_step
        fn.restype = I
        if first:
            fn.argtypes = [P, P, P, P, I, F, F, F, P, P, P, P, P]
            rows = lib.k10_z_rows()
            scratch = (torch.empty((n, 2), device="cuda"),
                       torch.empty((-(-n // rows),), dtype=torch.float64, device="cuda"),
                       torch.zeros((1,), dtype=torch.int32, device="cuda"),
                       torch.empty((1,), device="cuda"))
            args = [_args.ptr(pv), _args.ptr(y), _args.ptr(vel), _args.ptr(gains), n, 1.0, 0.8,
                    200.0, *map(_args.ptr, scratch), _args.stream(y)]
        else:
            fn.argtypes = [P, I, P, P, P, I, F, F, F, P, P, P, I, P]
            lib.k10_grid.argtypes = [I]
            grid = lib.k10_grid(n)
            scratch = (torch.empty((n, 8), device="cuda"),
                       torch.empty((grid, 4), dtype=torch.float64, device="cuda"),
                       torch.zeros((2,), dtype=torch.int32, device="cuda"))
            args = [_args.ptr(pv), pv.stride(0), _args.ptr(y), _args.ptr(vel), _args.ptr(gains),
                    n, 1.0, 0.8, 200.0, *map(_args.ptr, scratch), grid, _args.stream(y)]

        def call():
            status = fn(*args)
            if status:
                raise SystemExit(f"{tree} k10 {name}: CUDA error {status}")

        out["ms"][name] = timer(call)
        out.setdefault("launch_ms", {})[name] = cs.device_breakdown(torch, call)
        cs.log(f"split {tree} k10 {name}: {out['ms'][name]:.4f} ms, by launch "
               f"{out['launch_ms'][name]}")
        del pv


def time_k10c(torch, tree, built, timer, out):
    import chip_smoke as cs
    from gene2vec_tpu_torch.kernels import _args
    from gene2vec_tpu_torch.kernels.tsne_calibrate import target_entropy

    d2, p, _, _, _ = tsne_inputs(torch)
    del p
    n = d2.shape[0]
    target = target_entropy(cs.TSNE_PERPLEXITY)
    P, I, L, F = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_float
    with open(os.path.join(tree, CSRC, "k10c_tsne_calibrate.cu")) as f:
        first = "K10C_EARLY_EXIT" not in f.read()  # the first design: no row pitch
    for name, (paths, _) in built.items():
        lib = ctypes.CDLL(paths["k10c_tsne_calibrate.cu"])
        cal, sym = lib.k10c_calibrate_rows, lib.k10c_symmetrize
        cal.restype = sym.restype = I
        pitch = n if first else -(-n // 32) * 32
        buf = torch.empty((n, pitch), device="cuda")
        if first:
            cal.argtypes = [P, I, I, L, F, I, I, P, P]
            sym.argtypes = [P, I, P]
            extra = [_args.ptr(buf)]
            sym_args = [_args.ptr(buf), n, _args.stream(d2)]
        else:
            cal.argtypes = [P, I, I, L, F, I, I, P, I, P, P]
            sym.argtypes = [P, I, I, P]
            extra = [_args.ptr(buf), pitch, None]
            sym_args = [_args.ptr(buf), n, pitch, _args.stream(d2)]

        def call():  # the staged route, the main path's at this width
            status = cal(_args.ptr(d2), n, n, 0, target, 50, 1, *extra, _args.stream(d2))
            if status:
                raise SystemExit(f"{tree} k10c {name}: CUDA error {status}")

        out["ms"][f"conditional_{name}"] = timer(call)
        # P_cond's bits summed as integers: equal sums across builds and
        # trees say the conditionals agree bit for bit
        out.setdefault("pcond_bits", {})[name] = int(
            buf[:, :n].contiguous().view(torch.int32).to(torch.int64).sum())

        def call_sym():
            status = sym(*sym_args)
            if status:
                raise SystemExit(f"{tree} k10c {name} symmetrize: CUDA error {status}")

        out["ms"][f"symmetrize_{name}"] = timer(call_sym)
        cs.log(f"split {tree} k10c {name}: "
               f"{ {k: v for k, v in out['ms'].items() if k.endswith(name)} }")
        del buf


#: the first tree's full-build words by study size (``time_k11``): each
#: later tree is held to them bit for bit
_K11_FIRST: dict = {}


def time_k11(torch, tree, built, timer, out):
    import chip_smoke as cs
    from gene2vec_tpu_torch.kernels import _args
    from gene2vec_tpu_torch.kernels import coexpr_mask as cm

    with open(os.path.join(tree, CSRC, "k11_coexpr_mask.cu")) as f:
        first = "int pitch" not in f.read()  # the first design: z as it is, thr
    P, I, F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    g, thr = cs.V, cs.PIPE_THR
    words = cm.words_per_row(g)
    out["words_sha256"], out["bitwise"] = {}, {}
    for n in (cs.K11_MAIN_N, 24):
        z = cs.k11_study(torch, n).float().contiguous()
        pitch = g if first else cm.row_pitch(g)
        zp = torch.zeros((n, pitch), device="cuda")
        zp[:, :g] = z
        res = out["ms"][f"n{n}"] = {
            "bound_ms": cs.bound(n * g * 4 + g * words * 4, float(g) * (g + 1) * n)[0]}
        dst = torch.empty((g, words), dtype=torch.int32, device="cuda")
        for name, (paths, _) in built.items():
            fn = ctypes.CDLL(paths["k11_coexpr_mask.cu"]).k11_coexpr_mask
            fn.restype = I
            if first:
                fn.argtypes = [P, I, I, F, P, P]
                args = [_args.ptr(zp), n, g, thr, _args.ptr(dst), _args.stream(z)]
            else:
                fn.argtypes = [P, I, I, I, F, P, P]
                cut = thr if name == "div_epilogue" else cm.sum_threshold(n, thr)
                args = [_args.ptr(zp), pitch, n, g, cut, _args.ptr(dst), _args.stream(z)]

            def call():
                status = fn(*args)
                if status:
                    raise SystemExit(f"{tree} k11 {name} n {n}: CUDA error {status}")

            dst.zero_()
            call()
            torch.cuda.synchronize()
            if name in ("full", "div_epilogue", "single_buffer"):
                key = f"n{n}_{name}"
                out["words_sha256"][key] = hashlib.sha256(
                    dst.cpu().numpy().tobytes()).hexdigest()[:16]
                if name == "full" and n not in _K11_FIRST:
                    _K11_FIRST[n] = dst.clone()
                out["bitwise"][key] = bool(torch.equal(dst, _K11_FIRST[n]))
            res[name] = timer(call)
        cs.log(f"split {tree} k11 n {n}: {res}, bitwise {out['bitwise']}")
        del z, zp, dst


def dump_sass(tree, built, kernel, out) -> None:
    """Each build's SASS (``cuobjdump -sass``) into ``chip_smoke_sass/`` at
    the root of this checkout (git ignores it), with its instruction count
    by kernel in ``out["sass"]``."""
    from gene2vec_tpu_torch.kernels import build as kb

    tool = os.path.join(os.path.dirname(kb.nvcc_path()), "cuobjdump")
    dest = os.path.join(ROOT, "chip_smoke_sass")
    os.makedirs(dest, exist_ok=True)
    tag = os.path.basename(os.path.abspath(tree)) or "tree"
    for name, (paths, _) in built.items():
        for src_name, path in paths.items():
            text = subprocess.run([tool, "-sass", path], capture_output=True, text=True).stdout
            with open(os.path.join(dest, f"{tag}_{kernel}_{name}_{src_name[:-3]}.sass"),
                      "w") as f:
                f.write(text)
            counts, fn = {}, None
            for line in text.splitlines():
                m = re.search(r"Function : (\S+)", line)
                if m:
                    fn = kernel_name(m.group(1)) or m.group(1)[:60]
                elif fn and re.match(r"\s+/\*[0-9a-f]{4}\*/", line):
                    counts[fn] = counts.get(fn, 0) + 1
            out.setdefault("sass", {})[name] = counts


TIMERS = {"k5": time_k5, "k9": time_k9, "k10": time_k10, "k10c": time_k10c,
          "k11": time_k11, "k12": time_k12, "k13": time_k13}


def run_tree(torch, tree: str, kernel: str, reps: int) -> dict:
    import chip_smoke as cs

    out = {"tree": os.path.abspath(tree), "kernel": kernel, "ms": {}, "regs": {}}
    with tempfile.TemporaryDirectory(prefix="chip_smoke_split_", dir=ROOT) as work:
        built = build(tree, kernel, work)
        out["skipped"] = sorted(set(VARIANTS[kernel][1]) - set(built))
        out["regs"] = {name: regs for name, (_, regs) in built.items()}
        TIMERS[kernel](torch, tree, built, cs.Timer(torch, reps), out)
        if kernel in ("k10", "k10c", "k11"):
            dump_sass(tree, built, kernel, out)
    return out


def main() -> int:
    import torch

    args = sys.argv[1:]
    kernel = "k5"
    if args[:1] == ["--kernel"]:
        kernel, args = args[1], args[2:]
    if kernel not in VARIANTS:
        raise SystemExit(f"kernel_split: --kernel takes one of {sorted(VARIANTS)}")
    if not torch.cuda.is_available():
        print("kernel_split: no CUDA device available", file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    import chip_smoke as cs

    smi = cs.nvidia_smi_line()
    for tree in args or [ROOT]:
        rec = run_tree(torch, tree, kernel, cs.TIMED_REPS)
        rec["card"] = smi
        print(json.dumps({"split": rec}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
