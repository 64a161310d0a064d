#!/usr/bin/env python3
"""Where a kernel's time goes, by builds with one part changed or compiled out.

    python3 kernel_split.py [--kernel k5|k9|k12|k13] [TREE ...]   # on a machine with a CUDA card

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
"""

from __future__ import annotations

import ctypes
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


TIMERS = {"k5": time_k5, "k9": time_k9, "k12": time_k12, "k13": time_k13}


def run_tree(torch, tree: str, kernel: str, reps: int) -> dict:
    import chip_smoke as cs

    out = {"tree": os.path.abspath(tree), "kernel": kernel, "ms": {}, "regs": {}}
    with tempfile.TemporaryDirectory(prefix="chip_smoke_split_", dir=ROOT) as work:
        built = build(tree, kernel, work)
        out["skipped"] = sorted(set(VARIANTS[kernel][1]) - set(built))
        out["regs"] = {name: regs for name, (_, regs) in built.items()}
        TIMERS[kernel](torch, tree, built, cs.Timer(torch, reps), out)
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
