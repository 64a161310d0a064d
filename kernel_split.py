#!/usr/bin/env python3
"""Where a training kernel's time goes, by builds with parts compiled out.

    python3 kernel_split.py [TREE ...]     # on a machine with a CUDA card

For K5a (``csrc/k5_per_example.cu``) of each checkout given (default:
this one), builds its source as it is and with parts removed (the edits
below, matched by text, so a variant that does not apply to a tree's
source is skipped and says so; ``no_hot_rows`` sends every payload to
global atomics), loads each build with ctypes and times
it with ``chip_smoke.Timer`` (CUDA events, L2 flushed, median) at the
default configuration's full width (E = 8192, K = 5, D = 200), on the
same inputs ``chip_smoke.objective_kernel_check`` makes, at float32 and
bfloat16 tables.  The full build is also timed with uniform draws in
place of the alias draws: equal times say the hottest rows' atomics do
not contend.  A build with a part removed computes a wrong result; it is
timed, never checked.  One ``{"split": ...}`` line per tree on stdout,
with each build's registers (``ptxas -v``) and the card's name and power
limit.
"""

from __future__ import annotations

import ctypes
import json
import os
import re
import subprocess
import sys
import tempfile

ROOT = os.path.dirname(os.path.abspath(__file__))
SRC = os.path.join("gene2vec_tpu_torch", "kernels", "csrc", "k5_per_example.cu")

_DRAWS = ("add_hot(hot, n[k], D, vs, g[k], 1.0f, lane);", ";"), \
    ("add_payload(acc, n[k], D, vs, g[k], 1.0f, lane);", ";")
_CONTEXTS = ("add_hot(hot, c, D, vs, gp, 1.0f, lane);", ";"), \
    ("add_payload(acc, c, D, vs, gp, 1.0f, lane);", ";")
_SCALAR_PAYLOADS = ("atomicAdd(&acc[static_cast<size_t>(nk[k]) * D1 + d], __fmul_rn(gk[k], vd));",
                    ";")

#: variant → [(text, replacement)]; the first design (a column a lane,
#: scalar atomics, each noise row read twice) and the register design
#: name their parts differently
VARIANTS = {
    "no_payload_atomics": [_SCALAR_PAYLOADS],  # first design: the draws' g·v atomics
    "no_atomics": [  # first design: every atomic (payloads and counts)
        _SCALAR_PAYLOADS,
        ("atomicAdd(&acc[static_cast<size_t>(nk[k]) * D1 + D], 1.0f);", ";")],
    "no_noise_scatter": [*_DRAWS],  # the draws' payloads
    "no_context_scatter": [*_CONTEXTS],  # the positive contexts' payloads
    "no_scatter": [*_DRAWS, *_CONTEXTS],
    "no_hot_rows": [  # every payload by global atomics, none summed in shared memory
        ("if (n[k] < kHot) {", "if (false) {"), ("if (c < kHot) {", "if (false) {")],
}


def build(tree: str, work: str) -> dict:
    """{variant: (library path, registers by kernel)}, built in parallel."""
    from gene2vec_tpu_torch.kernels import build as kb

    csrc = os.path.join(tree, os.path.dirname(SRC))
    with open(os.path.join(tree, SRC)) as f:
        text = f.read()
    sources = {"full": text}
    for name, edits in VARIANTS.items():
        out = text
        if all(old in out for old, _ in edits):
            for old, new in edits:
                out = out.replace(old, new)
            sources[name] = out
    procs = {}
    for name, body in sources.items():
        src = os.path.join(work, f"k5_{name}.cu")
        with open(src, "w") as f:
            f.write(body)
        lib = os.path.join(work, f"k5_{name}.so")
        procs[name] = (lib, subprocess.Popen(
            [kb.nvcc_path(), *kb.NVCC_FLAGS, "-I", csrc, "-o", lib, src],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    built = {}
    for name, (lib, proc) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise SystemExit(f"{tree} {name}: nvcc exit {proc.returncode}\n{log}")
        regs = {}
        fn = None
        for line in log.splitlines():
            m = re.search(r"Compiling entry function '\S*?(per_example\w*kernel)I(\S*?)EEv", line)
            if m:
                fn = f"{m.group(1)}<{m.group(2)}>"
            m = re.search(r"Used (\d+) registers", line)
            if m and fn:
                regs[fn] = int(m.group(1))
        built[name] = (lib, regs)
    return built


def run_tree(torch, tree: str, reps: int) -> dict:
    import chip_smoke as cs
    from gene2vec_tpu_torch.data.negative_sampling import (
        build_alias_table, noise_distribution, sample_negatives)
    from gene2vec_tpu_torch.kernels import _args
    from gene2vec_tpu_torch.kernels.pos_logit import pos_logit_plain

    dev = torch.device("cuda")
    timer = cs.Timer(torch, reps)
    out = {"tree": os.path.abspath(tree), "ms": {}, "regs": {}}
    with tempfile.TemporaryDirectory(prefix="chip_smoke_split_", dir=ROOT) as work:
        built = build(tree, work)
        out["skipped"] = sorted(set(VARIANTS) - set(built))
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
            for name, (path, regs) in built.items():
                lib = ctypes.CDLL(path)
                fn = lib.k5_per_example
                fn.argtypes = [ctypes.c_void_p] * 9 + [ctypes.c_int] * 4 + [ctypes.c_void_p]
                fn.restype = ctypes.c_int
                out["regs"][name] = regs
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
    return out


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("kernel_split: no CUDA device available", file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    import chip_smoke as cs

    smi = cs.nvidia_smi_line()
    for tree in sys.argv[1:] or [ROOT]:
        rec = run_tree(torch, tree, cs.TIMED_REPS)
        rec["card"] = smi
        print(json.dumps({"split": rec}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
