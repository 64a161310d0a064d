"""Build and load the port's CUDA kernels (the training steps' K1-K6, the
serving kernels K7-K9r, t-SNE's K10c/K10, the co-expression mask K11,
the probes' counterparts K12-K14 and UMAP's K15/K16).

Each ``csrc/*.cu`` compiles with ``nvcc`` for ``sm_90a`` into its own
shared library with a plain C interface, loaded with ``ctypes``.  Builds
happen at first use — never at import — into ``kernels/_build/`` (listed
in ``.gitignore``), named by a hash of the sources and flags so an edited
source rebuilds.  :func:`build_all` starts one ``nvcc`` per source, all
at once, and waits for them together.  The process keeps a tally of its
compile events from its start (:func:`compile_events`): each ``nvcc``
run and each library opened, which ``obs/probes.py:CompileWatcher``
reads.

    python -m gene2vec_tpu_torch.kernels.build    # build all, print paths
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import sys
import threading
import time
from typing import Dict

CSRC = os.path.join(os.path.dirname(os.path.abspath(__file__)), "csrc")
BUILD_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), "_build")

#: library name → source file under csrc/
SOURCES = {
    "k1_pos_logit": "k1_pos_logit.cu",
    "k2_noise_head": "k2_noise_head.cu",
    "k3_noise_tail": "k3_noise_tail.cu",
    "k4_row_update": "k4_row_update.cu",
    "k5_per_example": "k5_per_example.cu",
    "k5_shared": "k5_shared.cu",
    "k6_hs": "k6_hs.cu",
    "k7_topk_exact": "k7_topk_exact.cu",
    "k8_quant_scan": "k8_quant_scan.cu",
    "k9_ivf_scan": "k9_ivf_scan.cu",
    "k9r_rescore": "k9r_rescore.cu",
    "k10c_tsne_calibrate": "k10c_tsne_calibrate.cu",
    "k10_tsne_step": "k10_tsne_step.cu",
    "k11_coexpr_mask": "k11_coexpr_mask.cu",
    "k12_stream_scale": "k12_stream_scale.cu",
    "k13_lane": "k13_lane.cu",
    "k14_staged_copy": "k14_staged_copy.cu",
    "k15_umap_graph": "k15_umap_graph.cu",
    "k16_umap_step": "k16_umap_step.cu",
}

NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
    "-Xptxas", "-v",
]

_lock = threading.Lock()
_libs: Dict[str, ctypes.CDLL] = {}
#: wall seconds this process has spent in :func:`build_all` compiling
_built = [0.0]
#: compile events since the process started: ``nvcc`` runs and libraries opened
_events: Dict[str, int] = {"nvcc_build": 0, "library_load": 0}
_events_lock = threading.Lock()


def _count(kind: str) -> None:
    with _events_lock:
        _events[kind] += 1


def nvcc_path() -> str:
    for cand in (
        os.path.join(os.environ.get("CUDA_HOME", ""), "bin", "nvcc"),
        "/usr/local/cuda/bin/nvcc",
        shutil.which("nvcc") or "",
    ):
        if cand and os.path.isfile(cand):
            return cand
    raise RuntimeError("nvcc not found (set CUDA_HOME or put nvcc on PATH)")


def _digest() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for name in sorted(os.listdir(CSRC)):
        with open(os.path.join(CSRC, name), "rb") as f:
            h.update(name.encode() + b"\0" + f.read())
    return h.hexdigest()[:12]


def lib_path(name: str) -> str:
    return os.path.join(BUILD_DIR, f"{name}-{_digest()}.so")


def build_all(verbose: bool = False) -> Dict[str, str]:
    """Compile every source that has no library for the current sources
    yet, one ``nvcc`` process per source, all started together.  Returns
    {name: library path}.  The compiler's resource report (``-Xptxas -v``)
    lands beside each library as ``<name>.log``."""
    os.makedirs(BUILD_DIR, exist_ok=True)
    nvcc = nvcc_path()
    t0 = time.perf_counter()
    procs = {}
    for name, src in SOURCES.items():
        out = lib_path(name)
        if os.path.exists(out):
            continue
        tmp = f"{out}.tmp{os.getpid()}"
        cmd = [nvcc, *NVCC_FLAGS, "-I", CSRC, "-o", tmp, os.path.join(CSRC, src)]
        procs[name] = (subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True
        ), tmp, out)
    failed = []
    for name, (proc, tmp, out) in procs.items():
        log, _ = proc.communicate()
        _count("nvcc_build")
        with open(os.path.join(BUILD_DIR, f"{name}.log"), "w") as f:
            f.write(log)
        if verbose and log:
            print(f"[{name}]\n{log}", file=sys.stderr)
        if proc.returncode != 0:
            failed.append(f"{name} (nvcc exit {proc.returncode}):\n{log}")
            if os.path.exists(tmp):
                os.unlink(tmp)
            continue
        os.replace(tmp, out)
    if procs:
        _built[0] += time.perf_counter() - t0
    if failed:
        raise RuntimeError("kernel build failed: " + "\n".join(failed))
    return {name: lib_path(name) for name in SOURCES}


def build_seconds() -> float:
    """Wall seconds this process has spent compiling kernels so far (the
    profiler's ``compile_s`` is its growth over one call)."""
    return _built[0]


def compile_events() -> Dict[str, int]:
    """This process's compile events so far: ``nvcc_build`` (each ``nvcc``
    that :func:`build_all` ran) and ``library_load`` (each library that
    :func:`load` opened).  A warm launch adds to neither."""
    with _events_lock:
        return dict(_events)


def load(name: str) -> ctypes.CDLL:
    """The loaded library ``name``, building all of them at first use."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            path = lib_path(name)
            if not os.path.exists(path):
                build_all()
            lib = ctypes.CDLL(path)
            _count("library_load")
            lib.g2v_error_string.restype = ctypes.c_char_p
            lib.g2v_error_string.argtypes = [ctypes.c_int]
            _libs[name] = lib
        return lib


def check(lib: ctypes.CDLL, status: int, what: str) -> None:
    """Raise if a C entry point returned a CUDA error code."""
    if status != 0:
        msg = lib.g2v_error_string(status).decode()
        raise RuntimeError(f"{what}: CUDA error {status} ({msg})")


if __name__ == "__main__":
    for n, p in build_all(verbose=True).items():
        print(n, p)
