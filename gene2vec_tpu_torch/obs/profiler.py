"""Kernel cost attribution: rooflines for the port's hot paths — the port
of ``gene2vec_tpu/obs/profiler.py``.

A :class:`KernelProfiler` names the hot paths (the SGNS epoch step, the
CBOW-HS epoch step, the GGIPNN step, each serve top-k bucket per index
mode) and records, per name:

* **static cost** — the operations and bytes the kernels' functions need,
  summed from each kernel module's ``work`` counts (the reference reads
  XLA's cost analysis, which has no torch counterpart); the seconds of
  the kernels' first-use ``nvcc`` build that the attributed call
  triggered (``compile_s``, 0 once built; ``lower_s`` is null: there is
  no lowering step) and ``torch.cuda.max_memory_allocated`` over that
  call;
* **dynamic throughput** — wall time of timed executions
  (:meth:`KernelProfiler.observe`; :meth:`KernelProfiler.measure` times
  with CUDA events and a synchronize, not ``torch.profiler``, which saw
  no time of K10's cooperative launch in some runs), from which achieved
  FLOP/s and bytes/s follow;
* **roofline position** — achieved against a per-backend peak table
  (:func:`peak_table`): the H100's data sheet on the card, conservative
  constants on the CPU and on anything unknown, each labelled.

:func:`bound` is the least time an H100 could take for a work dict: the
larger of its bytes over the HBM rate and its operations over the peak
rate for their type (float32 SIMT, int8 / bf16 / TF32 tensor cores), the
special-function unit's operations (ex2, rcp, rsqrt) taken beside the
rest since that unit issues alongside the FMA pipes.  :func:`utilization`
holds a timed call to the same sum.

Records flow to ``kernels.jsonl`` in the run dir (one JSON object per
name, schema :data:`RECORD_SCHEMA`) and, with a registry attached, to
``kernel_*`` gauges labelled by name — so ``metrics.prom`` and the serve
``/metrics`` endpoint carry the same numbers.

Attribution is warm-time by design: ``attribute`` runs once per name,
``observe`` is one float add per epoch or batch of executions and never
runs inside a step.
"""

from __future__ import annotations

import json
import os
import time
from typing import Callable, Dict, List, Optional, Sequence

KERNELS_LOG_NAME = "kernels.jsonl"

#: informational — the fields every kernels.jsonl record carries
RECORD_SCHEMA = (
    "name", "flops", "bytes_accessed", "peak_memory_bytes",
    "lower_s", "compile_s", "calls", "wall_s", "best_wall_s",
    "achieved_flops_per_sec", "achieved_bytes_per_sec",
    "flops_util", "bytes_util", "utilization", "bound", "backend",
)

# -- peak tables ---------------------------------------------------------------

#: conservative single-core-ish CPU ceilings (the reference's): utilization
#: against these reads optimistic on a big server, the safe direction for a
#: regression gate
CPU_PEAK_FLOPS = 5.0e10
CPU_PEAK_BYTES = 2.0e10

# one NVIDIA H100 SXM (data sheet; dense rates, the 700 W power limit)
HBM_BYTES_PER_S = 3.35e12   # HBM3
F32_FLOP_PER_S = 67e12      # float32, outside the tensor cores
INT8_OP_PER_S = 1979e12     # int8 tensor cores, dense
BF16_FLOP_PER_S = 989e12    # bf16 tensor cores, dense
TF32_FLOP_PER_S = 495e12    # tf32 tensor cores, dense
# the special-function unit (MUFU: ex2, rcp, rsqrt): 16 lanes a clock on each
# of the 132 SMs at the 1.98 GHz boost clock (CUDA programming guide's
# arithmetic-instruction throughput table for compute capability 9.0)
SFU_OP_PER_S = 16 * 132 * 1.98e9

#: the operation types of a work dict, in the order :func:`op_seconds` sums
#: them (the special-function unit's last, taken beside the sum)
OP_KEYS = ("flops", "int8_ops", "bf16_ops", "tf32_ops", "sfu_ops")

H100_PEAKS = {
    "peak_flops_per_sec": F32_FLOP_PER_S,
    "peak_bytes_per_sec": HBM_BYTES_PER_S,
    "peak_int8_ops_per_sec": INT8_OP_PER_S,
    "peak_bf16_ops_per_sec": BF16_FLOP_PER_S,
    "peak_tf32_ops_per_sec": TF32_FLOP_PER_S,
    "peak_sfu_ops_per_sec": SFU_OP_PER_S,
}

#: per-card peaks keyed by a substring of ``torch.cuda.get_device_name()``
#: (lower case): the data sheet's SXM part, whose 80 GB HBM3 card names
#: itself "NVIDIA H100 80GB HBM3".  No rate of any TPU is the card's.
GPU_DEVICE_PEAKS = {
    "h100 80gb hbm3": H100_PEAKS,
    "h100 sxm": H100_PEAKS,
}


def backend_facts(device=None) -> Dict[str, Optional[str]]:
    """``{"platform", "device_kind"}``: ``cpu`` when ``device`` is the CPU,
    else the card's (``gpu``, ``torch.cuda.get_device_name``), or Nones
    when there is no card (never raises)."""
    try:
        import torch

        dev = torch.device(device) if device is not None else None
        if dev is not None and dev.type == "cpu":
            return {"platform": "cpu", "device_kind": "cpu"}
        if torch.cuda.is_available():
            return {"platform": "gpu", "device_kind": str(torch.cuda.get_device_name(dev))}
    except Exception:
        pass
    return {"platform": None, "device_kind": None}


def peak_table(platform: Optional[str] = None, device_kind: Optional[str] = None) -> Dict:
    """Per-backend peak rates: ``{"peak_flops_per_sec", "peak_bytes_per_sec",
    "provenance", ...}``.

    * CPU → conservative constants (``provenance="cpu-conservative"``);
    * a known card → its data sheet's rates (``"gpu-device-facts"``), with
      the tensor cores' and the special-function unit's rates beside the
      float32 one;
    * anything else (an unknown card or backend, no backend) → the
      conservative constants labelled ``"unknown-conservative"``, so a
      record is honest about what its utilization means.
    """
    if platform is None and device_kind is None:
        facts = backend_facts()
        platform, device_kind = facts["platform"], facts["device_kind"]
    plat = (platform or "").lower()
    kind = (device_kind or "").lower()
    if plat == "cpu":
        return {"peak_flops_per_sec": CPU_PEAK_FLOPS, "peak_bytes_per_sec": CPU_PEAK_BYTES,
                "provenance": "cpu-conservative"}
    if plat == "gpu":
        for key in sorted(GPU_DEVICE_PEAKS, key=len, reverse=True):
            if key in kind:
                return {**GPU_DEVICE_PEAKS[key], "provenance": "gpu-device-facts"}
    return {"peak_flops_per_sec": CPU_PEAK_FLOPS, "peak_bytes_per_sec": CPU_PEAK_BYTES,
            "provenance": "unknown-conservative"}


# -- work → time ---------------------------------------------------------------


def op_seconds(work: Dict, peaks: Dict = H100_PEAKS) -> float:
    """Seconds the operations of ``work`` take at ``peaks``: each type's
    count over its peak rate, summed — float32, int8, bf16, TF32 — and the
    special-function unit's beside that sum (the larger of the two).  A
    table without a type's rate counts it at the float32 rate."""
    pf = peaks["peak_flops_per_sec"]
    t = (work.get("flops", 0.0) / pf
         + work.get("int8_ops", 0.0) / (peaks.get("peak_int8_ops_per_sec") or pf)
         + work.get("bf16_ops", 0.0) / (peaks.get("peak_bf16_ops_per_sec") or pf)
         + work.get("tf32_ops", 0.0) / (peaks.get("peak_tf32_ops_per_sec") or pf))
    return max(work.get("sfu_ops", 0.0) / (peaks.get("peak_sfu_ops_per_sec") or pf), t)


def bound(work: Dict, peaks: Dict = H100_PEAKS):
    """(ms, "bytes" | "operations"): the least time for ``work`` — the
    larger of its bytes over the memory rate and :func:`op_seconds`."""
    t_bytes = work.get("bytes", 0.0) / peaks["peak_bytes_per_sec"]
    t_ops = op_seconds(work, peaks)
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations")


def add_work(total: Dict, work: Dict) -> Dict:
    """Adds each count of ``work`` into ``total`` (in place); returns it."""
    for k, v in work.items():
        total[k] = total.get(k, 0) + v
    return total


def costs(work: Dict) -> Dict:
    """The record fields of a work dict: ``flops`` (every operation type
    summed) and ``bytes_accessed``."""
    return {"flops": float(sum(work.get(k, 0.0) for k in OP_KEYS)),
            "bytes_accessed": float(work.get("bytes", 0.0))}


def utilization(flops: Optional[float], bytes_accessed: Optional[float],
                wall_s: Optional[float], peaks: Dict, ops: Optional[Dict] = None) -> Dict:
    """Roofline position of one timed execution: achieved rates, their
    share of the peak table, and the wall the path leans on
    (``bound="compute"`` when the operations' share dominates, else
    ``"memory"``).  Utilization is the larger share, the roofline
    convention.  With ``ops`` (the operation counts by type) the
    operations' share is :func:`op_seconds` over the wall, the sum
    :func:`bound` takes, so tensor-core work is held to its own rate."""
    out: Dict = {"achieved_flops_per_sec": None, "achieved_bytes_per_sec": None,
                 "flops_util": None, "bytes_util": None, "utilization": None,
                 "bound": None}
    if not wall_s or wall_s <= 0:
        return out
    if flops is not None:
        out["achieved_flops_per_sec"] = flops / wall_s
        pf = peaks.get("peak_flops_per_sec")
        if ops:
            out["flops_util"] = op_seconds(ops, peaks) / wall_s
        elif pf:
            out["flops_util"] = out["achieved_flops_per_sec"] / pf
    if bytes_accessed is not None:
        out["achieved_bytes_per_sec"] = bytes_accessed / wall_s
        pb = peaks.get("peak_bytes_per_sec")
        if pb:
            out["bytes_util"] = out["achieved_bytes_per_sec"] / pb
    fu, bu = out["flops_util"], out["bytes_util"]
    if fu is not None or bu is not None:
        out["utilization"] = max(fu or 0.0, bu or 0.0)
        out["bound"] = "compute" if (fu or 0.0) >= (bu or 0.0) else "memory"
    return out


def _on_card(device) -> bool:
    import torch

    if device is not None:
        return torch.device(device).type == "cuda"
    return torch.cuda.is_available()


# -- the profiler --------------------------------------------------------------


class KernelProfiler:
    """Named hot-path attribution for one run.

    * :meth:`attribute` — one call of a hot path under a name, with its
      work counts: the build seconds it triggered and its peak memory.
    * :meth:`register_costs` — adopt costs a caller counted itself (the
      serve engine counts its buckets from shapes and launches nothing).
    * :meth:`observe` — account executed wall time to a name: one float
      add per call site, for per-epoch use.
    * :meth:`measure` — timed executions by CUDA events (host clock on the
      CPU), feeding :meth:`observe`.
    * :meth:`flush` — write ``kernels.jsonl`` and the ``kernel_*`` gauges.

    ``device`` is where the hot paths run (default: the card when there is
    one); the backend facts and peaks follow it unless given.
    """

    def __init__(self, run_dir: Optional[str] = None, registry=None,
                 peaks: Optional[Dict] = None, backend: Optional[Dict] = None,
                 device=None):
        self.run_dir = run_dir
        self.registry = registry
        self.device = device
        self.backend = dict(backend) if backend else backend_facts(device)
        self.peaks = dict(peaks) if peaks else peak_table(
            self.backend.get("platform"), self.backend.get("device_kind"))
        self._static: Dict[str, Dict] = {}
        self._ops: Dict[str, Dict] = {}
        self._calls: Dict[str, int] = {}
        self._wall: Dict[str, float] = {}
        self._best: Dict[str, float] = {}
        self._order: List[str] = []

    # -- registration ----------------------------------------------------------

    def _touch(self, name: str) -> None:
        if name not in self._order:
            self._order.append(name)


    def attribute(self, name: str, fn: Callable, args: Sequence = (),
                  kwargs: Optional[Dict] = None, work: Optional[Dict] = None) -> Dict:
        """Call ``fn(*args, **kwargs)`` once under ``name``, with ``work``
        (a work dict, the path's kernels' counts for this call) as its
        static cost: ``flops`` and ``bytes_accessed``, ``lower_s`` null,
        ``compile_s`` the seconds of kernel builds the call triggered and,
        on the card, ``peak_memory_bytes``.  Never raises: a call that
        fails still leaves a record, without ``compile_s``."""
        import torch

        from gene2vec_tpu_torch.kernels import build

        self._touch(name)
        rec: Dict = {"lower_s": None}
        if work is not None:
            self._ops[name] = {k: float(work.get(k, 0.0)) for k in OP_KEYS}
            rec.update(costs(work))
        try:
            card = _on_card(self.device)
            built = build.build_seconds()
            if card:
                torch.cuda.synchronize()
                torch.cuda.reset_peak_memory_stats()
            fn(*args, **(kwargs or {}))
            if card:
                torch.cuda.synchronize()
                rec["peak_memory_bytes"] = float(torch.cuda.max_memory_allocated())
            rec["compile_s"] = build.build_seconds() - built
        except Exception:
            pass
        self._static[name] = {**self._static.get(name, {}), **rec}
        return dict(self._static[name])

    def register_costs(self, name: str, costs: Dict) -> None:
        """Adopt static costs (flops / bytes_accessed / peak_memory_bytes /
        lower_s / compile_s) a caller counted for ``name``."""
        self._touch(name)
        merged = self._static.get(name, {})
        merged.update({k: v for k, v in costs.items() if v is not None})
        self._static[name] = merged

    # -- dynamic observation ---------------------------------------------------

    def observe(self, name: str, wall_s: float, calls: int = 1) -> None:
        """Account ``wall_s`` seconds of executed wall time covering
        ``calls`` executions of ``name``: the per-call best drives the
        roofline, the total the wall-share column."""
        if wall_s < 0:
            return
        self._touch(name)
        self._calls[name] = self._calls.get(name, 0) + int(calls)
        self._wall[name] = self._wall.get(name, 0.0) + float(wall_s)
        if calls > 0:
            per = float(wall_s) / calls
            prev = self._best.get(name)
            if prev is None or per < prev:
                self._best[name] = per

    def measure(self, name: str, fn: Callable, args: Sequence = (), iters: int = 3,
                warmup: int = 1) -> Optional[float]:
        """Run ``fn(*args)`` ``warmup`` + ``iters`` times, timing each timed
        call between two CUDA events and a synchronize (the host clock on
        the CPU) and feeding it to :meth:`observe`.  Returns the best
        per-call seconds (None when execution failed)."""
        try:
            import torch

            card = _on_card(self.device)
            for _ in range(max(warmup, 0)):
                fn(*args)
            if card:
                torch.cuda.synchronize()
            for _ in range(max(iters, 1)):
                if card:
                    a = torch.cuda.Event(enable_timing=True)
                    b = torch.cuda.Event(enable_timing=True)
                    a.record()
                    fn(*args)
                    b.record()
                    b.synchronize()
                    self.observe(name, a.elapsed_time(b) / 1e3)
                else:
                    t0 = time.perf_counter()
                    fn(*args)
                    self.observe(name, time.perf_counter() - t0)
            return self._best.get(name)
        except Exception:
            return None

    def attributed_seconds(self) -> Dict[str, float]:
        """Total observed wall seconds per name — the goodput ``compute``
        bucket's per-kernel breakdown feed."""
        return dict(self._wall)

    # -- records + flush -------------------------------------------------------

    def records(self) -> List[Dict]:
        """One merged record per name in registration order, with the
        roofline derived from the best observed per-call wall."""
        out = []
        for name in self._order:
            static = self._static.get(name, {})
            best = self._best.get(name)
            rec = {
                "name": name,
                "flops": static.get("flops"),
                "bytes_accessed": static.get("bytes_accessed"),
                "peak_memory_bytes": static.get("peak_memory_bytes"),
                "lower_s": static.get("lower_s"),
                "compile_s": static.get("compile_s"),
                "calls": self._calls.get(name, 0),
                "wall_s": round(self._wall.get(name, 0.0), 9),
                "best_wall_s": round(best, 9) if best is not None else None,
                "backend": {**self.backend, **self.peaks},
            }
            rec.update(utilization(rec["flops"], rec["bytes_accessed"], best, self.peaks,
                                   self._ops.get(name)))
            out.append(rec)
        return out

    def flush(self) -> List[Dict]:
        """Write ``kernels.jsonl`` into the run dir (atomic replace) and set
        the ``kernel_*`` gauges on the attached registry.  Returns the
        records written."""
        recs = self.records()
        if self.run_dir is not None and recs:
            path = os.path.join(self.run_dir, KERNELS_LOG_NAME)
            os.makedirs(self.run_dir, exist_ok=True)
            tmp = f"{path}.tmp.{os.getpid()}"
            with open(tmp, "w", encoding="utf-8") as f:
                for rec in recs:
                    f.write(json.dumps(rec, sort_keys=True) + "\n")
            os.replace(tmp, path)
        if self.registry is not None:
            stamp_records(self.registry, recs)
        return recs


#: record field → gauge name
GAUGES = (
    ("flops", "kernel_flops"),
    ("bytes_accessed", "kernel_bytes_accessed"),
    ("peak_memory_bytes", "kernel_peak_memory_bytes"),
    ("compile_s", "kernel_compile_seconds"),
    ("lower_s", "kernel_lower_seconds"),
    ("wall_s", "kernel_wall_seconds"),
    ("best_wall_s", "kernel_best_wall_seconds"),
    ("utilization", "kernel_utilization"),
)


#: the static fields, which the serve engine's bucket records carry
STATIC_FIELDS = ("flops", "bytes_accessed", "peak_memory_bytes", "compile_s", "lower_s")


def stamp_records(registry, records: List[Dict], fields: Sequence[str] = ()) -> None:
    """Export kernel records as ``kernel_*`` gauges labelled by name — the
    shape both run snapshots and the serve ``/metrics`` endpoint expose —
    of every field of :data:`GAUGES`, or of ``fields`` alone."""
    for rec in records:
        labels = {"kernel": str(rec["name"])}
        for field, metric in GAUGES:
            if fields and field not in fields:
                continue
            v = rec.get(field)
            if v is not None:
                registry.gauge(metric, labels=labels).set(float(v))


# -- reading back --------------------------------------------------------------


def read_kernels(run_dir: str) -> List[Dict]:
    """Parse ``kernels.jsonl`` from a run dir (one directory level down
    when the top level has none).  Malformed lines are skipped; a missing
    file is an empty list."""
    paths = [os.path.join(run_dir, KERNELS_LOG_NAME)]
    if not os.path.isfile(paths[0]) and os.path.isdir(run_dir):
        for entry in sorted(os.listdir(run_dir)):
            sub = os.path.join(run_dir, entry, KERNELS_LOG_NAME)
            if os.path.isfile(sub):
                paths.append(sub)
    out: List[Dict] = []
    for path in paths:
        if not os.path.isfile(path):
            continue
        try:
            with open(path, "r", encoding="utf-8") as f:
                for line in f:
                    line = line.strip()
                    if not line:
                        continue
                    try:
                        rec = json.loads(line)
                    except ValueError:
                        continue
                    if isinstance(rec, dict) and rec.get("name"):
                        out.append(rec)
        except OSError:
            continue
    return out


def _fmt_num(v: Optional[float]) -> str:
    if v is None:
        return "-"
    v = float(v)
    for div, suffix in ((1e12, "T"), (1e9, "G"), (1e6, "M"), (1e3, "k")):
        if abs(v) >= div:
            return f"{v / div:.2f}{suffix}"
    return f"{v:.3g}"


def _fmt_pct(v: Optional[float]) -> str:
    return "-" if v is None else f"{100.0 * float(v):.1f}%"


def format_kernels(records: List[Dict]) -> str:
    """Fixed-width roofline table over kernel records."""
    header = (f"{'kernel':<28} {'flops':>8} {'bytes':>8} {'best_ms':>9} "
              f"{'wall_s':>8} {'util':>7} {'bound':>7} {'compile_s':>9}")
    lines = [header, "-" * len(header)]
    for rec in records:
        best, wall, compile_s = rec.get("best_wall_s"), rec.get("wall_s"), rec.get("compile_s")
        best_ms = f"{1e3 * float(best):.3f}" if best is not None else "-"
        wall_str = f"{float(wall):.3f}" if wall is not None else "-"
        comp_str = f"{float(compile_s):.3f}" if compile_s is not None else "-"
        lines.append(
            f"{str(rec.get('name', '')):<28} "
            f"{_fmt_num(rec.get('flops')):>8} "
            f"{_fmt_num(rec.get('bytes_accessed')):>8} "
            f"{best_ms:>9} "
            f"{wall_str:>8} "
            f"{_fmt_pct(rec.get('utilization')):>7} "
            f"{str(rec.get('bound') or '-'):>7} "
            f"{comp_str:>9}"
        )
    if records:
        backend = records[0].get("backend") or {}
        prov = backend.get("provenance")
        if prov:
            lines.append(f"peaks: {_fmt_num(backend.get('peak_flops_per_sec'))}F/s "
                         f"{_fmt_num(backend.get('peak_bytes_per_sec'))}B/s ({prov})")
    return "\n".join(lines)


def kernel_summary(records: List[Dict], top: int = 5) -> Dict:
    """Compact per-kernel block for a run report: top names by observed
    wall share, with utilization and compile seconds."""
    total_wall = sum(float(r.get("wall_s") or 0.0) for r in records)
    total_compile = sum(float(r.get("compile_s") or 0.0) for r in records)
    ranked = sorted(records, key=lambda r: float(r.get("wall_s") or 0.0), reverse=True)
    rows = []
    for rec in ranked[: max(top, 1)]:
        wall = float(rec.get("wall_s") or 0.0)
        rows.append({
            "name": rec.get("name"),
            "wall_s": round(wall, 6),
            "wall_share": round(wall / total_wall, 4) if total_wall > 0 else 0.0,
            "utilization": rec.get("utilization"),
            "bound": rec.get("bound"),
            "compile_s": rec.get("compile_s"),
        })
    return {"kernels": len(records), "wall_s": round(total_wall, 6),
            "compile_s": round(total_compile, 6), "top": rows}
