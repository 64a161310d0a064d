"""Human-readable summary of any observed run directory — a copy of
``gene2vec_tpu/obs/report.py``.

``python -m gene2vec_tpu_torch.cli.obs report <run_dir>`` renders, from the
standard artifacts (``manifest.json`` + ``events.jsonl`` + optional
``kernels.jsonl``):

* the identity block — run name, config hash, git sha, backend, argv;
* per-phase wall time, aggregated over ``span_end`` events by name;
* throughput, from ``pairs``/``seconds`` span attrs when present;
* the goodput block of the manifest;
* peak device memory / host RSS / compile events across ``probe`` events;
* every ``stall`` event with the budget it broke;
* when the run attributed kernels (``kernels.jsonl``,
  :mod:`gene2vec_tpu_torch.obs.profiler`): the compact per-kernel block —
  top kernels by wall share with utilization and compile seconds
  (``cli.obs kernels`` renders the full roofline table).
"""

from __future__ import annotations

import collections
import json
import os
from typing import Dict, List

from gene2vec_tpu_torch.obs import profiler
from gene2vec_tpu_torch.obs.run import EVENTS_NAME, MANIFEST_NAME
from gene2vec_tpu_torch.obs.trace import read_events


def _fmt_s(s: float) -> str:
    if s >= 60:
        return f"{s / 60:.1f} min"
    if s >= 1:
        return f"{s:.2f} s"
    return f"{s * 1e3:.1f} ms"


def _fmt_bytes(b: float) -> str:
    for unit in ("B", "KiB", "MiB", "GiB", "TiB"):
        if abs(b) < 1024 or unit == "TiB":
            return f"{b:.1f} {unit}" if unit != "B" else f"{int(b)} B"
        b /= 1024
    return f"{b:.1f} TiB"


def load_run(run_dir: str) -> Dict:
    """Parsed artifacts: ``{"manifest": ..., "events": [...]}`` (either
    may be empty when the file is absent)."""
    manifest: Dict = {}
    mpath = os.path.join(run_dir, MANIFEST_NAME)
    if os.path.exists(mpath):
        with open(mpath, "r", encoding="utf-8") as f:
            manifest = json.load(f)
    events: List[Dict] = []
    epath = os.path.join(run_dir, EVENTS_NAME)
    if os.path.exists(epath):
        events = read_events(epath)
    return {"manifest": manifest, "events": events}


def summarize(run_dir: str) -> Dict:
    """Structured summary (the CLI renders this; tests assert on it)."""
    data = load_run(run_dir)
    manifest, events = data["manifest"], data["events"]

    phases: Dict[str, Dict] = collections.OrderedDict()
    pairs_total = 0.0
    train_seconds = 0.0
    for e in events:
        if e.get("type") != "span_end":
            continue
        name = e.get("name", "?")
        p = phases.setdefault(name, {"count": 0, "total_s": 0.0, "max_s": 0.0})
        dur = float(e.get("dur", 0.0))
        p["count"] += 1
        p["total_s"] += dur
        p["max_s"] = max(p["max_s"], dur)
        attrs = e.get("attrs") or {}
        if "pairs" in attrs:
            pairs_total += float(attrs["pairs"])
            train_seconds += dur

    peak: Dict[str, float] = {}
    for e in events:
        if e.get("type") == "event" and e.get("name") == "probe":
            for k, v in (e.get("attrs") or {}).items():
                if isinstance(v, (int, float)):
                    peak[k] = max(peak.get(k, 0.0), float(v))

    stalls = [
        {
            "step": (e.get("attrs") or {}).get("step"),
            "dur": (e.get("attrs") or {}).get("dur"),
            "budget": (e.get("attrs") or {}).get("budget"),
            "wall": e.get("wall"),
        }
        for e in events
        if e.get("type") == "stall"
    ]

    walls = [e["wall"] for e in events if "wall" in e]
    processes = sorted({e.get("pid") for e in events if e.get("pid")})
    kernel_records = profiler.read_kernels(run_dir)
    return {
        "goodput": manifest.get("goodput"),
        "kernels": (
            profiler.kernel_summary(kernel_records)
            if kernel_records else None
        ),
        "run_dir": os.path.abspath(run_dir),
        "name": manifest.get("name"),
        "config_hash": manifest.get("config_hash"),
        "git_sha": manifest.get("git_sha"),
        "backend": manifest.get("backend") or {},
        "argv": manifest.get("argv"),
        "n_events": len(events),
        "n_processes": len(processes),
        "wall_span_s": (max(walls) - min(walls)) if walls else 0.0,
        "phases": phases,
        "pairs_total": pairs_total,
        "pairs_per_sec": (
            pairs_total / train_seconds if train_seconds > 0 else None
        ),
        "peak": peak,
        "stalls": stalls,
    }


def format_report(run_dir: str) -> str:
    """The ``obs report`` text."""
    s = summarize(run_dir)
    lines = [f"run: {s['name'] or '(no manifest)'}  [{s['run_dir']}]"]
    if s["config_hash"]:
        lines.append(f"config hash: {s['config_hash']}")
    if s["git_sha"]:
        lines.append(f"git sha: {s['git_sha'][:12]}")
    backend = s["backend"]
    if backend:
        line = f"backend: {backend.get('platform')}"
        if backend.get("device_count") is not None:
            line += f" x{backend['device_count']}"
        if backend.get("process_count") is not None:
            line += (
                f" (process {backend.get('process_index')}/"
                f"{backend['process_count']})"
            )
        lines.append(line)
    lines.append(
        f"events: {s['n_events']} from {s['n_processes']} process(es) over "
        f"{_fmt_s(s['wall_span_s'])}"
    )
    if s["phases"]:
        lines.append("")
        lines.append(f"{'phase':<28}{'count':>7}{'total':>12}{'max':>12}")
        for name, p in sorted(
            s["phases"].items(), key=lambda kv: -kv[1]["total_s"]
        ):
            lines.append(
                f"{name:<28}{p['count']:>7}{_fmt_s(p['total_s']):>12}"
                f"{_fmt_s(p['max_s']):>12}"
            )
    if s["pairs_per_sec"]:
        lines.append("")
        train_s = s["pairs_total"] / s["pairs_per_sec"]
        lines.append(
            f"throughput: {s['pairs_per_sec']:,.0f} pairs/s "
            f"({s['pairs_total']:,.0f} pairs in {_fmt_s(train_s)} of "
            f"training spans)"
        )
    if s.get("goodput"):
        g = s["goodput"]
        lines.append("")
        fr = g.get("fractions") or {}
        lines.append(
            "goodput: "
            + "  ".join(
                f"{b} {100 * fr.get(b, 0.0):.1f}%"
                for b in ("compute", "input_stall", "checkpoint",
                          "preempted", "other")
            )
        )
        achieved = g.get("achieved_pairs_per_sec")
        peak_rate = g.get("peak_pairs_per_sec")
        if achieved is not None and peak_rate:
            lines.append(
                f"  achieved {achieved:,.0f} pairs/s vs peak "
                f"{peak_rate:,.0f} (utilization "
                f"{g.get('utilization', 0) or 0:.1%})"
            )
    if s.get("kernels"):
        ks = s["kernels"]
        lines.append("")
        lines.append(
            f"kernels: {ks.get('kernels', 0)} attributed, "
            f"{_fmt_s(ks.get('wall_s', 0.0))} observed wall, "
            f"{_fmt_s(ks.get('compile_s', 0.0))} compiling "
            "(full table: cli.obs kernels)"
        )
        for top in ks.get("top") or []:
            util = top.get("utilization")
            lines.append(
                f"  {top['name']:<26}{100 * top.get('wall_share', 0.0):>6.1f}"
                f"% wall  "
                + (f"util {util:.1%}" if util is not None else "util ?")
                + (f"  [{top['bound']}-bound]" if top.get("bound") else "")
            )
    if s["peak"]:
        lines.append("")
        for k in sorted(s["peak"]):
            v = s["peak"][k]
            shown = _fmt_bytes(v) if k.endswith("bytes") else f"{v:,.0f}"
            lines.append(f"peak {k}: {shown}")
    lines.append("")
    if s["stalls"]:
        lines.append(f"stalls: {len(s['stalls'])}")
        for st in s["stalls"][:20]:
            dur = st.get("dur")
            budget = st.get("budget")
            lines.append(
                f"  {st.get('step')}: "
                f"{_fmt_s(dur) if dur is not None else '?'} "
                f"(budget {_fmt_s(budget) if budget is not None else '?'})"
            )
        if len(s["stalls"]) > 20:
            lines.append(f"  ... and {len(s['stalls']) - 20} more")
    else:
        lines.append("stalls: none")
    return "\n".join(lines)


def find_runs(root: str) -> List[str]:
    """Run directories (holding events/manifest) under ``root``, direct
    children first — lets ``obs report`` take a parent directory."""
    out = []
    for dirpath, _, filenames in os.walk(root):
        if MANIFEST_NAME in filenames or EVENTS_NAME in filenames:
            out.append(dirpath)
    return sorted(out)
