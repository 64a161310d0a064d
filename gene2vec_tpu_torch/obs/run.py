"""Run manifest + stall watchdog — a copy of ``gene2vec_tpu/obs/run.py``.

A :class:`Run` owns one run directory and writes, at construction, a
``manifest.json`` recording what configuration produced the run: config
dict + deterministic config hash, git sha, argv, device facts and library
versions.  It exposes the tracer (``events.jsonl``), the metrics registry
(``metrics.prom`` snapshots + the trainer's CSV sink) and a step clock
whose :class:`StallWatchdog` flags any step slower than 3× the
rolling-window p99 as a ``stall`` event.

Device facts come from ``torch.cuda`` (the reference asks
``jax.devices()``); ``probe_devices=False`` leaves them out of the
manifest until :meth:`Run.annotate_backend`.  :meth:`Run.probe` samples
``obs/probes.py`` into gauges and a ``probe`` event.  Construction never
raises for missing optional context (no git, no GPU).
"""

from __future__ import annotations

import collections
import contextlib
import dataclasses
import hashlib
import json
import os
import socket
import subprocess
import sys
import time
from typing import Dict, Iterator, Optional

from gene2vec_tpu_torch.obs import probes, trace
from gene2vec_tpu_torch.obs.registry import MetricsRegistry
from gene2vec_tpu_torch.obs.trace import Tracer

MANIFEST_NAME = "manifest.json"
EVENTS_NAME = "events.jsonl"
METRICS_NAME = "metrics.prom"


def _config_dict(config) -> Dict:
    if config is None:
        return {}
    if dataclasses.is_dataclass(config) and not isinstance(config, type):
        return dataclasses.asdict(config)
    if isinstance(config, dict):
        return dict(config)
    return {"repr": repr(config)}


def config_hash(config) -> str:
    """Deterministic hash of a config (dataclass or dict): same config →
    same hash, across processes and sessions."""
    blob = json.dumps(
        _config_dict(config), sort_keys=True, separators=(",", ":"), default=str,
    )
    return hashlib.sha256(blob.encode("utf-8")).hexdigest()[:16]


def _git_sha() -> Optional[str]:
    try:
        out = subprocess.run(
            ["git", "rev-parse", "HEAD"], capture_output=True, timeout=10, text=True,
            cwd=os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
        )
        return out.stdout.strip() or None if out.returncode == 0 else None
    except (OSError, subprocess.SubprocessError):
        return None


def _versions() -> Dict[str, str]:
    from importlib import metadata

    out = {"python": sys.version.split()[0]}
    for mod in ("torch", "numpy"):
        try:
            out[mod] = metadata.version(mod)
        except metadata.PackageNotFoundError:
            continue
    return out


def _device_info() -> Dict:
    """The CUDA devices this process sees (empty on a CPU-only host)."""
    import torch

    if not torch.cuda.is_available():
        return {"platform": "cpu", "device_count": 0}
    n = torch.cuda.device_count()
    return {"platform": "gpu", "device_count": n,
            "kind": torch.cuda.get_device_name(0), "cuda": torch.version.cuda}


class StallWatchdog:
    """Rolling-p99 step budget: a step slower than ``factor`` × the p99
    of the trailing window is a stall.  The window holds the previous
    steps only, so one huge step cannot inflate its own budget."""

    def __init__(self, window: int = 64, factor: float = 3.0, min_samples: int = 5):
        self.window: collections.deque = collections.deque(maxlen=window)
        self.factor = factor
        self.min_samples = min_samples

    def p99(self) -> Optional[float]:
        if not self.window:
            return None
        ordered = sorted(self.window)
        return ordered[min(len(ordered) - 1, int(0.99 * len(ordered)))]

    def budget(self) -> Optional[float]:
        """Current stall threshold in seconds (None while warming up)."""
        if len(self.window) < self.min_samples:
            return None
        return self.factor * self.p99()

    def record(self, duration_s: float) -> bool:
        """Admit one step duration; True when it breached the budget."""
        budget = self.budget()
        stalled = budget is not None and duration_s > budget
        self.window.append(float(duration_s))
        return stalled


class Run:
    """One observed run: run dir + manifest + tracer + registry + watchdog.
    Installs itself as the ambient tracer, so spans emitted without a
    handle land in this run's ``events.jsonl``."""

    def __init__(self, run_dir: str, name: str = "run", config=None,
                 manifest_extra: Optional[Dict] = None,
                 watchdog: Optional[StallWatchdog] = None,
                 probe_devices: bool = True, snapshot_interval_s: float = 15.0):
        self.run_dir = os.path.abspath(run_dir)
        os.makedirs(self.run_dir, exist_ok=True)
        self.name = name
        self.config = config
        self.registry = MetricsRegistry()
        self.tracer = Tracer(os.path.join(self.run_dir, EVENTS_NAME))
        self.watchdog = watchdog or StallWatchdog()
        self._snapshot_interval = snapshot_interval_s
        self._closed = False
        self.manifest = {
            "name": name,
            "run_dir": self.run_dir,
            "created_unix": time.time(),
            "argv": list(sys.argv),
            "cwd": os.getcwd(),
            "hostname": socket.gethostname(),
            "pid": os.getpid(),
            "git_sha": _git_sha(),
            "config": _config_dict(config),
            "config_hash": config_hash(config),
            "versions": _versions(),
            "backend": _device_info() if probe_devices else {},
            "env": {k: os.environ[k] for k in ("CUDA_VISIBLE_DEVICES",) if k in os.environ},
            **(manifest_extra or {}),
        }
        self._write_manifest()
        trace.set_tracer(self.tracer)
        self.tracer.event("run_start", run=name)

    def _write_manifest(self) -> None:
        path = os.path.join(self.run_dir, MANIFEST_NAME)
        tmp = f"{path}.tmp.{os.getpid()}"
        with open(tmp, "w", encoding="utf-8") as f:
            json.dump(self.manifest, f, indent=1, default=str)
            f.write("\n")
        os.replace(tmp, path)

    def annotate(self, **fields) -> None:
        """Merge late-arriving facts into the on-disk manifest."""
        self.manifest.update(fields)
        self._write_manifest()

    def mark_interrupted(self, reason: str = "preempted", **fields) -> None:
        """Stamp the on-disk manifest ``interrupted=true`` (the
        preemption-drain contract): a resumed run can tell a drained
        predecessor from one that finished."""
        self.annotate(interrupted=True, interrupted_reason=reason, **fields)
        self.tracer.event("interrupted", reason=reason, **fields)

    def annotate_backend(self) -> None:
        """Merge the device facts into the manifest — for callers that
        construct with ``probe_devices=False`` and reach the device later."""
        self.annotate(backend=_device_info())

    # -- tracing -----------------------------------------------------------

    def span(self, name: str, **attrs):
        return self.tracer.span(name, **attrs)

    def event(self, name: str, **attrs) -> None:
        self.tracer.event(name, **attrs)

    def record_step(self, name: str, duration_s: float, **attrs) -> bool:
        """Feed one step duration to the ``step_seconds`` histogram and
        the stall detector; a breach emits a ``stall`` event carrying the
        budget it broke.  Span-free (the per-batch path).  Returns whether
        the step stalled."""
        budget = self.watchdog.budget()
        stalled = self.watchdog.record(duration_s)
        self.registry.histogram("step_seconds").observe(duration_s)
        if stalled:
            self.registry.counter("stalls_total").inc()
            canonical = {"step": name, "dur": duration_s, "budget": budget,
                         "p99": self.watchdog.p99()}
            extra = {(f"ctx_{k}" if k in canonical or k == "type" else k): v
                     for k, v in attrs.items()}
            self.tracer.event("stall", type="stall", **canonical, **extra)
        return stalled

    @contextlib.contextmanager
    def step(self, name: str = "step", **attrs) -> Iterator[Dict]:
        """A watchdog-clocked span: :meth:`record_step` plus the
        span_start/span_end records in the timeline."""
        t0 = time.perf_counter()
        with self.tracer.span(name, **attrs) as out:
            yield out
        self.record_step(name, time.perf_counter() - t0, **attrs)

    # -- metrics -----------------------------------------------------------

    def log_row(self, step: int, metrics: Dict[str, float]) -> None:
        """Per-iteration row → CSV sink + gauges + a bounded-cadence
        ``metrics.prom`` snapshot."""
        self.registry.log_row(step, metrics)
        self.registry.maybe_snapshot(os.path.join(self.run_dir, METRICS_NAME),
                                     self._snapshot_interval)

    def probe(self) -> Dict:
        """Sample runtime probes into gauges + one ``probe`` event."""
        values = probes.sample(self.registry)
        self.tracer.event("probe", **{k: v for k, v in values.items() if v is not None})
        return values

    # -- lifecycle ---------------------------------------------------------

    def close(self) -> None:
        if self._closed:
            return
        self._closed = True
        self.tracer.event("run_end", run=self.name)
        self.registry.snapshot_to(os.path.join(self.run_dir, METRICS_NAME))
        self.registry.close()
        if trace.get_tracer() is self.tracer:
            trace.set_tracer(None)
        self.tracer.close()

    def __enter__(self) -> "Run":
        return self

    def __exit__(self, *exc) -> None:
        self.close()
