"""Metrics registry: named counters/gauges/histograms, with labels — a
copy of ``gene2vec_tpu/obs/registry.py``.

Trainers register instruments once and update them per iteration; the
registry renders a Prometheus-style text exposition
(:meth:`MetricsRegistry.prometheus_text`) and snapshots it to disk at a
bounded cadence (:meth:`MetricsRegistry.maybe_snapshot`, called from the
per-iteration log path, so no background thread is needed).

Each distinct label set is its own series under one metric name (one
``# TYPE`` line per name); label values are escaped per the exposition
format (``\\`` → ``\\\\``, ``"`` → ``\\"``, newline → ``\\n``).  Distinct
label sets per metric are capped (:attr:`MetricsRegistry.max_label_sets`,
warn-then-drop) and ``metrics_dropped_labels_total`` counts the capped
lookups.

The per-row CSV of every trainer (``training_log.csv`` through
:class:`~gene2vec_tpu_torch.utils.metrics.MetricsLogger`) is the
registry's CSV sink: :meth:`MetricsRegistry.log_row` writes the row
through the attached logger and mirrors numeric values into same-named
gauges, so the Prometheus export always carries the latest row.
"""

from __future__ import annotations

import math
import os
import sys
import threading
from typing import Dict, List, Optional, Tuple, Union

from gene2vec_tpu_torch.utils.metrics import MetricsLogger

# powers-of-4 seconds-scale buckets: 61 µs .. 4,096 s covers everything
# from a jitted step to a full corpus build
_DEFAULT_BUCKETS = tuple(4.0 ** e for e in range(-7, 7))


def _fmt(v: float) -> str:
    """Prometheus float formatting (+Inf / integer-exact values)."""
    if math.isinf(v):
        return "+Inf" if v > 0 else "-Inf"
    if float(v).is_integer() and abs(v) < 1e15:
        return str(int(v))
    return repr(float(v))


def escape_label_value(value: str) -> str:
    """Prometheus exposition escaping for a label VALUE: backslash,
    double-quote, and newline must be escaped or the scrape line is
    unparseable (the text format's only three escapes)."""
    return (
        str(value)
        .replace("\\", "\\\\")
        .replace('"', '\\"')
        .replace("\n", "\\n")
    )


def unescape_label_value(value: str) -> str:
    """Inverse of :func:`escape_label_value` (scrape parsers use it)."""
    out: List[str] = []
    i = 0
    while i < len(value):
        c = value[i]
        if c == "\\" and i + 1 < len(value):
            nxt = value[i + 1]
            if nxt == "n":
                out.append("\n")
            elif nxt in ("\\", '"'):
                out.append(nxt)
            else:  # unknown escape: keep both chars, like Prometheus
                out.append(c)
                out.append(nxt)
            i += 2
            continue
        out.append(c)
        i += 1
    return "".join(out)


def _label_suffix(labels: Optional[Dict[str, str]]) -> str:
    """``{k="v",...}`` with escaped values, sorted keys; '' when bare."""
    if not labels:
        return ""
    inner = ",".join(
        f'{k}="{escape_label_value(v)}"' for k, v in sorted(labels.items())
    )
    return "{" + inner + "}"


class Counter:
    """Monotonically increasing value."""

    TYPE = "counter"

    def __init__(self, name: str, help: str = "", labels=None):
        self.name, self.help = name, help
        self.labels = dict(labels) if labels else None
        self._value = 0.0
        self._lock = threading.Lock()

    def inc(self, amount: Union[int, float] = 1) -> None:
        if amount < 0:
            raise ValueError(f"counter {self.name}: negative increment")
        with self._lock:
            self._value += amount

    @property
    def value(self) -> float:
        return self._value

    def expose(self) -> List[str]:
        return [
            f"{self.name}{_label_suffix(self.labels)} {_fmt(self._value)}",
        ]


class Gauge:
    """Last-written value."""

    TYPE = "gauge"

    def __init__(self, name: str, help: str = "", labels=None):
        self.name, self.help = name, help
        self.labels = dict(labels) if labels else None
        self._value = 0.0

    def set(self, value: float) -> None:
        self._value = float(value)

    def inc(self, amount: float = 1.0) -> None:
        self._value += amount

    @property
    def value(self) -> float:
        return self._value

    def expose(self) -> List[str]:
        return [
            f"{self.name}{_label_suffix(self.labels)} {_fmt(self._value)}",
        ]


class Histogram:
    """Cumulative-bucket histogram (Prometheus semantics) + min/max."""

    TYPE = "histogram"

    def __init__(self, name: str, help: str = "", buckets=_DEFAULT_BUCKETS,
                 labels=None):
        self.name, self.help = name, help
        self.labels = dict(labels) if labels else None
        self.buckets = tuple(sorted(buckets))
        self._counts = [0] * (len(self.buckets) + 1)  # +1 for +Inf
        self._sum = 0.0
        self._count = 0
        self._min = math.inf
        self._max = -math.inf
        self._lock = threading.Lock()

    def observe(self, value: float) -> None:
        value = float(value)
        with self._lock:
            i = 0
            while i < len(self.buckets) and value > self.buckets[i]:
                i += 1
            self._counts[i] += 1
            self._sum += value
            self._count += 1
            self._min = min(self._min, value)
            self._max = max(self._max, value)

    @property
    def count(self) -> int:
        return self._count

    @property
    def sum(self) -> float:
        return self._sum

    @property
    def mean(self) -> float:
        return self._sum / self._count if self._count else 0.0

    @property
    def max(self) -> float:
        return self._max if self._count else 0.0

    def expose(self) -> List[str]:
        suffix = _label_suffix(self.labels)
        lines: List[str] = []
        cum = 0
        for le, c in zip(self.buckets, self._counts):
            cum += c
            lines.append(
                f"{self.name}_bucket"
                f"{_label_suffix({**(self.labels or {}), 'le': _fmt(le)})}"
                f" {cum}"
            )
        lines.append(
            f"{self.name}_bucket"
            f"{_label_suffix({**(self.labels or {}), 'le': '+Inf'})}"
            f" {self._count}"
        )
        lines.append(f"{self.name}_sum{suffix} {_fmt(self._sum)}")
        lines.append(f"{self.name}_count{suffix} {self._count}")
        return lines


class MetricsRegistry:
    """(name, label set) → instrument registry with get-or-create
    accessors.  One metric NAME has one type (conflicts raise) and at
    most :attr:`max_label_sets` distinct label sets — beyond that,
    updates collapse into a shared detached instrument (invisible to
    the exposition) and ``metrics_dropped_labels_total`` counts the
    capped lookups, so a per-gene/per-trace label can never grow the
    scrape without bound."""

    #: distinct label sets allowed per metric name (warn-then-drop)
    max_label_sets = 64

    def __init__(self, max_label_sets: Optional[int] = None):
        if max_label_sets is not None:
            self.max_label_sets = int(max_label_sets)
        self._instruments: Dict[Tuple[str, Tuple], object] = {}
        self._label_sets: Dict[str, int] = {}   # name → distinct series
        self._warned_names: set = set()
        self._overflow: Dict[Tuple[str, str], object] = {}
        self._lock = threading.RLock()
        self._csv: Optional[MetricsLogger] = None
        self._last_snapshot = 0.0

    def _get(self, cls, name: str, help: str, labels=None, **kw):
        key = (name, tuple(sorted((labels or {}).items())))
        with self._lock:
            inst = self._instruments.get(key)
            if inst is not None:
                if not isinstance(inst, cls):
                    raise TypeError(
                        f"metric {name!r} already registered as "
                        f"{type(inst).__name__}, not {cls.__name__}"
                    )
                return inst
            # a NAME's type is fixed by its first series, labeled or not
            existing = self._label_sets.get(name)
            if existing is not None:
                for (n, _), other in self._instruments.items():
                    if n == name:
                        if not isinstance(other, cls):
                            raise TypeError(
                                f"metric {name!r} already registered as "
                                f"{type(other).__name__}, not {cls.__name__}"
                            )
                        break
            if labels and (existing or 0) >= self.max_label_sets:
                return self._drop_overflow(cls, name, help, **kw)
            inst = self._instruments[key] = cls(
                name, help, labels=labels, **kw
            )
            self._label_sets[name] = (existing or 0) + 1
            return inst

    def _drop_overflow(self, cls, name: str, help: str, **kw):
        """Cardinality cap hit: warn once per metric, count the capped
        lookup, and hand back one shared instrument that is NOT in the
        exposition — callers keep working, the scrape stays bounded."""
        if name not in self._warned_names:
            self._warned_names.add(name)
            print(
                f"metrics: label cardinality cap ({self.max_label_sets}) "
                f"hit for {name!r}; further label sets are dropped "
                "(metrics_dropped_labels_total counts them)",
                file=sys.stderr,
            )
        drop_key = ("metrics_dropped_labels_total", ())
        drop = self._instruments.get(drop_key)
        if drop is None:
            drop = self._instruments[drop_key] = Counter(
                "metrics_dropped_labels_total",
                "updates dropped by the per-metric label-cardinality cap",
            )
            self._label_sets["metrics_dropped_labels_total"] = 1
        drop.inc()
        okey = (name, cls.__name__)
        inst = self._overflow.get(okey)
        if inst is None:
            inst = self._overflow[okey] = cls(name, help, **kw)
        return inst

    def counter(self, name: str, help: str = "", labels=None) -> Counter:
        return self._get(Counter, name, help, labels=labels)

    def gauge(self, name: str, help: str = "", labels=None) -> Gauge:
        return self._get(Gauge, name, help, labels=labels)

    def histogram(
        self, name: str, help: str = "", buckets=_DEFAULT_BUCKETS,
        labels=None,
    ) -> Histogram:
        return self._get(Histogram, name, help, labels=labels,
                         buckets=buckets)

    def remove(self, name: str, labels=None) -> bool:
        """Drop one series from the exposition (and free its label-set
        slot).  For series keyed by inherently ephemeral label values —
        the fleet aggregator's ``fleet_scrape_staleness{target=}``
        gauges, whose ephemeral-port targets never recur — where
        leaving a dead series behind would grow the scrape without
        bound.  Returns whether the series existed."""
        key = (name, tuple(sorted((labels or {}).items())))
        with self._lock:
            if self._instruments.pop(key, None) is None:
                return False
            remaining = self._label_sets.get(name, 1) - 1
            if remaining > 0:
                self._label_sets[name] = remaining
            else:
                self._label_sets.pop(name, None)
            return True

    # -- exposition --------------------------------------------------------

    def prometheus_text(self) -> str:
        lines: List[str] = []
        with self._lock:
            instruments = sorted(
                self._instruments.items(), key=lambda kv: kv[0]
            )
        last_name = None
        for (name, _), inst in instruments:
            if name != last_name:
                lines.append(f"# TYPE {name} {inst.TYPE}")
                last_name = name
            lines.extend(inst.expose())
        return "\n".join(lines) + ("\n" if lines else "")

    def snapshot_to(self, path: str) -> None:
        """Atomic (tmp + rename) write of the Prometheus exposition."""
        os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
        tmp = f"{path}.tmp.{os.getpid()}"
        with open(tmp, "w", encoding="utf-8") as f:
            f.write(self.prometheus_text())
        os.replace(tmp, path)

    def maybe_snapshot(
        self, path: str, interval_s: float = 15.0, now: float = None
    ) -> bool:
        """Time-gated :meth:`snapshot_to` — call from any periodic code
        path (the per-iteration log row); writes at most once per
        ``interval_s``."""
        import time

        now = time.monotonic() if now is None else now
        if now - self._last_snapshot < interval_s:
            return False
        self._last_snapshot = now
        self.snapshot_to(path)
        return True

    # -- CSV sink ----------------------------------------------------------

    def attach_csv(
        self, csv_path: str, tensorboard_dir: Optional[str] = None
    ) -> MetricsLogger:
        """Attach the per-row CSV sink (the repo's ``training_log.csv``
        convention); rows then flow through :meth:`log_row`."""
        self._csv = MetricsLogger(csv_path, tensorboard_dir=tensorboard_dir)
        return self._csv

    def log_row(self, step: int, metrics: Dict[str, float]) -> None:
        """One iteration row: CSV append + same-named gauges updated."""
        if self._csv is not None:
            self._csv.log(step, metrics)
        for k, v in metrics.items():
            if isinstance(v, (int, float)) and not isinstance(v, bool):
                self.gauge(k).set(v)

    def close(self) -> None:
        if self._csv is not None:
            self._csv.close()
            self._csv = None
