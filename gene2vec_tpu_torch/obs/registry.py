"""Metrics registry: named counters, gauges and histograms with labels,
rendered as Prometheus text — the part of ``gene2vec_tpu/obs/registry.py``
that ``/metrics`` and a run's ``metrics.prom`` need, copied.

Each distinct label set is its own series under one metric name (one
``# TYPE`` line per name); label values are escaped per the exposition
format.  Distinct label sets per metric are capped
(:attr:`MetricsRegistry.max_label_sets`, warn-then-drop) and
``metrics_dropped_labels_total`` counts the capped lookups.
"""

from __future__ import annotations

import math
import os
import sys
import threading
from typing import Dict, List, Optional, Tuple, Union

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

    @property
    def value(self) -> float:
        return self._value

    def expose(self) -> List[str]:
        return [
            f"{self.name}{_label_suffix(self.labels)} {_fmt(self._value)}",
        ]


class Histogram:
    """Cumulative-bucket histogram (Prometheus semantics)."""

    TYPE = "histogram"

    def __init__(self, name: str, help: str = "", buckets=_DEFAULT_BUCKETS,
                 labels=None):
        self.name, self.help = name, help
        self.labels = dict(labels) if labels else None
        self.buckets = tuple(sorted(buckets))
        self._counts = [0] * (len(self.buckets) + 1)  # +1 for +Inf
        self._sum = 0.0
        self._count = 0
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
    capped lookups."""

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
