"""Per-iteration phase timeline — a copy of ``gene2vec_tpu/obs/timeline.py``.

:class:`PhaseTimeline` records how long each phase of a training
iteration took into a bounded ring and flushes it once, at the end of a
run, to ``timeline.jsonl`` in the export dir.  The trainers record the
reference's phases: ``host_ingest`` (the epoch's draws), ``dispatch``
(the epoch's step loop, which returns once its kernels are queued),
``compute`` (waiting for the epoch's loss) and ``ckpt_stage`` (the
export).  Each record is ``{"name", "step", "wall", "dur", "pid", "tid",
...attrs}`` with ``wall`` the phase start (``time.time()``), after a
``timeline_meta`` header line; the reference's ``read_timeline`` and its
Chrome-trace converter read the file as they read their own.
``enabled=False`` (``SGNSConfig(timeline=False)``) makes every method a
no-op and writes no file.

Export is Chrome-trace-event JSON (:func:`chrome_trace`, over a run tree
:func:`collect_run`), loadable in Perfetto / ``chrome://tracing``: each
phase name becomes its own named track, and the ``events.jsonl`` span
records of the same run render beside them.  The CLI entry point is
``python -m gene2vec_tpu_torch.cli.obs timeline <run_dir>``.
"""

from __future__ import annotations

import collections
import contextlib
import json
import os
import threading
import time
from typing import Dict, Iterable, Iterator, List, Optional

TIMELINE_NAME = "timeline.jsonl"


class PhaseTimeline:
    """Bounded ring of per-step phase timings.

    ``capacity`` bounds host memory: the ring keeps the newest records
    and counts what it evicted (``dropped``)."""

    def __init__(self, capacity: int = 4096, enabled: bool = True):
        if capacity <= 0:
            raise ValueError(f"capacity must be positive, got {capacity}")
        self.capacity = capacity
        self.enabled = enabled
        self._ring: collections.deque = collections.deque(maxlen=capacity)
        self._total = 0
        self._lock = threading.Lock()

    def add(self, name: str, dur: float, step: Optional[int] = None,
            wall: Optional[float] = None, **attrs) -> None:
        """Append one completed phase (``wall`` is the phase start)."""
        if not self.enabled:
            return
        rec: Dict = {
            "name": name,
            "wall": time.time() - dur if wall is None else wall,
            "dur": float(dur),
            "pid": os.getpid(),
            "tid": threading.get_ident(),
        }
        if step is not None:
            rec["step"] = int(step)
        if attrs:
            rec.update(attrs)
        with self._lock:
            self._ring.append(rec)
            self._total += 1

    @contextlib.contextmanager
    def phase(self, name: str, step: Optional[int] = None, **attrs) -> Iterator[None]:
        """Timed phase context; a disabled timeline runs the body bare."""
        if not self.enabled:
            yield
            return
        t0w = time.time()
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.add(name, time.perf_counter() - t0, step=step, wall=t0w, **attrs)

    @property
    def dropped(self) -> int:
        """Records evicted by the ring bound."""
        return max(0, self._total - self.capacity)

    def records(self) -> List[Dict]:
        """Snapshot of the ring, oldest first."""
        with self._lock:
            return list(self._ring)

    def flush(self, path: str) -> int:
        """Append the ring to a JSON-lines file after a ``timeline_meta``
        line (capacity, recorded, dropped).  Returns the number of phase
        records written; a disabled timeline writes nothing."""
        if not self.enabled:
            return 0
        records = self.records()
        os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
        with open(path, "a", encoding="utf-8") as f:
            meta = {
                "type": "timeline_meta",
                "capacity": self.capacity,
                "recorded": self._total,
                "dropped": self.dropped,
                "pid": os.getpid(),
                "wall": time.time(),
            }
            f.write(json.dumps(meta, separators=(",", ":")) + "\n")
            for rec in records:
                f.write(json.dumps(rec, separators=(",", ":"), default=str) + "\n")
        return len(records)


def read_timeline(path: str) -> List[Dict]:
    """Parse a ``timeline.jsonl`` (phase records only; ``timeline_meta``
    header lines and torn trailing lines are skipped), by start time."""
    out: List[Dict] = []
    with open(path, "r", encoding="utf-8") as f:
        for line in f:
            line = line.strip()
            if not line:
                continue
            try:
                rec = json.loads(line)
            except json.JSONDecodeError:
                continue
            if rec.get("type") == "timeline_meta":
                continue
            if "name" in rec and "dur" in rec:
                out.append(rec)
    out.sort(key=lambda r: r.get("wall", 0.0))
    return out


# -- Chrome trace-event export ----------------------------------------------

# Synthetic track ids for phase rows start high so they can never
# collide with a real OS thread id rendered from events.jsonl records.
_PHASE_TID_BASE = 1 << 48


def chrome_trace(
    timeline_records: Iterable[Dict],
    span_events: Iterable[Dict] = (),
    process_names: Optional[Dict[int, str]] = None,
) -> Dict:
    """Convert phase records (+ optional ``events.jsonl`` records) into
    one Chrome-trace-event document Perfetto can load.

    * each distinct phase name renders as its own named track
      (synthetic tid + ``thread_name`` metadata) under the recording
      process, so the step anatomy reads as parallel swimlanes;
    * ``span_end`` records from the span tracer become complete ("X")
      events on their real (pid, tid) track — hop records categorized
      ``hop`` and labelled with their trace id;
    * ``event``/``stall``/``probe`` records become instant ("i") events.

    Timestamps are microseconds relative to the earliest wall clock in
    the input (Chrome traces want small positive ts).
    """
    timeline_records = list(timeline_records)
    span_events = list(span_events)

    starts: List[float] = []
    for r in timeline_records:
        if "wall" in r:
            starts.append(float(r["wall"]))
    for e in span_events:
        if "wall" in e:
            # span_end wall stamps are END times; subtract dur for t0
            starts.append(float(e["wall"]) - float(e.get("dur", 0.0) or 0.0))
    t0 = min(starts) if starts else 0.0

    def us(wall: float) -> float:
        return round((wall - t0) * 1e6, 1)

    events: List[Dict] = []
    seen_pids: Dict[int, None] = {}
    phase_tids: Dict[str, int] = {}
    named_tracks: Dict[tuple, str] = {}

    for r in timeline_records:
        pid = int(r.get("pid", 0))
        seen_pids.setdefault(pid, None)
        name = str(r.get("name", "?"))
        tid = phase_tids.setdefault(name, _PHASE_TID_BASE + len(phase_tids))
        named_tracks[(pid, tid)] = f"phase:{name}"
        args = {k: v for k, v in r.items() if k not in ("name", "wall", "dur", "pid", "tid")}
        events.append({
            "name": name,
            "cat": "phase",
            "ph": "X",
            "ts": us(float(r.get("wall", t0))),
            "dur": round(max(float(r.get("dur", 0.0)), 0.0) * 1e6, 1),
            "pid": pid,
            "tid": tid,
            **({"args": args} if args else {}),
        })

    for e in span_events:
        etype = e.get("type")
        pid = int(e.get("pid", 0))
        tid = int(e.get("tid", 0))
        seen_pids.setdefault(pid, None)
        attrs = e.get("attrs") or {}
        if etype == "span_end":
            dur = float(e.get("dur", 0.0) or 0.0)
            args = dict(attrs)
            if e.get("trace"):
                args["trace"] = e["trace"]
            events.append({
                "name": str(e.get("name", "?")),
                "cat": "hop" if e.get("hop") else "span",
                "ph": "X",
                "ts": us(float(e.get("wall", t0)) - dur),
                "dur": round(max(dur, 0.0) * 1e6, 1),
                "pid": pid,
                "tid": tid,
                **({"args": args} if args else {}),
            })
        elif etype in ("event", "stall", "probe"):
            events.append({
                "name": str(e.get("name", "?")),
                "cat": str(etype),
                "ph": "i",
                "s": "t",
                "ts": us(float(e.get("wall", t0))),
                "pid": pid,
                "tid": tid,
                **({"args": dict(attrs)} if attrs else {}),
            })
        # span_start records carry nothing span_end lacks — skipped

    meta: List[Dict] = []
    for pid in seen_pids:
        label = (process_names or {}).get(pid) or f"pid {pid}"
        meta.append({"name": "process_name", "ph": "M", "pid": pid, "tid": 0,
                     "args": {"name": label}})
    for (pid, tid), label in named_tracks.items():
        meta.append({"name": "thread_name", "ph": "M", "pid": pid, "tid": tid,
                     "args": {"name": label}})

    return {
        "traceEvents": meta + events,
        "displayTimeUnit": "ms",
        "otherData": {
            "producer": "gene2vec_tpu_torch.obs.timeline",
            "t0_unix": t0,
            "phase_tracks": sorted(phase_tids),
        },
    }


def collect_run(run_dir: str) -> Dict:
    """Build the Chrome trace for one run directory tree: every
    ``timeline.jsonl`` and ``events.jsonl`` under ``run_dir`` merges into
    one document, each process labelled from its ``manifest.json``."""
    from gene2vec_tpu_torch.obs.run import EVENTS_NAME, MANIFEST_NAME
    from gene2vec_tpu_torch.obs.trace import read_events

    timeline_records: List[Dict] = []
    span_events: List[Dict] = []
    process_names: Dict[int, str] = {}
    for dirpath, _, filenames in os.walk(run_dir):
        if TIMELINE_NAME in filenames:
            timeline_records.extend(read_timeline(os.path.join(dirpath, TIMELINE_NAME)))
        if EVENTS_NAME in filenames:
            span_events.extend(read_events(os.path.join(dirpath, EVENTS_NAME)))
        if MANIFEST_NAME in filenames:
            try:
                with open(os.path.join(dirpath, MANIFEST_NAME), encoding="utf-8") as f:
                    m = json.load(f)
                if isinstance(m.get("pid"), int) and m.get("name"):
                    process_names[m["pid"]] = f"{m['name']} (pid {m['pid']})"
            except (OSError, ValueError):
                pass
    return chrome_trace(timeline_records, span_events, process_names=process_names)
