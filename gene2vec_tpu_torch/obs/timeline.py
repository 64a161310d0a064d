"""Per-iteration phase timeline (a copy of ``gene2vec_tpu/obs/timeline.py``'s
recording and reading half).

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
"""

from __future__ import annotations

import collections
import contextlib
import json
import os
import threading
import time
from typing import Dict, Iterator, List, Optional

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
