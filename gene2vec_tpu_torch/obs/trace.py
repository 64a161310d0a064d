"""Structured span tracer: append-only JSON-lines events — the part of
``gene2vec_tpu/obs/trace.py`` that :func:`ambient_span` and the run
reports need, copied.

Every record is one JSON object on one line of ``events.jsonl``
(``type``, ``name``, ``wall``, ``mono``, ``pid``, ``tid``, ``span``,
``parent``, ``dur`` on ``span_end``, free-form ``attrs``), written with
one ``os.write`` on an ``O_APPEND`` fd.  :func:`ambient_span` writes to
the installed tracer and otherwise buffers a bounded number of records
in memory, which the next installed tracer flushes.
:func:`read_events` parses the file back, merged by wall clock.

Under a sampled request context (``obs/tracecontext.py``) every record
also carries ``trace``/``tsid``/``tpid`` (trace id, this hop's span id,
its parent hop), so the spans of one request across the front door, a
replica's handler and its batcher join one tree that ``cli.obs trace``
reassembles; :func:`hop_span` writes a hop with an explicit context for
code that finishes a hop away from the request's thread.
"""

from __future__ import annotations

import contextlib
import itertools
import json
import os
import threading
import time
from typing import Dict, Iterator, List, Optional

from gene2vec_tpu_torch.obs import tracecontext

_PENDING_MAX = 256


def _stamp_trace(record: Dict) -> None:
    """Stamp the thread's sampled trace context onto a record —
    ``trace`` (trace_id), ``tsid`` (this hop's span id), ``tpid``
    (parent hop) — so every span/event written while a request context
    is installed joins the cross-process tree ``cli.obs trace``
    reassembles.  Explicit fields win; an unsampled or absent context
    stamps nothing (that IS the overhead contract)."""
    if "trace" in record:
        return
    ctx = tracecontext.current()
    if ctx is None or not ctx.sampled:
        return
    record["trace"] = ctx.trace_id
    record["tsid"] = ctx.span_id
    if ctx.parent_id is not None:
        record["tpid"] = ctx.parent_id


class Tracer:
    """JSON-lines span/event writer bound to one ``events.jsonl`` path."""

    def __init__(self, path: str):
        self.path = os.path.abspath(path)
        os.makedirs(os.path.dirname(self.path), exist_ok=True)
        self._fd: Optional[int] = None
        self._fd_pid: Optional[int] = None
        self._local = threading.local()
        self._ids = itertools.count(1)
        self._lock = threading.Lock()

    def _ensure_fd(self) -> int:
        pid = os.getpid()
        if self._fd is None or self._fd_pid != pid:
            self._fd = os.open(self.path, os.O_WRONLY | os.O_CREAT | os.O_APPEND, 0o644)
            self._fd_pid = pid
        return self._fd

    def _stack(self) -> List[str]:
        if not hasattr(self._local, "stack"):
            self._local.stack = []
        return self._local.stack

    def write(self, record: Dict) -> None:
        """Append one raw record (timestamps/pid/tid added if absent)."""
        record.setdefault("wall", time.time())
        record.setdefault("mono", time.monotonic())
        record.setdefault("pid", os.getpid())
        record.setdefault("tid", threading.get_ident())
        _stamp_trace(record)
        line = json.dumps(record, separators=(",", ":"), default=str) + "\n"
        with self._lock:
            os.write(self._ensure_fd(), line.encode("utf-8"))

    @contextlib.contextmanager
    def span(self, name: str, **attrs) -> Iterator[Dict]:
        """Nested timed span.  Keys set on the yielded dict during the
        body are recorded as ``span_end`` attrs."""
        stack = self._stack()
        span_id = f"{os.getpid()}-{next(self._ids)}"
        parent = stack[-1] if stack else None
        t0 = time.monotonic()
        self.write({
            "type": "span_start", "name": name, "span": span_id,
            "parent": parent, "mono": t0, **({"attrs": attrs} if attrs else {}),
        })
        stack.append(span_id)
        out_attrs: Dict = {}
        try:
            yield out_attrs
        finally:
            stack.pop()
            t1 = time.monotonic()
            merged = {**attrs, **out_attrs}
            self.write({
                "type": "span_end", "name": name, "span": span_id,
                "parent": parent, "mono": t1, "dur": t1 - t0,
                **({"attrs": merged} if merged else {}),
            })

    def event(self, name: str, type: str = "event", **attrs) -> None:
        stack = self._stack()
        self.write({
            "type": type, "name": name, "span": stack[-1] if stack else None,
            **({"attrs": attrs} if attrs else {}),
        })

    def close(self) -> None:
        with self._lock:
            if self._fd is not None and self._fd_pid == os.getpid():
                os.close(self._fd)
            self._fd = None
            self._fd_pid = None


_current: Optional[Tracer] = None
_pending: List[Dict] = []
_pending_lock = threading.Lock()


def get_tracer() -> Optional[Tracer]:
    """The installed tracer, or None."""
    return _current


def set_tracer(tracer: Optional[Tracer]) -> None:
    """Install (or clear) the ambient tracer; buffered records are
    flushed to a newly installed one."""
    global _current
    _current = tracer
    if tracer is not None:
        with _pending_lock:
            buffered, _pending[:] = _pending[:], []
        for rec in buffered:
            tracer.write(rec)


@contextlib.contextmanager
def ambient_span(name: str, **attrs) -> Iterator[Dict]:
    """A span on the ambient tracer; with no tracer installed the record
    is buffered (bounded) and flushed into the next tracer's file."""
    tracer = _current
    if tracer is not None:
        with tracer.span(name, **attrs) as out:
            yield out
        return
    t0m, t0w = time.monotonic(), time.time()
    out: Dict = {}
    try:
        yield out
    finally:
        t1 = time.monotonic()
        merged = {**attrs, **out}
        rec = {
            "type": "span_end", "name": name, "span": None, "parent": None,
            "wall": t0w, "mono": t1, "dur": t1 - t0m, "pid": os.getpid(),
            "tid": threading.get_ident(), "buffered": True,
            **({"attrs": merged} if merged else {}),
        }
        # capture the context now: the buffered record is flushed later
        # from whichever thread installs the next tracer
        _stamp_trace(rec)
        with _pending_lock:
            if len(_pending) < _PENDING_MAX:
                _pending.append(rec)


def hop_span(
    name: str,
    ctx,
    dur: Optional[float] = None,
    wall: Optional[float] = None,
    **attrs,
) -> None:
    """Emit one ``span_end`` hop record with an EXPLICIT trace context —
    for code that finishes a hop on a thread where installing the
    thread-local context is wrong (the batcher worker serves many traces
    per batch; a hedged client attempt concludes on its own thread).

    ``ctx`` is the hop's own :class:`~gene2vec_tpu_torch.obs.tracecontext.
    TraceContext` (its ``parent_id`` links it into the tree).  The
    record's process-local ``span`` field is the current thread's
    enclosing span, which is what lets ``cli.obs trace`` attach the
    surrounding ``serve_batch``/``serve_compute`` subtree to a
    ``batch_item`` hop.  No tracer installed, or an unsampled context →
    no record, no cost."""
    tracer = _current
    if tracer is None or ctx is None or not ctx.sampled:
        return
    stack = tracer._stack()
    record: Dict = {
        "type": "span_end",
        "name": name,
        # the ENCLOSING span's id, not an id of this record's own —
        # the "hop" marker below tells reassembly readers apart
        "span": stack[-1] if stack else None,
        "hop": True,
        "parent": None,
        "trace": ctx.trace_id,
        "tsid": ctx.span_id,
        **({"tpid": ctx.parent_id} if ctx.parent_id is not None else {}),
        **({"dur": float(dur)} if dur is not None else {}),
        **({"wall": float(wall)} if wall is not None else {}),
        **({"attrs": attrs} if attrs else {}),
    }
    tracer.write(record)


def read_events(path: str) -> List[Dict]:
    """Parse an ``events.jsonl`` (skipping torn/partial trailing lines),
    ordered by wall clock — the merged multi-process timeline."""
    events = []
    with open(path, "r", encoding="utf-8") as f:
        for line in f:
            line = line.strip()
            if not line:
                continue
            try:
                events.append(json.loads(line))
            except json.JSONDecodeError:
                continue
    events.sort(key=lambda e: e.get("wall", 0.0))
    return events
