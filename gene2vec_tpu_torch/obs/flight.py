"""Flight recorder + cross-process trace reassembly.

**Flight recorder**: every replica (and the fleet proxy) keeps a
bounded in-memory ring of recent request records — trace id, route,
status, duration, per-hop timings — costing one deque append per
request.  The ring is dumped to the run dir as ``flight-<pid>-<n>.json``
when (a) the operator sends SIGQUIT (``cli.serve`` installs the
handler), or (b) a 5xx burst is detected (``burst_threshold`` server
errors within ``burst_window_s``, rate-limited to one dump per window)
— so the moments *around* an incident are on disk even when sampling
missed the individual requests.

**Hop sink**: a thread-local dict installed around one request's
handling (:func:`collect_hops`); downstream stages on the same thread
(the batcher ticket recording queue-wait/compute time) deposit their
timings into it via :func:`add_hop` without any plumbing through the
route layer.

**Trace reassembly**: :func:`collect_trace` walks a directory tree for
``events.jsonl`` files and flight dumps (a fleet export dir holds the
proxy's ``fleet_runs/<ts>`` and every replica's ``serve_runs/<ts>``),
gathers the records stamped with one trace id, and rebuilds the
cross-process tree — proxy hop → client attempts (retries/hedges as
siblings) → replica request → batcher item → the process-local
``serve_batch``/``serve_compute``/``engine_topk`` subtree.  ``python -m
gene2vec_tpu_torch.cli.obs trace <run_dir> <trace_id>`` renders it.
"""

from __future__ import annotations

import collections
import contextlib
import itertools
import json
import math
import os
import threading
import time
from typing import Dict, Iterator, List, Optional, Tuple

FLIGHT_PREFIX = "flight-"

# -- per-request hop sink (thread-local) -------------------------------------

_hops_local = threading.local()


@contextlib.contextmanager
def collect_hops() -> Iterator[Dict[str, float]]:
    """Install a fresh hop-timing sink for this thread; stages that run
    on the request thread (``Ticket.get``) deposit into it."""
    prev = getattr(_hops_local, "sink", None)
    sink: Dict[str, float] = {}
    _hops_local.sink = sink
    try:
        yield sink
    finally:
        _hops_local.sink = prev


def add_hop(key: str, value: float) -> None:
    """Record one per-hop timing into the current request's sink (no-op
    without one — library code never needs to know whether a recorder
    is active)."""
    sink = getattr(_hops_local, "sink", None)
    if sink is not None:
        sink[key] = round(float(value), 6)


# -- the recorder ------------------------------------------------------------


class FlightRecorder:
    """Bounded ring of recent request records with 5xx-burst detection.

    ``record`` returns True when its 5xx pushed the burst window over
    ``burst_threshold`` and a dump is due — the caller dumps, the
    recorder never touches disk on the hot path.  The trigger is
    configurable (``cli.serve --burst-threshold/--burst-window``), and
    when a shared :class:`~gene2vec_tpu_torch.obs.alerts.RateLimiter` is
    provided it arbitrates dump cadence INSTEAD of the internal
    once-per-window rule — in the fleet proxy, burst dumps and
    rule-triggered incident bundles then draw from one budget, so an
    error storm plus a flapping alert cannot multiply disk writes.
    """

    def __init__(
        self,
        capacity: int = 512,
        burst_threshold: int = 10,
        burst_window_s: float = 5.0,
        clock=time.monotonic,
        limiter=None,
    ):
        self.capacity = capacity
        self.burst_threshold = burst_threshold
        self.burst_window_s = burst_window_s
        self._clock = clock
        self.limiter = limiter
        self._ring: "collections.deque[Dict]" = collections.deque(
            maxlen=capacity
        )
        self._5xx: "collections.deque[float]" = collections.deque()
        self._last_burst_dump = -math.inf
        self._seq = itertools.count(1)
        self._lock = threading.Lock()

    def record(
        self,
        route: str,
        status: int,
        dur_s: float,
        trace_id: Optional[str] = None,
        hops: Optional[Dict[str, float]] = None,
    ) -> bool:
        rec = {
            "wall": time.time(),
            "pid": os.getpid(),
            "route": route,
            "status": int(status),
            "dur_s": round(float(dur_s), 6),
        }
        if trace_id:
            rec["trace"] = trace_id
        if hops:
            rec["hops"] = dict(hops)
        now = self._clock()
        with self._lock:
            self._ring.append(rec)
            if status < 500:
                return False
            self._5xx.append(now)
            horizon = now - self.burst_window_s
            while self._5xx and self._5xx[0] < horizon:
                self._5xx.popleft()
            if len(self._5xx) < self.burst_threshold:
                return False
            if self.limiter is not None:
                # the shared alert/incident limiter owns dump cadence
                return self.limiter.allow("5xx-burst")
            if now - self._last_burst_dump >= self.burst_window_s:
                self._last_burst_dump = now
                return True
        return False

    def snapshot(self) -> List[Dict]:
        with self._lock:
            return list(self._ring)

    def snapshot_doc(self, reason: str) -> Dict:
        """The dump document WITHOUT touching disk — what ``GET
        /debug/flight`` returns and the incident manager files into a
        bundle (one schema for on-disk and over-the-wire dumps)."""
        return {
            "schema": "gene2vec-tpu/flight/v1",
            "reason": reason,
            "written_unix": time.time(),
            "pid": os.getpid(),
            "records": self.snapshot(),
        }

    def dump(self, dirpath: str, reason: str) -> str:
        """Write the current ring to ``<dirpath>/flight-<pid>-<n>.json``
        (tmp + rename, so reassembly never reads a torn dump)."""
        os.makedirs(dirpath, exist_ok=True)
        path = os.path.join(
            dirpath, f"{FLIGHT_PREFIX}{os.getpid()}-{next(self._seq)}.json"
        )
        doc = self.snapshot_doc(reason)
        tmp = f"{path}.tmp"
        with open(tmp, "w", encoding="utf-8") as f:
            json.dump(doc, f, indent=1)
            f.write("\n")
        os.replace(tmp, path)
        return path


# -- reassembly --------------------------------------------------------------


def _iter_artifact_files(root: str) -> Iterator[Tuple[str, str]]:
    """(kind, path) for every events.jsonl / flight dump under root."""
    for dirpath, _, filenames in os.walk(root):
        for fname in sorted(filenames):
            if fname == "events.jsonl":
                yield "events", os.path.join(dirpath, fname)
            elif fname.startswith(FLIGHT_PREFIX) and fname.endswith(".json"):
                yield "flight", os.path.join(dirpath, fname)


def _read_jsonl(path: str) -> List[Dict]:
    out = []
    try:
        with open(path, "r", encoding="utf-8") as f:
            for line in f:
                line = line.strip()
                if not line:
                    continue
                try:
                    out.append(json.loads(line))
                except json.JSONDecodeError:
                    continue  # torn trailing line (a SIGKILLed writer)
    except OSError:
        pass
    return out


def _expand_process_subtree(
    span_id: str, pid: int, by_parent: Dict[Tuple[int, str], List[Dict]],
    by_span: Dict[Tuple[int, str], Dict], depth: int = 0,
) -> List[Dict]:
    """The process-local span subtree rooted at (pid, span_id) — how a
    ``batch_item`` hop picks up the ``serve_batch``/``serve_compute``/
    ``engine_topk`` spans that served it."""
    root = by_span.get((pid, span_id))
    if root is None or depth > 8:
        return []
    node = {
        "name": root.get("name"),
        "pid": pid,
        "wall": root.get("wall"),
        "dur": root.get("dur"),
        "attrs": root.get("attrs") or {},
        "children": [],
    }
    for child in sorted(
        by_parent.get((pid, span_id), []), key=lambda r: r.get("wall", 0.0)
    ):
        node["children"].extend(_expand_process_subtree(
            child.get("span"), pid, by_parent, by_span, depth + 1
        ))
    return [node]


def collect_trace(root_dir: str, trace_id: str) -> Dict:
    """Reassemble one trace from every ``events.jsonl`` and flight dump
    under ``root_dir`` (pass a fleet export dir to cover the proxy's
    run AND every replica's)."""
    hop_records: List[Dict] = []
    by_span: Dict[Tuple[int, str], Dict] = {}
    by_parent: Dict[Tuple[int, str], List[Dict]] = {}
    flight: List[Dict] = []
    n_files = 0
    for kind, path in _iter_artifact_files(root_dir):
        n_files += 1
        if kind == "flight":
            try:
                with open(path, "r", encoding="utf-8") as f:
                    doc = json.load(f)
            except (OSError, ValueError):
                continue
            for rec in doc.get("records", []):
                if rec.get("trace") == trace_id:
                    flight.append({**rec, "source": path})
            continue
        # one file in memory at a time; its span index is kept ONLY
        # when this file contributed a hop that references a
        # process-local subtree — a fleet export dir also holds long
        # training histories whose spans a single-trace lookup must
        # not retain
        records = _read_jsonl(path)
        matched = []
        needs_index = False
        for rec in records:
            if rec.get("trace") == trace_id:
                matched.append({**rec, "source": path})
                if rec.get("hop") and rec.get("span"):
                    needs_index = True
        hop_records.extend(matched)
        if not needs_index:
            continue
        for rec in records:
            if rec.get("type") != "span_end" or rec.get("hop"):
                # hop records carry the ENCLOSING span's id in `span`;
                # indexing them under it would mislabel the subtree
                # root whenever the real span_end never landed (a
                # SIGKILL mid-batch — the forensics case)
                continue
            pid = rec.get("pid")
            if rec.get("span"):
                by_span[(pid, rec["span"])] = rec
            if rec.get("parent"):
                by_parent.setdefault(
                    (pid, rec["parent"]), []
                ).append(rec)

    # one node per hop (tsid); the primary record is the outermost
    # span_end in the hop (max dur) — every record written under one
    # installed context shares the tsid
    groups: Dict[str, List[Dict]] = {}
    for rec in hop_records:
        tsid = rec.get("tsid")
        if tsid:
            groups.setdefault(tsid, []).append(rec)

    nodes: Dict[str, Dict] = {}
    for tsid, recs in groups.items():
        span_ends = [r for r in recs if r.get("type") == "span_end"]
        pool = span_ends or recs
        primary = max(pool, key=lambda r: float(r.get("dur") or 0.0))
        node = {
            "tsid": tsid,
            "tpid": primary.get("tpid"),
            "name": primary.get("name"),
            "pid": primary.get("pid"),
            "wall": primary.get("wall"),
            "dur": primary.get("dur"),
            "attrs": primary.get("attrs") or {},
            "records": len(recs),
            "children": [],
            "process_spans": [],
        }
        # a batch_item hop carries the worker's enclosing serve_batch
        # span id in its process-local `span` field — expand that
        # subtree so "batcher → engine" is visible per trace
        if primary.get("name") == "batch_item" and primary.get("span"):
            node["process_spans"] = _expand_process_subtree(
                primary["span"], primary.get("pid"), by_parent, by_span
            )
        nodes[tsid] = node

    roots: List[Dict] = []
    for node in nodes.values():
        parent = nodes.get(node["tpid"]) if node["tpid"] else None
        if parent is not None:
            parent["children"].append(node)
        else:
            roots.append(node)
    for node in nodes.values():
        node["children"].sort(key=lambda n: n.get("wall") or 0.0)
    roots.sort(key=lambda n: n.get("wall") or 0.0)

    return {
        "trace_id": trace_id,
        "files_scanned": n_files,
        "hop_records": len(hop_records),
        "processes": sorted(
            {n["pid"] for n in nodes.values() if n.get("pid")}
        ),
        "roots": roots,
        "flight": sorted(flight, key=lambda r: r.get("wall", 0.0)),
    }


def _fmt_dur(dur) -> str:
    if dur is None:
        return "?"
    dur = float(dur)
    return f"{dur * 1e3:.1f}ms" if dur < 1 else f"{dur:.2f}s"


def _format_node(node: Dict, indent: int, t0: float, lines: List[str],
                 process_level: bool = False) -> None:
    attrs = node.get("attrs") or {}
    shown = " ".join(
        f"{k}={attrs[k]}" for k in sorted(attrs)
        if isinstance(attrs[k], (str, int, float, bool))
    )
    wall = node.get("wall")
    offset = f"+{(wall - t0) * 1e3:.1f}ms" if wall is not None else "?"
    marker = "· " if process_level else ""
    lines.append(
        f"{'  ' * indent}{marker}{node.get('name')} "
        f"[pid {node.get('pid')}] {offset} dur={_fmt_dur(node.get('dur'))}"
        + (f"  {shown}" if shown else "")
    )
    for sub in node.get("process_spans", []):
        _format_node(sub, indent + 1, t0, lines, process_level=True)
    for child in node.get("children", []):
        _format_node(child, indent + 1, t0, lines, process_level)


def format_trace(doc: Dict) -> str:
    """Human-readable tree for ``cli.obs trace``."""
    lines = [
        f"trace {doc['trace_id']}: {doc['hop_records']} record(s) across "
        f"{len(doc['processes'])} process(es) "
        f"({doc['files_scanned']} artifact file(s) scanned)"
    ]
    if not doc["roots"] and not doc["flight"]:
        lines.append("  (no matching records — wrong run dir, an "
                     "unsampled trace, or events not yet flushed)")
        return "\n".join(lines)
    walls = [
        n["wall"] for n in doc["roots"] if n.get("wall") is not None
    ] + [r["wall"] for r in doc["flight"] if r.get("wall") is not None]
    t0 = min(walls) if walls else 0.0
    for root in doc["roots"]:
        _format_node(root, 1, t0, lines)
    if doc["flight"]:
        lines.append("flight-recorder records:")
        for rec in doc["flight"]:
            hops = rec.get("hops") or {}
            hop_txt = " ".join(
                f"{k}={v}" for k, v in sorted(hops.items())
            )
            lines.append(
                f"  pid {rec.get('pid')} {rec.get('route')} "
                f"status={rec.get('status')} "
                f"dur={_fmt_dur(rec.get('dur_s'))}"
                + (f"  {hop_txt}" if hop_txt else "")
            )
    return "\n".join(lines)
