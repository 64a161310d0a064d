"""Incident capture: bundle the evidence the moment a rule fires.

When an :class:`~gene2vec_tpu_torch.obs.alerts.AlertEvaluator` rule
transitions to ``firing``, the on-call wants three things in one place:
*what fired*, *what the fleet looked like*, and *what a slow/failed
request actually did*.  :class:`IncidentManager` assembles exactly that
into a bounded **incident bundle** under
``<run_dir>/incidents/<ts>_<rule>/``:

* ``rule.json``            — the triggering rule, the transition record,
  and the snapshot values it fired on;
* ``metrics_window.json``  — the aggregator's RAW per-target scrape ring
  (the un-merged series, so per-replica attribution survives the merge:
  *which* replica's counters went bad is readable after the fact);
* ``flightdump-<pid>.json`` — a SIGQUIT-equivalent flight-recorder dump
  solicited from every live replica via ``GET /debug/flight``
  (serve/server.py) plus the proxy's own ring — the requests *around*
  the incident, even the unsampled ones;
* ``trace-<id>.json``      — the slowest sampled traces in the window,
  reassembled across every process via the existing
  :func:`~gene2vec_tpu_torch.obs.flight.collect_trace`;
* ``incident.MANIFEST.json`` — CRC32/size stamps over every bundle file
  via the resilience snapshot primitives
  (:func:`~gene2vec_tpu_torch.resilience.snapshot.write_manifest`), written
  LAST — a bundle without a verifying manifest is torn, exactly like a
  checkpoint.

Assembly is **rate-limited** (the :class:`~gene2vec_tpu_torch.obs.alerts.
RateLimiter` shared with the flight recorder's burst dumps) and
**disk-capped** (``max_bundles`` newest kept, hard ``max_total_bytes``
ceiling), so a flapping rule can never fill the disk.  It runs on its
own thread (``fire_async``) — the aggregator's scrape tick must never
block on N replica fetches.

``python -m gene2vec_tpu_torch.cli.obs incident <bundle>`` verifies the
manifest and renders the bundle.
"""

from __future__ import annotations

import json
import os
import sys
import threading
import time
import urllib.request
from typing import Callable, Dict, List, Optional, Sequence

from gene2vec_tpu_torch.obs import flight as flight_mod
from gene2vec_tpu_torch.resilience import snapshot as snap

SCHEMA = "gene2vec-tpu/incident/v1"
#: bundle files whose prefix deliberately does NOT match the flight
#: recorder's ``flight-`` discovery prefix: a bundle lives inside the
#: run-dir tree that ``collect_trace`` scans, and its copies must not
#: double-count as live dumps
FLIGHTDUMP_PREFIX = "flightdump-"
MANIFEST_PREFIX = "incident"


def _dir_bytes(root: str) -> int:
    total = 0
    for dirpath, _, filenames in os.walk(root):
        for name in filenames:
            try:
                total += os.path.getsize(os.path.join(dirpath, name))
            except OSError:
                continue
    return total


def _default_fetch(url: str, timeout_s: float) -> Dict:
    with urllib.request.urlopen(
        f"{url}/debug/flight", timeout=timeout_s
    ) as r:
        return json.loads(r.read().decode("utf-8"))


def collect_trace_multi(roots: Sequence[str], trace_id: str) -> Dict:
    """:func:`~gene2vec_tpu_torch.obs.flight.collect_trace` over several scan
    roots (export dir + an out-of-tree fleet run dir), merged into one
    document.  Nested/duplicate roots are deduped by path prefix."""
    kept: List[str] = []
    for root in sorted(
        {os.path.abspath(r) for r in roots if r}, key=len
    ):
        if not any(
            root == k or root.startswith(k + os.sep) for k in kept
        ):
            kept.append(root)
    merged: Optional[Dict] = None
    for root in kept:
        doc = flight_mod.collect_trace(root, trace_id)
        if merged is None:
            merged = doc
            continue
        merged["files_scanned"] += doc["files_scanned"]
        merged["hop_records"] += doc["hop_records"]
        merged["processes"] = sorted(
            set(merged["processes"]) | set(doc["processes"])
        )
        merged["roots"].extend(doc["roots"])
        merged["flight"].extend(doc["flight"])
    return merged if merged is not None else {
        "trace_id": trace_id, "files_scanned": 0, "hop_records": 0,
        "processes": [], "roots": [], "flight": [],
    }


class IncidentManager:
    """Assembles one bundle per allowed firing.

    ``targets`` is a zero-arg callable returning the replica base URLs
    to solicit flight dumps from (the supervisor's live set);
    ``local_flight`` is the calling process's own
    :class:`~gene2vec_tpu_torch.obs.flight.FlightRecorder` (the proxy's ring
    is captured in-process, not over HTTP); ``aggregator`` provides the
    raw scrape window; ``scan_roots`` are the directory trees trace
    reassembly walks.  ``fetch`` and ``clock`` are injectable for
    tests.
    """

    def __init__(
        self,
        incidents_dir: str,
        scan_roots: Sequence[str] = (),
        targets: Optional[Callable[[], Sequence[str]]] = None,
        local_flight=None,
        aggregator=None,
        limiter=None,
        metrics=None,
        fetch: Callable[[str, float], Dict] = _default_fetch,
        fetch_timeout_s: float = 3.0,
        window_s: float = 120.0,
        max_traces: int = 3,
        max_bundles: int = 8,
        max_total_bytes: int = 64 << 20,
        clock=time.monotonic,
    ):
        self.incidents_dir = os.path.abspath(incidents_dir)
        self.scan_roots = list(scan_roots)
        self.targets = targets
        self.local_flight = local_flight
        self.aggregator = aggregator
        self.limiter = limiter
        self.metrics = metrics
        self._fetch = fetch
        self.fetch_timeout_s = fetch_timeout_s
        self.window_s = window_s
        self.max_traces = max_traces
        self.max_bundles = max_bundles
        self.max_total_bytes = max_total_bytes
        self._clock = clock
        self._lock = threading.Lock()
        self.last_bundle: Optional[str] = None

    # -- entry points ------------------------------------------------------

    def fire_async(self, rule, snapshot: Dict, record: Dict) -> None:
        """``AlertEvaluator.on_fire`` adapter: assemble on a background
        thread so the scrape tick never blocks on replica fetches."""
        threading.Thread(
            target=self.on_fire, args=(rule, snapshot, record),
            name=f"incident-{getattr(rule, 'name', 'rule')}", daemon=True,
        ).start()

    def on_fire(self, rule, snapshot: Dict, record: Dict) -> Optional[str]:
        """Assemble one bundle; returns its path, or None when rate- or
        disk-limited (counted, never raised — alerting must outlive its
        own forensics)."""
        try:
            return self._assemble(rule, snapshot, record)
        except Exception as e:
            self._count("incident_errors_total")
            print(f"incident: bundle assembly failed: {e!r}",
                  file=sys.stderr)
            return None

    # -- assembly ----------------------------------------------------------

    def _count(self, name: str, **labels) -> None:
        if self.metrics is not None:
            self.metrics.counter(
                name, labels=labels or None
            ).inc()

    def _assemble(self, rule, snapshot: Dict, record: Dict) -> Optional[str]:
        name = getattr(rule, "name", str(rule))
        if self.limiter is not None and not self.limiter.allow(
            f"incident:{name}"
        ):
            self._count("incident_rate_limited_total")
            return None
        with self._lock:  # one bundle at a time; overlap is re-limited
            self._prune()
            if _dir_bytes(self.incidents_dir) >= self.max_total_bytes:
                self._count("incident_disk_capped_total")
                return None
            bundle = self._bundle_dir(name)
            files: List[str] = []

            def write_json(fname: str, doc: Dict) -> None:
                path = os.path.join(bundle, fname)
                snap.atomic_write_json(path, doc)
                files.append(path)

            write_json("rule.json", {
                "schema": SCHEMA,
                "created_unix": time.time(),
                "rule": self._rule_doc(rule),
                "transition": record,
                "snapshot": {
                    k: v for k, v in snapshot.items()
                    if isinstance(v, (int, float, str))
                },
            })
            # raw per-target scrape window: the UN-merged series, so
            # "which replica went bad" survives the fleet merge
            if self.aggregator is not None:
                window = getattr(self.aggregator, "raw_recent", None)
                write_json("metrics_window.json", {
                    "schema": "gene2vec-tpu/incident-metrics/v1",
                    "window": window() if callable(window) else [],
                })
            flight_docs = self._solicit_flight(write_json)
            self._reassemble_traces(flight_docs, write_json)
            # the manifest is the bundle's commit record, written LAST
            snap.write_manifest(
                os.path.join(bundle, MANIFEST_PREFIX), files,
                meta={"incident_schema": SCHEMA, "rule": name},
            )
            self._count("incidents_total", rule=name)
            self.last_bundle = bundle
            return bundle

    def _rule_doc(self, rule) -> Dict:
        import dataclasses

        if dataclasses.is_dataclass(rule) and not isinstance(rule, type):
            return dataclasses.asdict(rule)
        return {"name": getattr(rule, "name", str(rule))}

    def _bundle_dir(self, rule_name: str) -> str:
        base = f"{int(time.time())}_{rule_name}"
        path = os.path.join(self.incidents_dir, base)
        n = 1
        while os.path.exists(path):  # same rule, same second
            path = os.path.join(self.incidents_dir, f"{base}.{n}")
            n += 1
        os.makedirs(path)
        return path

    def _prune(self) -> None:
        """Keep only the newest ``max_bundles - 1`` existing bundles
        (the one being assembled makes ``max_bundles``)."""
        try:
            entries = sorted(
                e for e in os.listdir(self.incidents_dir)
                if os.path.isdir(os.path.join(self.incidents_dir, e))
            )
        except OSError:
            return
        import shutil

        for stale in entries[: max(0, len(entries) - self.max_bundles + 1)]:
            try:
                shutil.rmtree(os.path.join(self.incidents_dir, stale))
                self._count("incident_bundles_pruned_total")
            except OSError:
                continue

    def _solicit_flight(self, write_json) -> List[Dict]:
        """The proxy's own ring + ``GET /debug/flight`` from every live
        replica.  A replica that cannot answer is counted and skipped —
        an incident bundle built DURING the incident must tolerate the
        incident."""
        docs: List[Dict] = []
        written = set()

        def emit(doc: Dict) -> None:
            docs.append(doc)
            pid = doc.get("pid", 0)
            fname = f"{FLIGHTDUMP_PREFIX}{pid}.json"
            n = 1
            while fname in written:  # pid collision guard
                fname = f"{FLIGHTDUMP_PREFIX}{pid}.{n}.json"
                n += 1
            written.add(fname)
            write_json(fname, doc)

        if self.local_flight is not None:
            emit(self.local_flight.snapshot_doc("incident"))
        for url in (self.targets() if self.targets is not None else ()):
            try:
                doc = self._fetch(url, self.fetch_timeout_s)
            except Exception:
                self._count("incident_flight_fetch_errors_total")
                continue
            if not isinstance(doc, dict) or "records" not in doc:
                self._count("incident_flight_fetch_errors_total")
                continue
            emit({**doc, "target": url})
        return docs

    def _reassemble_traces(self, flight_docs: List[Dict],
                           write_json) -> None:
        """The slowest sampled trace ids among the window's flight
        records, reassembled cross-process."""
        now = time.time()
        candidates: List[Dict] = []
        for doc in flight_docs:
            for rec in doc.get("records", ()):
                if not isinstance(rec, dict) or not rec.get("trace"):
                    continue
                if (now - float(rec.get("wall", 0.0))) > self.window_s:
                    continue
                candidates.append(rec)
        candidates.sort(
            key=lambda r: float(r.get("dur_s", 0.0)), reverse=True
        )
        seen = set()
        for rec in candidates:
            if len(seen) >= self.max_traces:
                break
            tid = rec["trace"]
            if tid in seen:
                continue
            seen.add(tid)
            doc = collect_trace_multi(self.scan_roots, tid)
            doc["picked_for"] = {
                "route": rec.get("route"), "status": rec.get("status"),
                "dur_s": rec.get("dur_s"),
            }
            write_json(f"trace-{tid}.json", doc)


# -- verification + rendering (cli.obs incident) ------------------------------


def verify_bundle(bundle_dir: str):
    """CRC-verify one bundle via the resilience manifest primitives.
    Returns the :class:`~gene2vec_tpu_torch.resilience.snapshot.VerifyResult`
    (falsy with a machine-parseable reason on a torn bundle)."""
    return snap.verify_manifest(
        os.path.join(bundle_dir, MANIFEST_PREFIX), use_cache=False
    )


def _read_json(path: str) -> Optional[Dict]:
    try:
        with open(path, "r", encoding="utf-8") as f:
            doc = json.load(f)
        return doc if isinstance(doc, dict) else None
    except (OSError, ValueError):
        return None


def format_bundle(bundle_dir: str, verify) -> str:
    """Human-readable bundle report (the cli.obs incident runbook view:
    docs/OBSERVABILITY.md#reading-a-bundle)."""
    lines = [f"incident bundle {bundle_dir}"]
    lines.append(
        f"  manifest: {'VERIFIED' if verify else f'FAILED ({verify.reason})'}"
    )
    rule = _read_json(os.path.join(bundle_dir, "rule.json")) or {}
    r = rule.get("rule") or {}
    tr = rule.get("transition") or {}
    lines.append(
        f"  rule: {r.get('name')} [{r.get('severity')}] kind={r.get('kind')}"
    )
    value = tr.get("value")
    lines.append(
        f"  fired: {tr.get('from')} -> {tr.get('to')}"
        + (f" at value {value:g}" if isinstance(value, (int, float)) else "")
    )
    snapshot = rule.get("snapshot") or {}
    for key in sorted(snapshot):
        if key.startswith("_"):
            continue
        v = snapshot[key]
        if isinstance(v, (int, float)):
            lines.append(f"    {key} = {v:g}")
    metrics = _read_json(os.path.join(bundle_dir, "metrics_window.json"))
    if metrics is not None:
        window = metrics.get("window") or []
        targets = sorted({w.get("target") for w in window
                          if isinstance(w, dict)})
        lines.append(
            f"  metrics window: {len(window)} raw scrape(s) across "
            f"{len(targets)} target(s)"
        )
    try:
        names = sorted(os.listdir(bundle_dir))
    except OSError:
        names = []
    dumps = [n for n in names if n.startswith(FLIGHTDUMP_PREFIX)]
    traces = [n for n in names if n.startswith("trace-")]
    lines.append(f"  flight dumps: {len(dumps)} ({', '.join(dumps)})"
                 if dumps else "  flight dumps: none")
    for name in traces:
        doc = _read_json(os.path.join(bundle_dir, name)) or {}
        picked = doc.get("picked_for") or {}
        lines.append(
            f"  trace {doc.get('trace_id', name)}: "
            f"{doc.get('hop_records', 0)} record(s) across "
            f"{len(doc.get('processes', []))} process(es)"
            + (
                f"  [{picked.get('route')} status={picked.get('status')} "
                f"dur={picked.get('dur_s')}s]" if picked else ""
            )
        )
    if not traces:
        lines.append("  traces: none reassembled")
    return "\n".join(lines)
