"""The port's SLO alerting and incident capture on the CPU against the JAX
package's: rule parsing and the default rules, the evaluator's transitions
over scripted sample series (debounce, hysteresis, burn rate, counter
resets, staleness) equal the reference's, the aggregator's staleness, the
shared rate limiter, incident bundles that the unchanged reference reader
verifies, ``alerts.jsonl`` that the reference's ``collect_transitions``
reads, the ``cli.obs alerts|incident`` contracts and the server's
``/debug/flight``."""

import contextlib
import dataclasses
import io
import json
import os
import threading
import time
import urllib.request

import numpy as np
import pytest
import torch

from gene2vec_tpu.obs import alerts as ref_alerts
from gene2vec_tpu.obs import incident as ref_incident
from gene2vec_tpu_torch.cli import obs as obs_cli
from gene2vec_tpu_torch.io.checkpoint import save_iteration
from gene2vec_tpu_torch.io.vocab import Vocab
from gene2vec_tpu_torch.obs import alerts
from gene2vec_tpu_torch.obs.aggregate import FleetAggregator, parse_prometheus
from gene2vec_tpu_torch.obs.alerts import (
    AlertEvaluator,
    RateLimiter,
    collect_transitions,
    default_rules,
    format_timeline,
    parse_rules,
)
from gene2vec_tpu_torch.obs.flight import FlightRecorder
from gene2vec_tpu_torch.obs.incident import IncidentManager, verify_bundle
from gene2vec_tpu_torch.obs.registry import MetricsRegistry
from gene2vec_tpu_torch.serve.registry import ModelRegistry
from gene2vec_tpu_torch.serve.server import ServeApp, ServeConfig, make_server
from gene2vec_tpu_torch.sgns.model import SGNSParams


class FakeClock:
    def __init__(self, t=0.0):
        self.t = t

    def __call__(self):
        return self.t


def _threshold_rule(mod=alerts, **kw):
    base = dict(name="q", metric="fleet_queue_depth", op=">", value=5.0, clear_value=2.0,
                for_s=2.0, clear_for_s=3.0)
    base.update(kw)
    return mod.AlertRule(**base)


def _burn_rule(mod=alerts, **kw):
    base = dict(name="burn", kind="burn_rate", good="ok", total="all", max_bad_frac=0.02,
                short_window_s=5.0, long_window_s=10.0, min_count=10.0, for_s=0.0,
                clear_for_s=5.0)
    base.update(kw)
    return mod.AlertRule(**base)


def _firing(transitions):
    return [t for t in transitions if t["to"] == "firing"]


# -- rules ----------------------------------------------------------------------------


def test_parse_rules_validates():
    rules = parse_rules({"rules": [
        {"name": "a", "metric": "m", "op": ">", "value": 1.0},
        {"name": "b", "kind": "burn_rate", "good": "ok", "total": "all"},
    ]})
    assert [r.name for r in rules] == ["a", "b"]
    for doc, match in (
        ({"rules": [{"name": "a", "metric": "m", "treshold": 3}]}, "unknown field"),
        ({"rules": [{"name": "a", "metric": "m"}, {"name": "a", "metric": "m"}]}, "duplicate"),
        ({"rules": [{"name": "a", "kind": "nope"}]}, "kind"),
        ({"rules": [{"name": "a", "kind": "burn_rate"}]}, "'good' and 'total'"),
        ({"rules": [{"name": "a", "metric": "m", "op": "!="}]}, "op"),
        ({}, "rules"),
    ):
        with pytest.raises(ValueError, match=match):
            parse_rules(doc)
        with pytest.raises(ValueError, match=match):
            ref_alerts.parse_rules(doc)


def test_default_rules_equal_reference(tmp_path):
    got, want = default_rules(), ref_alerts.default_rules()
    assert [dataclasses.asdict(r) for r in got] == [dataclasses.asdict(r) for r in want]
    by_name = {r.name: r for r in got}
    assert by_name["availability-burn"].kind == "burn_rate"
    assert (by_name["availability-burn"].good, by_name["availability-burn"].total) == (
        "fleet_ok", "fleet_responses")
    path = tmp_path / "alerts.json"
    path.write_text(json.dumps({"rules": [dataclasses.asdict(r) for r in want]}))
    assert [dataclasses.asdict(r) for r in alerts.load_rules(str(path))] == \
        [dataclasses.asdict(r) for r in want]


# -- the evaluator: the reference's transitions over scripted series ----------------

HOT, WARM, COLD = ({"fleet_queue_depth": v, "_fresh_targets": 1.0} for v in (10.0, 3.0, 1.0))

#: scenario -> (rule factory, [(clock, snapshot), ...])
SCENARIOS = {
    "debounce_boundary": (lambda m: [_threshold_rule(m, for_s=2.0)],
                          [(0.0, HOT), (1.999, HOT), (2.0, HOT), (2.5, HOT)]),
    "breach_lost_in_debounce": (lambda m: [_threshold_rule(m, for_s=2.0)],
                                [(0.0, HOT), (1.0, COLD), (5.0, HOT)]),
    "hysteresis": (lambda m: [_threshold_rule(m, for_s=0.0, clear_for_s=3.0)],
                   [(0.0, HOT), (1.0, COLD), (2.0, WARM), (4.5, COLD), (7.4, COLD),
                    (7.5, COLD), (8.0, HOT)]),
    "missing_metric": (lambda m: [_threshold_rule(m, for_s=0.0)],
                       [(0.0, {"_fresh_targets": 1.0}), (1.0, HOT)]),
    "burn_sustained": (lambda m: [_burn_rule(m)],
                       [(float(i), {"ok": 100.0 * (i + 1), "all": 100.0 * (i + 1)})
                        for i in range(3)]
                       + [(float(i), {"ok": 300.0 + (i - 2) * 50.0, "all": 100.0 * (i + 1)})
                          for i in range(3, 8)]),
    "burn_counter_reset": (lambda m: [_burn_rule(m)],
                           [(float(i), {"ok": g, "all": g}) for i, g in enumerate(
                               (100.0, 200.0, 20.0, 120.0, 220.0, 320.0))]),
    "burn_min_count": (lambda m: [_burn_rule(m, min_count=10.0)],
                       [(0.0, {"ok": 0.0, "all": 1.0}), (1.0, {"ok": 0.0, "all": 2.0}),
                        (2.0, {"ok": 0.0, "all": 4.0})]),
    "availability_total_outage": (
        lambda m: [r for r in m.default_rules() if r.name == "availability-burn"],
        [(i * 10.0, {"fleet_ok": 10.0, "fleet_responses": 10.0 + 50.0 * i,
                     "_fresh_targets": 0.0}) for i in range(8)]),
    "staleness_holds": (lambda m: [_threshold_rule(m, for_s=0.0)],
                        [(0.0, {"fleet_queue_depth": 10.0, "_fresh_targets": 0.0}),
                         (1.0, {"fleet_queue_depth": 10.0, "_fresh_targets": 2.0}),
                         (100.0, {"fleet_queue_depth": 0.0, "_fresh_targets": 0.0})]),
    "every_default_rule": (lambda m: m.default_rules(), [
        (t, {"fleet_ok": 100.0 * t, "fleet_responses": 100.0 * t + (40.0 * t if t > 5 else 0),
             "fleet_queue_depth": 50.0 if 10 < t < 20 else 0.0,
             "fleet_rejection_rate": 0.2 if t > 15 else 0.0,
             "fleet_route_p99_seconds{route=/v1/similar}": 3.0 if t > 12 else 0.01,
             "_fresh_targets": 3.0})
        for t in np.arange(0.0, 60.0, 0.5).tolist()]),
}


@pytest.mark.parametrize("name", sorted(SCENARIOS))
def test_evaluator_transitions_equal_reference(name):
    rules_of, series = SCENARIOS[name]
    got = {}
    for pkg, mod in (("port", alerts), ("reference", ref_alerts)):
        clk = FakeClock()
        ev = mod.AlertEvaluator(rules_of(mod), clock=clk)
        out = []
        for t, snap in series:
            clk.t = t
            out.append(ev.observe(dict(snap), wall=1_800_000_000.0 + t))
        got[pkg] = (out, ev.states())
    assert got["port"] == got["reference"]
    transitions, states = got["port"]
    firing = [_firing(step) for step in transitions]
    if name == "debounce_boundary":  # the for_s boundary fires, not a tick early
        assert [len(f) for f in firing] == [0, 0, 1, 0]
    elif name == "hysteresis":  # no flap inside the band; a full clear re-arms
        assert [len(f) for f in firing] == [1, 0, 0, 0, 0, 0, 1]
        assert [t["to"] for t in transitions[5]] == ["inactive"]
    elif name in ("burn_counter_reset", "burn_min_count", "missing_metric"):
        assert not any(firing[:1 if name == "missing_metric" else None])
    elif name in ("burn_sustained", "availability_total_outage"):
        assert sum(len(f) for f in firing) == 1
    elif name == "staleness_holds":
        assert transitions[0] == [] and states["q"] == "firing"
    elif name == "every_default_rule":
        assert {t["rule"] for f in firing for t in f} >= {"availability-burn", "route-p99"}


def test_evaluator_exports_state_and_log(tmp_path):
    clk = FakeClock()
    reg = MetricsRegistry()
    fired = []
    ev = AlertEvaluator([_threshold_rule(for_s=0.0)], registry=reg,
                        log_path=str(tmp_path / "alerts.jsonl"),
                        on_fire=lambda rule, snap, rec: fired.append(rule.name), clock=clk)
    assert 'fleet_alert_active{rule="q"} 0' in reg.prometheus_text()
    ev.observe({"fleet_queue_depth": 10.0, "_fresh_targets": 1.0})
    text = reg.prometheus_text()
    assert 'fleet_alert_active{rule="q"} 1' in text
    assert 'fleet_alert_transitions_total{rule="q",to="firing"} 1' in text
    assert fired == ["q"]
    records = collect_transitions(str(tmp_path))
    assert [r["to"] for r in records] == ["pending", "firing"]
    # the unchanged reference reader takes the port's log as it is
    assert ref_alerts.collect_transitions(str(tmp_path)) == records
    assert format_timeline(records) == ref_alerts.format_timeline(records)
    assert "FIRING" in format_timeline(records)


# -- the aggregator's staleness -------------------------------------------------------


def _replica_text(requests, route_ms):
    r = MetricsRegistry()
    r.counter("serve_requests_total").inc(requests)
    h = r.histogram("serve_route_seconds", labels={"route": "/v1/similar"},
                    buckets=(0.001, 0.008, 0.064, 0.512))
    for ms in route_ms:
        h.observe(ms / 1000.0)
    return r.prometheus_text()


def test_aggregator_marks_series_stale_and_quantiles_go_fresh_only():
    texts = {"http://fast": _replica_text(100, [2.0] * 100),
             "http://slow": _replica_text(100, [400.0] * 100)}
    alive = dict(texts)
    snapshots = []

    class Sink:
        def observe(self, snapshot, wall=None):
            snapshots.append(snapshot)

    agg = FleetAggregator(lambda: list(texts), fetch=lambda url, t: alive[url],
                          stale_after=2, evaluator=Sink())

    def scrape():
        agg.scrape_once()
        return {(s.name, s.labels): s.value for s in parse_prometheus(agg.fleet_text())}

    key99 = ("fleet_route_p99_seconds", (("route", "/v1/similar"),))
    stale = ("fleet_scrape_staleness", (("target", "http://slow"),))
    s = scrape()
    assert s[key99] >= 0.064 and s[stale] == 0 and snapshots[-1]["_fresh_targets"] == 2.0
    del alive["http://slow"]  # wedged: listed, not answering
    s = scrape()
    assert s[stale] == 1 and s[("fleet_stale_targets", ())] == 0 and s[key99] >= 0.064
    s = scrape()
    assert s[stale] == 2 and s[("fleet_stale_targets", ())] == 1 and s[key99] <= 0.008
    assert snapshots[-1]["_fresh_targets"] == 1.0 and s[("fleet_requests", ())] == 200
    alive["http://slow"] = texts["http://slow"]
    s = scrape()
    assert s[stale] == 0 and s[key99] >= 0.064 and s[("fleet_requests", ())] == 200
    del texts["http://slow"], alive["http://slow"]  # departed: its series go too
    assert stale not in scrape()
    agg.view.close()


# -- the shared rate limiter and the flight burst --------------------------------------


def test_rate_limiter_equals_reference():
    got = {}
    for pkg, mod in (("port", alerts), ("reference", ref_alerts)):
        clk = FakeClock()
        lim = mod.RateLimiter(min_interval_s=30.0, max_per_window=3, window_s=100.0,
                              clock=clk)
        out = []
        for t, key in ((0, "a"), (0, "a"), (0, "b"), (31, "a"), (32, "c"), (131, "c"),
                       (131, "a"), (140, "b"), (200, "d"), (200, "d")):
            clk.t = float(t)
            out.append(lim.allow(key))
        got[pkg] = (out, lim.denied)
    assert got["port"] == got["reference"]
    assert got["port"][0][:6] == [True, False, True, True, False, True]


def test_flight_burst_configurable_and_shared_limiter():
    clk = FakeClock()
    lim = RateLimiter(min_interval_s=60.0, max_per_window=10, window_s=3600.0, clock=clk)
    rec = FlightRecorder(burst_threshold=3, burst_window_s=1.0, clock=clk, limiter=lim)
    assert [rec.record("/v1/similar", 500, 0.01) for _ in range(4)] == [False, False, True,
                                                                         False]
    assert not lim.allow("5xx-burst")  # the burst spent the shared budget
    assert lim.allow("incident:availability-burn")
    clk.t = 61.0
    rec2 = FlightRecorder(burst_threshold=2, burst_window_s=1.0, clock=clk, limiter=lim)
    assert [rec2.record("/x", 503, 0.01) for _ in range(2)] == [False, True]
    doc = rec2.snapshot_doc("debug")
    assert doc["schema"] == "gene2vec-tpu/flight/v1"
    assert len(doc["records"]) == 2 and doc["pid"] == os.getpid()


# -- incident bundles -----------------------------------------------------------------


def _span_end(path, trace, tsid, name, pid, wall, dur, tpid=None):
    rec = {"type": "span_end", "name": name, "trace": trace, "tsid": tsid, "pid": pid,
           "wall": wall, "dur": dur, "span": None}
    if tpid:
        rec["tpid"] = tpid
    with open(path, "a") as f:
        f.write(json.dumps(rec) + "\n")


@pytest.fixture
def bundle_env(tmp_path):
    """A two-process trace on disk and replica flight fetch stubs."""
    now = time.time()
    scan = tmp_path / "export"
    (scan / "fleet_runs" / "1").mkdir(parents=True)
    (scan / "serve_runs" / "1").mkdir(parents=True)
    proxy_events = str(scan / "fleet_runs" / "1" / "events.jsonl")
    replica_events = str(scan / "serve_runs" / "1" / "events.jsonl")
    slow_tid, fast_tid = "a" * 32, "b" * 32
    _span_end(proxy_events, slow_tid, "11", "proxy_request", 100, now - 2.0, 0.5)
    _span_end(replica_events, slow_tid, "22", "serve_request", 200, now - 1.9, 0.45,
              tpid="11")
    _span_end(proxy_events, fast_tid, "33", "proxy_request", 100, now - 1.0, 0.002)
    local = FlightRecorder()
    local.record("/v1/similar", 200, 0.5, trace_id=slow_tid)
    local.record("/v1/similar", 200, 0.002, trace_id=fast_tid)

    def fetch(url, timeout):
        if url == "http://dead":
            raise OSError("replica mid-incident")
        return {"schema": "gene2vec-tpu/flight/v1", "reason": "debug", "pid": 200,
                "records": [{"wall": now - 1.9, "pid": 200, "route": "/v1/similar",
                             "status": 200, "dur_s": 0.45, "trace": slow_tid}]}

    class Agg:
        def raw_recent(self):
            return [{"wall": now, "target": "http://r0",
                     "samples": {"serve_requests_total": 7.0}}]

    return {"scan": str(scan), "local": local, "fetch": fetch, "agg": Agg(),
            "slow_tid": slow_tid, "incidents": str(tmp_path / "run" / "incidents")}


def test_incident_bundle_assembly_and_verification(bundle_env):
    reg = MetricsRegistry()
    mgr = IncidentManager(
        bundle_env["incidents"], scan_roots=[bundle_env["scan"]],
        targets=lambda: ["http://r0", "http://dead"], local_flight=bundle_env["local"],
        aggregator=bundle_env["agg"], limiter=RateLimiter(min_interval_s=30.0,
                                                          clock=FakeClock()),
        metrics=reg, fetch=bundle_env["fetch"], max_traces=1)
    rule = _threshold_rule(name="route-p99")
    bundle = mgr.on_fire(rule, {"fleet_queue_depth": 9.0, "_fresh_targets": 2.0},
                         {"rule": "route-p99", "from": "pending", "to": "firing",
                          "value": 9.0})
    assert bundle and os.path.basename(bundle).endswith("_route-p99")
    names = sorted(os.listdir(bundle))
    assert {"rule.json", "metrics_window.json", "incident.MANIFEST.json"} <= set(names)
    assert len([n for n in names if n.startswith("flightdump-")]) == 2
    assert reg.counter("incident_flight_fetch_errors_total").value == 1
    traces = [n for n in names if n.startswith("trace-")]
    assert traces == [f"trace-{bundle_env['slow_tid']}.json"]  # the slowest trace
    with open(os.path.join(bundle, traces[0])) as f:
        doc = json.load(f)
    assert set(doc["processes"]) == {100, 200} and doc["picked_for"]["dur_s"] == 0.5
    assert verify_bundle(bundle)
    # the unchanged reference reader verifies the port's bundle
    ref_verify = ref_incident.verify_bundle(bundle)
    assert ref_verify and ref_verify.manifest == verify_bundle(bundle).manifest
    with open(os.path.join(bundle, "rule.json"), "a") as f:
        f.write("rot")
    for verify in (verify_bundle, ref_incident.verify_bundle):
        v = verify(bundle)
        assert not v and v.reason.startswith(("size:", "crc:"))
    assert mgr.on_fire(rule, {}, {}) is None  # same rule, same window: rate-limited
    assert reg.counter("incident_rate_limited_total").value == 1


def test_incident_bundle_disk_caps(bundle_env):
    mgr = IncidentManager(
        bundle_env["incidents"], scan_roots=[bundle_env["scan"]],
        local_flight=bundle_env["local"],
        limiter=RateLimiter(min_interval_s=0.0, max_per_window=100, clock=FakeClock()),
        max_bundles=2, metrics=MetricsRegistry())
    bundles = [mgr.on_fire(_threshold_rule(name=n), {}, {"to": "firing"}) for n in "abc"]
    assert all(bundles)
    kept = sorted(os.listdir(bundle_env["incidents"]))
    assert len(kept) == 2 and os.path.basename(bundles[2]) in kept  # oldest pruned
    mgr.max_total_bytes = 1
    assert mgr.on_fire(_threshold_rule(name="a"), {}, {"to": "firing"}) is None


# -- the CLI contracts ----------------------------------------------------------------


def _cli(*args):
    out, err = io.StringIO(), io.StringIO()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
        rc = obs_cli.main(list(args))
    return rc, out.getvalue(), err.getvalue()


def test_cli_obs_alerts_contract(tmp_path):
    run_dir = tmp_path / "fleet_runs" / "1"
    run_dir.mkdir(parents=True)
    assert _cli("alerts", str(tmp_path))[0] == 1  # no transitions
    assert _cli("alerts", str(tmp_path / "nope"))[0] == 2
    with open(run_dir / "alerts.jsonl", "w") as f:
        f.write(json.dumps({"wall": 1000.0, "rule": "availability-burn", "severity": "page",
                            "from": "pending", "to": "firing", "value": 0.2}) + "\n")
        f.write("{torn")  # a torn trailing line is skipped
    rc, out, err = _cli("alerts", str(tmp_path))
    assert rc == 0, err
    assert "availability-burn" in out and "FIRING" in out
    rc, out, _ = _cli("alerts", "--json", str(tmp_path))
    assert rc == 0 and json.loads(out)[0]["rule"] == "availability-burn"


def test_cli_obs_incident_contract(bundle_env):
    mgr = IncidentManager(bundle_env["incidents"], scan_roots=[bundle_env["scan"]],
                          local_flight=bundle_env["local"], metrics=MetricsRegistry())
    bundle = mgr.on_fire(_threshold_rule(name="queue-depth"), {"fleet_queue_depth": 9.0},
                         {"rule": "queue-depth", "from": "pending", "to": "firing",
                          "value": 9.0})
    rc, out, err = _cli("incident", bundle)
    assert rc == 0, err
    assert "VERIFIED" in out and "queue-depth" in out
    rc, out, _ = _cli("incident", "--json", bundle)
    assert rc == 0 and json.loads(out)["verified"] is True
    os.unlink(os.path.join(bundle, "rule.json"))
    rc, out, err = _cli("incident", bundle)
    assert rc == 1 and "missing:rule.json" in out + err
    assert _cli("incident", bundle + "-nope")[0] == 2


# -- /debug/flight over HTTP ------------------------------------------------------------


def test_debug_flight_endpoint(tmp_path):
    export = str(tmp_path / "export")
    rng = np.random.RandomState(0)
    save_iteration(export, 4, 1, SGNSParams(torch.from_numpy(rng.randn(16, 4).astype(
        np.float32)), torch.zeros(16, 4)), Vocab([f"G{i}" for i in range(16)],
                                                 np.arange(16, 0, -1)), txt_output=False)
    registry = ModelRegistry(export, device="cpu")
    assert registry.refresh()
    app = ServeApp(registry, config=ServeConfig(burst_threshold=3, burst_window_s=1.0)).start()
    assert app.flight.burst_threshold == 3  # ServeConfig plumbs through
    server = make_server(app, port=0)
    threading.Thread(target=server.serve_forever, daemon=True).start()
    base = f"http://127.0.0.1:{server.server_address[1]}"
    try:
        with urllib.request.urlopen(f"{base}/v1/similar?gene=G1&k=3", timeout=10) as r:
            assert r.status == 200
        doc = {}
        deadline = time.monotonic() + 5.0
        while time.monotonic() < deadline:  # the ring append follows the reply
            with urllib.request.urlopen(f"{base}/debug/flight", timeout=10) as r:
                doc = json.loads(r.read().decode("utf-8"))
            if any(rec["route"] == "/v1/similar" for rec in doc["records"]):
                break
            time.sleep(0.05)
        assert doc["schema"] == "gene2vec-tpu/flight/v1" and doc["reason"] == "debug"
        assert any(rec["route"] == "/v1/similar" for rec in doc["records"])
    finally:
        server.shutdown()
        server.server_close()
        app.stop()


def test_server_burst_dumps_through_the_shared_limiter(tmp_path):
    """A 5xx burst dumps the ring into ``flight_dir`` once per window."""
    export = str(tmp_path / "export")
    save_iteration(export, 4, 1, SGNSParams(torch.ones(8, 4), torch.zeros(8, 4)),
                   Vocab([f"G{i}" for i in range(8)], np.arange(8, 0, -1)), txt_output=False)
    registry = ModelRegistry(export, device="cpu")
    assert registry.refresh()
    app = ServeApp(registry, config=ServeConfig(burst_threshold=2, burst_window_s=30.0))
    app.flight_dir = str(tmp_path / "run")
    os.makedirs(app.flight_dir)
    app._dispatch = lambda *a, **k: 1 / 0  # every route crashes: 500s
    statuses = [app.handle("GET", "/v1/genes", None)[0] for _ in range(5)]
    assert statuses == [500] * 5
    dumps = [n for n in os.listdir(app.flight_dir) if n.startswith("flight")]
    assert len(dumps) == 1 and app.flight_limiter.denied >= 1
    with open(os.path.join(app.flight_dir, dumps[0])) as f:
        doc = json.load(f)
    assert doc["reason"] == "5xx-burst" and [r["status"] for r in doc["records"]] == [500, 500]
