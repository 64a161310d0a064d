"""The port's trace plane on the CPU against the JAX package's: traceparent
parsing and formatting and the sampler's decisions equal the reference's,
the tracer stamps a sampled context, the resilient client's attempts and
the batcher's hops join one trace, an HTTP request into the port's server
reassembles to the same tree through the port's and the reference's
``collect_trace``, the flight recorder keeps its ring and its bursts, and
the fleet aggregator's parser, quantiles and ``/metrics/fleet`` text equal
the reference's on the same replica texts."""

import json
import os
import random
import threading
import time
import urllib.request

import numpy as np
import pytest
import torch

from gene2vec_tpu.obs import aggregate as ref_aggregate
from gene2vec_tpu.obs import flight as ref_flight
from gene2vec_tpu.obs import tracecontext as ref_tc
from gene2vec_tpu.obs.registry import MetricsRegistry as RefRegistry
from gene2vec_tpu_torch.cli import obs as obs_cli
from gene2vec_tpu_torch.io.checkpoint import save_iteration
from gene2vec_tpu_torch.io.vocab import Vocab
from gene2vec_tpu_torch.obs import aggregate
from gene2vec_tpu_torch.obs import flight as flight_mod
from gene2vec_tpu_torch.obs import tracecontext as tc
from gene2vec_tpu_torch.obs.aggregate import (
    FleetAggregator,
    histogram_quantile,
    merge_samples,
    parse_prometheus,
)
from gene2vec_tpu_torch.obs.flight import FlightRecorder, collect_trace
from gene2vec_tpu_torch.obs.registry import MetricsRegistry
from gene2vec_tpu_torch.obs.trace import Tracer, hop_span, read_events, set_tracer
from gene2vec_tpu_torch.serve.batcher import MicroBatcher
from gene2vec_tpu_torch.serve.client import ResilientClient, RetryPolicy
from gene2vec_tpu_torch.serve.registry import ModelRegistry
from gene2vec_tpu_torch.serve.server import ServeApp, ServeConfig, make_server
from gene2vec_tpu_torch.sgns.model import SGNSParams

TRACE = "4bf92f3577b34da6a3ce929d0e0e4736"
SPAN = "00f067aa0ba902b7"


# -- trace context: equal to the reference's -------------------------------------


@pytest.mark.parametrize("header", [
    f"00-{TRACE}-{SPAN}-01", f"00-{TRACE}-{SPAN}-00", f"00-{TRACE.upper()}-{SPAN}-01",
    f" 00-{TRACE}-{SPAN}-01 ", f"01-{TRACE}-{SPAN}-01-extra", f"00-{TRACE}-{SPAN}-03",
    None, "", "garbage", "00-short-abc-01",
    "00-" + "0" * 32 + "-" + "1" * 16 + "-01",     # all-zero trace id
    "00-" + "a" * 32 + "-" + "0" * 16 + "-01",     # all-zero span id
    "ff-" + "a" * 32 + "-" + "b" * 16 + "-01",     # invalid version
    "00-" + "g" * 32 + "-" + "b" * 16 + "-01",     # non-hex
    f"00-{TRACE}-{SPAN}-zz",
])
def test_traceparent_parse_and_format_equal_reference(header):
    got, want = tc.TraceContext.from_header(header), ref_tc.TraceContext.from_header(header)
    if want is None:
        assert got is None
        return
    fields = ("trace_id", "span_id", "parent_id", "sampled")
    assert [getattr(got, f) for f in fields] == [getattr(want, f) for f in fields]
    assert got.to_header() == want.to_header()
    back = tc.TraceContext.from_header(got.to_header())
    assert (back.trace_id, back.span_id, back.sampled) == (got.trace_id, got.span_id,
                                                           got.sampled)


@pytest.mark.parametrize("rate", [0.0, 0.1, 0.5, 1.0])
def test_sampler_decisions_equal_reference(rate):
    got = tc.Sampler(rate, random.Random(5))
    want = ref_tc.Sampler(rate, random.Random(5))
    picks = [(got.maybe_new_trace() is None, want.maybe_new_trace() is None)
             for _ in range(400)]
    assert all(a == b for a, b in picks)
    n = sum(not a for a, _ in picks)
    assert (n == 0) if rate == 0.0 else (n == 400) if rate == 1.0 else 0 < n < 400
    ctx = tc.Sampler(1.0).maybe_new_trace()
    assert ctx is not None and ctx.sampled and ctx.parent_id is None


def test_child_lineage_and_thread_local_use():
    root = tc.new_trace()
    child = root.child()
    assert child.trace_id == root.trace_id and child.parent_id == root.span_id
    assert child.span_id != root.span_id
    assert tc.current() is None
    with tc.use(root):
        assert tc.current() is root
        with tc.use(child):
            assert tc.current() is child
        assert tc.current() is root
    assert tc.current() is None


# -- the tracer ---------------------------------------------------------------------


def test_tracer_stamps_sampled_context(tmp_path):
    t = Tracer(str(tmp_path / "events.jsonl"))
    ctx = tc.new_trace()
    with tc.use(ctx):
        with t.span("serve_request", route="/x"):
            t.event("inner")
    with tc.use(tc.TraceContext("a" * 32, "b" * 16, sampled=False)):
        t.event("dark")
    t.close()
    events = read_events(str(tmp_path / "events.jsonl"))
    spans = [e for e in events if e["name"] == "serve_request"]
    assert spans and all(e["trace"] == ctx.trace_id and e["tsid"] == ctx.span_id
                         for e in spans)
    assert next(e for e in events if e["name"] == "inner")["trace"] == ctx.trace_id
    assert "trace" not in next(e for e in events if e["name"] == "dark")


def test_hop_span_links_process_local_parent(tmp_path):
    t = Tracer(str(tmp_path / "events.jsonl"))
    set_tracer(t)
    try:
        root = tc.new_trace()
        hop = root.child()
        with t.span("serve_batch"):
            hop_span("batch_item", hop, dur=0.01, queue_wait_s=0.002)
    finally:
        set_tracer(None)
        t.close()
    events = read_events(str(tmp_path / "events.jsonl"))
    start = next(e for e in events if e["name"] == "serve_batch" and e["type"] == "span_start")
    item = next(e for e in events if e["name"] == "batch_item")
    assert (item["trace"], item["tsid"], item["tpid"]) == (root.trace_id, hop.span_id,
                                                          root.span_id)
    assert item["span"] == start["span"] and item["hop"] is True
    hop_span("batch_item", hop, dur=0.01)  # no tracer installed: free


# -- the resilient client's attempts --------------------------------------------------


class FakeClock:
    def __init__(self):
        self.t = 1000.0

    def __call__(self):
        return self.t


def _client(transport, policy=None, targets=("http://a", "http://b"), **kw):
    return ResilientClient(
        list(targets),
        policy or RetryPolicy(max_attempts=3, default_timeout_s=5.0, backoff_base_s=0.0,
                              trace_sample=1.0),
        transport=transport, clock=FakeClock(), sleep=lambda s: None, **kw)


def test_every_attempt_shares_trace_with_distinct_child_spans():
    seen = []

    def transport(base, method, path, body, ct, rt, headers=None):
        seen.append(dict(headers or {}))
        if len(seen) < 3:
            raise ConnectionRefusedError("down")
        return 200, json.dumps({"ok": True}).encode()

    r = _client(transport).request("/v1/similar", {"genes": ["G1"]})
    assert r.ok and r.attempts == 3 and r.retries == 2 and r.trace_id is not None
    parsed = [tc.TraceContext.from_header(h["traceparent"]) for h in seen]
    assert {p.trace_id for p in parsed} == {r.trace_id}
    assert len({p.span_id for p in parsed}) == 3 and all(p.sampled for p in parsed)


def test_ambient_context_wins_over_client_sampling():
    seen = []

    def transport(base, method, path, body, ct, rt, headers=None):
        seen.append(dict(headers or {}))
        return 200, b"{}"

    root = tc.new_trace()
    with tc.use(root):
        r = _client(transport).request("/v1/similar", {"genes": ["G1"]})
    p = tc.TraceContext.from_header(seen[0]["traceparent"])
    assert r.trace_id == p.trace_id == root.trace_id and p.span_id != root.span_id


def test_trace_sample_zero_sends_no_header():
    seen = []

    def transport(base, method, path, body, ct, rt, headers=None):
        seen.append(headers)
        return 200, b"{}"

    r = _client(transport, RetryPolicy(max_attempts=2, default_timeout_s=5.0)).request(
        "/v1/similar", {"genes": ["G1"]})
    assert r.ok and r.trace_id is None and seen == [None]

    class FixedRng(random.Random):
        def random(self):
            return 0.9  # above the 0.5 rate: not selected

    r2 = _client(transport, RetryPolicy(max_attempts=2, default_timeout_s=5.0,
                                        trace_sample=0.5), rng=FixedRng()).request(
        "/v1/similar", {"genes": ["G1"]})
    assert r2.ok and r2.trace_id is None and seen[-1] is None


def test_hedged_attempt_parents_to_same_request():
    headers_by_target = {}
    release = threading.Event()

    def transport(base, method, path, body, ct, rt, headers=None):
        headers_by_target.setdefault(base, []).append(dict(headers or {}))
        if base == "http://a":
            release.wait(5.0)  # the slow primary
        return 200, json.dumps({"from": base}).encode()

    c = ResilientClient(["http://a", "http://b"],
                        RetryPolicy(max_attempts=3, default_timeout_s=5.0, hedge=True,
                                    hedge_min_samples=4, trace_sample=1.0),
                        transport=transport)
    c._latencies = [0.01] * 8
    try:
        r = c.request("/v1/similar", {"genes": ["G1"]}, timeout_s=5.0)
    finally:
        release.set()
    assert r.ok and r.hedged
    primary, hedge = (tc.TraceContext.from_header(headers_by_target[t][0]["traceparent"])
                      for t in ("http://a", "http://b"))
    assert primary.trace_id == hedge.trace_id == r.trace_id
    assert primary.span_id != hedge.span_id


# -- the batcher's hops -------------------------------------------------------------


def test_batcher_emits_batch_item_hops(tmp_path):
    t = Tracer(str(tmp_path / "events.jsonl"))
    set_tracer(t)
    try:
        b = MicroBatcher(lambda items, k: [i * 2 for i in items], max_batch=4,
                         max_delay_s=0.01, max_queue=16, cache_size=4).start()
        ctx = tc.new_trace()
        with tc.use(ctx), flight_mod.collect_hops() as hops:
            assert b.submit(21, 1, cache_key="q21") == 42
            assert b.submit(21, 1, cache_key="q21") == 42  # an LRU hit
        b.stop()
    finally:
        set_tracer(None)
        t.close()
    assert {"queue_wait_s", "compute_s", "batch"} <= set(hops)
    events = read_events(str(tmp_path / "events.jsonl"))
    item = next(e for e in events if e["name"] == "batch_item")
    assert (item["trace"], item["tpid"]) == (ctx.trace_id, ctx.span_id)
    assert item["attrs"]["batch"] == 1 and item["attrs"]["queue_wait_s"] >= 0
    batch = next(e for e in events if e["name"] == "serve_batch" and e["type"] == "span_end")
    assert batch["attrs"]["traces"] == [ctx.trace_id] and item["span"] == batch["span"]
    hit = next(e for e in events if e["name"] == "cache_hit")
    assert (hit["trace"], hit["tpid"], hit["dur"]) == (ctx.trace_id, ctx.span_id, 0.0)


# -- an HTTP request into the port's server, reassembled -----------------------------


@pytest.fixture
def traced_serving(tmp_path):
    v, d = 12, 4
    rng = np.random.RandomState(0)
    export = tmp_path / "exports"
    emb = torch.from_numpy(rng.randn(v, d).astype(np.float32))
    save_iteration(str(export), d, 1, SGNSParams(emb, torch.zeros(v, d)),
                   Vocab([f"G{i}" for i in range(v)], np.arange(v, 0, -1)),
                   txt_output=False)
    run_dir = tmp_path / "run"
    tracer = Tracer(str(run_dir / "events.jsonl"))
    set_tracer(tracer)
    reg = ModelRegistry(str(export), device="cpu")
    assert reg.refresh()
    app = ServeApp(reg, ServeConfig(max_batch=8, max_delay_ms=2.0, max_queue=16)).start()
    app.flight_dir = str(run_dir)
    server = make_server(app, "127.0.0.1", 0)
    threading.Thread(target=server.serve_forever, daemon=True).start()
    yield f"http://127.0.0.1:{server.server_address[1]}", app, str(run_dir)
    server.shutdown()
    server.server_close()
    app.stop()
    set_tracer(None)
    tracer.close()


def _post(url, body, ctx=None, method="POST"):
    headers = {"Content-Type": "application/json"}
    if ctx is not None:
        headers["traceparent"] = ctx.to_header()
    data = json.dumps(body).encode() if method == "POST" else None
    req = urllib.request.Request(url, data=data, headers=headers, method=method)
    with urllib.request.urlopen(req, timeout=10.0) as r:
        assert r.status == 200
        return json.loads(r.read())


def _names(node, out):
    out.add(node["name"])
    for s in node.get("process_spans", []) + node.get("children", []):
        _names(s, out)
    return out


def _wait_for(predicate, timeout_s=10.0):
    deadline = time.monotonic() + timeout_s
    while not predicate() and time.monotonic() < deadline:
        time.sleep(0.02)
    return predicate()


@pytest.mark.parametrize("method", ["POST", "GET"])
def test_http_request_joins_propagated_trace(traced_serving, method):
    url, app, run_dir = traced_serving
    sender = tc.new_trace()  # as a proxy attempt would
    target = (f"{url}/v1/similar" if method == "POST" else f"{url}/v1/similar?gene=G1&k=3")
    _post(target, {"genes": ["G1"], "k": 3}, sender, method)
    events = read_events(os.path.join(run_dir, "events.jsonl"))
    sreq = next(e for e in events if e["name"] == "serve_request"
                and e["type"] == "span_end" and e.get("trace") == sender.trace_id)
    assert sreq["tpid"] == sender.span_id
    item = next(e for e in events if e["name"] == "batch_item"
                and e.get("trace") == sender.trace_id)
    assert item["tpid"] == sreq["tsid"]
    doc = collect_trace(run_dir, sender.trace_id)
    assert doc["roots"][0]["name"] == "serve_request"
    assert doc["roots"][0]["children"][0]["name"] == "batch_item"
    assert {"serve_request", "batch_item", "serve_batch", "engine_topk"} <= _names(
        doc["roots"][0], set())
    # the unchanged reference reader reassembles the port's run dir alike
    ref_doc = ref_flight.collect_trace(run_dir, sender.trace_id)
    assert json.dumps(ref_doc, sort_keys=True) == json.dumps(doc, sort_keys=True)
    # the flight recorder saw the request with its hops (appended just
    # after the response is written)
    assert _wait_for(lambda: any(r.get("trace") == sender.trace_id
                                 for r in app.flight.snapshot()))
    rec = next(r for r in app.flight.snapshot() if r.get("trace") == sender.trace_id)
    assert rec["route"] == "/v1/similar" and rec["status"] == 200
    assert "queue_wait_s" in rec["hops"]


def test_untraced_request_stays_dark(traced_serving):
    url, app, run_dir = traced_serving
    _post(f"{url}/v1/similar", {"genes": ["G2"], "k": 3})
    events = read_events(os.path.join(run_dir, "events.jsonl"))
    sreqs = [e for e in events if e.get("type") == "span_end"
             and e.get("name") == "serve_request"]
    assert sreqs and all("trace" not in e for e in sreqs)


def test_server_sampler_starts_root_traces(traced_serving):
    url, app, run_dir = traced_serving
    app.sampler = tc.Sampler(1.0)  # --trace-sample 1: every headerless request
    try:
        _post(f"{url}/v1/similar?gene=G4&k=2", None, method="GET")
    finally:
        app.sampler = None
    assert _wait_for(lambda: any(r.get("trace") for r in app.flight.snapshot()))
    tid = next(r["trace"] for r in app.flight.snapshot() if r.get("trace"))
    doc = collect_trace(run_dir, tid)
    assert doc["roots"][0]["name"] == "serve_request" and "tpid" not in json.dumps(
        doc["roots"][0].get("attrs", {}))


def test_obs_trace_cli(traced_serving, capsys):
    url, app, run_dir = traced_serving
    sender = tc.new_trace()
    _post(f"{url}/v1/similar", {"genes": ["G3"], "k": 2}, sender)
    assert obs_cli.main(["trace", run_dir, sender.trace_id]) == 0
    out = capsys.readouterr().out
    assert "serve_request" in out and "batch_item" in out and "engine_topk" in out
    assert obs_cli.main(["trace", "--json", run_dir, sender.trace_id]) == 0
    assert json.loads(capsys.readouterr().out)["trace_id"] == sender.trace_id
    assert obs_cli.main(["trace", run_dir, "f" * 32]) == 1
    capsys.readouterr()


# -- the flight recorder ----------------------------------------------------------------


def test_flight_recorder_ring_and_burst_equal_reference(tmp_path):
    outs = {}
    for pkg, mod in (("port", flight_mod), ("reference", ref_flight)):
        clk = FakeClock()
        fr = mod.FlightRecorder(capacity=4, burst_threshold=3, burst_window_s=5.0, clock=clk)
        got = [fr.record(f"/r{i}", 200, 0.01) for i in range(6)]
        got.append(len(fr.snapshot()))
        for step, status in ((0, 500), (1, 503), (1, 500), (0, 500), (6, 500), (0, 500),
                             (0, 500)):
            clk.t += step
            got.append(fr.record("/x", status, 0.01))
        outs[pkg] = got
    assert outs["port"] == outs["reference"]
    assert outs["port"][6] == 4 and outs["port"][9] is True and outs["port"][-1] is True
    fr = FlightRecorder()
    fr.record("/v1/similar", 200, 0.02, trace_id="ab" * 16, hops={"queue_wait_s": 0.001})
    path = fr.dump(str(tmp_path), "test")
    doc = json.load(open(path))
    assert doc["reason"] == "test" and doc["schema"] == "gene2vec-tpu/flight/v1"
    for mod in (flight_mod, ref_flight):  # dumps feed both readers
        out = mod.collect_trace(str(tmp_path), "ab" * 16)
        assert out["flight"] and out["flight"][0]["route"] == "/v1/similar"


# -- Prometheus text: the parser and the aggregator ------------------------------------


def test_label_escaping_round_trips_through_parser():
    r = MetricsRegistry()
    nasty = 'back\\slash "quoted"\nnewline'
    r.counter("esc_total", labels={"route": nasty}).inc(5)
    text = r.prometheus_text()
    s = next(s for s in parse_prometheus(text) if s.name == "esc_total")
    assert dict(s.labels)["route"] == nasty and s.value == 5.0
    assert parse_prometheus(text) == [
        aggregate.Sample(x.name, x.labels, x.value) for x in ref_aggregate.parse_prometheus(text)]


def _replica_text(requests, rejected, depth, route_ms, registry=MetricsRegistry):
    r = registry()
    r.counter("serve_requests_total").inc(requests)
    r.counter("serve_rejected_total").inc(rejected)
    r.gauge("serve_queue_depth").set(depth)
    r.counter("kernel_launches_total", labels={"kernel": "topk_exact"}).inc(requests // 3)
    h = r.histogram("serve_route_seconds", buckets=tuple(0.0005 * (2 ** e) for e in range(15)),
                    labels={"route": "/v1/similar"})
    for ms in route_ms:
        h.observe(ms / 1000.0)
    return r.prometheus_text()


EXPOSITIONS = [
    'h_bucket{le="0.1"} 50\nh_bucket{le="1"} 99\nh_bucket{le="+Inf"} 100\nh_sum 12\n'
    'h_count 100\n',
    'broken{le="x" 1\n# comment\nok 2\nesc{a="q\\"x\\\\y\\nz"} 3\n',
    _replica_text(100, 5, 3, [2.0] * 90 + [40.0] * 10),
]


@pytest.mark.parametrize("i", range(len(EXPOSITIONS)))
def test_parser_merge_and_quantiles_equal_reference(i):
    texts = [EXPOSITIONS[i], _replica_text(50, 0, 1, [2.0] * 50)]
    got = merge_samples([parse_prometheus(t) for t in texts])
    want = ref_aggregate.merge_samples([ref_aggregate.parse_prometheus(t) for t in texts])
    assert got == want
    for name, labels in (("h", ()), ("serve_route_seconds", (("route", "/v1/similar"),)),
                         ("missing", ())):
        for q in (0.5, 0.9, 0.99, 0.999):
            assert histogram_quantile(got, name, labels, q) == \
                ref_aggregate.histogram_quantile(want, name, labels, q)


def test_histogram_quantile_and_parser_edges():
    merged = merge_samples([parse_prometheus(EXPOSITIONS[0])])
    assert histogram_quantile(merged, "h", (), 0.50) == 0.1
    assert histogram_quantile(merged, "h", (), 0.99) == 1.0
    assert histogram_quantile(merged, "h", (), 0.999) == 1.0  # top finite bound
    assert histogram_quantile(merged, "missing", (), 0.5) is None
    assert parse_prometheus('broken{le="x" 1\n# comment\nok 2\n') == [
        parse_prometheus("ok 2")[0]]


def test_fleet_text_equals_reference(monkeypatch):
    """The same replica texts (one replica dead, one restarted between
    scrapes) and the same proxy counters give the reference's
    ``/metrics/fleet`` text, byte for byte."""
    monkeypatch.setattr(time, "time", lambda: 1_800_000_000.0)
    rounds = [
        {"http://r0": (100, 5, 3, [2.0] * 90 + [40.0] * 10), "http://r1": (50, 0, 1, [2.0] * 50)},
        {"http://r1": (80, 1, 2, [3.0] * 30)},
        {"http://r0": (10, 0, 0, [1.0] * 10), "http://r1": (90, 1, 0, [3.0] * 40)},
    ]
    texts = {}
    for pkg, mod, registry in (("port", aggregate, MetricsRegistry),
                               ("reference", ref_aggregate, RefRegistry)):
        proxy = registry()
        proxy.counter("fleet_proxy_responses_total").inc(140)
        proxy.counter("fleet_proxy_ok_total").inc(133)
        live = {}
        agg = mod.FleetAggregator(lambda: list(live) + ["http://dead"], proxy_registry=proxy,
                                  fetch=lambda url, t: live[url])
        out = []
        for r in rounds:
            live.clear()
            live.update({u: _replica_text(*a, registry=registry) for u, a in r.items()})
            out.append((agg.scrape_once(), agg.fleet_text()))
        agg.view.close()
        texts[pkg] = out
    assert texts["port"] == texts["reference"]
    assert "fleet_requests 200" in texts["port"][-1][1]  # 110 + 90: no counter goes back


def test_aggregator_merges_replicas_and_derives_slos(tmp_path):
    texts = {"http://r0": _replica_text(100, 5, 3, [2.0] * 90 + [40.0] * 10),
             "http://r1": _replica_text(50, 0, 1, [2.0] * 50)}
    proxy = MetricsRegistry()
    proxy.counter("fleet_proxy_responses_total").inc(140)
    proxy.counter("fleet_proxy_ok_total").inc(133)
    csv_path = str(tmp_path / "telemetry.csv")
    agg = FleetAggregator(lambda: list(texts) + ["http://dead"], proxy_registry=proxy,
                          csv_path=csv_path, fetch=lambda url, t: texts[url])
    h = agg.scrape_once()
    assert (h["fleet_replicas_scraped"], h["fleet_queue_depth"], h["fleet_requests"],
            h["fleet_rejected"]) == (2, 4, 150, 5)
    assert h["fleet_rejection_rate"] == pytest.approx(5 / 150)
    assert h["fleet_availability"] == pytest.approx(133 / 140)
    samples = {(s.name, s.labels): s.value for s in parse_prometheus(agg.fleet_text())}
    assert samples[("fleet_scrape_errors_total", ())] == 1
    key = (("route", "/v1/similar"),)
    assert samples[("fleet_route_p50_seconds", key)] <= 0.01 < \
        samples[("fleet_route_p99_seconds", key)] <= 0.128
    agg.view.close()
    rows = open(csv_path).read().splitlines()
    assert len(rows) == 2 and "fleet_availability" in rows[0]


def test_aggregator_retains_counters_across_death_and_restart():
    texts = {"http://r0": _replica_text(100, 5, 3, [2.0])}
    targets = ["http://r0"]
    agg = FleetAggregator(lambda: list(targets), fetch=lambda url, t: texts[url])
    assert agg.scrape_once()["fleet_requests"] == 100
    targets.clear()  # the replica dies: its history stays, its gauges go
    h = agg.scrape_once()
    assert (h["fleet_requests"], h["fleet_queue_depth"]) == (100, 0)
    texts["http://r0"] = _replica_text(10, 0, 1, [2.0])  # restarted, counters zeroed
    targets.append("http://r0")
    h = agg.scrape_once()
    assert (h["fleet_requests"], h["fleet_rejected"], h["fleet_queue_depth"]) == (110, 5, 1)
    agg.view.close()


def test_aggregator_background_loop():
    texts = {"http://r0": _replica_text(10, 0, 0, [1.0])}
    agg = FleetAggregator(["http://r0"], interval_s=0.05, fetch=lambda url, t: texts[url])
    agg.start()
    try:
        assert _wait_for(lambda: "fleet_requests 10" in agg.fleet_text(), 5.0)
    finally:
        agg.stop()
