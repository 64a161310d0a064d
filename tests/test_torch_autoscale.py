"""The port's elastic fleet and tenant admission on the CPU against the JAX
package's: the autoscale policies give the reference's decision sequence
on the same snapshot sequences, the tenant buckets, policy parsing,
admission and fair queue give its outputs on the same inputs (with an
injected clock), the elastic controller and the supervisor's slot
bookkeeping behave as ``tests/test_autoscale.py`` pins them (fakes and a
stub replica, ~100 ms a spawn), and a port server sheds an over-quota
tenant with a tenant-labelled 429."""

import dataclasses
import json
import os
import signal
import sys
import threading
import time
import urllib.error
import urllib.request

import numpy as np
import pytest
import torch

from gene2vec_tpu.serve import autoscale as ref_autoscale
from gene2vec_tpu.serve import tenancy as ref_tenancy
from gene2vec_tpu_torch.io.checkpoint import save_iteration
from gene2vec_tpu_torch.io.vocab import Vocab
from gene2vec_tpu_torch.obs.registry import MetricsRegistry
from gene2vec_tpu_torch.serve import autoscale as port_autoscale
from gene2vec_tpu_torch.serve import tenancy as port_tenancy
from gene2vec_tpu_torch.serve.autoscale import AutoscaleConfig, ElasticController
from gene2vec_tpu_torch.serve.batcher import MicroBatcher
from gene2vec_tpu_torch.serve.client import InFlightTracker
from gene2vec_tpu_torch.serve.fleet import FleetConfig, FleetSupervisor, ReplicaState
from gene2vec_tpu_torch.serve.registry import ModelRegistry
from gene2vec_tpu_torch.serve.server import ServeApp, ServeConfig, make_server
from gene2vec_tpu_torch.sgns.model import SGNSParams

PACKAGES = {"reference": (ref_autoscale, ref_tenancy), "port": (port_autoscale, port_tenancy)}


# -- the policies: the reference's decisions on the same snapshots ------------


def snap(queue=0.0, requests=0.0, rejected=0.0, ok=None, responses=None, fresh=3.0,
         p99=None, route="/v1/similar", quota_rejected=0.0, throttled=0.0):
    """One aggregator snapshot in the scaler's shape."""
    responses = requests if responses is None else responses
    ok = responses if ok is None else ok
    s = {"fleet_queue_depth": queue, "fleet_requests": requests, "fleet_rejected": rejected,
         "fleet_quota_rejected": quota_rejected, "fleet_ok": ok,
         "fleet_responses": responses, "fleet_throttled": throttled,
         "_fresh_targets": fresh}
    if p99 is not None:
        s[f"fleet_route_p99_seconds{{route={route}}}"] = p99
    return s


BASE = dict(min_replicas=1, max_replicas=4, up_queue_per_replica=8.0,
            up_rejection_rate=0.02, up_after_ticks=2, down_after_ticks=3,
            down_queue_per_replica=1.0, cooldown_s=10.0)

#: name -> (config overrides, [(snapshot kwargs, now, current replicas)],
#: the action the reference takes at the last tick)
POLICY_SCRIPTS = {
    "breach_at_tick_boundary": (
        {}, [({}, 0.0, 1), ({"queue": 20}, 1.0, 1), ({"queue": 20}, 2.0, 1)], "up"),
    "rejection_windowed_not_lifetime": (
        {"cooldown_s": 0.0, "down_after_ticks": 2},
        [({"requests": 100, "rejected": 50}, 0.0, 2),
         ({"requests": 110, "rejected": 50}, 1.0, 2),
         ({"requests": 120, "rejected": 50}, 2.0, 2)], "down"),
    "clear_window_then_min_clamp": (
        {"cooldown_s": 0.0},
        [({}, 0.0, 2), ({}, 1.0, 2), ({}, 2.0, 2), ({}, 3.0, 2)]
        + [({}, 10.0 + i, 1) for i in range(6)], "hold"),
    "middle_band_resets_streaks": (
        {"cooldown_s": 0.0, "down_after_ticks": 2},
        [({}, 0.0, 2), ({}, 1.0, 2), ({"queue": 4}, 2.0, 2), ({}, 3.0, 2), ({}, 4.0, 2)],
        "down"),
    "cooldown_then_pent_up_breach": (
        {"cooldown_s": 100.0},
        [({}, 0.0, 1), ({"queue": 20}, 1.0, 1), ({"queue": 20}, 2.0, 1),
         ({"queue": 20}, 3.0, 2), ({"queue": 20}, 4.0, 2), ({"queue": 20}, 200.0, 2)], "up"),
    "max_clamp": (
        {"cooldown_s": 0.0, "max_replicas": 2},
        [({}, 0.0, 2), ({"queue": 50}, 1.0, 2), ({"queue": 50}, 2.0, 2)], "hold"),
    "stale_snapshots": (
        {"cooldown_s": 0.0, "down_after_ticks": 2},
        [({}, 0.0, 2)] + [({"queue": 100, "fresh": 0.0}, 1.0 + i, 2) for i in range(5)]
        + [({"fresh": 0.0}, 10.0 + i, 2) for i in range(5)], "hold"),
    "availability_burn": (
        {"cooldown_s": 0.0},
        [({"requests": 0, "responses": 0}, 0.0, 1),
         ({"responses": 100, "ok": 50, "requests": 100}, 1.0, 1),
         ({"responses": 200, "ok": 100, "requests": 200}, 2.0, 1)], "up"),
    "quota_shedding_does_not_scale": (
        {"cooldown_s": 0.0},
        [({}, 0.0, 1)] + [({"requests": 10.0 * i, "rejected": 500.0 * i,
                            "quota_rejected": 500.0 * i, "responses": 510.0 * i,
                            "ok": 10.0 * i, "throttled": 500.0 * i}, float(i), 1)
                          for i in range(1, 6)], "hold"),
    "capacity_rejections_scale": (
        {"cooldown_s": 0.0},
        [({}, 0.0, 1), ({"requests": 100, "rejected": 50}, 1.0, 1),
         ({"requests": 200, "rejected": 100}, 2.0, 1)], "up"),
    "p99_signal": (
        {"cooldown_s": 0.0, "up_p99_s": 0.2, "down_p99_s": 0.05, "down_after_ticks": 2},
        [({}, 0.0, 2), ({"p99": 0.5}, 1.0, 2), ({"p99": 0.5}, 2.0, 2),
         ({"p99": 0.1}, 3.0, 3), ({"p99": 0.01}, 4.0, 3), ({"p99": 0.01}, 5.0, 3)], "down"),
}


def _decisions(mod, overrides, script):
    policy = mod.AutoscalePolicy(mod.AutoscaleConfig(**dict(BASE, **overrides)))
    return [dataclasses.asdict(policy.observe(snap(**kw), now=now, current=cur))
            for kw, now, cur in script]


@pytest.mark.parametrize("name", sorted(POLICY_SCRIPTS))
def test_policy_decisions_equal_reference(name):
    overrides, script, last = POLICY_SCRIPTS[name]
    ref = _decisions(ref_autoscale, overrides, script)
    assert _decisions(port_autoscale, overrides, script) == ref
    assert ref[-1]["action"] == last


def test_policy_validation():
    for kw in ({"min_replicas": 0}, {"min_replicas": 3, "max_replicas": 2}):
        with pytest.raises(ValueError):
            port_autoscale.AutoscalePolicy(AutoscaleConfig(**kw))


def _shard_snap(q0=0.0, q1=0.0, fresh=4.0, p99=None):
    s = {"_fresh_targets": fresh}
    if q0 is not None:
        s["fleet_shard_queue_depth{shard=0}"] = q0
    if q1 is not None:
        s["fleet_shard_queue_depth{shard=1}"] = q1
    if p99 is not None:
        s["fleet_shard_p99_seconds{shard=0}"] = p99
    return s


SHARD_CFG = dict(min_replicas=1, max_replicas=3, up_queue_per_replica=8.0,
                 down_queue_per_replica=1.0, up_after_ticks=2, down_after_ticks=3,
                 cooldown_s=0.0)

#: name -> ([(shard snapshot kwargs, now, {shard: current})], last action)
SHARD_SCRIPTS = {
    "hot_shard_only": ([({"q0": 2.0, "q1": 40.0}, float(t), {0: 2, 1: 2})
                        for t in range(3)], "up"),
    "down_never_below_min": ([({}, float(t), {0: 2, 1: 1}) for t in range(4)], "down"),
    "all_at_min_hold": ([({}, float(t), {0: 1, 1: 1}) for t in range(6)], "hold"),
    "dark_shard_holds": ([({"q1": None}, float(t), {0: 2, 1: 2}) for t in range(4)], "down"),
    "stale_holds": ([({"q1": 100.0, "fresh": 0.0}, float(t), {0: 1, 1: 1})
                     for t in range(4)], "hold"),
    "shard_p99": ([({"p99": 0.9}, float(t), {0: 1, 1: 1}) for t in range(3)], "up"),
}


@pytest.mark.parametrize("name", sorted(SHARD_SCRIPTS))
def test_shard_policy_decisions_equal_reference(name):
    script, last = SHARD_SCRIPTS[name]
    out = {}
    for pkg, (mod, _) in PACKAGES.items():
        cfg = mod.AutoscaleConfig(**dict(SHARD_CFG, up_p99_s=0.5))
        pol = mod.ShardAutoscalePolicy(cfg, num_shards=2)
        out[pkg] = [dataclasses.asdict(pol.observe(_shard_snap(**kw), now=now, current_of=cur))
                    for kw, now, cur in script]
        sub = mod.shard_snapshot(_shard_snap(q1=None), 1, cfg.p99_route)
        out[pkg].append(sub)
    assert out["port"] == out["reference"]
    assert out["port"][-2]["action"] == last


# -- tenant primitives: the reference's outputs on the same inputs ------------


class FakeClock:
    def __init__(self, t=0.0):
        self.t = t

    def __call__(self):
        return self.t


def _bucket_trace(mod):
    clock = FakeClock()
    b = mod.RateBucket(rate=10.0, burst=5.0, clock=clock)
    trace = []
    for step in (0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.1, 0.0, 100.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0,
                 0.05, 0.05, 0.33):
        clock.t += step
        trace.append((b.take(), round(b.tokens, 9)))
    return trace


def test_rate_bucket_equals_reference():
    got, want = _bucket_trace(port_tenancy), _bucket_trace(ref_tenancy)
    assert got == want
    assert [ok for ok, _ in got[:6]] == [True] * 5 + [False]


POLICY_ARGS = [
    (0.0, None, ()), (10.0, None, ()), (10.0, 30.0, ("vip:100:200:4",)),
    (10.0, 0.0, ("a:5", "b:5:7")), (10.0, None, ("vip",)), (10.0, None, ("vip:-1",)),
    (0.0, None, ("vip:10",)), (-50.0, None, ()), (10.0, -5.0, ()), (10.0, None, (":5",)),
    (10.0, None, ("a:1:2:3:4",)), (10.0, None, ("a:x",)),
]


@pytest.mark.parametrize("rate,burst,overrides", POLICY_ARGS)
def test_tenant_policy_from_args_equals_reference(rate, burst, overrides):
    def parse(mod):
        try:
            p = mod.TenantPolicy.from_args(rate, burst, overrides)
        except ValueError:
            return "ValueError"
        if p is None:
            return None
        return (dataclasses.astuple(p.default),
                {k: dataclasses.astuple(v) for k, v in p.overrides.items()},
                dataclasses.astuple(p.quota("anyone")))

    assert parse(port_tenancy) == parse(ref_tenancy)


@pytest.mark.parametrize("raw", [None, "", "  ", "alice", " bob ", "x" * 500, "é" * 70])
def test_sanitize_tenant_equals_reference(raw):
    assert port_tenancy.sanitize_tenant(raw) == ref_tenancy.sanitize_tenant(raw)


def _admission_trace(mod, metrics):
    clock = FakeClock()
    adm = mod.TenantAdmission(mod.TenantPolicy.from_args(10.0, 2.0, ["vip:100:50:3"]),
                              metrics=metrics, clock=clock, max_tenants=3)
    trace = []
    for i, tenant in enumerate(["alice"] * 4 + ["vip"] * 52 + ["b", "c", "d", "e", "b"]
                               + ["minted-1", "minted-2", "default", "alice"]):
        clock.t += 0.01 * (i % 3)
        trace.append(adm.admit(tenant))
    trace.append((adm.resolve("a"), adm.resolve("zzz"), adm.weight("vip"), adm.weight("x")))
    return trace


def test_tenant_admission_equals_reference():
    from gene2vec_tpu.obs.registry import MetricsRegistry as RefMetrics

    port_metrics, ref_metrics = MetricsRegistry(), RefMetrics()
    got = _admission_trace(port_tenancy, port_metrics)
    assert got == _admission_trace(ref_tenancy, ref_metrics)
    assert ("other", "other") == (got[-5][1], got[-4][1])  # the bounded table
    text = port_metrics.prometheus_text()
    assert 'serve_rejected_total{tenant="alice"}' in text
    for line in ref_metrics.prometheus_text().splitlines():
        if line.startswith(("serve_rejected_total", "serve_tenant_requests_total")):
            assert line in text


def _fair_trace(mod):
    weights = {"a": 3.0, "b": 1.0, "bad": -2.0}
    q = mod.FairQueue(weight_of=lambda t: weights.get(t, 1.0))
    for i in range(12):
        q.push("a", f"a{i}")
    for i in range(4):
        q.push("b", f"b{i}")
    for i in range(3):
        q.push("bad", f"x{i}")
    first = q.pop_upto(9)
    q.push("c", "c0")
    rest = q.drain()
    single = mod.FairQueue()
    for i in range(5):
        single.push("only", i)
    return first, rest, len(q), bool(q), single.drain(), single.pop()


def test_fair_queue_interleave_and_drain_equal_reference():
    got = _fair_trace(port_tenancy)
    assert got == _fair_trace(ref_tenancy)
    first, rest, n, nonempty, single, empty = got
    assert sum(x.startswith("a") for x in first[:8]) >= 4 and n == 0 and not nonempty
    assert single == [0, 1, 2, 3, 4] and empty is None
    order = first + rest
    assert [x for x in order if x.startswith("a")] == [f"a{i}" for i in range(12)]


def test_batcher_drains_tenant_lanes_weighted_fair():
    release = threading.Event()
    batches = []

    def compute(items, k):
        if items == ["plug"]:
            release.wait(timeout=10.0)
        batches.append(list(items))
        return [{"i": i} for i in items]

    b = MicroBatcher(compute, max_batch=8, max_delay_s=0.01, max_queue=64, cache_size=0,
                     tenant_weights=lambda t: 1.0).start()
    try:
        plug = b.submit_async("plug", 1)
        time.sleep(0.1)  # the worker is parked inside compute
        heavy = [b.submit_async(f"h{i}", 1, tenant="heavy") for i in range(16)]
        light = [b.submit_async(f"l{i}", 1, tenant="light") for i in range(4)]
        release.set()
        for t in heavy + light:
            t.get()
        plug.get()
        # the first contended batch interleaves the lanes, not arrival order
        assert sum(x.startswith("l") for x in batches[1]) == 4, batches
    finally:
        b.stop()


# -- the elastic controller over fakes ----------------------------------------


class FakeSupervisor:
    def __init__(self, count=2):
        self.count = count
        self.config = FleetConfig(contract_timeout_s=5.0)
        self.calls = []
        self.victim = type("R", (), {"url": "http://victim", "state": ReplicaState.UP,
                                     "alive": True, "spawning": False, "index": 1})()

    def active_count(self):
        return self.count

    def scale_up(self):
        self.calls.append("scale_up")
        self.count += 1
        return type("R", (), {"url": "http://new", "state": ReplicaState.UP,
                              "alive": True, "spawning": False, "index": 99})()

    def pick_drain_victim(self):
        return self.victim

    def begin_drain(self, r):
        self.calls.append(("begin_drain", r.url))
        r.state = ReplicaState.DRAINING

    def finish_drain(self, r):
        self.calls.append(("finish_drain", r.url))
        self.count -= 1


class FakeProxy:
    def __init__(self):
        self.inflight = InFlightTracker()


def _wait_for(predicate, timeout_s=10.0, what="condition"):
    deadline = time.monotonic() + timeout_s
    while time.monotonic() < deadline:
        if predicate():
            return
        time.sleep(0.01)
    raise TimeoutError(f"{what} not reached in {timeout_s}s")


def test_controller_scales_up_on_breach_and_counts_decision():
    sup, proxy, metrics = FakeSupervisor(count=1), FakeProxy(), MetricsRegistry()
    ctl = ElasticController(sup, proxy, AutoscaleConfig(min_replicas=1, max_replicas=2,
                                                        up_after_ticks=2, cooldown_s=0.0),
                            metrics=metrics)
    ctl.observe(snap())
    ctl.observe(snap(queue=50))
    assert sup.calls == []
    ctl.observe(snap(queue=50))
    _wait_for(lambda: "scale_up" in sup.calls, what="scale_up call")
    _wait_for(lambda: not ctl._busy, what="action slot released")
    assert metrics.counter("fleet_scale_up_total").value == 1
    assert metrics.gauge("fleet_replicas_active").value == 2


def test_controller_drain_waits_for_inflight_then_terminates():
    sup, proxy = FakeSupervisor(count=2), FakeProxy()
    ctl = ElasticController(sup, proxy, AutoscaleConfig(min_replicas=1, max_replicas=2,
                                                        down_after_ticks=2, cooldown_s=0.0),
                            metrics=MetricsRegistry(), drain_timeout_s=10.0, drain_poll_s=0.01)
    proxy.inflight.enter("http://victim")
    for _ in range(3):
        ctl.observe(snap())
    _wait_for(lambda: ("begin_drain", "http://victim") in sup.calls, what="begin_drain")
    time.sleep(0.2)
    assert ("finish_drain", "http://victim") not in sup.calls  # a request is on board
    proxy.inflight.exit("http://victim")
    _wait_for(lambda: ("finish_drain", "http://victim") in sup.calls,
              what="finish_drain after in-flight settles")


def test_controller_drain_timeout_is_counted_not_wedged():
    sup, proxy, metrics = FakeSupervisor(count=2), FakeProxy(), MetricsRegistry()
    ctl = ElasticController(sup, proxy, AutoscaleConfig(min_replicas=1, max_replicas=2,
                                                        down_after_ticks=1, cooldown_s=0.0),
                            metrics=metrics, drain_timeout_s=0.2, drain_poll_s=0.01)
    proxy.inflight.enter("http://victim")  # never settles
    ctl.observe(snap())
    ctl.observe(snap())
    _wait_for(lambda: ("finish_drain", "http://victim") in sup.calls,
              what="finish_drain after timeout")
    assert metrics.counter("fleet_drain_timeouts_total").value == 1


def test_controller_skips_ticks_while_an_action_is_in_flight():
    sup, proxy = FakeSupervisor(count=2), FakeProxy()
    ctl = ElasticController(sup, proxy, AutoscaleConfig(min_replicas=1, max_replicas=4,
                                                        down_after_ticks=1, cooldown_s=0.0),
                            metrics=MetricsRegistry(), drain_timeout_s=5.0, drain_poll_s=0.01)
    proxy.inflight.enter("http://victim")
    ctl.observe(snap())
    ctl.observe(snap())
    _wait_for(lambda: ctl._busy, what="action in flight")
    for _ in range(5):
        ctl.observe(snap())
    proxy.inflight.exit("http://victim")
    _wait_for(lambda: not ctl._busy, what="drain finished")
    assert sup.calls.count(("finish_drain", "http://victim")) == 1


# -- the supervisor's slots over a stub replica --------------------------------


STUB = r"""
import json
from http.server import BaseHTTPRequestHandler, HTTPServer

class H(BaseHTTPRequestHandler):
    def log_message(self, *a):
        pass
    def do_GET(self):
        payload = json.dumps({"status": "ok"}).encode()
        self.send_response(200)
        self.send_header("Content-Length", str(len(payload)))
        self.end_headers()
        self.wfile.write(payload)

srv = HTTPServer(("127.0.0.1", 0), H)
print(json.dumps({"url": f"http://127.0.0.1:{srv.server_address[1]}"}), flush=True)
srv.serve_forever()
"""


class StubSupervisor(FleetSupervisor):
    """The port's supervisor over the always-ready stub above."""

    def __init__(self, tmp, **kw):
        self._stub = os.path.join(tmp, "stub_replica.py")
        with open(self._stub, "w") as f:
            f.write(STUB)
        super().__init__(tmp, **kw)

    def _argv(self, index):
        return [sys.executable, self._stub]


FAST = dict(health_interval_s=0.05, health_timeout_s=1.0, unhealthy_after=2, readmit_after=1,
            backoff_base_s=0.05, backoff_max_s=0.2, contract_timeout_s=20.0)


def _pid_alive(pid):
    try:
        os.kill(pid, 0)
        return True
    except OSError:
        return False


def test_supervisor_scale_up_adds_replica_to_rotation(tmp_path):
    sup = StubSupervisor(str(tmp_path), config=FleetConfig(replicas=1, **FAST))
    sup.start()
    try:
        assert sup.active_count() == 1
        r = sup.scale_up()
        assert r.index == 1 and sup.active_count() == 2  # a fresh index, never reused
        _wait_for(lambda: r.state == ReplicaState.UP, what="scaled-up replica admitted")
        assert len(sup.healthy_urls()) == 2
    finally:
        sup.stop()


def test_supervisor_drain_leaves_rotation_then_terminates(tmp_path):
    metrics = MetricsRegistry()
    sup = StubSupervisor(str(tmp_path), config=FleetConfig(replicas=2, **FAST), metrics=metrics)
    sup.start()
    try:
        victim = sup.pick_drain_victim()
        assert victim is not None and victim.index == 1  # the newest UP
        pid = victim.pid
        sup.begin_drain(victim)
        assert len(sup.healthy_urls()) == 1 and victim.alive
        assert victim.url in sup.live_urls()
        time.sleep(0.3)  # the monitor neither ejects nor restarts it
        assert victim.state == ReplicaState.DRAINING
        sup.finish_drain(victim)
        assert sup.active_count() == 1 and len(sup.replicas) == 1
        assert "replica_1_up" not in metrics.prometheus_text()
        _wait_for(lambda: not _pid_alive(pid), what="victim terminated")
    finally:
        sup.stop()


def test_supervisor_draining_replica_death_is_not_restarted(tmp_path):
    sup = StubSupervisor(str(tmp_path), config=FleetConfig(replicas=2, **FAST))
    sup.start()
    try:
        victim = sup.pick_drain_victim()
        sup.begin_drain(victim)
        os.kill(victim.pid, signal.SIGKILL)
        time.sleep(0.5)  # several monitor ticks
        assert victim.restarts == 0 and victim.state == ReplicaState.DRAINING
        sup.finish_drain(victim)
    finally:
        sup.stop()


def test_pick_drain_victim_never_last_up_nor_mid_spawn(tmp_path):
    sup = StubSupervisor(str(tmp_path), config=FleetConfig(replicas=3, **FAST))
    sup.start()
    try:
        newest = max(sup.replicas, key=lambda r: r.index)
        newest.spawning = True
        victim = sup.pick_drain_victim()
        assert victim is not None and victim.index == 1  # the newest drainable
        victim.spawning = True
        assert sup.pick_drain_victim() is None  # only one serving replica left
        victim.spawning = newest.spawning = False
        for r in sup.replicas[1:]:
            sup.begin_drain(r)
        assert sup.pick_drain_victim() is None  # the last UP replica stays
        for r in list(sup.replicas[1:]):
            sup.finish_drain(r)
    finally:
        sup.stop()


# -- a port server: the tenant quota over HTTP --------------------------------


def _export(path, v=32, d=8, seed=1, iteration=1):
    rng = np.random.RandomState(seed)
    emb = rng.randn(v, d).astype(np.float32)
    save_iteration(str(path), d, iteration, SGNSParams(torch.from_numpy(emb), torch.zeros(v, d)),
                   Vocab([f"G{i}" for i in range(v)], np.arange(v, 0, -1)), txt_output=False)
    return emb


@pytest.fixture(scope="module")
def tenant_serving(tmp_path_factory):
    d = tmp_path_factory.mktemp("tenants")
    _export(d)
    reg = ModelRegistry(str(d), device="cpu")
    assert reg.refresh()
    # near-zero refill: each bucket is its burst for the test's duration
    app = ServeApp(reg, ServeConfig(max_batch=8, max_delay_ms=2.0, max_queue=64, cache_size=0,
                                    tenant_rate=0.1, tenant_burst=3.0,
                                    tenant_overrides=("vip:1000:1000",))).start()
    server = make_server(app, "127.0.0.1", 0)
    threading.Thread(target=server.serve_forever, daemon=True).start()
    yield f"http://127.0.0.1:{server.server_address[1]}", app, str(d)
    server.shutdown()
    server.server_close()
    app.stop()


def _request(url, tenant, get=False):
    headers = {"Content-Type": "application/json"}
    if tenant is not None:
        headers["X-Tenant"] = tenant
    if get:
        req = urllib.request.Request(f"{url}/v1/similar?gene=G1&k=3", headers=headers)
    else:
        req = urllib.request.Request(
            f"{url}/v1/similar", data=json.dumps({"genes": ["G0"], "k": 4}).encode(),
            headers=headers)
    try:
        with urllib.request.urlopen(req, timeout=10.0) as r:
            return r.status, json.loads(r.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


def test_http_tenant_quota_enforced_with_labeled_429(tenant_serving):
    url, app, _ = tenant_serving
    statuses = [_request(url, "abuser", get=i % 2 == 1)[0] for i in range(4)]
    assert statuses == [200, 200, 200, 429]  # the GET fast path is metered too
    status, doc = _request(url, "abuser")
    assert status == 429 and "quota" in doc["error"]
    assert _request(url, "vip")[0] == 200  # its own bucket
    assert _request(url, None)[0] == 200  # untagged: the default tenant
    status, health = app.healthz()
    assert health["tenancy"] == {"default_rate": 0.1, "default_burst": 3.0,
                                 "overrides": ["vip"]}
    text = app.metrics.prometheus_text()
    assert 'serve_rejected_total{tenant="abuser"} 2' in text
    assert 'serve_tenant_requests_total{tenant="vip"}' in text


def test_tenancy_off_by_default_ignores_header(tenant_serving):
    _, _, export = tenant_serving
    reg = ModelRegistry(export, device="cpu")
    assert reg.refresh()
    app = ServeApp(reg, ServeConfig())
    assert app.tenants is None and "tenancy" not in app.healthz()[1]
    app.stop()
