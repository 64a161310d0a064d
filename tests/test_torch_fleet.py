"""The port's serving fleet on the CPU against the JAX package's: the
resilient client's state machines (classification, breakers, the retry
budget and backoff) give the reference's outputs on the same inputs, the
port's server answers readiness, liveness and read deadlines as the
reference's does, the supervisor restarts, ejects and gives up on stub
replicas, and a real fleet of port replicas survives a SIGKILL with every
answer equal to the port's exact engine.

The supervisor tests run a stub replica (a stdlib HTTP server, ~100 ms a
spawn); only the last two tests spawn the port's ``cli.serve``."""

import dataclasses
import json
import os
import random
import signal
import subprocess
import sys
import threading
import time
import urllib.error
import urllib.request

import numpy as np
import pytest
import torch

from gene2vec_tpu.obs import flight as ref_flight
from gene2vec_tpu.serve import client as ref_client
from gene2vec_tpu.serve import fleet as ref_fleet
from gene2vec_tpu_torch.io.checkpoint import save_iteration
from gene2vec_tpu_torch.io.vocab import Vocab
from gene2vec_tpu_torch.obs import flight, tracecontext
from gene2vec_tpu_torch.obs.registry import MetricsRegistry
from gene2vec_tpu_torch.resilience.faults import FaultInjector, FaultSpec, slow_loris
from gene2vec_tpu_torch.serve import client as port_client
from gene2vec_tpu_torch.serve.client import (
    BreakerState,
    CircuitBreaker,
    ResilientClient,
    RetryPolicy,
    TokenBucket,
)
from gene2vec_tpu_torch.serve.fleet import (
    FleetConfig,
    FleetProxy,
    FleetSupervisor,
    ReplicaState,
    read_contract_line,
)
from gene2vec_tpu_torch.serve.registry import ModelRegistry
from gene2vec_tpu_torch.serve.server import ServeApp, ServeConfig, make_server
from gene2vec_tpu_torch.sgns.model import SGNSParams

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CLIENTS = {"reference": ref_client, "port": port_client}


class FakeClock:
    def __init__(self) -> None:
        self.t = 0.0
        self.sleeps = []

    def __call__(self) -> float:
        return self.t

    def sleep(self, s: float) -> None:
        self.sleeps.append(s)
        self.t += s


# -- deterministic pieces: equal to the reference's on the same inputs --------


@pytest.mark.parametrize("status,doc,cls,safe", [
    (200, None, "ok", False),
    (204, {"x": 1}, "ok", False),
    (429, None, "http_429", False),
    (400, None, "http_4xx", False),
    (404, {"error": "no route"}, "http_4xx", False),
    (503, None, "http_503", True),
    (502, None, "http_502", True),
    (504, {"error": "expired in queue"}, "http_504", True),
    (504, {"error": "no result within 1.0s"}, "http_504", False),
    (504, None, "http_504", False),
    (500, None, "http_500", True),
])
def test_classify(status, doc, cls, safe):
    assert port_client._classify(status, doc) == (cls, safe)
    assert port_client._classify(status, doc) == ref_client._classify(status, doc)


#: breaker scripts: ("f"ailure | "s"uccess | "a"llow | "c"ancel | a float:
#: advance the clock), each step's (state, allow result) compared
BREAKER_SCRIPTS = {
    "opens_after_consecutive": (dict(failure_threshold=3, reset_timeout_s=5.0),
                                "f f s f f f a"),
    "half_open_single_probe": (dict(failure_threshold=1, reset_timeout_s=5.0,
                                    half_open_successes=2),
                               "f 5.0 a a s a s a"),
    "probe_failure_reopens": (dict(failure_threshold=1, reset_timeout_s=5.0),
                              "f 5.0 a f 4.9 a 0.2 a"),
    "cancel_releases_probe": (dict(failure_threshold=1, reset_timeout_s=1.0),
                              "f 1.0 a c a f f 0.5 a 0.5 a s a"),
}


@pytest.mark.parametrize("name", sorted(BREAKER_SCRIPTS))
def test_breaker_sequence_equals_reference(name):
    kw, script = BREAKER_SCRIPTS[name]
    traces = {}
    for pkg, mod in CLIENTS.items():
        clock = FakeClock()
        b = mod.CircuitBreaker(clock=clock, **kw)
        trace = []
        for op in script.split():
            if op == "f":
                b.record_failure()
            elif op == "s":
                b.record_success()
            elif op == "c":
                b.cancel()
            elif op == "a":
                trace.append(("allow", b.allow()))
            else:
                clock.t += float(op)
            trace.append(b.state)
        traces[pkg] = trace
    assert traces["port"] == traces["reference"]
    assert BreakerState.OPEN in traces["port"]


def test_breaker_opens_and_half_open_probe():
    clock = FakeClock()
    b = CircuitBreaker(failure_threshold=1, reset_timeout_s=5.0,
                       half_open_successes=2, clock=clock)
    b.record_failure()
    assert b.state == BreakerState.OPEN and not b.allow()
    clock.t += 5.0
    assert b.state == BreakerState.HALF_OPEN
    assert b.allow() and not b.allow()  # one probe in flight at a time
    b.record_success()
    assert b.allow()
    b.record_success()
    assert b.state == BreakerState.CLOSED


def test_token_bucket_equals_reference():
    ops = "ssseesesseeeeeeeessssss"
    got = {}
    for pkg, mod in CLIENTS.items():
        tb = mod.TokenBucket(ratio=0.5, burst=2.0)
        got[pkg] = [tb.spend() if op == "s" else tb.earn() for op in ops] + [tb.tokens]
    assert got["port"] == got["reference"]
    tb = TokenBucket(ratio=0.5, burst=2.0)
    for _ in range(100):
        tb.earn()
    assert tb.tokens == pytest.approx(2.0)  # capped at burst


def _refusing_client(mod, clock, seed, **kw):
    def refuse(base, *a, **k):
        clock.t += 0.001
        raise ConnectionRefusedError()

    policy = dict(max_attempts=5, backoff_base_s=0.1, backoff_max_s=10.0, jitter_frac=0.5,
                  breaker_failure_threshold=10_000, retry_budget_burst=100.0)
    policy.update(kw)
    return mod.ResilientClient(["http://a", "http://b"], mod.RetryPolicy(**policy),
                               transport=refuse, clock=clock, sleep=clock.sleep,
                               rng=random.Random(seed))


@pytest.mark.parametrize("seed", [0, 1, 7])
def test_retry_backoff_equals_reference_for_a_seeded_rng(seed):
    got = {}
    for pkg, mod in CLIENTS.items():
        clock = FakeClock()
        c = _refusing_client(mod, clock, seed)
        rs = [c.request("/x", {"a": 1}, timeout_s=100.0) for _ in range(3)]
        got[pkg] = (clock.sleeps, [(r.status, r.attempts, r.retries, r.error_class)
                                   for r in rs], dict(c.stats))
    assert got["port"] == got["reference"]
    sleeps = got["port"][0]
    assert len(sleeps) == 12
    for i, s in enumerate(sleeps):
        base = 0.1 * (2 ** (i % 4))
        assert base * 0.5 <= s <= base * 1.5  # jitter never leaves ±50%


# -- the resilient client over a fake transport ---------------------------------


def _client(transport, clock, targets=("http://a", "http://b"), **kw):
    return ResilientClient(list(targets), RetryPolicy(**kw), transport=transport,
                           clock=clock, sleep=clock.sleep)


def test_client_fails_over_and_propagates_shrinking_deadline():
    clock = FakeClock()
    seen = []

    def transport(base, method, path, body, ct, rt, headers=None):
        at = clock.t
        clock.t += 0.2
        seen.append((base, json.loads(body)["timeout_ms"], at))
        if base == "http://a":
            raise ConnectionRefusedError()
        return 200, json.dumps({"hello": 1}).encode()

    c = _client(transport, clock, max_attempts=3, backoff_base_s=0.0)
    r = c.request("/v1/similar", {"genes": ["G0"]}, timeout_s=1.0)
    assert r.ok and r.retries == 1 and r.target == "http://b"
    assert seen[0][1] == pytest.approx(1000.0)
    assert seen[1][1] == pytest.approx(800.0)
    for _, timeout_ms, at in seen:
        assert timeout_ms / 1000.0 <= (1.0 - at) + 1e-9


def test_client_never_launches_attempt_past_deadline():
    clock = FakeClock()
    launches = []

    def transport(base, method, path, body, ct, rt, headers=None):
        launches.append(clock.t)
        clock.t += 0.6
        raise ConnectionRefusedError()

    c = _client(transport, clock, max_attempts=10, backoff_base_s=0.0)
    assert not c.request("/v1/similar", {"genes": ["G0"]}, timeout_s=1.0).ok
    assert all(t < 1.0 for t in launches)
    assert clock.t <= 1.0 + 0.6


@pytest.mark.parametrize("status,retriable", [(400, False), (429, False), (503, True),
                                              (500, True)])
def test_client_retries_only_retry_safe_statuses(status, retriable):
    got = {}
    for pkg, mod in CLIENTS.items():
        clock = FakeClock()
        calls = []

        def transport(base, *a, **kw):
            calls.append(base)
            clock.t += 0.01
            return status, json.dumps({"error": "x"}).encode()

        c = mod.ResilientClient(["http://a", "http://b"],
                                mod.RetryPolicy(max_attempts=3, backoff_base_s=0.0),
                                transport=transport, clock=clock, sleep=clock.sleep)
        r = c.request("/v1/similar", {"genes": ["G0"]}, timeout_s=5.0)
        got[pkg] = (r.status, list(calls))
    assert got["port"] == got["reference"]
    assert got["port"][0] == status and len(got["port"][1]) == (3 if retriable else 1)


def test_client_retries_queue_expired_504_but_not_compute_504():
    for error, n in (("expired in queue", 2), ("no result within 2.0s", 1)):
        clock = FakeClock()
        calls = []

        def transport(base, *a, **kw):
            calls.append(base)
            clock.t += 0.01
            return 504, json.dumps({"error": error}).encode()

        c = _client(transport, clock, max_attempts=2, backoff_base_s=0.0)
        assert c.request("/x", {"a": 1}, timeout_s=5.0).status == 504
        assert len(calls) == n


def test_client_retry_budget_bounds_amplification():
    clock = FakeClock()

    def refuse(base, *a, **kw):
        clock.t += 0.001
        raise ConnectionRefusedError()

    c = _client(refuse, clock, targets=("http://a",), max_attempts=5,
                retry_budget_ratio=0.0, retry_budget_burst=3.0, backoff_base_s=0.0,
                breaker_failure_threshold=10_000)
    attempts = sum(c.request("/x", {"a": 1}, timeout_s=5.0).attempts for _ in range(10))
    # 10 primaries + exactly burst=3 retries, ever
    assert attempts == 13
    assert c.stats["budget_exhausted"] >= 1


def test_client_all_breakers_open_fails_fast_as_503():
    clock = FakeClock()

    def refuse(base, *a, **kw):
        clock.t += 0.001
        raise ConnectionRefusedError()

    c = _client(refuse, clock, targets=("http://a",), max_attempts=1,
                breaker_failure_threshold=2, breaker_reset_timeout_s=60.0)
    c.request("/x", {"a": 1}, timeout_s=1.0)
    c.request("/x", {"a": 1}, timeout_s=1.0)
    r = c.request("/x", {"a": 1}, timeout_s=1.0)
    assert r.status == 503 and not r.ok
    assert c.stats["breaker_rejections"] == 1
    assert c.breaker("http://a").state == BreakerState.OPEN


def test_client_hedges_at_p95_and_first_answer_wins():
    slow, fast = "http://slow", "http://fast"

    def transport(base, method, path, body, ct, rt, headers=None):
        time.sleep(0.25 if base == slow else 0.005)
        return 200, json.dumps({"from": base}).encode()

    c = ResilientClient([slow, fast],
                        RetryPolicy(hedge=True, hedge_min_samples=4, max_attempts=2),
                        transport=transport)
    for _ in range(6):
        c._record_latency(0.01)
    r = c.request("/x", {"a": 1}, timeout_s=5.0)
    assert r.ok and r.hedged and r.doc["from"] == fast
    assert r.latency_s < 0.2
    assert c.stats["hedges"] == 1


# -- the port's server: readiness, liveness, read deadlines ---------------------


def _tiny_export(path, v=8, d=4, seed=0):
    rng = np.random.RandomState(seed)
    emb = rng.randn(v, d).astype(np.float32)
    save_iteration(str(path), d, 1, SGNSParams(torch.from_numpy(emb), torch.zeros(v, d)),
                   Vocab([f"G{i}" for i in range(v)], np.arange(v, 0, -1)),
                   txt_output=False)
    return emb


@pytest.fixture
def tiny_app(tmp_path):
    _tiny_export(tmp_path)
    reg = ModelRegistry(str(tmp_path), device="cpu")
    app = ServeApp(reg, ServeConfig(read_timeout_s=0.5))
    server = make_server(app, "127.0.0.1", 0)
    threading.Thread(target=server.serve_forever, daemon=True).start()
    yield app, reg, server
    server.shutdown()
    server.server_close()
    app.stop()


def test_healthz_not_ready_until_loaded_and_livez_always(tiny_app):
    app, reg, _ = tiny_app
    status, doc = app.handle("GET", "/healthz", None)
    assert status == 503 and doc["status"] == "not_ready"
    status, doc = app.handle("GET", "/livez", None)
    assert status == 200 and doc["status"] == "alive"
    assert reg.refresh()
    status, doc = app.handle("GET", "/healthz", None)
    assert status == 200 and doc["status"] == "ok" and doc["model"]["iteration"] == 1


def test_slow_loris_gets_408_and_thread_is_unpinned(tiny_app):
    app, reg, server = tiny_app
    reg.refresh()
    app.batcher.start()
    host, port = server.server_address[:2]
    status, held = slow_loris(host, port, drip_bytes=1, drip_interval_s=0.05, duration_s=5.0)
    assert status == 408 and held < 2.0
    assert app.metrics.counter("serve_http_408_total").value >= 1
    with urllib.request.urlopen(f"http://{host}:{port}/livez", timeout=5.0) as r:
        assert r.status == 200


def test_injected_reset_surfaces_as_transport_error(tiny_app):
    app, reg, server = tiny_app
    reg.refresh()
    app.batcher.start()
    app.faults = FaultInjector(FaultSpec(seed=0, reset_p=1.0))
    host, port = server.server_address[:2]
    r = ResilientClient([f"http://{host}:{port}"], RetryPolicy(max_attempts=1)).request(
        "/v1/genes?limit=2")
    assert r.error_class == "transport"
    app.faults = None


# -- the supervisor over a stub replica ------------------------------------------


STUB = r"""
import json, os, sys
from http.server import BaseHTTPRequestHandler, HTTPServer

unready_flag, die_flag = sys.argv[1], sys.argv[2]

class H(BaseHTTPRequestHandler):
    def log_message(self, *a):
        pass
    def _send(self, status, payload):
        self.send_response(status)
        self.send_header("Content-Length", str(len(payload)))
        self.end_headers()
        self.wfile.write(payload)
    def do_GET(self):
        if os.path.exists(die_flag):
            os._exit(9)
        if self.path.startswith("/metrics"):
            return self._send(200, b"serve_requests_total 3\nserve_queue_depth 1\n")
        ready = not os.path.exists(unready_flag)
        self._send(200 if ready else 503,
                   json.dumps({"status": "ok" if ready else "not_ready"}).encode())
    def do_POST(self):
        self.rfile.read(int(self.headers.get("Content-Length", "0")))
        self._send(200, json.dumps({"pid": os.getpid()}).encode())

srv = HTTPServer(("127.0.0.1", 0), H)
print(json.dumps({"url": f"http://127.0.0.1:{srv.server_address[1]}"}), flush=True)
srv.serve_forever()
"""


def stub_supervisor(base, tmp, **kw):
    """A supervisor of ``base`` (the port's or the reference's class)
    whose replicas are the stub above."""

    class Stub(base):
        def __init__(self):
            self._stub = os.path.join(tmp, "stub_replica.py")
            with open(self._stub, "w") as f:
                f.write(STUB)
            self.unready_flag = os.path.join(tmp, "unready")
            self.die_flag = os.path.join(tmp, "die")
            super().__init__(tmp, **kw)

        def _argv(self, index):
            return [sys.executable, self._stub, self.unready_flag, self.die_flag]

    return Stub()


FAST = dict(health_interval_s=0.05, health_timeout_s=1.0, unhealthy_after=2,
            readmit_after=2, backoff_base_s=0.05, backoff_max_s=0.2, contract_timeout_s=20.0)


def _wait(predicate, timeout_s=15.0, what="condition"):
    deadline = time.monotonic() + timeout_s
    while time.monotonic() < deadline:
        if predicate():
            return
        time.sleep(0.02)
    raise TimeoutError(f"{what} not reached in {timeout_s}s")


def test_supervisor_restarts_sigkilled_replica(tmp_path):
    reg = MetricsRegistry()
    sup = stub_supervisor(FleetSupervisor, str(tmp_path),
                          config=FleetConfig(replicas=1, **FAST), metrics=reg)
    sup.start()
    try:
        assert len(sup.healthy_urls()) == 1
        old_pid = sup.replicas[0].pid
        os.kill(old_pid, signal.SIGKILL)
        _wait(lambda: sup.replicas[0].restarts >= 1
              and sup.replicas[0].state == ReplicaState.UP, what="restart after SIGKILL")
        assert sup.replicas[0].pid != old_pid and sup.healthy_urls()
        assert reg.counter("replica_restarts_total").value >= 1
    finally:
        sup.stop()


def test_supervisor_ejects_unready_and_readmits(tmp_path):
    sup = stub_supervisor(FleetSupervisor, str(tmp_path), config=FleetConfig(replicas=1, **FAST))
    sup.start()
    try:
        open(sup.unready_flag, "w").close()
        _wait(lambda: sup.replicas[0].state == ReplicaState.EJECTED, what="ejection")
        assert sup.healthy_urls() == [] and sup.replicas[0].alive  # ejected, not restarted
        os.unlink(sup.unready_flag)
        _wait(lambda: sup.replicas[0].state == ReplicaState.UP, what="re-admission")
        assert len(sup.healthy_urls()) == 1
    finally:
        sup.stop()


def test_supervisor_storm_cap_gives_up(tmp_path):
    sup = stub_supervisor(FleetSupervisor, str(tmp_path), config=FleetConfig(
        replicas=1, storm_max_restarts=2, storm_window_s=60.0, **FAST))
    sup.start()
    try:
        open(sup.die_flag, "w").close()  # every probe now kills the stub
        _wait(lambda: sup.replicas[0].state == ReplicaState.FAILED, what="storm cap")
        assert sup.replicas[0].restarts <= 3 and "storm" in sup.replicas[0].last_error
        assert sup.healthy_urls() == []
    finally:
        sup.stop()


def test_supervisor_storm_cap_covers_precontract_crashes(tmp_path):
    sup = stub_supervisor(FleetSupervisor, str(tmp_path), config=FleetConfig(
        replicas=1, storm_max_restarts=2, storm_window_s=60.0,
        **{**FAST, "contract_timeout_s": 5.0}))
    sup.start()
    try:
        with open(sup._stub, "w") as f:
            f.write("import sys; sys.exit(3)\n")
        os.kill(sup.replicas[0].pid, signal.SIGKILL)
        _wait(lambda: sup.replicas[0].state == ReplicaState.FAILED, what="storm cap")
        assert sup.replicas[0].restarts == 0 and "storm" in sup.replicas[0].last_error
    finally:
        sup.stop()


def test_supervisor_jittered_backoff_equals_reference(tmp_path):
    cfg = FleetConfig(replicas=1, backoff_base_s=1.0, backoff_max_s=64.0, jitter_frac=0.5,
                      **{k: v for k, v in FAST.items() if "backoff" not in k})
    delays = {}
    for pkg, base in (("port", FleetSupervisor), ("reference", ref_fleet.FleetSupervisor)):
        kw = dict(config=cfg if pkg == "port" else ref_fleet.FleetConfig(**dataclasses.asdict(cfg)),
                  rng=random.Random(0))
        sup = stub_supervisor(base, str(tmp_path), **kw)
        r, now, got = sup.replicas[0], 100.0, []
        for n in range(6):
            r.restart_times.clear()
            r.restart_times.extend([now] * n)
            sup._schedule_restart(r, now)
            got.append((r.state, r.next_restart_at - now))
        delays[pkg] = got
    assert delays["port"] == delays["reference"]
    for n, (state, d) in enumerate(delays["port"][:5]):
        assert state == ReplicaState.BACKOFF
        assert 0.5 * 2 ** n <= d <= 1.5 * 2 ** n
    assert delays["port"][5][0] == ReplicaState.FAILED  # 5 restarts in the window


def test_read_contract_line_times_out_on_silent_child():
    proc = subprocess.Popen([sys.executable, "-c", "import time; time.sleep(30)"],
                            stdout=subprocess.PIPE, text=True)
    try:
        with pytest.raises(TimeoutError, match="contract line"):
            read_contract_line(proc, timeout_s=0.3)
    finally:
        proc.kill()
        proc.wait(timeout=10)


def test_proxy_reaps_slow_loris_with_408(tmp_path):
    sup = stub_supervisor(FleetSupervisor, str(tmp_path), config=FleetConfig(replicas=1, **FAST))
    sup.start()
    proxy = FleetProxy(sup, metrics=MetricsRegistry(), read_timeout_s=0.5, scrape_interval_s=0)
    url = proxy.serve("127.0.0.1", 0)
    try:
        host, port = url.split("//")[1].split(":")
        status, held = slow_loris(host, int(port), drip_bytes=1, drip_interval_s=0.05,
                                  duration_s=5.0)
        assert status == 408 and held < 2.0
        assert proxy.metrics.counter("fleet_http_408_total").value >= 1
    finally:
        proxy.stop()
        sup.stop()


def _get(url):
    try:
        with urllib.request.urlopen(url, timeout=5.0) as r:
            return r.status, r.read()
    except urllib.error.HTTPError as e:
        return e.code, e.read()


def test_proxy_routes_and_reports_fleet_health(tmp_path):
    sup = stub_supervisor(FleetSupervisor, str(tmp_path), config=FleetConfig(replicas=2, **FAST))
    sup.start()
    proxy = FleetProxy(sup, metrics=MetricsRegistry(), scrape_interval_s=0.05)
    url = proxy.serve("127.0.0.1", 0)
    try:
        status, raw = _get(f"{url}/healthz")
        assert status == 200 and json.loads(raw)["replicas_up"] == 2
        assert _get(f"{url}/livez") == (200, b'{"status": "alive"}')
        req = urllib.request.Request(f"{url}/v1/similar", data=b'{"genes": ["G0"]}',
                                     headers={"Content-Type": "application/json"})
        pids = set()
        for _ in range(4):  # round-robin spreads over both stubs
            with urllib.request.urlopen(req, timeout=5.0) as r:
                pids.add(json.loads(r.read())["pid"])
        assert len(pids) == 2
        assert _get(f"{url}/nope")[0] == 404
        status, raw = _get(f"{url}/debug/flight")
        doc = json.loads(raw)
        assert status == 200 and doc["schema"] == "gene2vec-tpu/flight/v1"
        assert sum(r["route"] == "/v1/similar" for r in doc["records"]) == 4
        # /metrics/fleet: the two stubs' counters summed
        _wait(lambda: b"fleet_requests 6" in _get(f"{url}/metrics/fleet")[1],
              what="the merged fleet view")
        assert b"fleet_proxy_ok_total 4" in _get(f"{url}/metrics")[1]
    finally:
        proxy.stop()
        sup.stop()


# -- real port replicas ----------------------------------------------------------


def _spawn_fleet(export, tmp, *extra, timeout_s=120.0):
    """``cli.fleet`` over ``export``; returns (process, contract line)."""
    env = dict(os.environ, OMP_NUM_THREADS="1", PYTHONPATH=REPO)
    err = open(os.path.join(tmp, "fleet.err"), "w")
    proc = subprocess.Popen(
        [sys.executable, "-m", "gene2vec_tpu_torch.cli.fleet", "--export-dir", str(export),
         "--port", "0", "--run-dir", os.path.join(tmp, "fleet_run"), *extra],
        stdout=subprocess.PIPE, stderr=err, text=True, env=env, cwd=REPO)
    err.close()
    try:
        return proc, read_contract_line(proc, timeout_s)
    except Exception:
        proc.kill()
        proc.wait(timeout=30)
        with open(os.path.join(tmp, "fleet.err")) as f:
            raise AssertionError(f.read()[-3000:])


def _stop_fleet(proc):
    proc.send_signal(signal.SIGTERM)
    try:
        proc.wait(timeout=60)
    except subprocess.TimeoutExpired:
        proc.kill()
        proc.wait(timeout=30)


def _fleet_health(url):
    return json.loads(_get(f"{url}/healthz")[1])


#: a served score against the oracle's: both are rounded to 6 decimals
#: from float32 dots whose last bits depend on the batch they ran in
SCORE_TOL = 1.5e-6


def _same_neighbors(got, want):
    """The same genes in the same order, every score within SCORE_TOL."""
    (g,), (w,) = got["results"], want["results"]
    return (g["query"] == w["query"]
            and [n["gene"] for n in g["neighbors"]] == [n["gene"] for n in w["neighbors"]]
            and all(abs(a["score"] - b["score"]) <= SCORE_TOL
                    for a, b in zip(g["neighbors"], w["neighbors"])))


def _tree(doc):
    """A reassembled trace as nested (name, pid, children) tuples."""
    def node(n):
        kids = n.get("process_spans", []) + n.get("children", [])
        return (n["name"], n.get("pid"), sorted(node(k) for k in kids))
    return sorted(node(r) for r in doc["roots"])


def test_fleet_survives_sigkill_with_exact_answers(tmp_path):
    """Two CPU replicas of the port's server behind ``cli.fleet``: SIGKILL
    one under load, and every answer through the front door equals the
    port's exact engine in this process (the same neighbors, each score
    within SCORE_TOL); the supervisor restarts the
    slot; a traced request reassembles across processes, the same tree
    through the port's and the reference's ``collect_trace``."""
    export = tmp_path / "export"
    _tiny_export(export, v=64, d=16, seed=3)
    proc, info = _spawn_fleet(
        export, str(tmp_path), "--replicas", "2", "--backoff-base", "0.05",
        "--health-interval", "0.1", "--scrape-interval", "0.2", "--alert-rules", "none",
        "--serve-arg=--device", "--serve-arg=cpu", "--serve-arg=--cache-size",
        "--serve-arg=0", "--serve-arg=--poll-interval", "--serve-arg=3600")
    reg = ModelRegistry(str(export), device="cpu")
    assert reg.refresh()
    oracle = ServeApp(reg, ServeConfig(cache_size=0)).start()
    url = info["url"]
    try:
        client = ResilientClient([url], RetryPolicy(max_attempts=4, default_timeout_s=10.0))
        wrong, statuses, stop = [], [], threading.Event()

        def load(worker):
            i = worker
            while not stop.is_set():
                gene, k = f"G{(i * 7) % 64}", 1 + i % 5
                r = client.request("/v1/similar", {"genes": [gene], "k": k})
                statuses.append(r.status)
                if r.ok and not _same_neighbors(r.doc, oracle.similar(
                        {"genes": [gene], "k": k})):
                    wrong.append((gene, k, r.doc))
                i += 2

        threads = [threading.Thread(target=load, args=(w,)) for w in range(2)]
        for t in threads:
            t.start()
        try:
            _wait(lambda: len(statuses) >= 20, 60.0, "traffic before the kill")
            os.kill(info["replica_pids"][0], signal.SIGKILL)
            _wait(lambda: any(r["restarts"] >= 1 and r["state"] == "up"
                              for r in _fleet_health(url)["replicas"]),
                  90.0, "the killed replica's restart")
            n = len(statuses)
            _wait(lambda: len(statuses) >= n + 20, 60.0, "traffic after the restart")
        finally:
            stop.set()
            for t in threads:
                t.join(timeout=60)
        assert not wrong, wrong[:2]
        assert statuses.count(200) == len(statuses), sorted(set(statuses))
        health = _fleet_health(url)
        assert health["replicas_up"] == 2
        assert health["replicas"][0]["pid"] != info["replica_pids"][0]
        # a traced request through the front door, reassembled
        ctx = tracecontext.new_trace()
        req = urllib.request.Request(
            f"{url}/v1/similar", data=json.dumps({"genes": ["G5"], "k": 3}).encode(),
            headers={"Content-Type": "application/json", "traceparent": ctx.to_header()})
        with urllib.request.urlopen(req, timeout=10.0) as r:
            assert r.status == 200
        names = set()

        def walk(n):
            names.add(n["name"])
            for k in n.get("process_spans", []) + n.get("children", []):
                walk(k)

        def reassembled():
            doc = flight.collect_trace(str(tmp_path), ctx.trace_id)
            names.clear()
            for root in doc["roots"]:
                walk(root)
            return {"proxy_request", "client_attempt", "serve_request", "batch_item",
                    "engine_topk"} <= names

        _wait(reassembled, 10.0, "the reassembled trace")
        port_doc = flight.collect_trace(str(tmp_path), ctx.trace_id)
        ref_doc = ref_flight.collect_trace(str(tmp_path), ctx.trace_id)
        assert _tree(port_doc) == _tree(ref_doc)
        assert len(port_doc["processes"]) >= 2  # the front door and a replica
    finally:
        oracle.stop()
        _stop_fleet(proc)
    assert proc.returncode == 0
    for pid in info["replica_pids"][1:]:
        with pytest.raises(ProcessLookupError):
            os.kill(pid, 0)


def test_fleet_without_a_gpu_or_a_cpu_flag_exits_nonzero(tmp_path):
    """On a host with no GPU and no ``--device cpu`` the replica exits at
    start and the fleet gives up: it never serves on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("this host has a GPU: the replicas would serve on it")
    export = tmp_path / "export"
    _tiny_export(export)
    res = subprocess.run(
        [sys.executable, "-m", "gene2vec_tpu_torch.cli.fleet", "--export-dir", str(export),
         "--port", "0", "--replicas", "2", "--run-dir", str(tmp_path / "run")],
        capture_output=True, text=True, timeout=180, cwd=REPO,
        env=dict(os.environ, OMP_NUM_THREADS="1", PYTHONPATH=REPO))
    assert res.returncode != 0
    assert res.stdout == ""  # no contract line: nothing was served
    assert "fleet failed to start" in res.stderr
