"""HTTP fault injection (``gene2vec_tpu_torch/resilience/faults.py``) held
against the reference's on the CPU: the spec's JSON, the injector's
decisions request for request, and the port's server answering each fault
kind as the reference's pins it (``tests/test_fleet.py``) — with the hot
read path stepping aside while an injector is set."""

import dataclasses
import http.client
import json
import os
import socket
import subprocess
import sys
import threading
import time
import urllib.error
import urllib.request

import numpy as np
import pytest
import torch

from gene2vec_tpu.obs.registry import MetricsRegistry as RefRegistry
from gene2vec_tpu.resilience import faults as ref_faults
from gene2vec_tpu_torch.io.checkpoint import save_iteration
from gene2vec_tpu_torch.io.vocab import Vocab
from gene2vec_tpu_torch.obs import trace
from gene2vec_tpu_torch.obs.registry import MetricsRegistry
from gene2vec_tpu_torch.resilience.faults import (
    FAULTS_ENV,
    Decision,
    FaultInjector,
    FaultSpec,
    slow_loris,
)
from gene2vec_tpu_torch.serve.registry import ModelRegistry
from gene2vec_tpu_torch.serve.server import ServeApp, ServeConfig, make_server
from gene2vec_tpu_torch.sgns.model import SGNSParams

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

SPECS = {
    "mixed": dict(seed=11, latency_p=0.3, latency_ms=5.0, error_p=0.2, reset_p=0.1,
                  blackhole_p=0.05),
    "drill": dict(seed=7, error_p=0.5),
    "byzantine": dict(seed=5, route_prefix="/v1/similar", latency_p=0.5, latency_ms=150.0,
                      error_p=0.5, error_status=404),
}
ROUTES = ["/v1/similar", "/healthz", "/v1/genes", "/metrics", "/v1/similar/x",
          "/v1/interaction", "/v1/embedding"]


@pytest.fixture(autouse=True)
def _no_buffered_spans():
    """Servers and writers outside a run buffer ambient spans for the next
    run's tracer: leave none behind for later tests in this process."""
    yield
    with trace._pending_lock:
        trace._pending.clear()


# -- the spec and the injector -----------------------------------------------------


@pytest.mark.parametrize("name", list(SPECS))
def test_fault_spec_round_trips_json_as_the_reference(name):
    spec = FaultSpec(**SPECS[name])
    assert FaultSpec.from_json(spec.to_json()) == spec
    assert spec.to_json() == ref_faults.FaultSpec(**SPECS[name]).to_json()
    assert dataclasses.asdict(spec) == dataclasses.asdict(
        ref_faults.FaultSpec.from_json(spec.to_json()))


@pytest.mark.parametrize("blob,match", [
    ('{"seed": 1, "error_q": 0.5}', "unknown fault spec field"),
    ('[1, 2]', "must be a JSON object"),
])
def test_fault_spec_rejects_unknown_fields_and_non_objects(blob, match):
    with pytest.raises(ValueError, match=match):
        FaultSpec.from_json(blob)
    with pytest.raises(ValueError, match=match):
        ref_faults.FaultSpec.from_json(blob)


@pytest.mark.parametrize("name", list(SPECS))
def test_injector_decides_as_the_reference_request_for_request(name):
    """500 requests over mixed routes: the same decisions in the same
    order, the same tallies and the same fault counters."""
    ours = FaultInjector(FaultSpec(**SPECS[name]), metrics=MetricsRegistry())
    theirs = ref_faults.FaultInjector(ref_faults.FaultSpec(**SPECS[name]),
                                      metrics=RefRegistry())
    rng = np.random.RandomState(3)
    for route in rng.choice(ROUTES, size=500):
        got, want = ours.decide(str(route)), theirs.decide(str(route))
        if want is None:
            assert got is None
        else:
            assert dataclasses.astuple(got) == dataclasses.astuple(want)
    assert ours.decisions == theirs.decisions
    assert sum(ours.decisions.values()) > 0
    for kind in ("injected", "latency", "error", "reset", "blackhole"):
        counter = ("serve_faults_injected_total" if kind == "injected"
                   else f"serve_fault_{kind}_total")
        assert (ours.metrics.counter(counter).value
                == theirs.metrics.counter(counter).value)


def test_injector_draws_twice_a_request_whatever_fires():
    a = FaultInjector(FaultSpec(**SPECS["mixed"]))
    for _ in range(50):
        assert a.decide("/healthz") is None  # outside route_prefix: no draw
    seq = [a.decide("/v1/similar") for _ in range(200)]
    kinds = {d.kind for d in seq if d is not None}
    assert {"error", "reset", "blackhole"} <= kinds
    b = FaultInjector(FaultSpec(**SPECS["mixed"]))
    assert seq == [b.decide("/v1/similar") for _ in range(200)]
    assert a._rng.getstate() == b._rng.getstate()


def test_injector_is_off_without_the_environment(monkeypatch):
    assert FAULTS_ENV == ref_faults.FAULTS_ENV == "GENE2VEC_TPU_FAULTS"
    monkeypatch.delenv(FAULTS_ENV, raising=False)
    assert FaultInjector.from_env() is None
    monkeypatch.setenv(FAULTS_ENV, '{"seed": 5, "error_p": 1.0}')
    inj = FaultInjector.from_env()
    assert inj.decide("/v1/x") == Decision(delay_s=0.0, kind="error", arg=503.0)


# -- the server ----------------------------------------------------------------------


V, D = 64, 8
TOKENS = [f"G{i}" for i in range(V)]


@pytest.fixture(scope="module")
def export(tmp_path_factory):
    d = tmp_path_factory.mktemp("export")
    rng = np.random.RandomState(0)
    emb = rng.randn(V, D).astype(np.float32)
    save_iteration(str(d), D, 1, SGNSParams(torch.from_numpy(emb), torch.zeros(V, D)),
                   Vocab(TOKENS, np.full(V, 3)), txt_output=False)
    return str(d)


class Server:
    def __init__(self, export, faults=None, read_timeout_s=10.0, cache_size=0):
        self.registry = ModelRegistry(export, device="cpu")
        assert self.registry.refresh()
        self.app = ServeApp(
            self.registry, ServeConfig(cache_size=cache_size, max_delay_ms=1.0,
                                       read_timeout_s=read_timeout_s),
            fault_injector=faults).start()
        self.http = make_server(self.app, "127.0.0.1", 0)
        self.host, self.port = self.http.server_address[:2]
        self.url = f"http://{self.host}:{self.port}"
        self.thread = threading.Thread(target=self.http.serve_forever, daemon=True)
        self.thread.start()

    def get(self, path, timeout=30):
        try:
            with urllib.request.urlopen(self.url + path, timeout=timeout) as r:
                return r.status, r.read()
        except urllib.error.HTTPError as e:
            return e.code, e.read()

    def close(self):
        self.http.shutdown()
        self.http.server_close()
        self.app.stop()
        self.thread.join(timeout=5)


@pytest.fixture
def serve(export):
    servers = []

    def start(**kw):
        servers.append(Server(export, **kw))
        return servers[-1]

    yield start
    for s in servers:
        s.close()


def test_error_faults_answer_the_spec_status_and_bypass_the_fast_path(serve):
    """``error_p=1``: every /v1/ request answers the spec's status, the GET
    hot path included (it would answer it from the loop otherwise), while
    /healthz and /metrics stay clean; the injector counts on /metrics."""
    s = serve(faults=FaultInjector(FaultSpec(seed=0, error_p=1.0, error_status=503)),
              cache_size=64)
    assert s.app.faults.metrics is s.app.metrics
    for path in ("/v1/similar?gene=G1&k=3", "/v1/genes?limit=2"):
        status, body = s.get(path)
        assert status == 503 and json.loads(body) == {
            "error": "injected fault (resilience drill)"}
    assert s.get("/healthz")[0] == 200
    status, text = s.get("/metrics")
    assert status == 200
    assert b"serve_fault_error_total 2" in text
    assert b"serve_faults_injected_total 2" in text
    assert s.app.metrics.counter("serve_response_cache_hits_total").value == 0


def test_injected_reset_surfaces_as_a_transport_error(serve):
    s = serve(faults=FaultInjector(FaultSpec(seed=0, reset_p=1.0)))
    conn = http.client.HTTPConnection(s.host, s.port, timeout=10)
    with pytest.raises((ConnectionResetError, http.client.RemoteDisconnected)):
        conn.request("GET", "/v1/genes?limit=2")
        conn.getresponse().read()
    conn.close()
    assert s.get("/healthz")[0] == 200  # the server lives on


def test_injected_blackhole_holds_then_closes_without_an_answer(serve):
    s = serve(faults=FaultInjector(FaultSpec(seed=0, blackhole_p=1.0,
                                             blackhole_hold_s=0.3)))
    conn = http.client.HTTPConnection(s.host, s.port, timeout=10)
    t0 = time.monotonic()
    with pytest.raises((http.client.RemoteDisconnected, ConnectionResetError)):
        conn.request("GET", "/v1/similar?gene=G2&k=3")
        conn.getresponse().read()
    assert time.monotonic() - t0 >= 0.25
    conn.close()


def test_injected_latency_delays_a_correct_answer(serve):
    clean = serve()
    slow = serve(faults=FaultInjector(FaultSpec(seed=0, latency_p=1.0, latency_ms=200.0)))
    want = clean.get("/v1/similar?gene=G5&k=4")
    t0 = time.monotonic()
    got = slow.get("/v1/similar?gene=G5&k=4")
    assert time.monotonic() - t0 >= 0.19
    assert got[0] == want[0] == 200
    assert json.loads(got[1])["results"] == json.loads(want[1])["results"]
    assert slow.app.metrics.counter("serve_fault_latency_total").value == 1


def test_the_drill_sequence_is_the_references_prediction(serve):
    """The GPU smoke run's fault phase in small: 64 sequential GETs under
    ``{"seed": 7, "error_p": 0.5}`` answer the statuses a reference
    injector predicts, and every clean answer is the unfaulted server's."""
    spec = FaultSpec(**SPECS["drill"])
    faulted, clean = serve(faults=FaultInjector(spec)), serve()
    oracle = ref_faults.FaultInjector(ref_faults.FaultSpec.from_json(spec.to_json()))
    want = [503 if oracle.decide("/v1/similar") else 200 for _ in range(64)]
    got = []
    for i in range(64):
        path = f"/v1/similar?gene=G{i % V}&k=5"
        status, body = faulted.get(path)
        got.append(status)
        if status == 200:
            assert json.loads(body)["results"] == json.loads(clean.get(path)[1])["results"]
    assert got == want and 0 < want.count(503) < 64
    assert faulted.app.metrics.counter("serve_fault_error_total").value == want.count(503)
    status, doc = faulted.get("/healthz")
    assert status == 200 and json.loads(doc)["status"] == "ok"


def test_slow_loris_gets_408_and_the_server_stays_up(serve):
    s = serve(read_timeout_s=0.5)
    status, held = slow_loris(s.host, s.port, drip_bytes=1, drip_interval_s=0.05,
                              duration_s=5.0)
    assert status == 408
    assert held < 2.0  # ~read_timeout_s, not the loris's duration
    assert s.app.metrics.counter("serve_http_408_total").value >= 1
    assert s.get("/healthz")[0] == 200


def test_serve_cli_takes_faults_and_says_so(export, tmp_path):
    spec = '{"seed": 7, "error_p": 1.0}'
    err_path = tmp_path / "stderr.txt"
    with open(err_path, "w") as err:
        proc = subprocess.Popen(
            [sys.executable, "-m", "gene2vec_tpu_torch.cli.serve", "--export-dir", export,
             "--port", "0", "--device", "cpu", "--faults", spec, "--cache-size", "0"],
            stdout=subprocess.PIPE, stderr=err, text=True, cwd=ROOT,
            env=dict(os.environ, OMP_NUM_THREADS="1"))
    try:
        url = json.loads(proc.stdout.readline())["url"]
        try:
            urllib.request.urlopen(url + "/v1/similar?gene=G1&k=2", timeout=30)
            raise AssertionError("the fault did not fire")
        except urllib.error.HTTPError as e:
            assert e.code == 503
        with urllib.request.urlopen(url + "/healthz", timeout=30) as r:
            assert r.status == 200
    finally:
        proc.terminate()
        proc.wait(timeout=30)
    text = err_path.read_text()
    assert f"FAULT INJECTION ACTIVE: {FaultSpec.from_json(spec).to_json()}" in text


def test_serve_cli_reads_the_environment_without_the_flag(export, tmp_path, monkeypatch):
    """Without ``--faults`` the CLI asks ``$GENE2VEC_TPU_FAULTS``; an
    unknown field fails the start loudly."""
    from gene2vec_tpu_torch.cli import serve as serve_cli

    monkeypatch.setenv(FAULTS_ENV, '{"seed": 1, "bogus": 2}')
    with pytest.raises(ValueError, match="unknown fault spec field"):
        serve_cli.main(["--export-dir", export, "--port", "0", "--device", "cpu"])


def test_apply_reset_closes_with_an_rst():
    from gene2vec_tpu_torch.resilience.faults import apply_reset

    srv = socket.socket()
    srv.bind(("127.0.0.1", 0))
    srv.listen(1)
    cli = socket.create_connection(srv.getsockname())
    conn, _ = srv.accept()
    apply_reset(conn)
    cli.settimeout(5)
    with pytest.raises(ConnectionResetError):
        cli.sendall(b"x")
        cli.recv(1)
    cli.close()
    srv.close()
    apply_reset(conn)  # already closed: best effort, never raises
