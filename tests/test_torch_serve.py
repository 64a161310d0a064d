"""The port's serving stack on the CPU against the JAX package's: the
registry on an export the port's checkpoint writer made, hot swap under
a reader, and the HTTP server's routes — its neighbor lists equal the
JAX ``ServeApp``'s on the same export, in all three index modes."""

import json
import threading
import time
import urllib.error
import urllib.request

import numpy as np
import pytest
import torch

from gene2vec_tpu.serve.registry import ModelRegistry as JaxRegistry
from gene2vec_tpu.serve.server import ServeApp as JaxApp
from gene2vec_tpu.serve.server import ServeConfig as JaxConfig
from gene2vec_tpu_torch.io.checkpoint import save_iteration
from gene2vec_tpu_torch.io.vocab import Vocab
from gene2vec_tpu_torch.serve.registry import ModelRegistry
from gene2vec_tpu_torch.serve.server import ServeApp, ServeConfig, make_server
from gene2vec_tpu_torch.sgns.model import SGNSParams

V, D = 300, 16
TOKENS = [f"G{i}" for i in range(V)]


def write_iteration(export, iteration, seed=None):
    """One export iteration through the port's trainer-side writer: a
    clustered random table (10 groups of 30 genes)."""
    rng = np.random.RandomState(iteration if seed is None else seed)
    cent = rng.randn(10, D).astype(np.float32)
    emb = cent[np.arange(V) // 30] + 0.3 * rng.randn(V, D).astype(np.float32)
    params = SGNSParams(torch.from_numpy(emb), torch.from_numpy(emb * 0.5))
    save_iteration(str(export), D, iteration, params, Vocab(TOKENS, np.full(V, 5)),
                   txt_output=False)
    return emb


@pytest.fixture
def export(tmp_path):
    d = tmp_path / "export"
    write_iteration(d, 1)
    write_iteration(d, 2)
    return d


def test_both_registries_load_the_same_newest_iteration(export):
    # a torn newest iteration: its manifest no longer matches the bytes
    write_iteration(export, 3)
    with open(export / "gene2vec_dim_16_iter_3.npz", "r+b") as f:
        f.seek(200)
        f.write(b"\0" * 64)
    jr, tr = JaxRegistry(str(export)), ModelRegistry(str(export), device="cpu")
    assert jr.refresh() and tr.refresh()
    jm, tm = jr.model, tr.model
    assert tm.version == jm.version == (16, 2)
    assert tm.tokens == jm.tokens and tm.index == jm.index
    assert tm.emb.tobytes() == np.asarray(jm.emb).tobytes()
    assert tm.unit.device.type == "cpu"
    np.testing.assert_allclose(tm.unit.numpy(), np.asarray(jm.unit), rtol=0, atol=1e-7)


def test_hot_swap_is_atomic_under_a_reader(export):
    reg = ModelRegistry(str(export), device="cpu", index_mode="quant")
    assert reg.refresh()
    bad, seen, stop = [], set(), threading.Event()

    def reader():
        while not stop.is_set():
            m = reg.model
            seen.add(m.iteration)
            if m.ann.version != m.version or m.meta.get("iteration") != m.iteration:
                bad.append(m.version)

    t = threading.Thread(target=reader)
    t.start()
    for it in (3, 4, 5):
        write_iteration(export, it)
        assert reg.refresh()
    stop.set()
    t.join()
    assert not bad and reg.model.iteration == 5 and 2 in seen


def test_failed_loads_back_off_and_quarantine(export):
    """An iteration that verifies but fails to load (here: a vocab sidecar
    of the wrong length) is retried, then quarantined, while the last good
    model keeps serving; rewriting its bytes clears the verdict."""
    reg = ModelRegistry(str(export), device="cpu", retry_backoff_s=0.0, quarantine_after=2)
    assert reg.refresh() and reg.model.iteration == 2
    write_iteration(export, 3)
    (export / "gene2vec_dim_16_iter_3.vocab.tsv").write_text("A\t1\nB\t1\n")
    assert not reg.refresh() and not reg.quarantined
    assert not reg.refresh()
    assert list(reg.quarantined) == [str(export / "gene2vec_dim_16_iter_3.npz")]
    assert reg.model.iteration == 2
    (export / "gene2vec_dim_16_iter_3.vocab.tsv").unlink()
    time.sleep(0.01)
    write_iteration(export, 3, seed=5)
    assert reg.refresh() and reg.model.iteration == 3 and not reg.quarantined


# -- the HTTP server -------------------------------------------------------------


class Server:
    def __init__(self, export, mode="exact", poll=None):
        self.registry = ModelRegistry(str(export), device="cpu", index_mode=mode)
        assert self.registry.refresh()
        if poll:
            self.registry.start_watcher(poll)
        self.app = ServeApp(self.registry, ServeConfig(index=mode, cache_size=0,
                                                       max_delay_ms=1.0)).start()
        self.http = make_server(self.app, "127.0.0.1", 0)
        self.url = "http://127.0.0.1:%d" % self.http.server_address[1]
        self.thread = threading.Thread(target=self.http.serve_forever, daemon=True)
        self.thread.start()

    def get(self, path):
        return self._open(urllib.request.Request(self.url + path))

    def post(self, path, doc):
        data = doc if isinstance(doc, bytes) else json.dumps(doc).encode()
        return self._open(urllib.request.Request(self.url + path, data=data, method="POST"))

    @staticmethod
    def _open(req):
        try:
            with urllib.request.urlopen(req, timeout=30) as r:
                body = r.read()
                return r.status, body
        except urllib.error.HTTPError as e:
            return e.code, e.read()

    def close(self):
        self.http.shutdown()
        self.http.server_close()
        self.app.stop()
        self.thread.join(timeout=5)


@pytest.fixture
def server(export):
    s = Server(export)
    yield s
    s.close()


def neighbors(doc):
    return [[(n["gene"], n["score"]) for n in r["neighbors"]] for r in doc["results"]]


def assert_same_neighbors(got, want):
    """Equal gene lists, scores within 1e-6 (rounded to 6 places by both
    servers); a swap of two genes whose scores tie within that is a
    near-tie and allowed.  IVF may return fewer candidates than k: the
    tail is -inf in both."""
    for g_row, w_row in zip(got, want):
        assert len(g_row) == len(w_row)
        for (gg, gs), (wg, ws) in zip(g_row, w_row):
            assert gs == ws or abs(gs - ws) <= 2e-6
            if gg != wg:
                assert dict(w_row).get(gg) is not None and abs(dict(w_row)[gg] - gs) <= 2e-6


@pytest.mark.parametrize("mode", ["exact", "quant", "ivf"])
def test_neighbor_lists_equal_the_jax_server(export, mode):
    srv = Server(export, mode)
    japp = JaxApp(JaxRegistry(str(export), index_mode=mode),
                  config=JaxConfig(index=mode, cache_size=0))
    assert japp.registry.refresh()
    japp.start()
    try:
        rng = np.random.RandomState(0)
        vec = (rng.randn(3, D)).astype(np.float32).tolist()
        for body in ({"genes": ["G0", "G31", "G299"], "k": 10},
                     {"genes": ["G5"], "k": 1}, {"genes": ["G7"], "k": 256},
                     {"vectors": vec, "k": 20}):
            status, raw = srv.post("/v1/similar", body)
            j_status, j_doc = japp.handle("POST", "/v1/similar", body)
            assert status == j_status == 200
            doc = json.loads(raw)
            assert doc["model"] == j_doc["model"] == {"dim": D, "iteration": 2}
            assert [r["query"] for r in doc["results"]] == [r["query"] for r in j_doc["results"]]
            assert_same_neighbors(neighbors(doc), neighbors(j_doc))
        status, raw = srv.get("/v1/similar?gene=G12&k=5")
        _, j_doc = japp.handle("GET", "/v1/similar?gene=G12&k=5", None)
        assert status == 200
        assert_same_neighbors(neighbors(json.loads(raw)), neighbors(j_doc))
        # a gene query never returns itself
        assert "G12" not in [g for g, _ in neighbors(json.loads(raw))[0]]
    finally:
        srv.close()
        japp.stop()


def test_routes_and_errors(server):
    status, raw = server.post("/v1/embedding", {"genes": ["G3", "G4"]})
    doc = json.loads(raw)
    assert status == 200 and [e["gene"] for e in doc["embeddings"]] == ["G3", "G4"]
    np.testing.assert_allclose(doc["embeddings"][0]["vector"], server.registry.model.emb[3])
    status, raw = server.get("/v1/genes?limit=3&offset=10")
    assert status == 200 and json.loads(raw) == {"total": V, "genes": ["G10", "G11", "G12"]}
    status, raw = server.get("/healthz")
    doc = json.loads(raw)
    assert status == 200 and doc["model"]["iteration"] == 2 and doc["index"] == "exact"
    assert doc["device"] == "cpu"
    server.post("/v1/similar", {"genes": ["G1"], "k": 3})
    status, raw = server.get("/metrics")
    text = raw.decode()
    assert status == 200 and 'serve_route_seconds_count{route="/v1/similar"}' in text
    assert 'engine_jit_cache_entries{mode="exact"} 1' in text
    assert "model_iteration 2" in text
    for body, frag in (({"genes": ["nope"]}, "unknown gene"),
                       ({"genes": ["G1"], "k": 0}, "k must be"),
                       ({"genes": ["G1"], "k": 257}, "k must be"),
                       ({"genes": ["G1"], "vectors": [[0.0] * D]}, "exactly one"),
                       ({"vectors": [[0.0] * 3]}, "dim 16"),
                       ({"genes": ["G1"] * 65}, "at most 64")):
        status, raw = server.post("/v1/similar", body)
        assert status == 400 and frag in json.loads(raw)["error"], body
    assert server.post("/v1/similar", b"{not json")[0] == 400
    assert server.post("/v1/embedding", {"genes": ["nope"]})[0] == 400
    assert server.get("/v1/similar?k=3")[0] == 400
    assert server.get("/v1/similar?gene=G1&k=x")[0] == 400
    assert server.get("/v1/genes?limit=-1")[0] == 400
    assert server.get("/v1/nothing")[0] == 404
    # GGIPNN scoring is served (untrained head without a checkpoint)
    status, raw = server.post("/v1/interaction", {"pairs": [["G1", "G2"]]})
    assert status == 200 and json.loads(raw)["trained_head"] is False
    assert server.post("/v1/interaction", {"pairs": [["G1", "nope"]]})[0] == 400


def test_serves_a_new_iteration_once_it_lands(export):
    srv = Server(export, "ivf", poll=0.1)
    try:
        before = json.loads(srv.post("/v1/similar", {"genes": ["G1"], "k": 5})[1])
        assert before["model"]["iteration"] == 2
        emb = write_iteration(export, 3, seed=77)
        deadline = time.monotonic() + 20
        while srv.registry.model.iteration != 3 and time.monotonic() < deadline:
            time.sleep(0.05)
        doc = json.loads(srv.post("/v1/similar", {"genes": ["G1"], "k": 5})[1])
        assert doc["model"]["iteration"] == 3
        unit = emb / np.linalg.norm(emb, axis=1, keepdims=True)
        want = [f"G{i}" for i in np.argsort(-(unit @ unit[1]))[1:6]]
        assert [n["gene"] for n in doc["results"][0]["neighbors"]] == want
        h = json.loads(srv.get("/healthz")[1])
        assert h["model"]["iteration"] == 3 and h["ann"]["mode"] == "ivf"
    finally:
        srv.close()


# -- the copied control-plane pieces against the originals ------------------------


def test_metrics_text_matches_the_reference():
    from gene2vec_tpu.obs.registry import MetricsRegistry as JaxMetrics
    from gene2vec_tpu_torch.obs.registry import MetricsRegistry

    texts = []
    for reg in (JaxMetrics(max_label_sets=3), MetricsRegistry(max_label_sets=3)):
        reg.counter("serve_requests_total").inc(3)
        reg.gauge("model_iteration").set(7)
        h = reg.histogram("serve_route_seconds", buckets=(0.001, 0.01),
                          labels={"route": '/v1/"x"\n'})
        for v in (0.0005, 0.005, 0.5):
            h.observe(v)
        for i in range(5):  # past the label-set cap
            reg.counter("kernel_launches_total", labels={"kernel": f"k{i}"}).inc(i + 1)
        texts.append(reg.prometheus_text())
    assert texts[0] == texts[1]
    assert "metrics_dropped_labels_total 2" in texts[1]


def test_fair_queue_matches_the_reference():
    from gene2vec_tpu.serve.tenancy import FairQueue as JaxQueue
    from gene2vec_tpu_torch.serve.tenancy import FairQueue

    weights = {"a": 3.0, "b": 1.0, "c": 0.5}
    orders = []
    for cls in (JaxQueue, FairQueue):
        q = cls(weight_of=weights.get)
        for i in range(12):
            q.push("abc"[i % 3], i)
        orders.append(q.pop_upto(5) + q.pop_upto(20))
    assert orders[0] == orders[1] and len(orders[1]) == 12


def test_batcher_batches_rejects_and_expires():
    from gene2vec_tpu_torch.obs.registry import MetricsRegistry
    from gene2vec_tpu_torch.serve.batcher import DeadlineExceeded, MicroBatcher, RejectedError

    gate, entered, seen = threading.Event(), threading.Event(), []

    def compute(items, k_max):
        entered.set()
        gate.wait(5)
        seen.append((len(items), k_max))
        return [i * 10 for i in items]

    m = MetricsRegistry()
    b = MicroBatcher(compute, max_batch=4, max_delay_s=0.05, max_queue=6, metrics=m,
                     cache_size=8).start()
    try:
        tickets = [b.submit_async(i, k, cache_key=("q", i)) for i, k in
                   ((1, 3), (2, 5), (3, 1), (4, 2), (5, 1))]
        assert entered.wait(5)  # the worker holds the first batch of 4 at the gate
        tickets += [b.submit_async(i, 1) for i in (6, 7, 8, 9, 10)]
        with pytest.raises(RejectedError):
            b.submit_async(11, 1)
        gate.set()
        assert [t.get() for t in tickets] == [10, 20, 30, 40, 50, 60, 70, 80, 90, 100]
        assert seen[0] == (4, 5)
        assert b.submit(1, 3, cache_key=("q", 1)) == 10  # from the LRU
        assert m.counter("serve_cache_hits_total").value == 1
        gate.clear()
        slow = b.submit_async(99, 1, timeout_s=0.05)
        with pytest.raises(DeadlineExceeded):
            slow.get()
        gate.set()
    finally:
        gate.set()
        b.stop()


def test_spans_reach_an_installed_tracer(tmp_path):
    from gene2vec_tpu_torch.obs import trace
    from gene2vec_tpu_torch.serve.engine import BucketedTopKEngine

    unit = torch.nn.functional.normalize(torch.randn(50, 8), dim=1)
    engine = BucketedTopKEngine(max_batch=4)
    engine.top_k(unit, unit[:2].numpy(), 3)  # buffered: no tracer yet
    tracer = trace.Tracer(str(tmp_path / "events.jsonl"))
    trace.set_tracer(tracer)
    try:
        engine.top_k(unit, unit[:3].numpy(), 3)
    finally:
        trace.set_tracer(None)
        tracer.close()
    events = [json.loads(line) for line in open(tmp_path / "events.jsonl")]
    topk = [e for e in events if e["name"] == "engine_topk" and e["type"] == "span_end"]
    assert len(topk) >= 2 and topk[-1]["attrs"] == {"batch": 4, "k": 4}
