"""The port's multi-model catalog (``serve/catalog.py``, the server's
``/v1/<model>/*`` dispatch, ``serve/autoscale.py:PoolElasticController``
and the supervisor's model pools) against the JAX package's: the cases of
``tests/test_catalog.py`` run through both packages on the same inputs.

Spec parsing, route splitting and ``ModelAdmission`` are pure functions
(the admission on a fake clock); the pool policies and the pool controller
run on scripted scrapes; two catalogs over the same seeded exports, one of
each package, serve in process through ``ServeApp.handle`` and behind the
port's event loop.  A single-model port server keeps its responses and
series: no ``name``, no ``model=`` label, the reference's bytes."""

import json
import time
import urllib.request

import numpy as np
import pytest
import torch

from gene2vec_tpu.serve import autoscale as ref_autoscale
from gene2vec_tpu.serve import catalog as ref_catalog
from gene2vec_tpu.serve import registry as ref_registry
from gene2vec_tpu.serve import routes as ref_routes
from gene2vec_tpu.serve import server as ref_server
from gene2vec_tpu_torch.io.checkpoint import save_iteration
from gene2vec_tpu_torch.io.vocab import Vocab
from gene2vec_tpu_torch.obs.registry import MetricsRegistry
from gene2vec_tpu_torch.serve import autoscale as port_autoscale
from gene2vec_tpu_torch.serve import catalog as port_catalog
from gene2vec_tpu_torch.serve import routes as port_routes
from gene2vec_tpu_torch.serve import server as port_server
from gene2vec_tpu_torch.serve.client import InFlightTracker
from gene2vec_tpu_torch.serve.fleet import FleetConfig, FleetSupervisor, ReplicaState
from gene2vec_tpu_torch.serve.registry import ModelRegistry
from gene2vec_tpu_torch.sgns.model import SGNSParams

PKGS = {"port": port_catalog, "reference": ref_catalog}
#: a served score against the other package's: both are float32 dots
#: rounded to 6 decimals
SCORE_TOL = 1e-6


def _write_export(export_dir, dim, iteration=1, vocab_size=16, seed=0):
    rng = np.random.RandomState(seed + iteration)
    emb = rng.randn(vocab_size, dim).astype(np.float32)
    save_iteration(str(export_dir), dim, iteration,
                   SGNSParams(torch.from_numpy(emb), torch.zeros(vocab_size, dim)),
                   Vocab([f"G{i}" for i in range(vocab_size)],
                         np.arange(vocab_size, 0, -1)),
                   txt_output=False)


def _spec_doc(root, **overrides):
    doc = {
        "schema": "gene2vec-tpu/catalog/v1",
        "default": "alpha",
        "models": {
            "alpha": {"export_dir": str(root / "a"), "dim": 4},
            "beta": {"export_dir": str(root / "b"), "dim": 8},
        },
    }
    doc.update(overrides)
    return doc


# -- spec parsing -------------------------------------------------------------


@pytest.mark.parametrize("pkg", sorted(PKGS))
def test_parse_catalog_spec_round_trip(tmp_path, pkg):
    spec = PKGS[pkg].parse_catalog_spec(_spec_doc(tmp_path))
    assert spec.names == ("alpha", "beta") and spec.default == "alpha"
    assert spec.default_entry.dim == 4
    assert spec.entry("beta").export_dir == str(tmp_path / "b")
    with pytest.raises(KeyError):
        spec.entry("gamma")


def test_parsed_specs_equal_reference(tmp_path):
    doc = _spec_doc(tmp_path)
    doc["models"]["beta"].update({
        "index": "ivf", "rate": 2.5, "burst": 3, "replicas": 2,
        "ggipnn_checkpoint": "head.npz", "extra_args": ["--cache-size", "0"],
        "partition_rules": [["(^|/)(emb|ctx|unit)$", ["model", None]], [".*", []]],
    })
    got = port_catalog.parse_catalog_spec(doc, base_dir=str(tmp_path), path="p")
    want = ref_catalog.parse_catalog_spec(doc, base_dir=str(tmp_path), path="p")
    assert got.default == want.default and got.path == want.path
    for g, w in zip(got.entries, want.entries, strict=True):
        assert vars(g) == vars(w)
    assert port_catalog.RESERVED_MODEL_NAMES == ref_catalog.RESERVED_MODEL_NAMES
    assert port_catalog.CATALOG_SCHEMA == ref_catalog.CATALOG_SCHEMA


@pytest.mark.parametrize("pkg", sorted(PKGS))
def test_parse_catalog_spec_default_falls_back_to_first(tmp_path, pkg):
    doc = _spec_doc(tmp_path)
    del doc["default"]
    assert PKGS[pkg].parse_catalog_spec(doc).default == "alpha"


BAD_DOCS = {
    "empty": ({"models": {}}, None),
    "default_names_none": ("default_nope", None),
    "reserved": ({"models": {"similar": {"export_dir": "/x"}}}, "reserved"),
    "bad_name": ({"models": {"bad name!": {"export_dir": "/x"}}}, "must match"),
    "no_export_dir": ({"models": {"alpha": {}}}, "export_dir"),
    "zero_replicas": ({"models": {"alpha": {"export_dir": "/x", "replicas": 0}}}, "replicas"),
    "negative_rate": ({"models": {"alpha": {"export_dir": "/x", "rate": -1}}}, "rate/burst"),
    "bad_rules": ({"models": {"alpha": {"export_dir": "/x",
                                         "partition_rules": [[".*"]]}}}, "pattern, axes"),
    "cap": ({"models": {f"m{i}": {"export_dir": f"/x/{i}"} for i in range(17)}}, "cap"),
}


@pytest.mark.parametrize("pkg", sorted(PKGS))
@pytest.mark.parametrize("case", sorted(BAD_DOCS))
def test_parse_catalog_spec_rejects_bad_docs(tmp_path, pkg, case):
    doc, match = BAD_DOCS[case]
    if doc == "default_nope":
        doc = _spec_doc(tmp_path, default="nope")
    with pytest.raises(ValueError, match=match):
        PKGS[pkg].parse_catalog_spec(doc)


@pytest.mark.parametrize("pkg", sorted(PKGS))
def test_load_catalog_spec_resolves_relative_paths(tmp_path, pkg):
    p = tmp_path / "catalog.json"
    p.write_text(json.dumps({"default": "alpha",
                             "models": {"alpha": {"export_dir": "exports/a",
                                                  "ggipnn_checkpoint": "h.npz"}}}))
    spec = PKGS[pkg].load_catalog_spec(str(p))
    assert spec.entry("alpha").export_dir == str(tmp_path / "exports" / "a")
    assert spec.entry("alpha").ggipnn_checkpoint == str(tmp_path / "h.npz")


# -- route grammar ------------------------------------------------------------


@pytest.mark.parametrize("path", [
    "/v1/alpha/similar", "/v1/alpha/genes", "/v1/similar", "/healthz", "/v1/shard/topk",
    "/v1/jobs/j123/artifact", "/v1/alpha/jobs", "/v1/alpha/doesnotexist",
    "/v1/alpha/jobs/j1/cancel", "/v1/alpha/interaction",
])
def test_split_model_route_equals_reference(path):
    assert port_routes.split_model_route(path) == ref_routes.split_model_route(path)


def test_model_label_is_bounded_like_reference():
    known = ("alpha", "beta")
    for name in ("alpha", None, "not-in-catalog", "x" * 500):
        assert port_routes.model_label(name, known) == ref_routes.model_label(name, known)
    assert len(port_routes.model_label("x" * 500, known)) <= 64


# -- per-model admission ------------------------------------------------------


def test_model_admission_decisions_equal_reference(tmp_path):
    doc = _spec_doc(tmp_path)
    doc["models"]["alpha"].update({"rate": 1.0, "burst": 2})
    doc["models"]["beta"].update({"rate": 0.5, "burst": 0})
    decisions = {}
    script = [("alpha", 0.0)] * 3 + [("beta", 0.0)] * 3 + [("gamma", 0.0), (None, 0.0),
              ("alpha", 1.0), ("alpha", 0.0), ("beta", 2.0), ("beta", 0.1)]
    for name, mod in PKGS.items():
        now = [100.0]
        adm = mod.ModelAdmission(mod.parse_catalog_spec(doc), clock=lambda: now[0])
        out = []
        for model, dt in script:
            now[0] += dt
            out.append(adm.admit(model))
        decisions[name] = out
    assert decisions["port"] == decisions["reference"]
    assert decisions["port"][:3] == [True, True, False]


# -- (model, shard) autoscale pools -------------------------------------------


AUTOSCALE = {"port": port_autoscale, "reference": ref_autoscale}


def _tick(policy, snapshot, now, current_of):
    snapshot = dict(snapshot)
    snapshot.setdefault("_fresh_targets", 2.0)
    return policy.observe(snapshot, now=now, current_of=current_of)


def _decision(d):
    return (d.action, d.model, d.shard, d.target, d.reason)


def test_pool_policy_scales_only_the_hot_model():
    got = {}
    for name, mod in AUTOSCALE.items():
        cfg = mod.AutoscaleConfig(min_replicas=1, max_replicas=3, up_queue_per_replica=4.0,
                                  up_after_ticks=2, cooldown_s=0.0)
        policy = mod.PoolAutoscalePolicy(cfg, [("alpha", None), ("beta", None)])
        current = {("alpha", None): 1, ("beta", None): 1}
        hot = {"fleet_model_queue_depth{model=alpha}": 40.0,
               "fleet_model_queue_depth{model=beta}": 0.0}
        got[name] = [_decision(_tick(policy, hot, t, current)) for t in (1.0, 2.0, 3.0)]
    assert got["port"] == got["reference"]
    assert got["port"][-1][:4] == ("up", "alpha", None, 2) and "model alpha" in got["port"][-1][4]


def test_pool_policy_hottest_queue_wins_tie():
    got = {}
    for name, mod in AUTOSCALE.items():
        cfg = mod.AutoscaleConfig(min_replicas=1, max_replicas=3, up_queue_per_replica=4.0,
                                  up_after_ticks=1, cooldown_s=0.0)
        policy = mod.PoolAutoscalePolicy(cfg, [("alpha", None), ("beta", None)])
        current = {("alpha", None): 1, ("beta", None): 1}
        both = {"fleet_model_queue_depth{model=alpha}": 10.0,
                "fleet_model_queue_depth{model=beta}": 50.0}
        got[name] = [_decision(_tick(policy, both, t, current)) for t in (1.0, 2.0)]
    assert got["port"] == got["reference"] and got["port"][-1][:2] == ("up", "beta")


@pytest.mark.parametrize("pkg", sorted(AUTOSCALE))
def test_pool_policy_rejects_degenerate_pools(pkg):
    mod = AUTOSCALE[pkg]
    with pytest.raises(ValueError):
        mod.PoolAutoscalePolicy(mod.AutoscaleConfig(), [])
    with pytest.raises(ValueError):
        mod.PoolAutoscalePolicy(mod.AutoscaleConfig(), [("alpha", None), ("alpha", None)])


@pytest.mark.parametrize("pkg", sorted(AUTOSCALE))
def test_shard_policy_is_a_pool_policy_view(pkg):
    policy = AUTOSCALE[pkg].ShardAutoscalePolicy(AUTOSCALE[pkg].AutoscaleConfig(), num_shards=2)
    assert policy.policies[0] is policy.pool_policies[(None, 0)]
    assert policy.policies[1] is policy.pool_policies[(None, 1)]
    d = policy.observe({"_fresh_targets": 2.0, "fleet_shard_queue_depth{shard=1}": 1.0},
                       now=1.0, current_of={0: 1, 1: 1})
    assert d.shard in (0, 1) and d.model is None


class PoolSupervisor:
    """A catalog supervisor's elastic surface over per-model counts."""

    def __init__(self, counts):
        self.counts = dict(counts)
        self.config = FleetConfig(contract_timeout_s=5.0)
        self.calls = []

    def active_count(self, shard=None, model=None):
        if model is None:
            return sum(self.counts.values())
        return self.counts[model]

    def scale_up(self, shard=None, model=None):
        self.calls.append(("scale_up", model))
        self.counts[model] += 1
        return type("R", (), {"url": f"http://{model}-new", "state": ReplicaState.UP,
                              "alive": True, "spawning": False})()

    def pick_drain_victim(self, shard=None, model=None):
        if self.counts[model] < 2:
            return None
        return type("R", (), {"url": f"http://{model}-old", "state": ReplicaState.UP})()

    def begin_drain(self, r):
        self.calls.append(("begin_drain", r.url))

    def finish_drain(self, r):
        self.calls.append(("finish_drain", r.url))
        self.counts[r.url.split("//")[1].split("-")[0]] -= 1


def _wait_idle(ctl, timeout_s=10.0):
    deadline = time.monotonic() + timeout_s
    while ctl._busy and time.monotonic() < deadline:
        time.sleep(0.01)
    assert not ctl._busy


def test_pool_controller_actions_equal_reference_on_scripted_scrapes():
    """The same scrapes drive both packages' pool controllers to the same
    actions: a scale-up into the hot model's pool, then a drain of the
    idle pool's newest member, never a model's last replica; the per-model
    active gauges follow."""
    script = (
        [{"fleet_model_queue_depth{model=alpha}": 0.0,
          "fleet_model_queue_depth{model=beta}": 60.0}] * 4
        + [{"fleet_model_queue_depth{model=alpha}": 0.0,
            "fleet_model_queue_depth{model=beta}": 0.0}] * 6
    )
    got = {}
    for name, mod in AUTOSCALE.items():
        sup = PoolSupervisor({"alpha": 1, "beta": 1})
        metrics = MetricsRegistry()
        cfg = mod.AutoscaleConfig(min_replicas=1, max_replicas=2, up_queue_per_replica=4.0,
                                  up_after_ticks=2, down_after_ticks=3, cooldown_s=0.0)
        ctl = mod.PoolElasticController(
            sup, type("P", (), {"inflight": InFlightTracker()})(), cfg,
            pools=[("alpha", None), ("beta", None)], metrics=metrics,
            drain_timeout_s=1.0)
        ctl.drain_poll_s = 0.001
        for snap in script:
            ctl.observe(dict(snap, _fresh_targets=2.0))
            _wait_idle(ctl)
        ctl.stop()
        got[name] = (sup.calls, dict(sup.counts),
                     metrics.gauge("fleet_model_replicas_active",
                                   labels={"model": "beta"}).value,
                     metrics.counter("fleet_scale_up_total").value,
                     metrics.counter("fleet_scale_down_total").value)
    assert got["port"] == got["reference"]
    assert got["port"][0][0] == ("scale_up", "beta")
    assert ("begin_drain", "http://beta-old") in got["port"][0]


def test_supervisor_model_pools():
    """The supervisor's model grid: slots per model, the model's flags in
    its replicas' argv (export dir, name), per-model URLs and UP counts,
    and pool-scoped capacity and drain victims that never take a model's
    last UP replica."""
    sup = FleetSupervisor(
        "exp", FleetConfig(replicas=3), serve_args=["--device", "cpu"],
        model_of={0: "alpha", 1: "beta", 2: "beta"},
        model_args={"alpha": ["--export-dir", "a", "--model-name", "alpha"],
                    "beta": ["--export-dir", "b", "--model-name", "beta"]})
    assert [r.model for r in sup.replicas] == ["alpha", "beta", "beta"]
    argv = sup._argv(2)
    assert argv[argv.index("--model-name") + 1] == "beta"
    # last-wins: the model's export dir follows the fleet's default
    assert argv[len(argv) - 1 - argv[::-1].index("--export-dir") + 1] == "b"
    for i, r in enumerate(sup.replicas):
        r.url, r.state = f"http://r{i}", ReplicaState.UP
    assert sup.model_urls("beta") == ["http://r1", "http://r2"]
    assert sup.model_up_counts() == {"alpha": 1, "beta": 2}
    assert sup.model_of_url("http://r2/") == "beta" and sup.model_of_url("") is None
    assert sup.active_count(model="beta") == 2 and sup.active_count() == 3
    assert sup.pick_drain_victim(model="alpha") is None
    assert sup.pick_drain_victim(model="beta").index == 2
    assert [s["model"] for s in sup.states()] == ["alpha", "beta", "beta"]


# -- the live two-model catalog ------------------------------------------------


@pytest.fixture(scope="module")
def exports(tmp_path_factory):
    root = tmp_path_factory.mktemp("catalog")
    _write_export(root / "a", dim=4, seed=1)
    _write_export(root / "b", dim=8, seed=2)
    return root


def _build(pkg, root, **spec_overrides):
    mod = PKGS[pkg]
    spec = mod.parse_catalog_spec(_spec_doc(root, **spec_overrides))
    # one metrics registry for every model's app, as cli.serve gives it
    if pkg == "port":
        return mod.ModelCatalog(spec, config=port_server.ServeConfig(
            max_delay_ms=1.0, cache_size=0), metrics=MetricsRegistry(), device="cpu")
    from gene2vec_tpu.obs.registry import MetricsRegistry as RefMetricsRegistry

    return mod.ModelCatalog(spec, config=ref_server.ServeConfig(
        max_delay_ms=1.0, cache_size=0), metrics=RefMetricsRegistry())


@pytest.fixture(scope="module")
def catalogs(exports):
    out = {pkg: _build(pkg, exports).build().start() for pkg in PKGS}
    yield out
    for c in out.values():
        c.stop()


def _same_answer(got, want):
    assert got["model"] == want["model"]
    for g, w in zip(got["results"], want["results"], strict=True):
        gs = [n["score"] for n in g["neighbors"]]
        ws = [n["score"] for n in w["neighbors"]]
        np.testing.assert_allclose(gs, ws, rtol=0, atol=SCORE_TOL)
        for gn, wn in zip(g["neighbors"], w["neighbors"]):
            # ids equal except a near-tie, whose scores agree within the bar
            if gn["gene"] != wn["gene"]:
                assert sum(abs(s - gn["score"]) <= SCORE_TOL for s in ws) >= 2


@pytest.mark.parametrize("path,body", [
    ("/v1/alpha/similar", {"genes": ["G0", "G5"], "k": 3}),
    ("/v1/beta/similar", {"genes": ["G0"], "k": 5}),
    ("/v1/similar", {"genes": ["G3"], "k": 4}),
    ("/v1/beta/similar", {"vectors": [[0.5, -1.0, 0.25, 2.0, 0.0, 1.0, -0.5, 0.75]], "k": 3}),
])
def test_catalog_serves_each_model_by_name_like_reference(catalogs, path, body):
    got = catalogs["port"].default_app.handle("POST", path, dict(body))
    want = catalogs["reference"].default_app.handle("POST", path, dict(body))
    assert got[0] == want[0] == 200
    _same_answer(got[1], want[1])
    name = path.split("/")[2] if path.count("/") == 3 else "alpha"
    assert got[1]["model"]["name"] == name
    assert got[1]["model"]["dim"] == {"alpha": 4, "beta": 8}[name]


def test_catalog_models_answer_differently(catalogs):
    app = catalogs["port"].default_app
    body = {"genes": ["G0"], "k": 3}
    _, alpha = app.handle("POST", "/v1/alpha/similar", body)
    _, beta = app.handle("POST", "/v1/beta/similar", body)
    assert ([n["gene"] for n in alpha["results"][0]["neighbors"]]
            != [n["gene"] for n in beta["results"][0]["neighbors"]])


@pytest.mark.parametrize("method,path,body", [
    ("POST", "/v1/beta/embedding", {"genes": ["G1", "G2"]}),
    ("GET", "/v1/beta/genes?limit=5&offset=3", None),
    ("GET", "/v1/alpha/genes", None),
    ("POST", "/v1/gamma/similar", {"genes": ["G0"], "k": 3}),
    ("POST", "/v1/beta/similar", {"genes": ["NOPE"], "k": 3}),
])
def test_catalog_routes_equal_reference(catalogs, method, path, body):
    got = catalogs["port"].default_app.handle(method, path, body)
    want = catalogs["reference"].default_app.handle(method, path, body)
    assert got[0] == want[0]
    if "embeddings" in want[1]:
        for g, w in zip(got[1]["embeddings"], want[1]["embeddings"], strict=True):
            assert g["gene"] == w["gene"]
            np.testing.assert_array_equal(g["vector"], w["vector"])
        assert got[1]["model"] == want[1]["model"]
    else:
        assert got[1] == want[1]


def test_catalog_healthz_equals_reference(catalogs):
    for name in ("alpha", "beta"):
        got = catalogs["port"].apps[name].healthz()
        want = catalogs["reference"].apps[name].healthz()
        assert got[0] == want[0] == 200
        got, want = dict(got[1]), dict(want[1])
        for doc in (got, want):
            doc.pop("uptime_s")
        assert got.pop("device") == "cpu"
        assert got == want and got["catalog"] == ["alpha", "beta"]
        assert got["model"]["name"] == name


def test_catalog_sibling_dispatch_works_from_any_app(catalogs):
    for pkg in PKGS:
        status, doc = catalogs[pkg].apps["beta"].handle(
            "POST", "/v1/alpha/similar", {"genes": ["G0"], "k": 3})
        assert status == 200 and doc["model"]["name"] == "alpha"


def test_catalog_labels_series_by_model(catalogs):
    """Named apps label their route and batcher series ``{model=}``; the
    failure/quarantine counters of a named registry have their twin."""
    app = catalogs["port"].default_app
    app.handle("POST", "/v1/beta/similar", {"genes": ["G0"], "k": 3})
    text = app.metrics.prometheus_text()
    assert 'serve_route_seconds_count{model="beta",route="/v1/similar"}' in text
    assert 'serve_requests_total{model="beta"}' in text
    assert 'serve_queue_depth{model="alpha"}' in text


@pytest.mark.parametrize("pkg", sorted(PKGS))
def test_catalog_default_must_load(tmp_path, pkg):
    (tmp_path / "a").mkdir()
    _write_export(tmp_path / "b", dim=8, seed=2)
    with pytest.raises(RuntimeError, match="default model"):
        _build(pkg, tmp_path).build()


@pytest.mark.parametrize("pkg", sorted(PKGS))
def test_catalog_non_default_may_start_empty(tmp_path, pkg):
    _write_export(tmp_path / "a", dim=4, seed=1)
    (tmp_path / "b").mkdir()
    catalog = _build(pkg, tmp_path).build().start()
    try:
        app = catalog.default_app
        assert app.handle("POST", "/v1/alpha/similar", {"genes": ["G0"], "k": 3})[0] == 200
        assert app.handle("POST", "/v1/beta/similar", {"genes": ["G0"], "k": 3})[0] == 503
    finally:
        catalog.stop()


def test_catalog_over_http_fast_path(catalogs):
    """Behind the event loop: a model-prefixed GET takes the named app's
    fast path (its cache and labels), an unknown one 404s, and /healthz
    names the catalog."""
    app = catalogs["port"].default_app
    server = port_server.make_server(app, "127.0.0.1", 0)
    import threading

    threading.Thread(target=server.serve_forever, daemon=True).start()
    url = f"http://127.0.0.1:{server.server_address[1]}"
    try:
        with urllib.request.urlopen(url + "/v1/beta/similar?gene=G2&k=3", timeout=30) as r:
            doc = json.loads(r.read())
        want = catalogs["port"].apps["beta"].handle(
            "POST", "/v1/similar", {"genes": ["G2"], "k": 3})[1]
        assert doc == want and doc["model"]["name"] == "beta"
        with pytest.raises(urllib.error.HTTPError) as err:
            urllib.request.urlopen(url + "/v1/gamma/similar?gene=G2&k=3", timeout=30)
        assert err.value.code == 404
        with urllib.request.urlopen(url + "/metrics", timeout=30) as r:
            text = r.read().decode()
        assert 'serve_route_seconds_count{model="beta",route="/v1/similar"}' in text
    finally:
        server.shutdown()
        server.server_close()


# -- single-model serving is unchanged ------------------------------------------


def _series(text):
    return {line.split(" ")[0] for line in text.splitlines()
            if line and not line.startswith("#")}


def test_single_model_responses_and_series_unchanged(exports):
    """A default-named port server answers the reference's single-model
    bytes (no ``name``, no ``catalog``), takes no model prefix, and mints
    no ``model=`` label."""
    port_reg = ModelRegistry(str(exports / "b"), device="cpu")
    ref_reg = ref_registry.ModelRegistry(str(exports / "b"))
    assert port_reg.refresh() and ref_reg.refresh()
    port_app = port_server.ServeApp(port_reg, config=port_server.ServeConfig(
        max_delay_ms=1.0, cache_size=0)).start()
    ref_app = ref_server.ServeApp(ref_reg, config=ref_server.ServeConfig(
        max_delay_ms=1.0, cache_size=0)).start()
    try:
        for method, path, body in (("POST", "/v1/embedding", {"genes": ["G4"]}),
                                   ("GET", "/v1/genes?limit=4", None)):
            got, want = port_app.handle(method, path, body), ref_app.handle(method, path, body)
            assert got[0] == want[0] == 200
            assert json.dumps(got[1]) == json.dumps(want[1])
        status, doc = port_app.handle("POST", "/v1/similar", {"genes": ["G1"], "k": 3})
        assert status == 200 and list(doc) == ["model", "results"]
        assert doc["model"] == {"dim": 8, "iteration": 1}
        status, doc = port_app.handle("POST", "/v1/default/similar", {"genes": ["G1"], "k": 3})
        assert (status, doc) == (404, {"error": "no route POST /v1/default/similar"})
        health = port_app.healthz()[1]
        assert "catalog" not in health and "name" not in health["model"]
        series = _series(port_app.metrics.prometheus_text())
        assert not [s for s in series if "model=" in s]
        assert 'serve_route_seconds_count{route="/v1/similar"}' in series
        assert 'serve_route_seconds_count{route="other"}' in series
        assert "serve_requests_total" in series and "serve_queue_depth" in series
    finally:
        port_app.stop()
        ref_app.stop()


def test_named_replica_answers_its_own_prefix(exports):
    """A catalog fleet's replica is one export under ``--model-name``: its
    own name is an alias of the unprefixed routes (the front door forwards
    ``/v1/<model>/*`` verbatim), over HTTP too, and another name 404s."""
    import threading

    reg = ModelRegistry(str(exports / "b"), device="cpu", name="beta")
    assert reg.refresh()
    app = port_server.ServeApp(reg, config=port_server.ServeConfig(
        max_delay_ms=1.0, cache_size=0), model_name="beta").start()
    server = port_server.make_server(app, "127.0.0.1", 0)
    threading.Thread(target=server.serve_forever, daemon=True).start()
    url = f"http://127.0.0.1:{server.server_address[1]}"
    try:
        with urllib.request.urlopen(url + "/v1/beta/similar?gene=G2&k=3", timeout=30) as r:
            doc = json.loads(r.read())
        assert doc == app.handle("POST", "/v1/similar", {"genes": ["G2"], "k": 3})[1]
        assert doc["model"] == {"dim": 8, "iteration": 1, "name": "beta"}
        assert app.handle("GET", "/v1/alpha/genes", None)[0] == 404
        assert app.healthz()[1]["model"]["name"] == "beta"
        assert 'model_iteration{model="beta"} 1' in app.metrics.prometheus_text()
    finally:
        server.shutdown()
        server.server_close()
        app.stop()
