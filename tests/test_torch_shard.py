"""The port's row shards on the CPU against the JAX package's: the shard
helpers and ``read_npz_rows`` bitwise the reference's, the merge equal to
the reference's in-mesh ``two_stage_topk``, the registry's shard load and
a shard replica's ``/v1/shard/topk`` equal to the reference's on the same
export, the scatter-gather front door (``serve/shardgroup.py``) equal to
the full-table oracle and holding the degraded, 503, mixed-epoch, shared
budget, failover and swap behaviours ``tests/test_shard.py`` pins, the
cross-shard scorer within 1e-6 of the reference's on the same head and
vectors, and real ``cli.fleet`` runs over CPU replicas.

Shard replicas run in process behind real HTTP on module-scoped fixtures;
two tests spawn ``cli.fleet``."""

import json
import os
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

from gene2vec_tpu.io import checkpoint as ref_checkpoint
from gene2vec_tpu.parallel import sharding as ref_sharding
from gene2vec_tpu.serve import registry as ref_registry
from gene2vec_tpu.serve import server as ref_server
from gene2vec_tpu_torch.io import checkpoint as port_checkpoint
from gene2vec_tpu_torch.io.checkpoint import save_iteration
from gene2vec_tpu_torch.io.vocab import Vocab
from gene2vec_tpu_torch.obs.registry import MetricsRegistry
from gene2vec_tpu_torch.parallel import sharding as port_sharding
from gene2vec_tpu_torch.parallel.sharding import merge_shard_topk, shard_of_row, shard_ranges
from gene2vec_tpu_torch.serve.client import RetryPolicy
from gene2vec_tpu_torch.serve.fleet import (
    FleetConfig,
    FleetSupervisor,
    Replica,
    ReplicaState,
    read_contract_line,
)
from gene2vec_tpu_torch.serve.interaction import CrossShardScorer, InteractionScorer
from gene2vec_tpu_torch.serve.registry import ModelRegistry, l2_normalize
from gene2vec_tpu_torch.serve.server import ApiError, ServeApp, ServeConfig, make_server
from gene2vec_tpu_torch.serve.shardgroup import (
    RoutingTable,
    ShardGroup,
    ShardGroupConfig,
    SwapCoordinator,
)
from gene2vec_tpu_torch.sgns.model import SGNSParams

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
V, D = 24, 8
#: a served score against another: both are rounded to 6 decimals from
#: float32 dots whose last bits depend on the batch they ran in
SCORE_TOL = 1.5e-6


def _write_iteration(export_dir, iteration, seed, vocab=V, dim=D):
    rng = np.random.RandomState(seed)
    emb = rng.randn(vocab, dim).astype(np.float32)
    save_iteration(str(export_dir), dim, iteration,
                   SGNSParams(torch.from_numpy(emb), torch.zeros(vocab, dim)),
                   Vocab([f"G{i}" for i in range(vocab)], np.arange(vocab, 0, -1)),
                   txt_output=False)
    return emb


@pytest.fixture
def export_dir(tmp_path):
    d = tmp_path / "exports"
    _write_iteration(d, 1, seed=1)
    return d


def _full(export_dir):
    reg = ModelRegistry(str(export_dir), device="cpu")
    assert reg.refresh()
    return reg.model


# -- the helpers: bitwise the reference's --------------------------------------


@pytest.mark.parametrize("total,n,pad", [(0, 1, False), (7, 3, False), (24, 5, False),
                                         (13, 8, True), (16, 4, True), (3, 5, False)])
def test_shard_ranges_and_owner_equal_reference(total, n, pad):
    got = port_sharding.shard_ranges(total, n, pad_to_multiple=pad)
    assert got == ref_sharding.shard_ranges(total, n, pad_to_multiple=pad)
    for row in range(total):
        assert port_sharding.shard_of_row(row, got) == ref_sharding.shard_of_row(row, got)
    for bad in ((5, 0), (-1, 2)):
        with pytest.raises(ValueError):
            port_sharding.shard_ranges(*bad)
    with pytest.raises(ValueError):
        port_sharding.shard_of_row(total + 100, got)


@pytest.mark.parametrize("seed,k", [(0, 3), (1, 7), (2, 40)])
def test_merge_bitwise_equal_reference_with_ties(seed, k):
    rng = np.random.RandomState(seed)
    parts = []
    base = 0
    for width in (5, 1, 9, 4):
        # scores on a coarse grid: ties across and within parts
        s = -np.sort(-np.round(rng.randn(3, width), 1), axis=1).astype(np.float32)
        parts.append((s, np.arange(base, base + width)[None, :].repeat(3, 0)))
        base += width
    gs, gi = port_sharding.merge_shard_topk(parts + [None], k)
    ws, wi = ref_sharding.merge_shard_topk(parts, k)
    assert gs.tobytes() == ws.tobytes() and np.array_equal(gi, wi)
    with pytest.raises(ValueError):
        port_sharding.merge_shard_topk([], 3)


@pytest.mark.parametrize("vocab,k", [(13, 4), (16, 3), (9, 8)])
def test_merge_equals_reference_two_stage_topk(vocab, k):
    """The merge of shard-local top-k sets equals the reference's in-mesh
    ``two_stage_topk`` (8 CPU devices) bit for bit, pad shards and k past
    a shard's rows included; the local sets are the reference engine's."""
    import jax
    import jax.numpy as jnp

    from gene2vec_tpu.config import MeshConfig
    from gene2vec_tpu.parallel.mesh import make_mesh
    from gene2vec_tpu.serve.engine import SimilarityEngine

    p = 8
    rng = np.random.RandomState(vocab * 100 + k)
    unit = l2_normalize(rng.randn(vocab, D).astype(np.float32))
    queries = rng.randn(3, D).astype(np.float32)
    pad = (-vocab) % p
    padded = np.concatenate([unit, np.zeros((pad, D), np.float32)]) if pad else unit
    mesh = make_mesh(MeshConfig(data=1, model=p))
    unit_dev = jax.device_put(jnp.asarray(padded), ref_sharding.row_sharding(mesh))
    ref_scores, ref_idx = SimilarityEngine(max_batch=4, mesh=mesh).top_k(
        unit_dev, queries, k, valid=vocab)
    local = SimilarityEngine(max_batch=4)
    parts = []
    for start, end in shard_ranges(padded.shape[0], p, pad_to_multiple=True):
        valid = max(0, min(vocab, end) - start)
        s, i = local.top_k(jnp.asarray(padded[start:end]), queries, min(k, end - start),
                           valid=valid or None)
        if valid == 0:
            s = np.full_like(s, -np.inf)
        parts.append((s, i.astype(np.int64) + start))
    got_scores, got_idx = merge_shard_topk(parts, k)
    assert got_scores.tobytes() == np.asarray(ref_scores).tobytes()
    np.testing.assert_array_equal(got_idx, ref_idx)


@pytest.mark.parametrize("writer", ["port", "reference"])
def test_read_npz_rows_bitwise_reference(tmp_path, writer):
    if writer == "port":
        emb = _write_iteration(tmp_path, 1, seed=4, vocab=37, dim=5)
    else:
        import jax.numpy as jnp

        from gene2vec_tpu.io.vocab import Vocab as RefVocab
        from gene2vec_tpu.sgns.model import SGNSParams as RefParams

        emb = np.random.RandomState(4).randn(37, 5).astype(np.float32)
        ref_checkpoint.save_iteration(
            str(tmp_path), 5, 1, RefParams(jnp.asarray(emb), jnp.zeros((37, 5))),
            RefVocab([f"G{i}" for i in range(37)], np.arange(37, 0, -1)))
    path = str(tmp_path / "gene2vec_dim_5_iter_1.npz")
    for start, end in ((0, 0), (5, 17), (35, 50), (0, 37), (-3, 2)):
        got, total = port_checkpoint.read_npz_rows(path, "emb", start, end)
        want, ref_total = ref_checkpoint.read_npz_rows(path, "emb", start, end)
        assert total == ref_total == 37
        assert got.dtype == want.dtype and got.tobytes() == want.tobytes()
    np.testing.assert_array_equal(port_checkpoint.read_npz_rows(path, "emb", 5, 17)[0],
                                  emb[5:17])
    comp = str(tmp_path / "comp.npz")
    np.savez_compressed(comp, emb=emb)
    for args in ((path, "nope", 0, 1), (comp, "emb", 0, 2)):
        with pytest.raises(ValueError):
            port_checkpoint.read_npz_rows(*args)


# -- the registry's shard load -------------------------------------------------


@pytest.mark.parametrize("shard", [(0, 3), (1, 3), (2, 3), (1, 2)])
def test_registry_shard_load_equals_reference(export_dir, shard):
    port = ModelRegistry(str(export_dir), shard=shard, device="cpu")
    ref = ref_registry.ModelRegistry(str(export_dir), shard=shard)
    assert port.refresh() and ref.refresh()
    pm, rm = port.model, ref.model
    assert (pm.row_base, pm.total_rows, pm.epoch, pm.tokens) == \
        (rm.row_base, rm.total_rows, rm.epoch, rm.tokens)
    assert pm.emb.tobytes() == np.asarray(rm.emb).tobytes()
    assert tuple(pm.unit.shape) == (len(pm), D)  # only the slice is placed
    start, end = shard_ranges(V, shard[1])[shard[0]]
    assert pm.index[f"G{start}"] == 0 and "G99" not in pm.index
    if start > 0:
        assert "G0" not in pm.index


def test_registry_shard_validation_and_w2v_fallback(export_dir, tmp_path):
    for bad in ((3, 3), (0, 0)):
        with pytest.raises(ValueError):
            ModelRegistry(str(export_dir), shard=bad, device="cpu")
    # a text-only export: the full load, then the slice
    from gene2vec_tpu_torch.io.emb_io import write_word2vec_format

    emb = np.random.RandomState(2).randn(10, 4).astype(np.float32)
    d = tmp_path / "w2v"
    d.mkdir()
    write_word2vec_format(str(d / "gene2vec_dim_4_iter_1_w2v.txt"),
                          [f"T{i}" for i in range(10)], emb)
    reg = ModelRegistry(str(d), shard=(1, 2), device="cpu", dim=4)
    assert reg.refresh()
    assert reg.model.row_base == 5 and reg.model.tokens[0] == "T5"
    np.testing.assert_allclose(reg.model.emb, emb[5:], rtol=1e-6)


def test_registry_shard_ivf_index_over_the_slice(export_dir):
    reg = ModelRegistry(str(export_dir), shard=(1, 2), index_mode="ivf", ann_clusters=3,
                        device="cpu")
    assert reg.refresh()
    lists = reg.model.ann.lists
    assert int(lists.max()) < len(reg.model)  # local rows only
    assert any("shard1of2" in f for f in os.listdir(export_dir / "ann_cache"))


def test_stage_then_flip_is_atomic(export_dir):
    reg = ModelRegistry(str(export_dir), shard=(0, 2), device="cpu")
    assert reg.refresh() and reg.model.iteration == 1
    _write_iteration(export_dir, 2, seed=2)
    assert reg.stage(D, 2).iteration == 2 and reg.model.iteration == 1
    with pytest.raises(RuntimeError):
        reg.flip(3)
    m = reg.flip(2)
    assert (m.iteration, m.epoch, reg.flip(2).epoch) == (2, 2, 2)
    with pytest.raises(FileNotFoundError):
        reg.stage(D, 9)


# -- the replica's shard plane against the reference's ---------------------------


@pytest.fixture(scope="module")
def module_export(tmp_path_factory):
    d = tmp_path_factory.mktemp("shard_export")
    _write_iteration(d, 1, seed=1)
    return d


@pytest.fixture(scope="module")
def shard_apps(module_export):
    """Two port shard replicas over one export, in process."""
    apps = []
    for i in range(2):
        reg = ModelRegistry(str(module_export), shard=(i, 2), device="cpu")
        assert reg.refresh()
        apps.append(ServeApp(reg, config=ServeConfig(max_delay_ms=1.0)).start())
    yield apps
    for app in apps:
        app.stop()


def _same_topk(got, want):
    """Rows equal except near-ties (scores within SCORE_TOL), every score
    within SCORE_TOL."""
    for g, w in zip(got["results"], want["results"]):
        assert len(g["rows"]) == len(w["rows"])
        for gr, gs, wr, ws in zip(g["rows"], g["scores"], w["rows"], w["scores"]):
            assert abs(gs - ws) <= SCORE_TOL
            assert gr == wr or abs(gs - ws) <= SCORE_TOL


@pytest.mark.parametrize("index", ["exact", "ivf"])
def test_shard_topk_equals_reference_replica(module_export, index):
    rng = np.random.RandomState(3)
    queries = [list(map(float, q)) for q in rng.randn(5, D)]
    for i in range(2):
        port = ServeApp(ModelRegistry(str(module_export), shard=(i, 2), device="cpu",
                                      index_mode=index, ann_clusters=3),
                        config=ServeConfig(index=index, nprobe=3))
        ref = ref_server.ServeApp(ref_registry.ModelRegistry(
            str(module_export), shard=(i, 2), index_mode=index, ann_clusters=3),
            config=ref_server.ServeConfig(index=index, nprobe=3))
        assert port.registry.refresh() and ref.registry.refresh()
        for body in ({"vectors": queries, "k": 5}, {"vectors": queries[:1], "k": 257},
                     {"genes": [f"G{shard_ranges(V, 2)[i][0]}"], "k": 3}):
            got, want = port.shard_topk(body), ref.shard_topk(body)
            assert got["shard"] == want["shard"]
            _same_topk(got, want)
            for r in got["results"]:
                assert r["tokens"] == [f"G{row}" for row in r["rows"]]
        assert port.healthz()[1]["shard"] == ref.healthz()[1]["shard"]


def test_shard_plane_errors(shard_apps, module_export):
    app = shard_apps[0]
    cur = app.registry.model.epoch
    cases = [({"vectors": [[0.0] * D], "k": 2, "epoch": cur + 1}, 409),
             ({"vectors": [[0.0] * D], "k": app.config.max_k + 2}, 400),
             ({"genes": [f"G{V - 1}"], "k": 2}, 400), ({"k": 2}, 400)]
    for body, status in cases:
        with pytest.raises(ApiError) as e:
            app.shard_topk(body)
        assert e.value.status == status
    start, end = shard_ranges(V, 2)[0]
    full = _full(module_export)
    doc = app.shard_vectors({"genes": [f"G{start}"]})
    np.testing.assert_allclose(doc["vectors"][0], full.emb[start], rtol=1e-6)
    with pytest.raises(ApiError) as e:
        app.shard_vectors({"genes": [f"G{end}"]})
    assert e.value.status == 400
    assert app.handle("POST", "/v1/shard/stage", {"dim": "x"})[0] == 400
    assert app.handle("POST", "/v1/shard/flip", {"epoch": 99})[0] == 409
    unsharded = ServeApp(ModelRegistry(str(module_export), device="cpu"))
    assert unsharded.registry.refresh()
    for route in ("topk", "vectors", "stage", "flip"):
        assert unsharded.handle("POST", f"/v1/shard/{route}", {})[0] == 404
    assert "shard" not in unsharded.healthz()[1]


# -- the front door's scatter-gather ----------------------------------------------


def _serve(app):
    srv = make_server(app, "127.0.0.1", 0)
    threading.Thread(target=srv.serve_forever, daemon=True).start()
    host, port = srv.server_address[:2]
    return srv, f"http://{host}:{port}"


def _group(export_dir, urls_of, n=2, metrics=None, **kw):
    routing = RoutingTable(str(export_dir), n)
    assert routing.reload()
    group = ShardGroup(
        ShardGroupConfig(num_shards=n, shard_deadline_s=kw.pop("deadline", 2.0),
                         default_timeout_s=5.0),
        urls_of, metrics=metrics if metrics is not None else MetricsRegistry(),
        policy=kw.pop("policy", RetryPolicy(max_attempts=2, connect_timeout_s=0.5,
                                            default_timeout_s=2.0, backoff_base_s=0.0)),
        routing=routing, **kw)
    group.current_epoch = 1
    return group


@pytest.fixture
def shard_fleet(export_dir):
    """2 shards x 2 replicas, in process behind HTTP, and a ShardGroup whose
    shard lists are the live siblings."""
    apps, servers, urls = [], [], {}
    for shard in range(2):
        for _ in range(2):
            reg = ModelRegistry(str(export_dir), shard=(shard, 2), device="cpu")
            assert reg.refresh()
            app = ServeApp(reg, config=ServeConfig(max_delay_ms=1.0)).start()
            srv, url = _serve(app)
            apps.append(app)
            servers.append(srv)
            urls.setdefault(shard, []).append(url)
    alive = {(s, r): True for s in range(2) for r in range(2)}
    metrics = MetricsRegistry()
    group = _group(export_dir, lambda i: [urls[i][r] for r in range(2) if alive[(i, r)]],
                   metrics=metrics)
    yield group, alive, metrics, apps
    for app in apps:
        app.stop()
    for srv in servers:
        srv.shutdown()
        srv.server_close()


def _oracle(export_dir, q, k, rows=None, exclude=None):
    m = _full(export_dir)
    unit = l2_normalize(m.emb)
    cols = np.arange(V) if rows is None else np.asarray(rows)
    order = np.argsort(-(unit[cols] @ l2_normalize(np.asarray([q], np.float32))[0]),
                       kind="stable")
    toks = [m.tokens[cols[j]] for j in order if m.tokens[cols[j]] != exclude]
    return toks[:k]


def test_scatter_equals_full_table_oracle(shard_fleet, export_dir):
    group, _, metrics, _ = shard_fleet
    m = _full(export_dir)
    for gene in ("G3", "G20"):
        status, doc = group.similar({"genes": [gene], "k": 4})
        assert status == 200 and doc["degraded"] is False
        assert doc["shards"] == {"total": 2, "answered": 2, "indexes": [0, 1], "epoch": 1}
        got = [n["gene"] for n in doc["results"][0]["neighbors"]]
        assert got == _oracle(export_dir, m.emb[m.index[gene]], 4, exclude=gene)
    q = list(map(float, m.emb[5]))
    status, doc = group.similar({"vectors": [q], "k": 3})
    assert [n["gene"] for n in doc["results"][0]["neighbors"]] == _oracle(export_dir, q, 3)
    status, doc = group.similar({"genes": ["G3"], "k": group.config.max_k})
    assert status == 200 and len(doc["results"][0]["neighbors"]) == V - 1
    for bad in ({"k": 2}, {"genes": [], "k": 2}, {"genes": ["G1"], "k": 0},
                {"genes": ["NOPE"], "k": 2}, {"genes": ["G1"], "vectors": [[0.0]], "k": 2}):
        assert group.similar(bad)[0] == 400
    assert metrics.counter("fleet_degraded_responses_total").value == 0


def test_sibling_death_invisible_group_death_degraded_all_dead_503(shard_fleet, export_dir):
    group, alive, metrics, _ = shard_fleet
    m = _full(export_dir)
    alive[(1, 0)] = False
    status, doc = group.similar({"genes": ["G3"], "k": 4})
    assert status == 200 and doc["degraded"] is False and doc["shards"]["answered"] == 2
    alive[(1, 1)] = False
    q = list(map(float, m.emb[2]))
    status, doc = group.similar({"vectors": [q], "k": 4})
    assert status == 200 and doc["degraded"] is True and doc["shards"]["indexes"] == [0]
    start, end = shard_ranges(V, 2)[0]
    assert [n["gene"] for n in doc["results"][0]["neighbors"]] == \
        _oracle(export_dir, q, 4, rows=range(start, end))
    # a gene owned by the dead group: warm in the cache answers, cold is degraded
    status, doc = group.similar({"genes": ["G20"], "k": 3})
    assert status == 200 and doc["degraded"] and doc["results"][0]["neighbors"] == []
    assert metrics.counter("fleet_qvec_unresolved_total").value == 1
    assert group.embedding({"genes": ["G20"]})[0] == 503
    alive[(0, 0)] = alive[(0, 1)] = False
    status, doc = group.similar({"vectors": [q], "k": 2})
    assert status == 503 and doc["shards"]["answered"] == 0


def test_gene_on_dead_owner_answers_from_cache(shard_fleet):
    group, alive, _, _ = shard_fleet
    gene = f"G{shard_ranges(V, 2)[1][0]}"
    assert group.similar({"genes": [gene], "k": 3})[1]["degraded"] is False
    alive[(1, 0)] = alive[(1, 1)] = False
    status, doc = group.similar({"genes": [gene], "k": 3})
    assert status == 200 and doc["degraded"] is True and doc["results"][0]["neighbors"]


def test_embedding_routes_to_owner(shard_fleet, export_dir):
    group, _, _, _ = shard_fleet
    m = _full(export_dir)
    status, doc = group.embedding({"genes": ["G1", "G20"]})
    assert status == 200
    np.testing.assert_allclose(doc["embeddings"][1]["vector"], m.emb[20], rtol=1e-6)
    assert group.embedding({"genes": ["NOPE"]})[0] == 400


def test_mixed_epoch_rescatters_once_then_majority(export_dir):
    """Three shards, one flipped to iteration 2 on its own: the gather
    re-scatters once and merges the two-shard majority epoch, degraded."""
    apps, servers, urls = [], [], []
    for i in range(3):
        reg = ModelRegistry(str(export_dir), shard=(i, 3), device="cpu")
        assert reg.refresh()
        app = ServeApp(reg, config=ServeConfig(max_delay_ms=1.0)).start()
        srv, url = _serve(app)
        apps.append(app)
        servers.append(srv)
        urls.append(url)
    try:
        metrics = MetricsRegistry()
        group = _group(export_dir, lambda i: urls[i], n=3, metrics=metrics)
        _write_iteration(export_dir, 2, seed=2)
        apps[2].registry.stage(D, 2)
        apps[2].registry.flip(2)
        q = list(map(float, _full(export_dir).emb[0]))
        status, doc = group.similar({"vectors": [q], "k": 3})
        assert status == 200 and doc["degraded"] is True
        assert doc["shards"]["epoch"] == 1 and doc["shards"]["indexes"] == [0, 1]
        assert metrics.counter("fleet_mixed_epoch_rescatter_total").value == 1
    finally:
        for app in apps:
            app.stop()
        for srv in servers:
            srv.shutdown()
            srv.server_close()


def test_drop_malformed_legs_degrades_visibly(export_dir):
    metrics = MetricsRegistry()
    group = _group(export_dir, lambda i: None, metrics=metrics)
    good = {"shard": {"epoch": 1},
            "results": [{"rows": [1, 2], "scores": [0.9, 0.8], "tokens": ["G1", "G2"]}]}
    assert list(group._drop_malformed({0: good, 1: {"results": []}}, 1)) == [0]
    assert group._drop_malformed({0: {"results": [{"rows": [1], "scores": []}]}}, 1) == {}
    assert metrics.counter("fleet_shard_malformed_total").value == 2


def _topk_doc(rows, scores, tokens, epoch=1):
    return {"shard": {"index": 0, "num_shards": 1, "epoch": epoch, "iteration": epoch},
            "results": [{"rows": rows, "scores": scores, "tokens": tokens}]}


def test_scatter_leg_fails_over_and_shares_one_budget(export_dir):
    calls = []

    def transport(base_url, method, path, body, ct, rt, headers=None):
        calls.append(base_url)
        if "dead" in base_url:
            raise ConnectionRefusedError("sibling died")
        return 200, json.dumps(_topk_doc([1, 2], [0.9, 0.8], ["G1", "G2"])).encode()

    group = _group(export_dir, lambda i: ["http://dead:1", "http://live:1"], n=1,
                   transport=transport)
    status, doc = group.similar({"vectors": [[0.0] * D], "k": 2})
    assert status == 200 and doc["degraded"] is False
    assert calls == ["http://dead:1", "http://live:1"]
    # every shard's retries draw one bucket: a dead fleet cannot multiply them
    group = _group(export_dir, lambda i: "http://127.0.0.1:9", deadline=0.2,
                   policy=RetryPolicy(max_attempts=3, connect_timeout_s=0.2,
                                      default_timeout_s=0.2, retry_budget_ratio=0.0,
                                      retry_budget_burst=1.0))
    assert group.client(0).budget is group.client(1).budget
    for _ in range(2):
        group.similar({"vectors": [[0.0] * D], "k": 2})
    assert sum(group.client(i).stats["retries"] for i in range(2)) <= 1


def test_swap_stages_flips_defers_and_repairs(shard_fleet, export_dir):
    group, alive, metrics, apps = shard_fleet
    coord = SwapCoordinator(str(export_dir), group, interval_s=0.1, metrics=metrics)
    coord.tick()
    assert group.current_epoch == 1
    alive[(1, 0)] = alive[(1, 1)] = False  # a whole group down: deferred
    _write_iteration(export_dir, 2, seed=2)
    coord.tick()
    assert group.current_epoch == 1 and metrics.counter("fleet_swap_deferred_total").value == 1
    alive[(1, 0)] = True  # one sibling back: the swap goes, the other waits
    coord.tick()
    assert group.current_epoch == 2
    assert [a.registry.model.epoch for a in apps] == [2, 2, 2, 1]
    alive[(1, 1)] = True
    coord.tick()  # the repair pass converges the returned cell
    assert [a.registry.model.epoch for a in apps] == [2, 2, 2, 2]
    assert metrics.counter("fleet_swap_repairs_total").value == 1
    status, doc = group.similar({"genes": ["G0"], "k": 2})
    assert status == 200 and not doc["degraded"] and doc["model"]["iteration"] == 2
    states = group.shard_states()
    assert [s["epoch"] for s in states] == [2, 2]
    assert states[0]["rows"] == list(shard_ranges(V, 2)[0])


def test_routing_table_from_manifest_and_atomic_snapshot(export_dir):
    rt = RoutingTable(str(export_dir), 3)
    assert rt.reload()
    assert rt.total_rows == V and rt.dim == D and rt.iteration == 1
    ranges = shard_ranges(V, 3)
    for row, tok in enumerate(rt.tokens):
        assert rt.owner(tok) == shard_of_row(row, ranges)
    assert rt.owner("NOPE") is None
    assert rt.genes_doc(limit=5, offset=2) == {"total": V, "genes": list(rt.tokens[2:7])}
    snap = rt._snap
    assert snap.index is rt.index and snap.ranges is rt.ranges
    _write_iteration(export_dir, 2, seed=2)
    assert rt.reload() and rt.iteration == 2 and rt._snap is not snap


# -- the supervisor's (shard, replica) grid ----------------------------------------


def _grid_supervisor(export_dir, n_shards=2, rps=2):
    total = n_shards * rps
    return FleetSupervisor(
        str(export_dir), config=FleetConfig(replicas=total), serve_args=["--cache-size", "0"],
        replica_args={3: ["--faults"]}, shard_of={i: i // rps for i in range(total)},
        shard_args={s: ["--shard-index", str(s), "--num-shards", str(n_shards)]
                    for s in range(n_shards)})


def test_grid_slots_urls_and_redundancy_facts(export_dir):
    sup = _grid_supervisor(export_dir)
    assert [r.shard for r in sup.replicas] == [0, 0, 1, 1]
    argv3 = sup._argv(3)
    i = argv3.index("--shard-index")
    assert argv3[i:i + 4] == ["--shard-index", "1", "--num-shards", "2"]
    assert argv3[-1] == "--faults" and "gene2vec_tpu_torch.cli.serve" in argv3
    for r, (url, state) in zip(sup.replicas, [("http://a", ReplicaState.UP),
                                              ("http://b", ReplicaState.UP),
                                              ("http://c", ReplicaState.UP),
                                              ("http://d", ReplicaState.BACKOFF)]):
        r.url, r.state = url, state
    assert sup.shard_urls(0) == ["http://a", "http://b"] and sup.shard_urls(1) == ["http://c"]
    assert sup.shard_up_counts() == {0: 2, 1: 1}
    assert sup.active_count() == 4 and sup.active_count(shard=1) == 2
    assert [s["shard"] for s in sup.states()] == [0, 0, 1, 1]
    assert sup.shard_of_url("http://c/") == 1 and sup.shard_of_url("http://x") is None
    assert sup.shard_redundancy_facts() == {0: {"up": 2, "desired": 2},
                                            1: {"up": 1, "desired": 2}}
    sup.replicas[1].state = ReplicaState.DRAINING  # a scale-down leaves the promise
    assert sup.shard_redundancy_facts()[0] == {"up": 1, "desired": 1}
    sup.replicas[3].state = ReplicaState.FAILED  # an involuntary loss keeps it
    assert sup.shard_redundancy_facts()[1] == {"up": 1, "desired": 2}
    new = Replica(4, shard=1)
    sup.replicas.append(new)
    assert sup.shard_redundancy_facts()[1] == {"up": 1, "desired": 2}
    new.restarts = 1
    assert sup.shard_redundancy_facts()[1] == {"up": 1, "desired": 3}


def test_grid_drain_victim_and_scale_up_are_shard_scoped(export_dir):
    sup = _grid_supervisor(export_dir)
    for r in sup.replicas:
        r.url, r.state = f"http://r{r.index}", ReplicaState.UP
    v = sup.pick_drain_victim(shard=0)
    assert v is not None and v.index == 1 and v.shard == 0
    sup.replicas[1].state = ReplicaState.DRAINING
    assert sup.pick_drain_victim(shard=0) is None  # the shard's last UP replica
    sup.replicas[3].state = ReplicaState.BACKOFF
    assert sup.pick_drain_victim(shard=1).index == 3  # a dead sibling first
    sup.replicas[3].state = ReplicaState.UP

    def fake_spawn(replica):
        replica.url, replica.state = f"http://new{replica.index}", ReplicaState.STARTING

    sup._spawn = fake_spawn
    replica = sup.scale_up(shard=1)
    assert replica.shard == 1 and replica.index == 4
    assert sup._argv(4)[sup._argv(4).index("--shard-index") + 1] == "1"
    assert sup.active_count(shard=1) == 3
    replica.state = ReplicaState.UP
    assert sup.shard_urls(1) == ["http://r2", "http://r3", "http://new4"]


# -- cross-shard /v1/interaction ---------------------------------------------------


def _head_checkpoint(path, m):
    """A GGIPNN head in the checkpoint layout both packages read, from the
    port's own init (no JAX compile): both packages' scorers load the
    same weights."""
    from gene2vec_tpu_torch.models.ggipnn import GGIPNN

    net = GGIPNN(len(m.tokens), m.dim)
    net.reset_parameters(torch.Generator().manual_seed(7))
    np.savez(str(path), **net.to_flat())
    return str(path)


def test_cross_shard_scorer_within_1e6_of_reference(tmp_path, export_dir):
    from gene2vec_tpu.serve.interaction import CrossShardScorer as RefScorer

    m = _full(export_dir)
    ckpt = _head_checkpoint(tmp_path / "head.npz", m)
    rng = np.random.RandomState(9)
    vec_pairs = [(m.emb[a], m.emb[b]) for a, b in rng.randint(0, V, (11, 2))]
    port = CrossShardScorer(D, checkpoint_path=ckpt, max_pairs=8, batch_size=8, device="cpu")
    ref = RefScorer(D, checkpoint_path=ckpt, max_pairs=8, batch_size=8)
    assert port.trained and ref.trained
    for chunk in (vec_pairs[:8], vec_pairs[8:], vec_pairs[:1]):
        np.testing.assert_allclose(port.score_vectors(chunk), ref.score_vectors(chunk),
                                   rtol=0, atol=1e-6)
    # the port's single-replica scorer over the full table, the same head
    pairs = [("G0", "G23"), ("G5", "G12"), ("G7", "G7")]
    want = InteractionScorer(m, checkpoint_path=ckpt, batch_size=8, device="cpu").score(pairs)
    got = port.score_vectors([(m.emb[m.index[a]], m.emb[m.index[b]]) for a, b in pairs])
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)
    assert not CrossShardScorer(D, device="cpu").trained
    assert port.score_vectors([]) == []
    with pytest.raises(ValueError):
        port.score_vectors(vec_pairs[:9])
    with pytest.raises(ValueError):
        CrossShardScorer(D + 1, checkpoint_path=ckpt, device="cpu")


def test_group_interaction_over_live_shards(shard_fleet, tmp_path, export_dir):
    group, alive, metrics, _ = shard_fleet
    m = _full(export_dir)
    group.ggipnn_checkpoint = _head_checkpoint(tmp_path / "head.npz", m)
    group.scorer_device = "cpu"
    pairs = [["G1", "G20"], ["G0", "G3"], ["G22", "G23"]]
    status, doc = group.interaction({"pairs": pairs})
    assert status == 200 and doc["trained_head"] is True and doc["degraded"] is False
    want = InteractionScorer(m, checkpoint_path=group.ggipnn_checkpoint,
                             device="cpu").score([tuple(p) for p in pairs])
    np.testing.assert_allclose([s["score"] for s in doc["scores"]], want, rtol=0, atol=1e-6)
    assert metrics.counter("fleet_interaction_pairs_total").value == 3
    for bad in ({}, {"pairs": []}, {"pairs": [["G1"]]}, {"pairs": [[["G1"], "G2"]]},
                {"pairs": [["G1", 7]]}):
        assert group.interaction(bad)[0] == 400
    status, doc = group.interaction({"pairs": [["G1", "NOPE"]]})
    assert status == 400 and "NOPE" in doc["error"]
    alive[(1, 0)] = alive[(1, 1)] = False  # G21 is cold: G20 sits in the vector cache
    status, doc = group.interaction({"pairs": [["G2", "G21"], ["G0", "G3"]]})
    assert status == 200 and doc["degraded"] is True
    assert doc["scores"][0]["score"] is None and isinstance(doc["scores"][1]["score"], float)
    alive[(0, 0)] = alive[(0, 1)] = False
    assert group.interaction({"pairs": [["G4", "G21"]]})[0] == 503


# -- real fleets over CPU replicas --------------------------------------------------


def _one_core():
    """The spawned fleet and its replicas (which inherit it) on one CPU:
    the test suite's other workers keep the rest."""
    os.sched_setaffinity(0, {max(os.sched_getaffinity(0))})


def _spawn_fleet(module, export, tmp, *extra, timeout_s=240.0):
    env = dict(os.environ, OMP_NUM_THREADS="1", PYTHONPATH=REPO, JAX_PLATFORMS="cpu")
    err_path = os.path.join(tmp, f"{module.split('.')[0]}_fleet.err")
    err = open(err_path, "w")
    proc = subprocess.Popen(
        [sys.executable, "-m", module, "--export-dir", str(export), "--port", "0",
         "--run-dir", os.path.join(tmp, module.split(".")[0] + "_run"), *extra],
        stdout=subprocess.PIPE, stderr=err, text=True, env=env, cwd=REPO,
        preexec_fn=_one_core)
    err.close()
    try:
        return proc, read_contract_line(proc, timeout_s)
    except Exception:
        proc.kill()
        proc.wait(timeout=30)
        with open(err_path) as f:
            raise AssertionError(f.read()[-3000:])


def _stop(proc):
    proc.send_signal(signal.SIGTERM)
    try:
        proc.wait(timeout=60)
    except subprocess.TimeoutExpired:
        proc.kill()
        proc.wait(timeout=30)


def _post(url, body):
    req = urllib.request.Request(url, data=json.dumps(body).encode(),
                                 headers={"Content-Type": "application/json"})
    try:
        with urllib.request.urlopen(req, timeout=150.0) as r:
            return r.status, json.loads(r.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


def test_unsharded_fleet_checkpoint_is_not_passed_to_replicas(tmp_path, export_dir):
    """``--ggipnn-checkpoint`` in an unsharded fleet is only checked: the
    reference's replicas and the port's answer ``trained_head`` false
    alike (a head reaches them through ``--serve-arg``)."""
    ckpt = _head_checkpoint(tmp_path / "head.npz", _full(export_dir))
    heads = {}
    for module, extra in (("gene2vec_tpu_torch.cli.fleet",
                           ("--serve-arg=--device", "--serve-arg=cpu")),
                          ("gene2vec_tpu.cli.fleet", ())):
        proc, info = _spawn_fleet(module, export_dir, str(tmp_path), "--replicas", "1",
                                  "--ggipnn-checkpoint", ckpt, "--alert-rules", "none",
                                  "--scrape-interval", "0", "--proxy-timeout-ms", "120000",
                                  *extra)
        try:
            # the reference replica compiles its scorer at the first pair
            status, doc = _post(info["url"] + "/v1/interaction",
                                {"pairs": [["G1", "G2"]], "timeout_ms": 120000})
            assert status == 200, doc
            heads[module] = doc["trained_head"]
        finally:
            _stop(proc)
    assert heads == {"gene2vec_tpu_torch.cli.fleet": False, "gene2vec_tpu.cli.fleet": False}
    res = subprocess.run([sys.executable, "-m", "gene2vec_tpu_torch.cli.fleet", "--export-dir",
                          str(export_dir), "--ggipnn-checkpoint", str(tmp_path / "missing.npz")],
                         capture_output=True, text=True, timeout=60, cwd=REPO)
    assert res.returncode == 2 and "does not exist" in res.stderr


def test_sharded_fleet_scatter_interaction_and_kill(tmp_path):
    """``cli.fleet --shard-by-rows 2`` over CPU replicas, with the autoscale
    flags on: the contract's shards block, scatter answers equal to the
    full-table oracle, the front door's cross-shard ``/v1/interaction``
    within 1e-6 of the port's single-replica scorer, a SIGKILLed shard
    degrading answers until the supervisor restarts it."""
    export = tmp_path / "export"
    _write_iteration(export, 1, seed=5, vocab=40)
    m = _full(export)
    ckpt = _head_checkpoint(tmp_path / "head.npz", m)
    proc, info = _spawn_fleet(
        "gene2vec_tpu_torch.cli.fleet", export, str(tmp_path), "--shard-by-rows", "2",
        "--ggipnn-checkpoint", ckpt, "--device", "cpu", "--max-replicas", "2",
        "--scale-down-after", "1000", "--health-interval", "0.1", "--backoff-base", "0.05",
        "--scrape-interval", "0.2", "--alert-rules", "none", "--shard-deadline-ms", "1500",
        "--serve-arg=--device", "--serve-arg=cpu", "--serve-arg=--cache-size",
        "--serve-arg=0")
    url = info["url"]
    try:
        assert info["shards"]["ranges"] == [[0, 20], [20, 40]]
        assert info["shards"]["total_rows"] == 40 and info["autoscale"] == {"min": 1, "max": 2}
        unit = l2_normalize(m.emb)
        for gene in ("G3", "G33"):
            status, doc = _post(url + "/v1/similar", {"genes": [gene], "k": 5})
            assert status == 200 and doc["degraded"] is False
            s = unit @ unit[m.index[gene]]
            s[m.index[gene]] = -np.inf
            want = np.argsort(-s, kind="stable")[:5]
            for n, row in zip(doc["results"][0]["neighbors"], want):
                assert abs(n["score"] - s[row]) <= SCORE_TOL
                assert n["gene"] == f"G{row}" or abs(s[int(n['gene'][1:])] - s[row]) <= SCORE_TOL
        pairs = [["G1", "G30"], ["G22", "G5"]]
        status, doc = _post(url + "/v1/interaction", {"pairs": pairs})
        assert status == 200 and doc["trained_head"] is True
        want = InteractionScorer(m, checkpoint_path=ckpt, device="cpu").score(
            [tuple(p) for p in pairs])
        np.testing.assert_allclose([s["score"] for s in doc["scores"]], want, rtol=0,
                                   atol=1e-6)
        with urllib.request.urlopen(url + "/healthz", timeout=10) as r:
            health = json.loads(r.read())
        assert [s["rows"] for s in health["shards"]] == [[0, 20], [20, 40]]
        os.kill(info["replica_pids"][1], signal.SIGKILL)
        status, doc = _post(url + "/v1/similar", {"vectors": [list(map(float, m.emb[0]))],
                                                  "k": 3})
        assert status == 200
        deadline = time.monotonic() + 60
        while time.monotonic() < deadline:
            status, doc = _post(url + "/v1/similar", {"genes": ["G3"], "k": 5})
            if status == 200 and not doc["degraded"]:
                break
            time.sleep(0.2)
        assert status == 200 and doc["degraded"] is False
    finally:
        _stop(proc)
    assert proc.returncode == 0
