"""The port's ``/v1/interaction`` (``serve/interaction.py`` and the route in
``serve/server.py``) on the CPU against the JAX package's scorer and
``ServeApp`` on the same served table and head: scores within 1e-6 (both
round to 6 places), the same 400s, ``trained_head``, and the rebuild on
hot swap.  The JAX side runs in process (its first request jit-compiles
the scanned predict); the port's HTTP client waits up to 120 s."""

import json
import threading
import urllib.error
import urllib.request

import numpy as np
import pytest
import torch

from gene2vec_tpu.serve.interaction import InteractionScorer as RefScorer
from gene2vec_tpu.serve.registry import ModelRegistry as RefRegistry
from gene2vec_tpu.serve.server import ServeApp as RefApp
from gene2vec_tpu.serve.server import ServeConfig as RefConfig
from gene2vec_tpu_torch.config import GGIPNNConfig
from gene2vec_tpu_torch.io.checkpoint import save_iteration
from gene2vec_tpu_torch.io.emb_io import write_word2vec_format
from gene2vec_tpu_torch.io.vocab import Vocab
from gene2vec_tpu_torch.models.ggipnn import from_jax_params, init_params_numpy
from gene2vec_tpu_torch.models.ggipnn_obs import GGIPNNRun
from gene2vec_tpu_torch.serve.interaction import InteractionScorer, unflatten_params
from gene2vec_tpu_torch.serve.registry import ModelRegistry
from gene2vec_tpu_torch.serve.server import ServeApp, ServeConfig, make_server
from gene2vec_tpu_torch.sgns.model import SGNSParams

V, D = 120, 16
TOKENS = [f"G{i}" for i in range(V)]
SCORE_TOL = 1e-6
PAIRS = [["G0", "G1"], ["G5", "G5"], ["G119", "G3"], ["G40", "G77"], ["G8", "G9"]]


def write_iteration(export, iteration):
    rng = np.random.RandomState(iteration)
    cent = rng.randn(6, D).astype(np.float32)
    emb = cent[np.arange(V) % 6] + 0.3 * rng.randn(V, D).astype(np.float32)
    save_iteration(str(export), D, iteration, SGNSParams(torch.from_numpy(emb),
                                                         torch.from_numpy(emb)),
                   Vocab(TOKENS, np.full(V, 5)), txt_output=False)
    return emb


@pytest.fixture
def export(tmp_path):
    d = tmp_path / "export"
    write_iteration(d, 1)
    write_iteration(d, 2)
    return d


@pytest.fixture
def checkpoint(tmp_path):
    """A head trained nowhere, written by the port's run writer in the
    reference's layout: the JAX scorer and the port's load the same."""
    cfg = GGIPNNConfig(embedding_dim=D)
    run = GGIPNNRun(str(tmp_path / "run"), config=cfg)
    path = run.checkpoint(100, from_jax_params(init_params_numpy(3, V, cfg), cfg))
    run.close()
    return path


def scores_of(doc):
    return [row["score"] for row in doc["scores"]]


def test_unflatten_params_is_the_reference_copy():
    flat = {"embedding": np.zeros(2), "hidden1/kernel": np.ones(3), "hidden1/bias": np.ones(1)}
    got = unflatten_params(flat)
    assert set(got) == {"embedding", "hidden1"} and set(got["hidden1"]) == {"kernel", "bias"}


@pytest.mark.parametrize("with_head", [False, True])
def test_scorer_matches_the_jax_scorer(export, checkpoint, with_head):
    ref_reg, reg = RefRegistry(str(export)), ModelRegistry(str(export), device="cpu")
    assert ref_reg.refresh() and reg.refresh()
    path = checkpoint if with_head else None
    ref, port = RefScorer(ref_reg.model, checkpoint_path=path), InteractionScorer(
        reg.model, checkpoint_path=path, device="cpu")
    assert port.trained == ref.trained == with_head
    assert port.version == ref.version == (D, 2)
    pairs = [tuple(p) for p in PAIRS]
    np.testing.assert_array_equal(port.encode(pairs), ref.encode(pairs))
    with pytest.raises(KeyError, match="NOPE"):
        port.encode([("G1", "NOPE")])
    got = port.score(pairs)
    assert port.score([]) == []
    # the served table, never the checkpoint's
    np.testing.assert_array_equal(port.trainer.model.embedding.detach().numpy(),
                                  reg.model.emb)
    if with_head:
        np.testing.assert_allclose(got, ref.score(pairs), rtol=0, atol=SCORE_TOL)
    else:  # the port's own head init is not the reference's PRNGKey(10)
        assert all(0.0 <= s <= 1.0 for s in got)


def test_checkpoint_of_another_vocab_is_refused(export, tmp_path):
    cfg = GGIPNNConfig(embedding_dim=D)
    run = GGIPNNRun(str(tmp_path / "small"), config=cfg)
    path = run.checkpoint(1, from_jax_params(init_params_numpy(1, V - 1, cfg), cfg))
    run.close()
    reg = ModelRegistry(str(export), device="cpu")
    assert reg.refresh()
    with pytest.raises(ValueError, match="different vocab"):
        InteractionScorer(reg.model, checkpoint_path=path, device="cpu")


def test_cli_checkpoint_scores_in_the_jax_scorer(export, tmp_path):
    """A head trained by the port's CLI on the CPU (--run-dir) loads into
    the unchanged JAX scorer, which scores the same pairs as the port."""
    from gene2vec_tpu_torch.cli import ggipnn

    rng = np.random.RandomState(0)
    reg = ModelRegistry(str(export), device="cpu")
    assert reg.refresh()
    data = tmp_path / "predictionData"
    data.mkdir()
    for split, n in (("train", 2 * V), ("valid", 40), ("test", 60)):
        a = np.arange(n) % V if split == "train" else rng.randint(0, V, n)
        b = rng.randint(0, V, n)
        (data / f"{split}_text.txt").write_text(
            "\n".join(f"{TOKENS[i]} {TOKENS[j]}" for i, j in zip(a, b)) + "\n")
        (data / f"{split}_label.txt").write_text(
            "\n".join(str(int(i % 6 == j % 6)) for i, j in zip(a, b)) + "\n")
    w2v = str(tmp_path / "emb_w2v.txt")
    write_word2vec_format(w2v, list(reg.model.tokens), reg.model.emb)
    run_dir = tmp_path / "run"
    assert ggipnn.main(["--data-dir", str(data), "--emb", w2v, "--embedding-dim", str(D),
                        "--device", "cpu", "--run-dir", str(run_dir),
                        "--checkpoint-every", "2", "--batch-size", "32"]) == 0
    path = str(run_dir / "checkpoints" / "model-8.npz")
    ref_reg = RefRegistry(str(export))
    assert ref_reg.refresh()
    ref = RefScorer(ref_reg.model, checkpoint_path=path)
    port = InteractionScorer(reg.model, checkpoint_path=path, device="cpu")
    assert ref.trained and port.trained
    pairs = [tuple(p) for p in PAIRS]
    np.testing.assert_allclose(port.score(pairs), ref.score(pairs), rtol=0, atol=SCORE_TOL)


class Server:
    def __init__(self, export, checkpoint=None):
        self.registry = ModelRegistry(str(export), device="cpu")
        assert self.registry.refresh()
        self.app = ServeApp(self.registry, ServeConfig(cache_size=0, max_queries_per_request=8),
                            ggipnn_checkpoint=checkpoint).start()
        self.http = make_server(self.app, "127.0.0.1", 0)
        self.url = "http://127.0.0.1:%d" % self.http.server_address[1]
        self.thread = threading.Thread(target=self.http.serve_forever, daemon=True)
        self.thread.start()

    def post(self, path, doc):
        data = doc if isinstance(doc, bytes) else json.dumps(doc).encode()
        req = urllib.request.Request(self.url + path, data=data, method="POST")
        try:
            with urllib.request.urlopen(req, timeout=120) as r:
                return r.status, json.loads(r.read())
        except urllib.error.HTTPError as e:
            return e.code, json.loads(e.read())

    def metrics(self):
        with urllib.request.urlopen(self.url + "/metrics", timeout=120) as r:
            return r.read().decode()

    def close(self):
        self.http.shutdown()
        self.http.server_close()
        self.app.stop()
        self.thread.join(timeout=5)


def test_http_interaction_matches_the_jax_app(export, checkpoint):
    srv = Server(export, checkpoint)
    ref = RefApp(RefRegistry(str(export)), config=RefConfig(cache_size=0,
                                                            max_queries_per_request=8),
                 ggipnn_checkpoint=checkpoint)
    assert ref.registry.refresh()
    ref.start()
    try:
        status, doc = srv.post("/v1/interaction", {"pairs": PAIRS})
        ref_status, ref_doc = ref.handle("POST", "/v1/interaction", {"pairs": PAIRS})
        assert status == ref_status == 200
        assert doc["model"] == ref_doc["model"] == {"dim": D, "iteration": 2}
        assert doc["trained_head"] is ref_doc["trained_head"] is True
        assert [r["pair"] for r in doc["scores"]] == PAIRS
        np.testing.assert_allclose(scores_of(doc), scores_of(ref_doc), rtol=0, atol=SCORE_TOL)
        for body in ({"pairs": []}, {"pairs": [["G1"]]}, {"pairs": "G1 G2"}, {},
                     {"pairs": [["G1", "G2"]] * 9}, {"pairs": [["G1", "NOPE"]]}):
            status, doc = srv.post("/v1/interaction", body)
            ref_status, ref_doc = ref.handle("POST", "/v1/interaction", body)
            assert status == ref_status == 400, body
            assert doc["error"] == ref_doc["error"]
        assert srv.post("/v1/interaction", b"{not json")[0] == 400
        assert 'serve_interaction_pairs_total 5' in srv.metrics()
        assert 'kernel_launches_total' not in srv.metrics()  # CPU: plain versions
    finally:
        srv.close()
        ref.stop()


def test_http_interaction_untrained_head_and_hot_swap(export, checkpoint):
    """Without a checkpoint ``trained_head`` is false; after a hot swap the
    scorer is rebuilt on the new table (the JAX scorer on the same
    iteration and head agrees)."""
    srv = Server(export)
    try:
        status, doc = srv.post("/v1/interaction", {"pairs": PAIRS[:2]})
        assert status == 200 and doc["trained_head"] is False
    finally:
        srv.close()
    srv = Server(export, checkpoint)
    try:
        _, before = srv.post("/v1/interaction", {"pairs": PAIRS})
        first = srv.app._scorer
        write_iteration(export, 3)
        assert srv.registry.refresh()
        status, after = srv.post("/v1/interaction", {"pairs": PAIRS})
        assert status == 200 and after["model"]["iteration"] == 3
        assert srv.app._scorer is not first and srv.app._scorer.version == (D, 3)
        assert scores_of(after) != scores_of(before)
        ref_reg = RefRegistry(str(export))
        assert ref_reg.refresh() and ref_reg.model.iteration == 3
        want = RefScorer(ref_reg.model, checkpoint_path=checkpoint).score(
            [tuple(p) for p in PAIRS])
        np.testing.assert_allclose(scores_of(after), want, rtol=0, atol=SCORE_TOL)
    finally:
        srv.close()
