"""The port's GGIPNN (``gene2vec_tpu_torch/models/ggipnn*.py``,
``eval/metrics.py``, ``io/emb_io.py``'s GGIPNN loaders, ``cli/ggipnn.py``)
against the JAX package on the CPU, at a small size (V = 50, D = 8,
hidden (16, 16, 4), B = 16), from the same params and the reference's own
random draws.

The reference's dropout masks are recovered by applying a same-named
``nn.Dropout`` in a top-level flax module to ones of each hidden layer's
shape, in call order, under the same rng (mask = output ≠ 0); the first
test pins that the injected masks reproduce flax's ``train=True`` logits.

Tolerances: logits and losses within 1e-6 (float32 sums in another
order); after Adam steps each tensor within 1e-4 × its largest |value|
(Adam divides by √v + ε, so a gradient's rounding shows relative to the
step, lr = 1e-3; one step is ~1e-6 of the scale); a frozen table
bitwise unchanged; the data utilities array-identical.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import linen as nn

from gene2vec_tpu.config import GGIPNNConfig as RefConfig
from gene2vec_tpu.eval import metrics as ref_metrics
from gene2vec_tpu.io import emb_io as ref_emb_io
from gene2vec_tpu.models import ggipnn_data as ref_data
from gene2vec_tpu.models.ggipnn import GGIPNN as RefGGIPNN
from gene2vec_tpu.models.ggipnn import loss_fn as ref_loss_fn
from gene2vec_tpu.models.ggipnn_obs import GGIPNNRun as RefRun
from gene2vec_tpu.models.ggipnn_obs import _flatten_params as ref_flatten
from gene2vec_tpu.models.ggipnn_obs import load_checkpoint as ref_load_checkpoint
from gene2vec_tpu.models.ggipnn_train import GGIPNNTrainer as RefTrainer
from gene2vec_tpu.serve.interaction import unflatten_params as ref_unflatten
from gene2vec_tpu_torch.config import GGIPNNConfig
from gene2vec_tpu_torch.eval import metrics
from gene2vec_tpu_torch.io import emb_io
from gene2vec_tpu_torch.models import ggipnn_data
from gene2vec_tpu_torch.models.ggipnn import from_jax_params, init_params_numpy, loss_fn
from gene2vec_tpu_torch.models.ggipnn_obs import GGIPNNRun, _flatten_params, load_checkpoint
from gene2vec_tpu_torch.models.ggipnn_train import FitDraws, GGIPNNTrainer

V, D, HIDDEN, B = 50, 8, (16, 16, 4), 16
KW = dict(embedding_dim=D, hidden_dims=HIDDEN, batch_size=B)
LOGIT_TOL = 1e-6
PARAM_RTOL = 1e-4


class _Drops(nn.Module):
    """The reference's one shared ``Dropout_0``, called once per hidden
    layer in order: its outputs on ones are its masks."""

    hidden: tuple
    rate: float

    @nn.compact
    def __call__(self, b):
        drop = nn.Dropout(rate=self.rate, deterministic=False)
        return [drop(jnp.ones((b, h))) for h in self.hidden]


def ref_masks(key, b, keep=0.5):
    outs = _Drops(HIDDEN, 1.0 - keep).apply({}, b, rngs={"dropout": key})
    return tuple(np.asarray(o) != 0 for o in outs)


def step_loop_masks(seed, sizes):
    """The reference's step loop: ``key, sub = split(key)`` per step from
    ``PRNGKey(seed + 1)``; ``sizes`` are the steps' batch sizes."""
    key = jax.random.PRNGKey(seed + 1)
    out = []
    for b in sizes:
        key, sub = jax.random.split(key)
        out.append(ref_masks(sub, b))
    return out


def scanned_draws(seed, num_epochs, num_batches, b):
    """The reference's scanned fit: per epoch ``split(fold_in(PRNGKey(seed
    + 1), epoch))`` into the batch-order and dropout keys; each step's
    masks from ``fold_in(drop_key, step)``."""
    key = jax.random.PRNGKey(seed + 1)
    orders, masks = [], []
    for epoch in range(num_epochs):
        order_key, drop_key = jax.random.split(jax.random.fold_in(key, epoch))
        orders.append(np.asarray(jax.random.permutation(order_key, num_batches)))
        masks += [ref_masks(jax.random.fold_in(drop_key, s), b) for s in range(num_batches)]
    return FitDraws(masks=masks, orders=np.stack(orders))


def data(n, seed=0):
    rng = np.random.RandomState(seed)
    x = rng.randint(0, V, (n, 2)).astype(np.int32)
    y = np.eye(2, dtype=np.float32)[(x[:, 0] % 3 == x[:, 1] % 3).astype(int)]
    return x, y


def vocabs():
    lines = [f"G{i} G{(i + 1) % V}" for i in range(V)]
    return ref_data.PairTextVocab().fit(lines), ggipnn_data.PairTextVocab().fit(lines)


def jparams(p):
    return jax.tree_util.tree_map(jnp.asarray, p)


def assert_params_close(ref_params, model, start=None, frozen_table=False):
    want = ref_flatten(jax.tree_util.tree_map(np.asarray, ref_params))
    got = model.to_flat()
    assert set(want) == set(got)
    for k in want:
        if k == "embedding" and frozen_table:
            np.testing.assert_array_equal(got[k], start[k])
            np.testing.assert_array_equal(want[k], start[k])
            continue
        err = np.abs(got[k] - want[k]).max()
        assert err <= PARAM_RTOL * np.abs(want[k]).max(), (k, err)


@pytest.mark.parametrize("train", [False, True])
def test_forward_logits_match(train):
    p0 = init_params_numpy(3, V, GGIPNNConfig(**KW))
    x, _ = data(B)
    ref = RefGGIPNN(vocab_size=V, embedding_dim=D, hidden_dims=HIDDEN)
    key = jax.random.PRNGKey(5)
    want = np.asarray(ref.apply({"params": jparams(p0)}, jnp.asarray(x), train=train,
                                rngs={"dropout": key}))
    model = from_jax_params(p0, GGIPNNConfig(**KW))
    model.train(train)
    masks = [torch.from_numpy(m) for m in ref_masks(key, B)] if train else None
    got = model(torch.from_numpy(x), masks=masks).detach().numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=LOGIT_TOL * np.abs(want).max())
    if train:  # dropout changed the answer: the masks were applied
        model.eval()
        assert np.abs(model(torch.from_numpy(x)).detach().numpy() - want).max() > 1e-3


@pytest.mark.parametrize("l2", [0.0, 0.1])
def test_loss_fn_matches(l2):
    p0 = init_params_numpy(4, V, GGIPNNConfig(**KW))
    x, y = data(B, seed=1)
    ref = RefGGIPNN(vocab_size=V, embedding_dim=D, hidden_dims=HIDDEN)
    logits = ref.apply({"params": jparams(p0)}, jnp.asarray(x))
    want_loss, want_acc = ref_loss_fn(logits, jnp.asarray(y), jparams(p0), l2)
    model = from_jax_params(p0, GGIPNNConfig(**KW))
    loss, acc = loss_fn(torch.from_numpy(np.asarray(logits)), torch.from_numpy(y), model, l2)
    assert abs(float(loss) - float(want_loss)) <= LOGIT_TOL * abs(float(want_loss))
    assert float(acc) == float(want_acc)
    if l2:
        plain, _ = loss_fn(torch.from_numpy(np.asarray(logits)), torch.from_numpy(y), model)
        assert float(loss) > float(plain) + 1e-3


@pytest.mark.parametrize("embed_train", [False, True])
def test_one_adam_step_matches(embed_train):
    cfg = dict(KW, embed_train=embed_train)
    p0 = init_params_numpy(5, V, GGIPNNConfig(**cfg))
    x, y = data(B, seed=2)
    jv, tv = vocabs()
    key = jax.random.PRNGKey(7)
    ref = RefTrainer(RefConfig(**cfg), jv)
    params = jparams(p0)
    params, _, ref_loss, ref_acc = ref.train_step(params, ref.tx.init(params), jnp.asarray(x),
                                                  jnp.asarray(y), key)
    tr = GGIPNNTrainer(GGIPNNConfig(**cfg), tv, device="cpu")
    tr.init_state(params=p0)
    masks = [torch.from_numpy(m) for m in ref_masks(key, B)]
    loss, acc = tr.train_step(torch.from_numpy(x), torch.from_numpy(y), masks)
    assert abs(float(loss) - float(ref_loss)) <= LOGIT_TOL * abs(float(ref_loss))
    assert float(acc) == float(ref_acc)
    assert_params_close(params, tr.model, start=_flatten_params(p0),
                        frozen_table=not embed_train)
    # the frozen table takes no gradient and no optimizer state
    assert tr.model.embedding.requires_grad == embed_train
    assert sum(p.numel() for g in tr.optimizer.param_groups for p in g["params"]) == (
        sum(p.numel() for p in tr.model.parameters()) - (0 if embed_train else V * D))


@pytest.mark.parametrize("embed_train", [False, True])
def test_step_loop_fit_matches(embed_train):
    """scan_fit off: ``batch_iter`` order (ragged last batch kept), two
    epochs, the reference's per-step masks, dev evaluation on cadence."""
    cfg = dict(KW, embed_train=embed_train, scan_fit=False, num_epochs=2, evaluate_every=3)
    p0 = init_params_numpy(6, V, GGIPNNConfig(**cfg))
    x, y = data(5 * B + 3, seed=3)
    xv, yv = data(2 * B + 1, seed=4)
    jv, tv = vocabs()
    ref = RefTrainer(RefConfig(**cfg), jv)
    params = jparams(p0)
    ref._state = (params, ref.tx.init(params))
    ref_log = []
    params, _ = ref.fit(x, y, xv, yv, log=ref_log.append)
    sizes = [B] * 5 + [3]
    tr = GGIPNNTrainer(GGIPNNConfig(**cfg), tv, device="cpu")
    tr.init_state(params=p0)
    log = []
    tr.fit(x, y, xv, yv, log=log.append, draws=FitDraws(masks=step_loop_masks(10, sizes * 2)))
    assert tr._step == ref._step == 12
    assert len(log) == len(ref_log) == 4
    assert_params_close(params, tr.model, start=_flatten_params(p0),
                        frozen_table=not embed_train)


@pytest.mark.parametrize("embed_train", [False, True])
def test_scanned_fit_matches(embed_train):
    """The scanned fit's equivalent: RandomState permutation, np.resize
    wrap-pad, each epoch's batch order and each step's masks from the
    reference's keys."""
    cfg = dict(KW, embed_train=embed_train, num_epochs=2)
    p0 = init_params_numpy(7, V, GGIPNNConfig(**cfg))
    x, y = data(4 * B + 5, seed=5)
    jv, tv = vocabs()
    ref = RefTrainer(RefConfig(**cfg), jv)
    params = jparams(p0)
    ref._state = (params, ref.tx.init(params))
    ref_log = []
    params, _ = ref.fit(x, y, log=ref_log.append)
    tr = GGIPNNTrainer(GGIPNNConfig(**cfg), tv, device="cpu")
    tr.init_state(params=p0)
    log = []
    tr.fit(x, y, log=log.append, draws=scanned_draws(10, 2, 5, B))
    assert tr._step == ref._step == 10
    assert_params_close(params, tr.model, start=_flatten_params(p0),
                        frozen_table=not embed_train)
    # per-epoch mean loss and accuracy, as the reference logs them
    assert [m.split(" | ")[0] for m in log] == [m.split(" | ")[0] for m in ref_log]


def test_scanned_fit_rejects_a_bad_order():
    jv, tv = vocabs()
    tr = GGIPNNTrainer(GGIPNNConfig(**KW), tv, device="cpu")
    tr.init_state(params=init_params_numpy(1, V, GGIPNNConfig(**KW)))
    x, y = data(2 * B)
    with pytest.raises(ValueError, match="permutation"):
        tr.fit(x, y, log=lambda m: None, draws=FitDraws(orders=np.array([[0, 0]])))


@pytest.mark.parametrize("n", [3 * B, 3 * B + 5])
def test_predict_and_evaluate_match(n):
    """Padded static-shape batches (the last row repeated), per-batch
    losses over the padded rows included, AUC from ``scores[:, 1]``."""
    cfg = dict(KW, l2_lambda=0.01)
    p0 = init_params_numpy(8, V, GGIPNNConfig(**cfg))
    x, y = data(n, seed=6)
    jv, tv = vocabs()
    ref = RefTrainer(RefConfig(**cfg), jv)
    ws, wp, wl = ref.predict(jparams(p0), x, y)
    tr = GGIPNNTrainer(GGIPNNConfig(**cfg), tv, device="cpu")
    tr.init_state(params=p0)
    gs, gp, gl = tr.predict(x, y)
    assert gs.shape == ws.shape == (n, 2) and gl.shape == wl.shape == (-(-n // B),)
    np.testing.assert_allclose(gs, ws, rtol=0, atol=LOGIT_TOL)
    np.testing.assert_array_equal(gp, wp)
    np.testing.assert_allclose(gl, wl, rtol=LOGIT_TOL)
    want, got = ref.evaluate(jparams(p0), x, y), tr.evaluate(x, y)
    assert set(got) == set(want) == {"loss", "accuracy", "auc"}
    assert got["accuracy"] == want["accuracy"]
    for k in ("loss", "auc"):
        assert abs(got[k] - want[k]) <= 1e-6, k
    # without labels: zero one-hots, scores unchanged
    np.testing.assert_allclose(tr.predict(x)[0], gs, rtol=0, atol=0)


def test_roc_auc_and_accuracy_are_the_reference_copies():
    rng = np.random.RandomState(0)
    y = rng.randint(0, 2, 200)
    s = np.round(rng.rand(200), 1)  # many ties: mid-ranks
    assert metrics.roc_auc_score(y, s) == ref_metrics.roc_auc_score(y, s)
    assert metrics.accuracy(y, s > 0.5) == ref_metrics.accuracy(y, s > 0.5)
    with pytest.raises(ValueError):
        metrics.roc_auc_score(np.ones(4), np.arange(4))


@pytest.mark.parametrize("fmt", ["w2v", "matrix"])
def test_load_embedding_for_vocab_identical(tmp_path, fmt):
    rng = np.random.RandomState(1)
    tokens = [f"G{i}" for i in range(30)]
    mat = rng.randn(30, D).astype(np.float32)
    path = str(tmp_path / f"emb.{fmt}")
    writer = ref_emb_io.write_word2vec_format if fmt == "w2v" else ref_emb_io.write_matrix_txt
    writer(path, tokens, mat)
    # a vocab with genes the file lacks (random fallback rows)
    vocab = {t: i for i, t in enumerate(tokens[::2] + [f"X{i}" for i in range(7)])}
    want = ref_emb_io.load_embedding_for_vocab(vocab, path, D, rng=np.random.RandomState(10))
    got = emb_io.load_embedding_for_vocab(vocab, path, D, rng=np.random.RandomState(10))
    np.testing.assert_array_equal(got, want)
    assert np.abs(got[-7:]).max() <= 0.25
    for a, b in zip(emb_io.load_embedding_any(path), ref_emb_io.load_embedding_any(path)):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def test_pair_vocab_labels_and_batch_iter_identical(tmp_path):
    lines = ["A B", "B C", "D A", "E F", "C E"]
    got = ggipnn_data.PairTextVocab().fit(lines[:2], lines[2:])
    want = ref_data.PairTextVocab().fit(lines[:2], lines[2:])
    assert got.token_to_id == want.token_to_id and got.id_to_token == want.id_to_token
    np.testing.assert_array_equal(got.transform(lines), want.transform(lines))
    with pytest.raises(ValueError, match="2 tokens"):
        got.transform(["A B C"])
    labels = ["0", "1", "1", "0", "1"]
    np.testing.assert_array_equal(ggipnn_data.one_hot_labels(labels),
                                  ref_data.one_hot_labels(labels))
    with pytest.raises(ValueError, match="out of range"):
        ggipnn_data.one_hot_labels(["2"])
    data_ = np.arange(23 * 3).reshape(23, 3)
    for shuffle in (True, False):
        a = list(ggipnn_data.batch_iter(data_, 5, 3, shuffle=shuffle, seed=4))
        b = list(ref_data.batch_iter(data_, 5, 3, shuffle=shuffle, seed=4))
        assert len(a) == len(b) == 15 and a[4].shape == (3, 3)
        for u, w in zip(a, b):
            np.testing.assert_array_equal(u, w)
    p = tmp_path / "lines.txt"
    p.write_text("A B\n\n  C D  \n")
    assert ggipnn_data.read_lines(str(p)) == ref_data.read_lines(str(p)) == ["A B", "C D"]


def test_checkpoints_read_both_ways(tmp_path):
    """A port checkpoint (flax names and layouts) loads into the reference
    model with the unchanged JAX reader and scores as the port does; a
    JAX checkpoint loads into the port."""
    cfg = GGIPNNConfig(**KW)
    p0 = init_params_numpy(9, V, cfg)
    x, _ = data(B)
    ref = RefGGIPNN(vocab_size=V, embedding_dim=D, hidden_dims=HIDDEN)

    run = GGIPNNRun(str(tmp_path / "port"), max_to_keep=2, config=cfg)
    model = from_jax_params(p0, cfg)
    for step in (1, 2, 3):
        path = run.checkpoint(step, model)
    run.close()
    assert sorted(os.listdir(run.checkpoint_dir)) == ["model-2.npz", "model-3.npz"]
    loaded = ref_unflatten(ref_load_checkpoint(path))
    want = np.asarray(ref.apply({"params": jparams(loaded)}, jnp.asarray(x)))
    model.eval()
    got = model(torch.from_numpy(x)).detach().numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=LOGIT_TOL * np.abs(want).max())

    ref_run = RefRun(str(tmp_path / "ref"), config=RefConfig(**KW))
    ref_path = ref_run.checkpoint(4, jparams(init_params_numpy(10, V, cfg)))
    ref_run.close()
    port = from_jax_params(load_checkpoint(ref_path), cfg)
    port.eval()
    want = np.asarray(ref.apply({"params": jparams(ref_unflatten(load_checkpoint(ref_path)))},
                                jnp.asarray(x)))
    np.testing.assert_allclose(port(torch.from_numpy(x)).detach().numpy(), want, rtol=0,
                               atol=LOGIT_TOL * np.abs(want).max())


def test_init_state_loads_the_pretrained_table(tmp_path):
    """The pretrained table replaces the init, with the reference's
    RandomState(seed) fallback rows for genes the file lacks; without
    ``params`` the port's own init is drawn from its seed."""
    jv, tv = vocabs()
    tokens = [f"G{i}" for i in range(0, V, 2)]
    mat = np.random.RandomState(2).randn(len(tokens), D).astype(np.float32)
    path = str(tmp_path / "emb_w2v.txt")
    emb_io.write_word2vec_format(path, tokens, mat)
    cfg = GGIPNNConfig(**KW)
    tr = GGIPNNTrainer(cfg, tv, device="cpu")
    tr.init_state(pretrained_emb_path=path)
    want = ref_emb_io.load_embedding_for_vocab(jv.token_to_id, path, D,
                                               rng=np.random.RandomState(cfg.seed))
    np.testing.assert_array_equal(tr.model.to_flat()["embedding"], want)
    a = GGIPNNTrainer(cfg, tv, device="cpu")
    b = GGIPNNTrainer(cfg, tv, device="cpu")
    fa, fb = a.init_state().to_flat(), b.init_state().to_flat()
    for k in fa:
        np.testing.assert_array_equal(fa[k], fb[k])
    assert np.abs(fa["embedding"]).max() <= 1.0


def _write_prediction_data(root, tokens, rng):
    for split, n in (("train", 160), ("valid", 40), ("test", 60)):
        pairs = rng.randint(0, len(tokens), (n, 2))
        labels = (pairs[:, 0] % 2 == pairs[:, 1] % 2).astype(int)
        (root / f"{split}_text.txt").write_text(
            "\n".join(f"{tokens[a]} {tokens[b]}" for a, b in pairs) + "\n")
        (root / f"{split}_label.txt").write_text("\n".join(map(str, labels)) + "\n")


def test_cli_trains_on_the_cpu_and_writes_checkpoints(tmp_path, capsys):
    from gene2vec_tpu_torch.cli import ggipnn

    rng = np.random.RandomState(0)
    tokens = [f"G{i}" for i in range(V)]
    data_dir = tmp_path / "predictionData"
    data_dir.mkdir()
    _write_prediction_data(data_dir, tokens, rng)
    emb = rng.randn(V, D).astype(np.float32)
    emb[:, 0] = np.arange(V) % 2  # the label is the parity: learnable
    w2v = str(tmp_path / "emb_w2v.txt")
    emb_io.write_word2vec_format(w2v, tokens, emb)
    base = ["--data-dir", str(data_dir), "--emb", w2v, "--embedding-dim", str(D),
            "--batch-size", "16", "--device", "cpu"]
    assert ggipnn.main(base) == 0
    out = capsys.readouterr().out
    assert "vocab size: 50" in out and "The AUC score is" in out
    run_dir = tmp_path / "run"
    assert ggipnn.main(base + ["--embed-train", "--run-dir", str(run_dir), "--num-epochs", "3",
                               "--checkpoint-every", "10", "--evaluate-every", "5"]) == 0
    names = sorted(os.listdir(run_dir / "checkpoints"))
    assert names == [f"model-{s}.npz" for s in (10, 20, 30)]
    flat = ref_load_checkpoint(str(run_dir / "checkpoints" / "model-30.npz"))
    assert flat["hidden1/kernel"].shape == (2 * D, 100)
    for f in ("manifest.json", "events.jsonl", "metrics.prom", "summaries/train/metrics.csv",
              "summaries/dev/metrics.csv"):
        assert (run_dir / f).exists(), f
    header = (run_dir / "summaries/train/metrics.csv").read_text().splitlines()[0]
    assert "embedding/grad/sparsity" in header and "output/kernel/grad/sparsity" in header
    assert "--device" in ggipnn.build_parser().format_help()
    assert "preemption" in ggipnn.build_parser().format_help()
