"""The port's quality tooling (``eval/planted.py``, ``eval/holdout.py``,
``sgns/train.py:train_epochs`` / ``make_train_epoch`` and
``GGIPNNTrainer.fit_epoch``) held against the JAX package on the CPU.

Tolerances, each with its reason:
- the planted corpus, the holdout split and corpus, the cosines and the
  AUC: equal (the same numpy code on the same inputs);
- ``train_epochs`` at dim 16, two epochs under the reference's draws
  (``fold_in(PRNGKey(seed), it)``, recomputed here) from the reference's
  init: the two-epoch SGNS bar of ``tests/test_torch_train.py``, loss rtol
  1e-4 and tables atol 1e-5 (float32 sums in another order);
- ``fit_epoch`` under the reference's batch order and dropout masks:
  GGIPNN's bar of ``tests/test_torch_ggipnn.py``, every tensor within 1e-4
  of its largest |value| (Adam divides by √v + ε), the epoch's mean loss
  within 1e-5 relative, its accuracy equal;
- the planted gate: the reference's own thresholds (INTRA_MIN, INTER_MAX,
  the loss 1.0 under its init plateau ln 2·(1 + K)) at the settings of
  ``tests/test_quality_regression.py``.
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from gene2vec_tpu.config import GGIPNNConfig as RefGGIPNNConfig
from gene2vec_tpu.config import SGNSConfig as JConfig
from gene2vec_tpu.data.pipeline import PairCorpus as JCorpus
from gene2vec_tpu.eval import holdout as ref_holdout
from gene2vec_tpu.eval import planted as ref_planted
from gene2vec_tpu.io.vocab import Vocab as JVocab
from gene2vec_tpu.models.ggipnn_train import GGIPNNTrainer as RefGGIPNNTrainer
from gene2vec_tpu.sgns import step as jstep
from gene2vec_tpu.sgns import train as ref_train
from gene2vec_tpu_torch import eval as port_eval
from gene2vec_tpu_torch.config import GGIPNNConfig, SGNSConfig
from gene2vec_tpu_torch.data.pipeline import PairCorpus
from gene2vec_tpu_torch.eval import holdout, planted
from gene2vec_tpu_torch.io.vocab import Vocab
from gene2vec_tpu_torch.models.ggipnn import init_params_numpy as ggipnn_init
from gene2vec_tpu_torch.models.ggipnn_obs import _flatten_params
from gene2vec_tpu_torch.models.ggipnn_train import FitDraws, GGIPNNTrainer
from gene2vec_tpu_torch.sgns import train as port_train
from gene2vec_tpu_torch.sgns.model import from_jax_params
from test_torch_ggipnn import B, KW, assert_params_close, data, jparams, ref_masks, vocabs
from test_torch_train import SMALL, _jax_epoch_draws, _zipf_corpus


# -- eval/planted.py ------------------------------------------------------------


def test_planted_constants_are_the_references():
    for name in ("N_CLUSTERS", "N_GENES", "PAIRS_PER_CLUSTER", "INTRA_MIN", "INTER_MAX"):
        assert getattr(planted, name) == getattr(ref_planted, name)


@pytest.mark.parametrize("kw", [{}, {"n_clusters": 3, "n_genes": 9, "pairs_per": 50, "seed": 4}])
def test_planted_corpus_is_bitwise_the_references(kw):
    vocab, corpus = planted.planted_corpus(**kw)
    jvocab, jcorpus = ref_planted.planted_corpus(**kw)
    assert vocab.id_to_token == jvocab.id_to_token
    np.testing.assert_array_equal(vocab.counts, jvocab.counts)
    assert corpus.pairs.dtype == jcorpus.pairs.dtype
    np.testing.assert_array_equal(corpus.pairs, jcorpus.pairs)


@pytest.mark.parametrize("seed", [0, 1])
def test_cluster_cosines_equal_on_one_embedding(seed):
    vocab, _ = planted.planted_corpus(pairs_per=200)
    jvocab, _ = ref_planted.planted_corpus(pairs_per=200)
    emb = np.random.RandomState(seed).randn(len(vocab.id_to_token), 12).astype(np.float32)
    assert planted.cluster_cosines(vocab, emb) == ref_planted.cluster_cosines(jvocab, emb)


# -- eval/holdout.py ------------------------------------------------------------


def _write_split(root, n=400, genes=300, seed=0):
    """A reference-format train split (``train_text.txt`` pairs and
    ``train_label.txt`` labels) made from ``seed``."""
    rng = np.random.RandomState(seed)
    a, b = rng.randint(0, genes, n), rng.randint(0, genes, n)
    labels = (a % 3 == b % 3).astype(int)
    root.mkdir(exist_ok=True)
    (root / "train_text.txt").write_text("".join(f"G{i} G{j}\n" for i, j in zip(a, b)))
    (root / "train_label.txt").write_text("".join(f"{y}\n" for y in labels))
    return str(root)


def test_holdout_constants_and_exports_are_the_references():
    for name in ("HOLDOUT_SEED", "HOLDOUT_FRACTION", "ORACLE_COS_AUC",
                 "DEGREE_BASELINE_AUC", "GATE_MIN_AUC", "GATE_MAX_AUC"):
        assert getattr(holdout, name) == getattr(ref_holdout, name)
    import gene2vec_tpu.eval as ref_eval

    names = {n for n in dir(ref_eval) if not n.startswith("_") and n not in
             ("holdout", "metrics", "planted", "target_function")}
    assert names <= set(dir(port_eval))


@pytest.mark.parametrize("auc", [holdout.GATE_MIN_AUC, holdout.GATE_MAX_AUC,
                                 holdout.ORACLE_COS_AUC, 0.5, 0.9613, 0.86199, 1.0,
                                 float("nan"), float("inf")])
def test_auc_in_gate_band_agrees(auc):
    assert holdout.auc_in_gate_band(auc) == ref_holdout.auc_in_gate_band(auc)


def test_holdout_split_and_load_equal(tmp_path):
    root = _write_split(tmp_path / "data")
    lines, labels = holdout.read_split(root, "train")
    jlines, jlabels = ref_holdout.read_split(root, "train")
    assert lines == jlines
    np.testing.assert_array_equal(labels, jlabels)
    for fraction, seed in ((holdout.HOLDOUT_FRACTION, holdout.HOLDOUT_SEED), (0.35, 2)):
        got = holdout.holdout_split(lines, labels, fraction, seed)
        want = ref_holdout.holdout_split(jlines, jlabels, fraction, seed)
        assert got._fields == want._fields
        for g, w in zip(got, want):
            if isinstance(w, np.ndarray):
                np.testing.assert_array_equal(g, w)
            else:
                assert g == w
    corpus, split = holdout.load_holdout(root)
    jcorpus, jsplit = ref_holdout.load_holdout(root)
    assert corpus.vocab.id_to_token == jcorpus.vocab.id_to_token
    np.testing.assert_array_equal(corpus.vocab.counts, jcorpus.vocab.counts)
    np.testing.assert_array_equal(corpus.pairs, jcorpus.pairs)
    assert split.hold_pairs == jsplit.hold_pairs
    # one embedding, both scorers
    emb = np.random.RandomState(3).randn(corpus.vocab_size, 8).astype(np.float32)
    scores, mask = holdout.cosine_scores(corpus.vocab.token_to_id, emb, split.hold_pairs)
    jscores, jmask = ref_holdout.cosine_scores(jcorpus.vocab.token_to_id, emb,
                                               jsplit.hold_pairs)
    np.testing.assert_array_equal(scores, jscores)
    np.testing.assert_array_equal(mask, jmask)
    assert not mask.all()  # held-out genes absent from every fit positive score 0
    for in_vocab_only in (True, False):
        got = holdout.holdout_cos_auc(corpus.vocab, emb, split, in_vocab_only)
        want = ref_holdout.holdout_cos_auc(jcorpus.vocab, emb, jsplit, in_vocab_only)
        assert got == want and math.isfinite(got)


def test_read_split_refuses_mismatched_files(tmp_path):
    root = _write_split(tmp_path / "data")
    with open(f"{root}/train_label.txt", "a") as f:
        f.write("1\n")
    with pytest.raises(ValueError, match="pair lines vs"):
        holdout.read_split(root, "train")


# -- sgns/train.py: train_epochs, make_train_epoch ------------------------------


def test_train_epochs_matches_under_the_references_draws(monkeypatch):
    monkeypatch.setattr(jstep, "_DENSE_HEAD_PRECISION", jax.lax.Precision.HIGHEST)
    toks, counts, pairs = _zipf_corpus()
    kw = dict(SMALL, seed=5)
    jcorpus = JCorpus(JVocab(toks, counts), pairs)
    corpus = PairCorpus(Vocab(toks, counts), pairs)
    jt = ref_train.SGNSTrainer(jcorpus, JConfig(**kw))
    tt = port_train.SGNSTrainer(corpus, SGNSConfig(**kw), device="cpu")
    draws = [_jax_epoch_draws(jt, tt, jax.random.fold_in(jax.random.PRNGKey(5), it))
             for it in (1, 2)]
    j0 = jt.init()
    monkeypatch.setattr(port_train.SGNSTrainer, "init", lambda self, seed=None: from_jax_params(
        np.asarray(j0.emb), np.asarray(j0.ctx)))
    want, wlosses = ref_train.train_epochs(jcorpus, JConfig(**kw), 2)
    got, losses = port_train.train_epochs(corpus, SGNSConfig(**kw), 2, draws=draws,
                                          device="cpu")
    assert got.dtype == np.float32 and got.shape == want.shape == (len(toks), 16)
    np.testing.assert_allclose(losses, wlosses, rtol=1e-4)
    np.testing.assert_allclose(got, np.asarray(want), atol=1e-5)
    with pytest.raises(ValueError, match="epochs of draws"):
        port_train.train_epochs(corpus, SGNSConfig(**kw), 3, draws=draws, device="cpu")


def test_train_epochs_draws_as_run_does():
    """Without draws, iteration ``it`` trains under
    ``epoch_generator(seed, it)``, as ``run`` does; ``make_train_epoch``
    is the epoch function the trainer runs."""
    toks, counts, pairs = _zipf_corpus()
    corpus = PairCorpus(Vocab(toks, counts), pairs)
    cfg = SGNSConfig(**SMALL)
    emb, losses = port_train.train_epochs(corpus, cfg, 2, device="cpu")
    tt = port_train.SGNSTrainer(corpus, cfg, device="cpu")
    epoch = port_train.make_train_epoch(tt)
    params = tt.init()
    for it in (1, 2):
        params, loss = epoch(params, tt.draw_epoch(port_train.epoch_generator(cfg.seed, it)))
        assert float(loss) == losses[it - 1]
    np.testing.assert_array_equal(emb, params.emb.numpy())


def test_planted_gate_passes_on_the_cpu():
    """The reference's quality regression (its settings: 1,500 pairs a
    cluster, dim 32, batch 1,024, 12 epochs) through the port's loop."""
    vocab, corpus = planted.planted_corpus(pairs_per=1500)
    cfg = SGNSConfig(dim=32, num_iters=12, batch_pairs=1024)
    emb, losses = port_train.train_epochs(corpus, cfg, 12, device="cpu")
    plateau = float(np.log(2.0) * (1 + cfg.negatives))
    assert losses[0] == pytest.approx(plateau, abs=0.1)
    assert losses[-1] < plateau - 1.0, losses
    intra, inter = planted.cluster_cosines(vocab, emb)
    assert intra > planted.INTRA_MIN and inter < planted.INTER_MAX, (intra, inter)


# -- models/ggipnn_train.py: fit_epoch ------------------------------------------


@pytest.mark.parametrize("embed_train", [False, True])
def test_fit_epoch_matches(embed_train):
    cfg = dict(KW, embed_train=embed_train)
    p0 = ggipnn_init(3, 50, GGIPNNConfig(**cfg))
    x, y = data(5 * B, seed=2)
    jv, tv = vocabs()
    ref = RefGGIPNNTrainer(RefGGIPNNConfig(**cfg), jv)
    params = jparams(p0)
    key = jax.random.PRNGKey(11)
    params, _, wloss, wacc = ref.fit_epoch(params, ref.tx.init(params), jnp.asarray(x),
                                           jnp.asarray(y), key)
    order_key, drop_key = jax.random.split(key)
    draws = FitDraws(
        masks=[ref_masks(jax.random.fold_in(drop_key, s), B) for s in range(5)],
        orders=np.asarray(jax.random.permutation(order_key, 5))[None])
    tr = GGIPNNTrainer(GGIPNNConfig(**cfg), tv, device="cpu")
    tr.init_state(params=p0)
    model, opt, loss, acc = tr.fit_epoch(x, y, draws)
    assert model is tr.model and opt is tr.optimizer and tr._step == 5
    assert_params_close(params, model, start=_flatten_params(p0),
                        frozen_table=not embed_train)
    np.testing.assert_allclose(float(loss), float(wloss), rtol=1e-5)
    assert float(acc) == float(wacc)


def test_fit_epoch_refuses_less_than_one_batch():
    jv, tv = vocabs()
    x, y = data(B - 1)
    ref = RefGGIPNNTrainer(RefGGIPNNConfig(**KW), jv)
    tr = GGIPNNTrainer(GGIPNNConfig(**KW), tv, device="cpu")
    tr.init_state(params=ggipnn_init(1, 50, GGIPNNConfig(**KW)))
    want = f"{B - 1} examples is fewer than one batch (batch_size={B})"
    with pytest.raises(ValueError) as ref_err:
        ref.fit_epoch(None, None, x, y, jax.random.PRNGKey(0))
    assert str(ref_err.value) == want
    with pytest.raises(ValueError) as err:
        tr.fit_epoch(x, y)
    assert str(err.value) == want
