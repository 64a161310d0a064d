"""The port's trainer held against the JAX package on the CPU: two epochs
under the reference's own draws (recomputed here with its key
derivations), an export that the unchanged JAX checkpoint code accepts,
resume, and planted-cluster quality.  Tolerances for two epochs: loss
rtol 1e-4, tables atol 1e-5 (float32 sums in another order)."""

import csv
import os

import numpy as np
import pytest
import torch

import jax

from gene2vec_tpu.config import SGNSConfig as JConfig
from gene2vec_tpu.data.pipeline import PairCorpus as JCorpus
from gene2vec_tpu.eval.planted import INTER_MAX, INTRA_MIN, cluster_cosines, planted_corpus
from gene2vec_tpu.io import checkpoint as jckpt
from gene2vec_tpu.io.emb_io import read_word2vec_format
from gene2vec_tpu.io.vocab import Vocab as JVocab
from gene2vec_tpu.resilience import snapshot as jsnap
from gene2vec_tpu.sgns import step as jstep
from gene2vec_tpu.sgns.model import init_params_numpy
from gene2vec_tpu.sgns.train import SGNSTrainer as JTrainer
from gene2vec_tpu_torch.config import SGNSConfig
from gene2vec_tpu_torch.data.pipeline import PairCorpus, ShuffleDraw
from gene2vec_tpu_torch.io.vocab import Vocab
from gene2vec_tpu_torch.sgns.model import from_jax_params
from gene2vec_tpu_torch.sgns.train import EpochDraws, SGNSTrainer

V, N = 257, 1100
SMALL = dict(dim=16, batch_pairs=128, strat_head=32, strat_block=64,
             strat_group=32, positive_head=8, positive_mid=24, num_iters=2)


def _zipf_corpus(v=V, n=N, seed=0):
    rng = np.random.RandomState(seed)
    p = 1.0 / np.arange(1, v + 1)
    p /= p.sum()
    pairs = rng.choice(v, size=(n, 2), p=p).astype(np.int32)
    counts = np.bincount(pairs.reshape(-1), minlength=v).astype(np.int64) + 1
    return [f"G{i}" for i in range(v)], counts, pairs


def _shuffle_draw(key, num_pairs, num_batches, batch_pairs, mode):
    """The draws inside ``gene2vec_tpu.data.pipeline.epoch_shuffle``."""
    span = num_batches * batch_pairs
    if mode == "full":
        return ShuffleDraw(0, np.asarray(jax.random.permutation(key, num_pairs)[:span]))
    off_key, blk_key = jax.random.split(key)
    block = 512 if span % 512 == 0 else batch_pairs
    return ShuffleDraw(int(jax.random.randint(off_key, (), 0, num_pairs)),
                       np.asarray(jax.random.permutation(blk_key, span // block)))


def _jax_epoch_draws(jt, tt, key):
    """The draws the JAX trainer's jitted epoch makes from ``key``
    (train.py:83-124, pipeline.py:146-153, 338, step.py:753)."""
    cfg = jt.config
    shuffle_key, step_key = jax.random.split(key)
    if jt.pos_quotas is not None:
        keys = jax.random.split(shuffle_key, len(jt.pairs))
        shuffles = tuple(
            _shuffle_draw(k, int(p.shape[0]), jt.num_batches, q, cfg.shuffle_mode)
            if q else None
            for p, k, q in zip(jt.pairs, keys, jt.pos_quotas)
        )
    else:
        shuffles = (_shuffle_draw(shuffle_key, jt.global_num_pairs, jt.num_batches,
                                  cfg.batch_pairs, cfg.shuffle_mode),)
    blocks = np.stack([
        np.asarray(jax.random.randint(jax.random.fold_in(step_key, s),
                                      (tt.num_groups,), 0, jt.stratified.nb))
        for s in range(jt.num_batches)
    ])
    return EpochDraws(shuffles, blocks)


@pytest.mark.parametrize("overrides", [
    {},                                            # default: 3-class layout
    {"positive_mid": 0},                           # head-only layout
    {"positive_head": 0},                          # plain gathers
    {"shuffle_mode": "full", "combiner": "sum"},
    {"combiner": "mean", "positive_mid": 0},
], ids=["head_mid", "head_only", "plain", "full_sum", "mean_head_only"])
def test_two_epochs_match_under_injected_draws(overrides, monkeypatch):
    monkeypatch.setattr(jstep, "_DENSE_HEAD_PRECISION", jax.lax.Precision.HIGHEST)
    toks, counts, pairs = _zipf_corpus()
    kw = dict(SMALL, **overrides)
    jt = JTrainer(JCorpus(JVocab(toks, counts), pairs), JConfig(**kw))
    tt = SGNSTrainer(PairCorpus(Vocab(toks, counts), pairs), SGNSConfig(**kw),
                     device="cpu")
    assert (tt.num_batches, tt.pos_quotas, jt.pos_shards) == (
        jt.num_batches, jt.pos_quotas, 1)
    assert tt.config.positive_head == jt.config.positive_head
    assert tt.config.positive_mid == jt.config.positive_mid
    if tt.pos_quotas is not None:
        for a, b in zip(tt.pairs, jt.pairs):
            np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    jp = init_params_numpy(0, V, kw["dim"])
    tp = from_jax_params(np.asarray(jp.emb), np.asarray(jp.ctx))
    for it in (1, 2):
        key = jax.random.fold_in(jax.random.PRNGKey(kw.get("seed", 1)), it)
        draws = _jax_epoch_draws(jt, tt, key)
        jp, jloss = jt.train_epoch(jp, key)
        tp, tloss = tt.train_epoch(tp, draws=draws)
        np.testing.assert_allclose(float(tloss), float(jloss), rtol=1e-4)
    np.testing.assert_allclose(tp.emb.numpy(), np.asarray(jp.emb), atol=1e-5)
    np.testing.assert_allclose(tp.ctx.numpy(), np.asarray(jp.ctx), atol=1e-5)


def test_learning_rate_schedule_matches():
    toks, counts, pairs = _zipf_corpus()
    tt = SGNSTrainer(PairCorpus(Vocab(toks, counts), pairs), SGNSConfig(**SMALL),
                     device="cpu")
    nb = tt.num_batches
    for step in range(nb):
        frac = np.float32(step) / np.float32(nb)
        want = np.float32(0.025) * (np.float32(1) - frac) + np.float32(1e-4) * frac
        assert tt.learning_rate(step) == float(want)
    assert tt.learning_rate(0) == float(np.float32(0.025))


def _run(export_dir, num_iters=2, logs=None, txt=True):
    toks, counts, pairs = _zipf_corpus()
    cfg = SGNSConfig(**dict(SMALL, num_iters=num_iters, txt_output=txt))
    tr = SGNSTrainer(PairCorpus(Vocab(toks, counts), pairs), cfg, device="cpu")
    return tr.run(str(export_dir), log=(logs.append if logs is not None else print))


def test_export_is_read_by_the_unchanged_jax_side(tmp_path):
    params = _run(tmp_path)
    d = str(tmp_path)
    assert jckpt.latest_iteration(d, 16, verified_only=True) == 2
    for it in (1, 2):
        assert jsnap.verify_manifest(jckpt.ckpt_prefix(d, 16, it))
    jparams, jvocab, meta = jckpt.load_iteration(d, 16, 2)
    assert meta["table_dtype"] == "float32" and meta["iteration"] == 2
    assert str(jparams.emb.dtype) == "float32"
    np.testing.assert_array_equal(np.asarray(jparams.emb), params.emb.numpy())
    np.testing.assert_array_equal(np.asarray(jparams.ctx), params.ctx.numpy())
    toks, mat = read_word2vec_format(os.path.join(d, "gene2vec_dim_16_iter_2_w2v.txt"))
    assert toks == jvocab.id_to_token and len(toks) == V
    np.testing.assert_array_equal(mat, params.emb.numpy())
    assert [it for _, it, _ in jckpt.iter_checkpoints(d, verified_only=True)] == [1, 2]
    with open(os.path.join(d, "training_log.csv")) as f:
        rows = list(csv.DictReader(f))
    assert [int(r["step"]) for r in rows] == [1, 2]
    assert set(rows[0]) == {"loss", "pairs_per_sec", "seconds", "step", "time"}


def test_resume_trains_nothing_and_replays_exactly(tmp_path, capsys):
    full = _run(tmp_path / "a", txt=False)
    capsys.readouterr()
    again = _run(tmp_path / "a", txt=False)
    assert capsys.readouterr().out == "resuming from iteration 2\n"
    assert torch.equal(again.emb, full.emb)
    with open(tmp_path / "a" / "training_log.csv") as f:
        assert len(list(csv.DictReader(f))) == 2
    # interrupted after iteration 1, then resumed: the same tables
    _run(tmp_path / "b", num_iters=1, txt=False)
    logs = []
    resumed = _run(tmp_path / "b", logs=logs, txt=False)
    assert logs[0] == "resuming from iteration 1"
    assert torch.equal(resumed.emb, full.emb) and torch.equal(resumed.ctx, full.ctx)


def test_port_separates_planted_clusters():
    vocab, jcorpus = planted_corpus(pairs_per=1500)
    corpus = PairCorpus(Vocab(vocab.id_to_token, vocab.counts), jcorpus.pairs)
    cfg = SGNSConfig(dim=32, batch_pairs=1024, num_iters=12)
    tr = SGNSTrainer(corpus, cfg, device="cpu")
    params = tr.init()
    losses = []
    for it in range(1, 13):
        params, loss = tr.train_epoch(params, generator=torch.Generator().manual_seed(it))
        losses.append(float(loss))
    assert losses[-1] < np.log(2.0) * 6 - 1.0, losses
    intra, inter = cluster_cosines(vocab, params.emb.numpy())
    assert intra > INTRA_MIN and inter < INTER_MAX, (intra, inter)


def test_trainer_rejects_ids_and_draws_out_of_range():
    toks, counts, pairs = _zipf_corpus()
    bad = pairs.copy()
    bad[3, 1] = V
    with pytest.raises(ValueError, match="pair ids outside"):
        SGNSTrainer(PairCorpus(Vocab(toks, counts), bad), SGNSConfig(**SMALL),
                    device="cpu")
    tt = SGNSTrainer(PairCorpus(Vocab(toks, counts), pairs), SGNSConfig(**SMALL),
                     device="cpu")
    draws = tt.draw_epoch(torch.Generator().manual_seed(0))
    blocks = draws.blocks.copy()
    blocks[1, 2] = tt.stratified.nb
    p = tt.init()
    with pytest.raises(ValueError, match="draws.blocks outside"):
        tt.train_epoch(p, draws=draws._replace(blocks=blocks))
    with pytest.raises(ValueError, match="draws.blocks must be"):
        tt.train_epoch(p, draws=draws._replace(blocks=blocks[1:]))
