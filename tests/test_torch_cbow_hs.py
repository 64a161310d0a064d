"""The port's CBOW and hierarchical-softmax objectives (K6), and the
trainers of every non-default objective and noise mode, held against the
JAX package on the CPU.

The Huffman copies must be array identical.  The trainers run two epochs
under the reference's own draws, recomputed here with its key
derivations (``split(key)`` into shuffle and step keys,
``fold_in(step_key, step)`` per step; cbow_hs.py:309-365, train.py:83-124).
Tolerances: one step — tables within 1e-6 of each row's largest value,
loss within 1e-6 relative (float32 sums in another order); two epochs —
loss rtol 1e-5, tables atol 1e-5."""

import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from gene2vec_tpu.config import SGNSConfig as JConfig
from gene2vec_tpu.data import negative_sampling as jns
from gene2vec_tpu.data.pipeline import PairCorpus as JCorpus
from gene2vec_tpu.io import checkpoint as jckpt
from gene2vec_tpu.io.vocab import Vocab as JVocab
from gene2vec_tpu.resilience import snapshot as jsnap
from gene2vec_tpu.sgns import cbow_hs as jcbow
from gene2vec_tpu.sgns import huffman as jhuff
from gene2vec_tpu.sgns.model import SGNSParams as JParams
from gene2vec_tpu.sgns.train import SGNSTrainer as JTrainer
from gene2vec_tpu_torch.config import SGNSConfig
from gene2vec_tpu_torch.data.pipeline import PairCorpus, ShuffleDraw
from gene2vec_tpu_torch.io.vocab import Vocab
from gene2vec_tpu_torch.kernels import hs as khs
from gene2vec_tpu_torch.sgns import cbow_hs as tcbow
from gene2vec_tpu_torch.sgns import huffman as thuff
from gene2vec_tpu_torch.sgns.model import from_jax_params
from gene2vec_tpu_torch.sgns.train import EpochDraws, SGNSTrainer

V, N, D, B = 257, 1100, 16, 128
SMALL = dict(dim=D, batch_pairs=B, strat_head=32, strat_block=64, strat_group=32,
             num_iters=2)


def _zipf_corpus(v=V, n=N, seed=0):
    rng = np.random.RandomState(seed)
    p = 1.0 / np.arange(1, v + 1)
    p /= p.sum()
    pairs = rng.choice(v, size=(n, 2), p=p).astype(np.int32)
    counts = np.bincount(pairs.reshape(-1), minlength=v).astype(np.int64) + 1
    return [f"G{i}" for i in range(v)], counts, pairs


def _t(x):
    return torch.from_numpy(np.array(x))


def assert_rows_close(got, want, rtol=1e-6):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    err = np.abs(got - want).reshape(len(want), -1).max(1)
    lim = rtol * np.abs(want).reshape(len(want), -1).max(1)
    bad = np.flatnonzero(err > lim)
    assert bad.size == 0, f"rows {bad[:5]}: err {err[bad[:5]]} > {lim[bad[:5]]}"


# -- the Huffman copy -----------------------------------------------------------


@pytest.mark.parametrize("counts", [
    [4], [2, 2], [5, 5, 5, 5, 5], [1, 2, 3, 4, 5, 6, 7, 8],
    list(_zipf_corpus()[1]), list(np.arange(600, 0, -1) ** 2),
], ids=["single", "pair", "ties", "ramp", "zipf", "square"])
def test_huffman_and_split_are_array_identical(counts):
    want = jhuff.build_huffman_tree(np.asarray(counts))
    got = thuff.build_huffman_tree(np.asarray(counts))
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    if want.num_nodes <= 1:
        return
    for depth in (1, 3, 10, 40):
        ws, gs = jhuff.split_shallow(want, depth), thuff.split_shallow(got, depth)
        for g, w in zip(gs, ws):
            np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("counts", [
    [2, 2], [5, 5, 5, 5, 5], [1, 2, 3, 4, 5, 6, 7, 8],
    list(_zipf_corpus()[1]), list(np.arange(600, 0, -1) ** 2),
], ids=["pair", "ties", "ramp", "zipf", "square"])
def test_shallow_paths_are_the_sign_rows_in_level_order(counts):
    """K6's compact shallow layout: scattered back it is the reference's
    ``split_shallow`` sign matrix entry for entry, and each row's ids are
    the tree's first levels of that token's path, root first."""
    tree = jhuff.build_huffman_tree(np.asarray(counts))
    for depth in (1, 3, 10, 40):
        split = jhuff.split_shallow(tree, depth)
        paths = thuff.shallow_paths(split)
        assert paths.ids.dtype == np.int32 and paths.signs.dtype == np.int8
        assert paths.n_shallow == split.n_shallow
        back = np.zeros_like(split.sign)
        rows = np.repeat(np.arange(len(back)), paths.ids.shape[1])
        back[rows, paths.ids.reshape(-1)] += paths.signs.reshape(-1)
        np.testing.assert_array_equal(back, split.sign)
        n = np.minimum(tree.lengths, depth)
        for t in range(len(n)):
            np.testing.assert_array_equal(paths.ids[t, :n[t]],
                                          split.perm[tree.points[t, :n[t]]])
            np.testing.assert_array_equal(paths.signs[t, :n[t]],
                                          1 - 2 * tree.codes[t, :n[t]])
            assert not paths.signs[t, n[t]:].any() and not paths.ids[t, n[t]:].any()


# -- K6 and the HS step ---------------------------------------------------------


def _hs_setup(depth, seed=0, v=V, d=D):
    toks, counts, pairs = _zipf_corpus(v)
    tree = jhuff.build_huffman_tree(counts)
    rng = np.random.RandomState(seed)
    emb = (rng.randn(v, d) * 0.1).astype(np.float32)
    node = (rng.randn(tree.num_nodes, d) * 0.1).astype(np.float32)
    if depth:
        s = jhuff.split_shallow(tree, depth)
        arrays = (s.points_deep, s.codes_deep, s.lengths_deep, s.sign, s)
    else:
        arrays = (tree.points, tree.codes, tree.lengths, None, None)
    return pairs[:B], emb, node, arrays


@pytest.mark.parametrize("depth", [0, 3, 10])
def test_k6_plain_matches_jax(depth):
    pairs, emb, node, (pts, cds, lens, sign, split) = _hs_setup(depth)
    ns = split.n_shallow if split else 0
    inputs, targets = pairs[:, 0], pairs[:, 1]
    loss, d_input, d_node, jpts, mask = jcbow.hs_loss_and_grads(
        jnp.asarray(emb), jnp.asarray(node), jnp.asarray(inputs), jnp.asarray(targets),
        jnp.asarray(pts), jnp.asarray(cds), jnp.asarray(lens))
    acc = torch.zeros((node.shape[0], D + 1))
    di, ld, ls = khs.hs(_t(emb), _t(node), _t(inputs), _t(targets), _t(pts), _t(cds),
                        _t(lens), None if split is None else tcbow.shallow_on(split, "cpu"),
                        acc)
    np.testing.assert_allclose(float(ld.mean()), float(loss), rtol=1e-6)
    want_acc = jnp.zeros((node.shape[0], D + 1)).at[jpts.reshape(-1)].add(
        jnp.concatenate([d_node.reshape(-1, D), mask.reshape(-1, 1)], axis=1))
    if sign is None:
        assert ls is None
        assert_rows_close(di.numpy(), d_input)
        np.testing.assert_allclose(acc.numpy(), np.asarray(want_acc), rtol=1e-6, atol=1e-7)
        return
    # the dense shallow levels (cbow_hs.py:149-160, 205-208)
    v = jnp.asarray(emb)[inputs]
    w_s = jnp.asarray(node)[:ns]
    s = jnp.asarray(sign)[targets].astype(jnp.float32)
    logit_s = v @ w_s.T
    loss_s = jnp.sum(jnp.abs(s) * jax.nn.softplus(-s * logit_s), axis=-1)
    g_s = jnp.abs(s) * (jax.nn.sigmoid(logit_s) - (1.0 + s) / 2.0)
    np.testing.assert_allclose(ls.numpy(), np.asarray(loss_s), rtol=1e-6, atol=1e-7)
    assert_rows_close(di.numpy(), d_input + g_s @ w_s)
    want_acc = want_acc.at[:ns, :D].add(g_s.T @ v).at[:ns, D].add(jnp.sum(jnp.abs(s), 0))
    np.testing.assert_allclose(acc.numpy(), np.asarray(want_acc), rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("depth", [3, 10])
def test_k6_bound_counts_only_on_path_entries(depth):
    """``chip_smoke.hs_work`` counts K6's work by the reference's paths:
    each target's shallow entries are its path length less its deep
    length, not every shallow column of its sign row."""
    from chip_smoke import hs_work

    _, counts, pairs = _zipf_corpus()
    tree = jhuff.build_huffman_tree(counts)
    split = jhuff.split_shallow(tree, depth)
    inputs, targets = pairs[:B, 0], pairs[:B, 1]
    work = hs_work(thuff.split_shallow(thuff.build_huffman_tree(counts), depth),
                   inputs, targets, D)
    deep = int(split.lengths_deep[targets].sum())
    shallow = int((tree.lengths[targets] - split.lengths_deep[targets]).sum())
    assert (work["deep_entries"], work["shallow_entries"]) == (deep, shallow)
    assert work["flops"] == 6 * shallow * D + 5 * deep * D
    assert shallow <= depth * B < B * split.n_shallow


@pytest.mark.parametrize("cbow", [False, True], ids=["sg_hs", "cbow_hs"])
@pytest.mark.parametrize("depth", [0, 3, 10])
@pytest.mark.parametrize("combiner", ["capped", "sum"])
def test_hs_step_matches(cbow, depth, combiner):
    pairs, emb, node, (pts, cds, lens, sign, split) = _hs_setup(depth, seed=1)
    ns = split.n_shallow if split else 0
    pairs = pairs.copy()
    pairs[:40, 1] = 0  # the hottest token's path in 80 examples: capped binds
    jp = JParams(emb=jnp.asarray(emb), ctx=jnp.asarray(node))
    kw = dict(cbow=cbow, combiner=combiner)
    want, wloss = jcbow.hs_step(
        jp, jnp.asarray(pairs), jnp.asarray(pts), jnp.asarray(cds), jnp.asarray(lens),
        jnp.float32(0.05), shallow_sign=None if sign is None else jnp.asarray(sign),
        n_shallow=ns, **kw)
    tp = from_jax_params(emb, node)
    got, gloss = tcbow.hs_step(
        tp, _t(pairs), _t(pts), _t(cds), _t(lens), 0.05,
        shallow=None if split is None else tcbow.shallow_on(split, "cpu"), **kw)
    np.testing.assert_allclose(float(gloss), float(wloss), rtol=1e-6)
    assert_rows_close(got.emb.numpy(), want.emb)
    assert_rows_close(got.ctx.numpy(), want.ctx)


# -- the trainers under the reference's draws -----------------------------------


def _shuffle_draw(key, num_pairs, num_batches, batch_pairs, mode):
    """The draws inside ``gene2vec_tpu.data.pipeline.epoch_shuffle``."""
    span = num_batches * batch_pairs
    if mode == "full":
        return ShuffleDraw(0, np.asarray(jax.random.permutation(key, num_pairs)[:span]))
    off_key, blk_key = jax.random.split(key)
    block = 512 if span % 512 == 0 else batch_pairs
    return ShuffleDraw(int(jax.random.randint(off_key, (), 0, num_pairs)),
                       np.asarray(jax.random.permutation(blk_key, span // block)))


def _jax_draws(jt, tt, key, noise):
    """The draws the JAX trainer's jitted epoch makes from ``key``."""
    cfg = jt.config
    shuffle_key, step_key = jax.random.split(key)
    shuffles = (_shuffle_draw(shuffle_key, jt.corpus.num_pairs, jt.num_batches,
                              cfg.batch_pairs, cfg.shuffle_mode),)
    keys = [jax.random.fold_in(step_key, s) for s in range(jt.num_batches)]
    if getattr(tt, "hs", False):
        return EpochDraws(shuffles)
    if cfg.negative_mode == "stratified":
        blocks = np.stack([np.asarray(jax.random.randint(k, (tt.noise.num_groups,), 0,
                                                          tt.noise.stratified.nb))
                           for k in keys])
        return EpochDraws(shuffles, blocks=blocks)
    negs = np.stack([np.asarray(jns.sample_negatives(noise, k, tt.noise.draw_shape))
                     for k in keys])
    return EpochDraws(shuffles, negs=negs)


def _start_tables(v, d, out_rows, seed=3):
    rng = np.random.RandomState(seed)
    emb = rng.uniform(-0.5 / d, 0.5 / d, (v, d)).astype(np.float32)
    ctx = (rng.randn(out_rows, d) * 0.05).astype(np.float32)
    return emb, ctx


@pytest.mark.parametrize("overrides", [
    {"objective": "sg_hs", "hs_dense_depth": 0},
    {"objective": "cbow_hs", "hs_dense_depth": 3},
    {"objective": "sg_hs", "shuffle_mode": "full", "combiner": "mean"},
    {"objective": "cbow", "negative_mode": "stratified"},
    {"objective": "cbow", "negative_mode": "per_example"},
    {"objective": "cbow", "negative_mode": "shared"},
    {"objective": "sgns", "negative_mode": "per_example"},
    {"objective": "sgns", "negative_mode": "shared", "combiner": "sum"},
], ids=["sg_hs_classic", "cbow_hs_split", "sg_hs_full_mean", "cbow_strat",
        "cbow_per_example", "cbow_shared", "sgns_per_example", "sgns_shared_sum"])
def test_two_epochs_match_under_injected_draws(overrides):
    toks, counts, pairs = _zipf_corpus()
    kw = dict(SMALL, **overrides)
    jcfg = JConfig(**kw)
    if kw["objective"] == "sgns":
        jt = JTrainer(JCorpus(JVocab(toks, counts), pairs), jcfg)
        tt = SGNSTrainer(PairCorpus(Vocab(toks, counts), pairs), SGNSConfig(**kw),
                         device="cpu")
        assert tt.pos_quotas is None and jt.pos_quotas is None
        noise = jt.noise
    else:
        jt = jcbow.CBOWHSTrainer(JCorpus(JVocab(toks, counts), pairs), jcfg)
        tt = tcbow.CBOWHSTrainer(PairCorpus(Vocab(toks, counts), pairs), SGNSConfig(**kw),
                                 device="cpu")
        noise = None if tt.hs else jt.noise
    assert tt.num_batches == jt.num_batches
    out_rows = tt.init().ctx.shape[0]
    assert out_rows == jt.init().ctx.shape[0]
    emb, ctx = _start_tables(V, D, out_rows)
    jp = JParams(emb=jnp.asarray(emb), ctx=jnp.asarray(ctx))
    tp = from_jax_params(emb, ctx)
    for it in (1, 2):
        key = jax.random.fold_in(jax.random.PRNGKey(kw.get("seed", 1)), it)
        draws = _jax_draws(jt, tt, key, noise)
        jp, jloss = jt.train_epoch(jp, key)
        tp, tloss = tt.train_epoch(tp, draws=draws)
        np.testing.assert_allclose(float(tloss), float(jloss), rtol=1e-5)
    np.testing.assert_allclose(tp.emb.numpy(), np.asarray(jp.emb), atol=1e-5)
    np.testing.assert_allclose(tp.ctx.numpy(), np.asarray(jp.ctx), atol=1e-5)


def test_trainers_check_their_draws_and_objective():
    toks, counts, pairs = _zipf_corpus()
    corpus = PairCorpus(Vocab(toks, counts), pairs)
    tt = SGNSTrainer(corpus, SGNSConfig(**SMALL, negative_mode="per_example"), device="cpu")
    draws = tt.draw_epoch(torch.Generator().manual_seed(0))
    assert draws.negs is None and draws.neg_seed is not None and draws.blocks is None
    bad = np.zeros((tt.num_batches, 2 * B, 5), np.int32)
    bad[0, 0, 0] = V
    p = tt.init()
    with pytest.raises(ValueError, match="draws.negs outside"):
        tt.train_epoch(p, draws=draws._replace(negs=bad))
    with pytest.raises(ValueError, match="draws.negs must be"):
        tt.train_epoch(p, draws=draws._replace(negs=bad[:, :3]))
    # the device generator's stream replays from the same seed
    a = tt.train_epoch(tt.init(), draws=draws)
    b = tt.train_epoch(tt.init(), draws=draws)
    assert float(a[1]) == float(b[1]) and torch.equal(a[0].ctx, b[0].ctx)
    with pytest.raises(NotImplementedError, match="CBOWHSTrainer"):
        SGNSTrainer(corpus, SGNSConfig(**SMALL, objective="sg_hs"), device="cpu")
    with pytest.raises(ValueError, match="not in"):
        tcbow.CBOWHSTrainer(corpus, SGNSConfig(**SMALL), device="cpu")
    assert isinstance(tcbow.make_trainer(corpus, SGNSConfig(**SMALL), device="cpu"),
                      SGNSTrainer)
    assert isinstance(tcbow.make_trainer(corpus, SGNSConfig(**SMALL, objective="cbow"),
                                         device="cpu"), tcbow.CBOWHSTrainer)


# -- resume and exports ------------------------------------------------------------


def _hs_run(export_dir, num_iters=2, depth=3, logs=None):
    toks, counts, pairs = _zipf_corpus()
    cfg = SGNSConfig(**dict(SMALL, objective="sg_hs", hs_dense_depth=depth,
                            num_iters=num_iters))
    tr = tcbow.CBOWHSTrainer(PairCorpus(Vocab(toks, counts), pairs), cfg, device="cpu")
    return tr.run(str(export_dir), log=(logs.append if logs is not None else print))


def test_hs_export_is_read_and_resumed_by_the_jax_side(tmp_path):
    logs = []
    params = _hs_run(tmp_path, num_iters=1, logs=logs)
    assert logs[0].startswith("gene2vec [sg_hs] dimension 16 iteration 1 done: loss=")
    d = str(tmp_path)
    assert jckpt.latest_iteration(d, D, verified_only=True) == 1
    assert jsnap.verify_manifest(jckpt.ckpt_prefix(d, D, 1))
    jparams, _, meta = jckpt.load_iteration(d, D, 1)
    assert meta["objective"] == "sg_hs" and meta["hs_dense_depth"] == 3
    assert jparams.ctx.shape == (V - 1, D)
    np.testing.assert_array_equal(np.asarray(jparams.emb), params.emb.numpy())
    np.testing.assert_array_equal(np.asarray(jparams.ctx), params.ctx.numpy())
    toks, counts, pairs = _zipf_corpus()
    jcfg = JConfig(**dict(SMALL, objective="sg_hs", hs_dense_depth=3, num_iters=2))
    jt = jcbow.CBOWHSTrainer(JCorpus(JVocab(toks, counts), pairs), jcfg)
    jlogs = []
    jt.run(d, log=jlogs.append)
    assert jlogs[0] == "resuming from iteration 1"
    assert jckpt.latest_iteration(d, D, verified_only=True) == 2


def test_hs_resume_refuses_another_depth_and_replays(tmp_path):
    full = _hs_run(tmp_path / "a")
    _hs_run(tmp_path / "b", num_iters=1)
    logs = []
    resumed = _hs_run(tmp_path / "b", logs=logs)
    assert logs[0] == "resuming from iteration 1"
    assert torch.equal(resumed.emb, full.emb) and torch.equal(resumed.ctx, full.ctx)
    with pytest.raises(ValueError, match="hs_dense_depth=3, config has 2"):
        _hs_run(tmp_path / "a", num_iters=3, depth=2)
    assert not os.path.exists(tmp_path / "a" / f"gene2vec_dim_{D}_iter_3.npz")


# -- the CLI -----------------------------------------------------------------------


@pytest.mark.parametrize("flags,tag", [
    (["--objective", "sg_hs"], "sg_hs"),
    (["--negative-mode", "per_example"], "sgns"),
    (["--objective", "cbow_hs", "--hs-dense-depth", "0"], "cbow_hs"),
])
def test_cli_trains_each_objective_on_the_cpu(tmp_path, capsys, flags, tag):
    from gene2vec_tpu_torch.cli import gene2vec

    data = tmp_path / "data"
    data.mkdir()
    toks, _, pairs = _zipf_corpus(n=600)
    (data / "p.txt").write_text("".join(f"{toks[a]} {toks[b]}\n" for a, b in pairs))
    out = tmp_path / "out"
    assert gene2vec.main([str(data), str(out), "--device", "cpu", "--dim", "8", "--iters",
                          "2", "--batch-pairs", "64", "--no-txt-output", *flags]) == 0
    assert "iteration 2 done" in capsys.readouterr().out
    _, _, meta = jckpt.load_iteration(str(out), 8, 2)
    assert meta.get("objective", "sgns") == tag
