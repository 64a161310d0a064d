"""bfloat16 tables with stochastic rounding (SR) held against the JAX package
on the CPU: the SR write-back itself, one step of every objective and
noise mode with SR on and off, two epochs of both trainers under the
reference's own draws and salts, the planted clusters under bf16 + SR, and
bf16 exports read and resumed across the two packages (R3).

Salts are recomputed with the reference's key derivations:
``bits(fold_in(key, 0x51EB | 0x51EC), (2,), uint32)`` for the SGNS and cbow
steps (step.py:884-887, 207), ``bits`` of each half of
``split(fold_in(step_key, step))`` for hierarchical softmax
(cbow_hs.py:162-164, 339-343).

Tolerances.  The SR primitive and the nearest-even cast: bitwise.  One
step: loss rtol 1e-6; every table element equal to the reference's or one
bf16 ulp from it, on at most 1e-3 of the elements (the float32 ``new`` may
differ in its last bits, from sums taken in another order, and a carry
across the rounding threshold then moves one ulp).  One epoch of each
trainer: the one-step bar on the tables, against controls whose salts
are misaligned by a step.  Two epochs: losses rtol 1e-4; tables within
4 bf16 ulps of each row's largest element on all but 1e-3 of the
elements (an ulp moved in one step feeds the next)."""

import functools
import warnings

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
from gene2vec_tpu.sgns import cbow_hs as jcbow
from gene2vec_tpu.sgns import huffman as jhuff
from gene2vec_tpu.sgns import step as jstep
from gene2vec_tpu.sgns.model import SGNSParams as JParams
from gene2vec_tpu.sgns.train import SGNSTrainer as JTrainer
from gene2vec_tpu_torch.config import SGNSConfig
from gene2vec_tpu_torch.data import negative_sampling as tns
from gene2vec_tpu_torch.data.pipeline import PairCorpus, ShuffleDraw
from gene2vec_tpu_torch.io import checkpoint as tckpt
from gene2vec_tpu_torch.io.vocab import Vocab
from gene2vec_tpu_torch.kernels import row_update
from gene2vec_tpu_torch.sgns import cbow_hs as tcbow
from gene2vec_tpu_torch.sgns import step as tstep
from gene2vec_tpu_torch.sgns.model import from_jax_params, init_params, init_params_numpy
from gene2vec_tpu_torch.sgns.train import EpochDraws, SGNSTrainer

V, D, B, K = 257, 16, 128, 5
HEAD, BLOCK, GROUP = 32, 64, 32
ULP_SHARE = 1e-3          # elements one bf16 ulp from the reference, at most
LOSS_RTOL = 1e-6


def _u16(x) -> np.ndarray:
    """bfloat16 bits of a JAX/numpy bf16 array or a torch bf16 tensor."""
    if isinstance(x, torch.Tensor):
        return x.contiguous().view(torch.int16).numpy().view(np.uint16)
    return np.asarray(x).view(np.uint16)


def _ordered(bits: np.ndarray) -> np.ndarray:
    """bf16 bits → integers whose differences count ulps across the line."""
    mag = (bits & 0x7FFF).astype(np.int64)
    return np.where(bits & 0x8000, -mag, mag)


def ulp_diff(got, want) -> np.ndarray:
    return np.abs(_ordered(_u16(got)) - _ordered(_u16(want)))


def assert_within_one_ulp(got, want, label):
    """Every element equal or one bf16 ulp apart, on at most ULP_SHARE."""
    diff = ulp_diff(got, want)
    assert diff.max() <= 1, f"{label}: {int(diff.max())} ulps apart"
    share = float((diff > 0).mean())
    assert share <= ULP_SHARE, f"{label}: {share:.2e} of the elements one ulp apart"


def _salts(key) -> np.ndarray:
    return np.asarray(jax.random.bits(key, (2,), jnp.uint32)).astype(np.int64)


def _step_salts(key) -> np.ndarray:
    """The SGNS/cbow step's (2, 2) salts: emb's row, ctx's row."""
    return np.stack([_salts(jax.random.fold_in(key, 0x51EB)),
                     _salts(jax.random.fold_in(key, 0x51EC))])


def _hs_salts(sr_key) -> np.ndarray:
    """The HS step's (2, 2) salts: input table's row, node table's row."""
    return np.stack([_salts(k) for k in jax.random.split(sr_key)])


def _t(x, dtype=None):
    return torch.from_numpy(np.array(x, dtype=dtype))


# -- the SR write-back ---------------------------------------------------------


def _case(name, rng):
    if name == "mixed":        # negatives and positives over many binades, V != D
        return (rng.randn(61, 23) * np.exp(rng.randn(61, 23) * 3)).astype(np.float32)
    if name == "node_table":   # an HS node table: V - 1 rows
        return (rng.randn(60, 23) * 0.1).astype(np.float32)
    if name == "exact":        # already bf16 (rows a step never touched), ±0
        x = rng.randn(64, 7) * 3
        x[0, :4] = [0.0, -0.0, 65280.0, -1e-30]
        return np.asarray(jnp.asarray(x, jnp.bfloat16).astype(jnp.float32))
    if name == "halfway":      # exactly between two bf16 neighbours, either sign
        hi = _u16(jnp.asarray(rng.randn(40, 9) * 5, jnp.bfloat16)).astype(np.uint32)
        return ((hi << 16) | 0x8000).view(np.float32)
    raise ValueError(name)


CASES = ("mixed", "node_table", "exact", "halfway")


@pytest.mark.parametrize("case", CASES)
@pytest.mark.parametrize("seed", [0, 1, 7])
def test_sr_write_back_is_bitwise_the_reference(case, seed):
    x = _case(case, np.random.RandomState(seed))
    key = jax.random.PRNGKey(seed)
    want = jstep._stochastic_round_bf16(jnp.asarray(x), key)
    got = row_update.stochastic_round_bf16(torch.from_numpy(x), _salts(key))
    assert got.dtype == torch.bfloat16 and tuple(got.shape) == x.shape
    np.testing.assert_array_equal(_u16(got), _u16(want))
    if case == "exact":  # values already in bf16 pass through
        np.testing.assert_array_equal(got.float().numpy(), x)


@pytest.mark.parametrize("case", CASES)
def test_nearest_even_write_back_is_astype(case):
    x = _case(case, np.random.RandomState(3))
    table = torch.zeros(x.shape, dtype=torch.bfloat16)
    row_update.write_back(table, torch.from_numpy(x))
    np.testing.assert_array_equal(_u16(table), _u16(jnp.asarray(x).astype(jnp.bfloat16)))


@pytest.mark.parametrize("combiner", ["capped", "sum", "mean"])
@pytest.mark.parametrize("sr", [True, False])
def test_finalize_rows_matches_the_reference(combiner, sr):
    """K4's plain finalize of a bf16 table against ``_finalize_row_updates``
    on the same float32 accumulator: bitwise (same float32 ``new``, same
    rounding); untouched rows pass through."""
    rng = np.random.RandomState(4)
    rows = 45
    table = jnp.asarray(rng.randn(rows, D) * 0.2, jnp.bfloat16)
    acc = rng.randn(rows, D + 1).astype(np.float32)
    acc[:, D] = rng.randint(0, 80, rows)
    acc[::5] = 0.0  # untouched rows
    key = jax.random.PRNGKey(9)
    want = jstep._finalize_row_updates(table, jnp.asarray(acc), jnp.float32(0.0125),
                                       combiner, sr_key=key if sr else None)
    got = _t(np.asarray(table.astype(jnp.float32))).to(torch.bfloat16)
    row_update.finalize_rows(got, _t(acc), 0.0125, combiner, _salts(key) if sr else None)
    np.testing.assert_array_equal(_u16(got), _u16(want))
    np.testing.assert_array_equal(_u16(got)[::5], _u16(table)[::5])


# -- one step of every objective and noise mode ----------------------------------


def _zipf_pairs(v, n, seed=0):
    rng = np.random.RandomState(seed)
    p = 1.0 / np.arange(1, v + 1)
    p /= p.sum()
    return rng.choice(v, size=(n, 2), p=p).astype(np.int32)


def _bf16_tables(v, out_rows, d, seed=0):
    rng = np.random.RandomState(seed)
    emb = jnp.asarray(rng.uniform(-0.5 / d, 0.5 / d, (v, d)) * 40, jnp.bfloat16)
    ctx = jnp.asarray(rng.randn(out_rows, d) * 0.1, jnp.bfloat16)
    return JParams(emb=emb, ctx=ctx)


def _check_step(got, gloss, want, wloss, label):
    np.testing.assert_allclose(float(gloss), float(wloss), rtol=LOSS_RTOL)
    assert got.emb.dtype == torch.bfloat16 and got.ctx.dtype == torch.bfloat16
    assert_within_one_ulp(got.emb, want.emb, f"{label} emb")
    assert_within_one_ulp(got.ctx, want.ctx, f"{label} ctx")


@pytest.mark.parametrize("objective", ["sgns", "cbow"])
@pytest.mark.parametrize("mode", ["stratified", "shared", "per_example"])
@pytest.mark.parametrize("sr", [True, False], ids=["sr", "nearest"])
def test_sgns_step_matches(objective, mode, sr):
    """The SGNS step (and cbow's, the same step on the swapped pairs) on
    bf16 tables, each noise mode, SR on and off."""
    pairs = _zipf_pairs(V, B, seed=2)
    pairs[:45, 0] = 5  # a row past the capped divisor's 32 units
    if objective == "cbow":
        pairs = pairs[:, ::-1].copy()
    counts = np.bincount(pairs.reshape(-1), minlength=V).astype(np.int64) + 1
    jp = _bf16_tables(V, V, D)
    key = jax.random.PRNGKey(11)
    jnoise = jns.build_alias_table(jns.noise_distribution(counts))
    e = 2 * B
    kw = dict(negatives=K, negative_mode=mode, strat_group=GROUP)
    draws = {}
    if mode == "stratified":
        g = tstep.num_tail_groups(e, GROUP)
        spec_j = jns.build_stratified_spec(counts, HEAD, BLOCK)
        draws = dict(stratified=tns.build_stratified_spec(counts, HEAD, BLOCK),
                     blocks=_t(jax.random.randint(key, (g,), 0, spec_j.nb)))
        kw_j = dict(stratified=spec_j)
    else:
        shape = ((int(np.prod(tstep.shared_pool_layout(e, K))),) if mode == "shared"
                 else (e, K))
        draws = dict(negs=_t(jns.sample_negatives(jnoise, key, shape)))
        kw_j = {}
    want, wloss = jstep.sgns_step(jp, jnp.asarray(pairs), jnoise, key, jnp.float32(0.05),
                                  bf16_stochastic_round=sr, **kw, **kw_j)
    tp = from_jax_params(jp.emb, jp.ctx)
    got, gloss = tstep.sgns_step(tp, _t(pairs), 0.05, stochastic_round=sr,
                                 sr_salts=_step_salts(key) if sr else None, **kw, **draws)
    _check_step(got, gloss, want, wloss, f"{objective} {mode}")


def _hs_setup(depth, seed=0):
    pairs = _zipf_pairs(V, B, seed=seed)
    counts = np.bincount(pairs.reshape(-1), minlength=V).astype(np.int64) + 1
    tree = jhuff.build_huffman_tree(counts)
    if depth:
        s = jhuff.split_shallow(tree, depth)
        arrays = (s.points_deep, s.codes_deep, s.lengths_deep, s.sign, s)
    else:
        arrays = (tree.points, tree.codes, tree.lengths, None, None)
    return pairs, tree.num_nodes, arrays


@pytest.mark.parametrize("cbow", [False, True], ids=["sg_hs", "cbow_hs"])
@pytest.mark.parametrize("depth", [0, 3])
@pytest.mark.parametrize("sr", [True, False], ids=["sr", "nearest"])
def test_hs_step_matches(cbow, depth, sr):
    pairs, nodes, (pts, cds, lens, sign, split) = _hs_setup(depth, seed=1)
    pairs[:40, 1] = 0  # the hottest token's path in 80 examples: capped binds
    jp = _bf16_tables(V, nodes, D, seed=1)
    sr_key = jax.random.PRNGKey(5)
    jsign = None if sign is None else jnp.asarray(sign)
    want, wloss = jcbow.hs_step(
        jp, jnp.asarray(pairs), jnp.asarray(pts), jnp.asarray(cds), jnp.asarray(lens),
        jnp.float32(0.05), cbow=cbow, shallow_sign=jsign,
        n_shallow=split.n_shallow if split else 0,
        sr_key=sr_key if sr else None)
    tp = from_jax_params(jp.emb, jp.ctx)
    got, gloss = tcbow.hs_step(
        tp, _t(pairs), _t(pts), _t(cds), _t(lens), 0.05, cbow=cbow,
        shallow=None if split is None else tcbow.shallow_on(split, "cpu"),
        stochastic_round=sr, sr_salts=_hs_salts(sr_key) if sr else None)
    _check_step(got, gloss, want, wloss, "cbow_hs" if cbow else "sg_hs")


def test_step_draws_salts_and_checks_them():
    """Without ``sr_salts`` the step draws its four words from the
    generator (the same seed, the same tables); malformed salts raise;
    float32 tables and SR off take no salts."""
    pairs = _zipf_pairs(V, B, seed=6)
    counts = np.bincount(pairs.reshape(-1), minlength=V) + 1
    noise = tns.build_alias_table(tns.noise_distribution(counts))
    outs = []
    for _ in range(2):
        p = init_params_numpy(0, V, D, dtype=torch.bfloat16)
        p.ctx.copy_(p.emb * 3)
        p, _ = tstep.sgns_step(p, _t(pairs), 0.05, negative_mode="per_example",
                               noise=noise, generator=torch.Generator().manual_seed(3))
        outs.append(p.ctx.clone())
    assert torch.equal(outs[0], outs[1])
    with pytest.raises(ValueError, match="sr_salts"):
        tstep.sgns_step(p, _t(pairs), 0.05, negative_mode="per_example", noise=noise,
                        sr_salts=[[1, 2, 3]])
    with pytest.raises(ValueError, match="sr_salts"):
        tstep.sgns_step(p, _t(pairs), 0.05, negative_mode="per_example", noise=noise,
                        sr_salts=[[1, 2], [3, 1 << 32]])
    f32 = init_params_numpy(0, V, D)
    assert tstep.sr_salts_for(f32, None, True, None) is None
    assert tstep.sr_salts_for(p, None, False, None) is None
    assert tstep.sr_salts_for(p, np.array([[1, 2], [3, 4]]), True, None) == [[1, 2], [3, 4]]


def test_tables_carry_across_at_their_width():
    """init at bf16 rounds the float32 draw to nearest-even; a JAX bf16
    array crosses bit-exactly; ``dtype`` overrides the source's width."""
    p = init_params_numpy(0, 33, 8, dtype=torch.bfloat16)
    f = init_params_numpy(0, 33, 8)
    want = jnp.asarray(f.emb.numpy()).astype(jnp.bfloat16)
    np.testing.assert_array_equal(_u16(p.emb), _u16(want))
    assert p.ctx.dtype == torch.bfloat16 and not p.ctx.any()
    jp = _bf16_tables(33, 32, 8)
    tp = from_jax_params(jp.emb, jp.ctx)
    np.testing.assert_array_equal(_u16(tp.emb), _u16(jp.emb))
    np.testing.assert_array_equal(_u16(tp.ctx), _u16(jp.ctx))
    assert from_jax_params(jp.emb, jp.ctx, dtype="float32").emb.dtype == torch.float32
    g = init_params(torch.Generator().manual_seed(0), 33, 8, dtype="bfloat16")
    assert g.emb.dtype == g.ctx.dtype == torch.bfloat16


# -- two epochs of the trainers under the reference's draws and salts --------------


def _zipf_corpus(v=V, n=1100, seed=0):
    pairs = _zipf_pairs(v, n, seed)
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


def _jax_epoch_draws(jt, tt, key, noise, hs):
    """Every draw of the JAX trainer's jitted epoch from ``key``, the
    SR salts included."""
    cfg = jt.config
    shuffle_key, step_key = jax.random.split(key)
    if getattr(jt, "pos_quotas", None) is not None:  # the class-segmented layout
        pool_keys = jax.random.split(shuffle_key, len(jt.pairs))
        shuffles = tuple(
            _shuffle_draw(k, int(p.shape[0]), jt.num_batches, q, cfg.shuffle_mode)
            if q else None
            for p, k, q in zip(jt.pairs, pool_keys, jt.pos_quotas))
    else:
        shuffles = (_shuffle_draw(shuffle_key, jt.corpus.num_pairs, jt.num_batches,
                                  cfg.batch_pairs, cfg.shuffle_mode),)
    keys = [jax.random.fold_in(step_key, s) for s in range(jt.num_batches)]
    if hs:
        return EpochDraws(shuffles, salts=np.stack([_hs_salts(k) for k in keys]))
    salts = np.stack([_step_salts(k) for k in keys])
    if cfg.negative_mode == "stratified":
        blocks = np.stack([np.asarray(jax.random.randint(k, (tt.noise.num_groups,), 0,
                                                          tt.noise.stratified.nb))
                           for k in keys])
        return EpochDraws(shuffles, blocks=blocks, salts=salts)
    negs = np.stack([np.asarray(jns.sample_negatives(noise, k, tt.noise.draw_shape))
                     for k in keys])
    return EpochDraws(shuffles, negs=negs, salts=salts)


SMALL = dict(dim=D, batch_pairs=B, strat_head=HEAD, strat_block=BLOCK, strat_group=GROUP,
             num_iters=2, table_dtype="bfloat16")


def _assert_tables_close(got, want, label):
    """Within 4 bf16 ulps of each row's largest element, but on ULP_SHARE."""
    g = got.float().numpy().astype(np.float64)
    w = np.asarray(jnp.asarray(want).astype(jnp.float32), np.float64)
    scale = np.abs(w).max(1, keepdims=True) * 2.0 ** -8
    far = np.abs(g - w) > 4 * scale
    assert far.mean() <= ULP_SHARE, f"{label}: {far.mean():.2e} of the elements off"


@pytest.mark.parametrize("overrides", [
    {"objective": "sgns"},
    {"objective": "sgns", "negative_mode": "shared"},
    {"objective": "sgns", "negative_mode": "per_example", "bf16_stochastic_round": False},
    {"objective": "cbow", "negative_mode": "per_example"},
    {"objective": "sg_hs", "hs_dense_depth": 3},
    {"objective": "cbow_hs", "hs_dense_depth": 0, "bf16_stochastic_round": False},
], ids=["sgns_strat", "sgns_shared", "sgns_per_example_nearest", "cbow_per_example",
        "sg_hs_split", "cbow_hs_classic_nearest"])
def test_two_epochs_match_under_injected_draws(overrides, monkeypatch):
    """The default SGNS configuration (the class-segmented head/mid layout,
    whose one-hot products the JAX side runs at HIGHEST, as
    tests/test_torch_train.py does) and the other modes and objectives."""
    monkeypatch.setattr(jstep, "_DENSE_HEAD_PRECISION", jax.lax.Precision.HIGHEST)
    toks, counts, pairs = _zipf_corpus()
    kw = dict(SMALL, **overrides)
    jcfg = JConfig(**kw)
    hs = kw["objective"].endswith("_hs")
    if kw["objective"] == "sgns":
        jt = JTrainer(JCorpus(JVocab(toks, counts), pairs), jcfg)
        tt = SGNSTrainer(PairCorpus(Vocab(toks, counts), pairs), SGNSConfig(**kw),
                         device="cpu")
    else:
        jt = jcbow.CBOWHSTrainer(JCorpus(JVocab(toks, counts), pairs), jcfg)
        tt = tcbow.CBOWHSTrainer(PairCorpus(Vocab(toks, counts), pairs), SGNSConfig(**kw),
                                 device="cpu")
    assert tt.num_batches == jt.num_batches
    assert getattr(tt, "pos_quotas", None) == getattr(jt, "pos_quotas", None)
    init = tt.init()
    assert init.emb.dtype == init.ctx.dtype == torch.bfloat16
    jp = _bf16_tables(V, init.ctx.shape[0], D, seed=3)
    tp = from_jax_params(jp.emb, jp.ctx)
    for it in (1, 2):
        key = jax.random.fold_in(jax.random.PRNGKey(kw.get("seed", 1)), it)
        draws = _jax_epoch_draws(jt, tt, key, None if hs else jt.noise, hs)
        if not kw.get("bf16_stochastic_round", True):
            draws = draws._replace(salts=None)
        jp, jloss = jt.train_epoch(jp, key)
        tp, tloss = tt.train_epoch(tp, draws=draws)
        np.testing.assert_allclose(float(tloss), float(jloss), rtol=1e-4)
    assert jp.emb.dtype == jnp.bfloat16 and tp.emb.dtype == torch.bfloat16
    _assert_tables_close(tp.emb, jp.emb, "emb")
    _assert_tables_close(tp.ctx, jp.ctx, "ctx")


ONE_EPOCH = {
    "sgns_strat": {"objective": "sgns"},
    "cbow_per_example": {"objective": "cbow", "negative_mode": "per_example"},
    "sg_hs_split": {"objective": "sg_hs", "hs_dense_depth": 3},
    "cbow_hs_classic": {"objective": "cbow_hs", "hs_dense_depth": 0},
}


@functools.lru_cache(maxsize=None)
def _one_epoch_reference(case):
    """(port trainer, start tables, the epoch's draws, JAX tables and loss
    after one epoch from them) for ONE_EPOCH[case]."""
    toks, counts, pairs = _zipf_corpus()
    kw = dict(SMALL, **ONE_EPOCH[case])
    hs = kw["objective"].endswith("_hs")
    jcorpus, tcorpus = JCorpus(JVocab(toks, counts), pairs), PairCorpus(Vocab(toks, counts), pairs)
    if kw["objective"] == "sgns":
        jt, tt = JTrainer(jcorpus, JConfig(**kw)), SGNSTrainer(tcorpus, SGNSConfig(**kw),
                                                                device="cpu")
    else:
        jt = jcbow.CBOWHSTrainer(jcorpus, JConfig(**kw))
        tt = tcbow.CBOWHSTrainer(tcorpus, SGNSConfig(**kw), device="cpu")
    jp = _bf16_tables(V, tt.init().ctx.shape[0], D, seed=3)
    start = from_jax_params(jp.emb, jp.ctx)  # before the JAX epoch donates jp
    key = jax.random.fold_in(jax.random.PRNGKey(1), 1)
    draws = _jax_epoch_draws(jt, tt, key, None if hs else jt.noise, hs)
    jp, jloss = jt.train_epoch(jp, key)
    return tt, start, draws, (_u16(jp.emb), _u16(jp.ctx)), float(jloss)


@pytest.mark.parametrize("fault", ["none", "shifted", "repeated"])
@pytest.mark.parametrize("case", list(ONE_EPOCH))
def test_one_epoch_salts_align_with_the_reference(case, fault, monkeypatch):
    """One epoch through each trainer under the reference's draws: the
    tables within one ulp of the JAX trainer's on at most ULP_SHARE of the
    elements (they come out bitwise equal), so the salts reach step s as
    salts[s].  The controls — salts shifted by one step, or step 0's
    reused every step — fail that bar while the loss still agrees within
    the two-epoch test's rtol."""
    monkeypatch.setattr(jstep, "_DENSE_HEAD_PRECISION", jax.lax.Precision.HIGHEST)
    tt, start, draws, (jemb, jctx), jloss = _one_epoch_reference(case)
    salts = {"none": draws.salts, "shifted": np.roll(draws.salts, 1, axis=0),
             "repeated": np.repeat(draws.salts[:1], len(draws.salts), axis=0)}[fault]
    tp = type(start)(start.emb.clone(), start.ctx.clone())
    tp, tloss = tt.train_epoch(tp, draws=draws._replace(salts=salts))
    np.testing.assert_allclose(float(tloss), jloss, rtol=1e-4)
    if fault == "none":
        assert_within_one_ulp(tp.emb, jemb, f"{case} emb")
        assert_within_one_ulp(tp.ctx, jctx, f"{case} ctx")
    else:
        with pytest.raises(AssertionError, match="apart"):
            assert_within_one_ulp(tp.ctx, jctx, f"{case} ctx")


def test_trainer_draws_and_checks_salts():
    toks, counts, pairs = _zipf_corpus()
    corpus = PairCorpus(Vocab(toks, counts), pairs)
    tt = SGNSTrainer(corpus, SGNSConfig(**SMALL), device="cpu")
    draws = tt.draw_epoch(torch.Generator().manual_seed(0))
    assert draws.salts.shape == (tt.num_batches, 2, 2)
    assert draws.salts.min() >= 0 and draws.salts.max() < 1 << 32
    p = tt.init()
    with pytest.raises(ValueError, match="need draws.salts"):
        tt.train_epoch(p, draws=draws._replace(salts=None))
    with pytest.raises(ValueError, match="draws.salts must be"):
        tt.train_epoch(p, draws=draws._replace(salts=draws.salts[:1]))
    off = SGNSTrainer(corpus, SGNSConfig(**SMALL, bf16_stochastic_round=False), device="cpu")
    assert off.draw_epoch(torch.Generator().manual_seed(0)).salts is None
    f32 = SGNSTrainer(corpus, SGNSConfig(**dict(SMALL, table_dtype="float32")), device="cpu")
    d32 = f32.draw_epoch(torch.Generator().manual_seed(0))
    assert d32.salts is None
    # the float32 draws keep their stream: the salts are drawn last
    np.testing.assert_array_equal(d32.blocks, draws.blocks)


# -- the planted clusters under bf16 + SR (tests/test_stochastic_round.py:109) ---


def _planted_corpus(v=64, n=8192, seed=0):
    rng = np.random.RandomState(seed)
    half = v // 2
    pairs = np.concatenate([rng.randint(0, half, size=(n // 2, 2)),
                            rng.randint(half, v, size=(n // 2, 2))]).astype(np.int32)
    rng.shuffle(pairs)
    counts = np.bincount(pairs.reshape(-1), minlength=v).astype(np.int64)
    return PairCorpus(Vocab([f"G{i}" for i in range(v)], counts), pairs)


@pytest.mark.parametrize("negative_mode", ["stratified", "shared"])
def test_bf16_tables_learn_planted_clusters(negative_mode):
    """The reference's small-scale bf16 regime, where nearest rounding
    absorbs the updates: with SR on the port learns the two clusters."""
    cfg = SGNSConfig(dim=16, batch_pairs=512, lr=0.05, table_dtype="bfloat16",
                     negative_mode=negative_mode, positive_head=16, strat_head=8,
                     strat_block=16, strat_group=32)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        tr = SGNSTrainer(_planted_corpus(), cfg, device="cpu")
    params = tr.init()
    losses = []
    for it in range(8):
        params, loss = tr.train_epoch(params, generator=torch.Generator().manual_seed(it))
        losses.append(float(loss))
    assert params.emb.dtype == torch.bfloat16
    assert losses[-1] < losses[0] - 0.5, losses
    emb = params.emb.float().numpy()
    unit = emb / np.linalg.norm(emb, axis=1, keepdims=True)
    intra = np.mean(unit[:32] @ unit[:32].T)
    inter = np.mean(unit[:32] @ unit[32:].T)
    assert intra > inter + 0.3, (intra, inter)


# -- R3: bf16 exports across the two packages ---------------------------------------


def _export_corpus():
    toks, counts, pairs = _zipf_corpus(n=600)
    return toks, counts, pairs


def test_port_bf16_export_is_read_by_the_jax_loader(tmp_path):
    toks, counts, pairs = _export_corpus()
    cfg = SGNSConfig(**dict(SMALL, num_iters=1))
    params = SGNSTrainer(PairCorpus(Vocab(toks, counts), pairs), cfg, device="cpu").run(
        str(tmp_path), log=lambda s: None)
    d = str(tmp_path)
    jparams, _, meta = jckpt.load_iteration(d, D, 1)
    assert meta["table_dtype"] == "bfloat16"
    assert jparams.emb.dtype == jnp.bfloat16 and jparams.ctx.dtype == jnp.bfloat16
    np.testing.assert_array_equal(_u16(jparams.emb), _u16(params.emb))
    np.testing.assert_array_equal(_u16(jparams.ctx), _u16(params.ctx))
    # the port's own loader restores the recorded width, or casts with a warning
    tp, _, _ = tckpt.load_iteration(d, D, 1)
    assert tp.emb.dtype == torch.bfloat16 and torch.equal(tp.emb, params.emb)
    with pytest.warns(UserWarning, match="saved with table_dtype=bfloat16; resuming at "
                      "the configured float32"):
        t32, _, _ = tckpt.load_iteration(d, D, 1, table_dtype="float32")
    assert t32.emb.dtype == torch.float32 and torch.equal(t32.emb, params.emb.float())


@pytest.mark.parametrize("table_dtype", ["float32", "bfloat16"])
def test_jax_bf16_export_is_resumed_by_the_port(tmp_path, table_dtype):
    """A JAX-written bf16 export: the port's trainer resumes it at its
    configured width — bit-exact at bf16, cast with the reference's
    warning at float32 — instead of raising."""
    toks, counts, pairs = _export_corpus()
    jp = _bf16_tables(V, V, D, seed=5)
    d = str(tmp_path)
    jckpt.save_iteration(d, D, 1, jp, JVocab(toks, counts), txt_output=False)
    tt = SGNSTrainer(PairCorpus(Vocab(toks, counts), pairs),
                     SGNSConfig(**dict(SMALL, table_dtype=table_dtype)), device="cpu")
    logs = []
    if table_dtype == "float32":
        with pytest.warns(UserWarning, match="saved with table_dtype=bfloat16; resuming "
                          "at the configured float32"):
            params = tt.run(d, log=logs.append)
    else:
        with warnings.catch_warnings():
            warnings.simplefilter("error")
            params = tt.run(d, log=logs.append)
    assert logs[0] == "resuming from iteration 1"
    assert params.emb.dtype == getattr(torch, table_dtype)
    _, _, meta = jckpt.load_iteration(d, D, 2)
    assert meta["table_dtype"] == table_dtype


def test_cli_trains_bf16_tables(tmp_path, capsys):
    from gene2vec_tpu_torch.cli import gene2vec

    data = tmp_path / "data"
    data.mkdir()
    toks, _, pairs = _zipf_corpus(n=600)
    (data / "p.txt").write_text("".join(f"{toks[a]} {toks[b]}\n" for a, b in pairs))
    for flags in ([], ["--objective", "sg_hs"]):
        out = tmp_path / f"out{len(flags)}"
        assert gene2vec.main([str(data), str(out), "--device", "cpu", "--dim", "8",
                              "--iters", "2", "--batch-pairs", "64", "--no-txt-output",
                              "--table-dtype", "bfloat16", *flags]) == 0
        assert "iteration 2 done" in capsys.readouterr().out
        params, _, meta = jckpt.load_iteration(str(out), 8, 2)
        assert meta["table_dtype"] == "bfloat16" and params.emb.dtype == jnp.bfloat16


# -- chip_smoke.py's bf16 gate, K1's bound and the launch counts, on the CPU ----


def test_bf16_table_gate_allows_only_the_float32_error_of_new():
    """Past one bf16 ulp, an element passes only within the float32 error
    of new = t - lr·update: F32_ULPS float32 ulps of |t| + |t - new| plus
    TABLE_ULPS of the table's largest |t - new|.  In a table whose updates
    stay at 2e-4, a value of 1e-5 may move one ulp (row 1) but not three;
    where some update reaches 0.05, a value near zero where t - lr·update
    cancels may move several of its tiny ulps (row 0), and one of 1e-5
    three (row 3, beyond the element term alone)."""
    from chip_smoke import F32_ULPS, TABLE_ULPS, compare_bf16_tables

    t = torch.full((4, 1024), 0.05).to(torch.bfloat16)
    want = torch.full((4, 1024), 0.0498).to(torch.bfloat16)
    want[1, 0] = 1e-5
    t[1, 0] = want[1, 0].float() + 2e-4
    wide = want.clone()  # updates up to 0.05
    wide[0, 0], wide[3, 0] = 1.5e-9, 1e-5

    def moved(w, row, ulps):
        got = w.clone()
        bits = got[row, 0:1].view(torch.int16)
        got[row, 0:1] = (bits + ulps).view(torch.bfloat16)
        return got

    diff = float(moved(wide, 3, 3)[3, 0].float() - wide[3, 0].float())
    assert F32_ULPS * 2.0 ** -23 * 0.1 < diff < TABLE_ULPS * 2.0 ** -23 * 0.05
    for w, row, ulps in ((want, 1, 1), (want, 2, 1), (wide, 0, 5), (wide, 3, 3)):
        err, share = compare_bf16_tables(torch, "gate", [("t", moved(w, row, ulps), w)],
                                         start=(t,))
        assert share == 1 / 4096 and err > 0
    with pytest.raises(SystemExit, match="bf16 ulps"):
        compare_bf16_tables(torch, "gate", [("t", moved(want, 1, 3), want)], start=(t,))
    with pytest.raises(SystemExit, match="touched elements one ulp apart"):
        everywhere = (want.view(torch.int16) + 1).view(torch.bfloat16)
        compare_bf16_tables(torch, "gate", [("t", everywhere, want)], start=(t,))


def test_k1_bound_reads_each_distinct_row_once():
    from chip_smoke import k1_bytes

    c, x = np.array([3, 3, 3, 9]), np.array([1, 1, 2, 2])
    d = 8
    fixed = 4 * (2 * 4 + 2 * 4 * d + 2 * 4)  # ids; v, u; g_pos, loss
    assert k1_bytes(c, x, d, 2) == fixed + 2 * (2 + 2) * d
    assert k1_bytes(c, x, d, 4) == fixed + 4 * (2 + 2) * d


def test_launch_counts_derive_totals_and_variants():
    """Each variant's launches show under ``<name>_<variant>`` and in the
    entry point's total; reset zeroes every counter; a run's expected
    counts in chip_smoke follow the same rule."""
    from chip_smoke import expected_launches
    from gene2vec_tpu_torch import kernels

    kernels.reset_launch_counts()
    row_update.launches["row_finalize", "bf16_sr"] += 2
    row_update.launches["row_finalize", ""] += 1
    row_update.launches["row_scatter", ""] += 1
    kernels.MODULES["hs"].launches["hs", "bf16"] += 1
    counts = kernels.launch_counts()
    kernels.reset_launch_counts()
    assert counts == expected_launches(
        {"hs_bf16": 1, "row_scatter": 1, "row_finalize_bf16_sr": 2, "row_finalize": 1},
        1, counts)
    assert counts["row_finalize"] == 3 and counts["row_finalize_bf16_rn"] == 0
    assert not any(kernels.launch_counts().values())
    with pytest.raises(KeyError):
        expected_launches({"no_such_kernel": 1}, 1, counts)
