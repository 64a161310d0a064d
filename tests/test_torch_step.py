"""The port's stratified SGNS step held against the JAX package on the CPU.

Each kernel's plain PyTorch version (what a CPU tensor runs) is checked
against the JAX expression it replaces, then the whole ``sgns_step`` for
the plain-gather, head-only and head+mid batch layouts, all combiners, a
row duplicated past the capped divisor's 32, and a vocab whose last tail
block clamps and overlaps.  The JAX step draws its tail blocks inside;
the tests recompute them with ``jax.random.randint(key, (G,), 0, nb)``
and hand them to the port.  Where the JAX step takes its dense-slab path
its matmul precision is pinned to HIGHEST, as tests/test_dense_head.py
does.  Tolerances: one step — loss rtol 1e-5, tables atol 2e-6 (float32
sums in another order)."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from gene2vec_tpu.data.negative_sampling import NoiseTable
from gene2vec_tpu.data.negative_sampling import build_stratified_spec as jax_spec
from gene2vec_tpu.data.pipeline import segment_corpus_by_head as jax_segment
from gene2vec_tpu.sgns import step as jstep
from gene2vec_tpu.sgns.model import SGNSParams as JParams
from gene2vec_tpu.sgns.model import init_params_numpy
from gene2vec_tpu_torch.data.negative_sampling import build_stratified_spec
from gene2vec_tpu_torch.kernels import noise_head, noise_tail, pos_logit, row_update
from gene2vec_tpu_torch.sgns import step as tstep
from gene2vec_tpu_torch.sgns.model import from_jax_params

V, D, B = 257, 16, 128
HEAD, BLOCK, GROUP, K = 32, 64, 32, 5


def _zipf_pairs(v, n, seed=0):
    rng = np.random.RandomState(seed)
    p = 1.0 / np.arange(1, v + 1)
    p /= p.sum()
    return rng.choice(v, size=(n, 2), p=p).astype(np.int32)


def _counts(pairs, v=V):
    return np.bincount(pairs.reshape(-1), minlength=v).astype(np.int64) + 1


def _params(seed=0, v=V, d=D):
    """init_params_numpy emb with a non-zero ctx, so every product moves."""
    p = init_params_numpy(seed, v, d)
    ctx = np.random.RandomState(seed + 1).randn(v, d).astype(np.float32) * 0.1
    return JParams(emb=p.emb, ctx=jnp.asarray(ctx))


def _t(x, dtype=None):
    return torch.from_numpy(np.array(x, dtype=dtype))


def _key_with(nb, g, need_last=True):
    """A step key whose tail draw includes the clamped last block and a
    repeated block."""
    for s in range(200):
        key = jax.random.PRNGKey(s)
        b = np.asarray(jax.random.randint(key, (g,), 0, nb))
        if (not need_last or (b == nb - 1).any()) and len(set(b.tolist())) < g:
            return key, b.astype(np.int32)
    raise AssertionError("no suitable key")


# -- the plain versions against the JAX expressions ---------------------------


def test_k1_plain_matches_jax():
    p = _params()
    pairs = _zipf_pairs(V, B)
    c, x = pairs[:, 0], pairs[:, 1]
    v = p.emb[c]
    u = p.ctx[x]
    logit = jnp.sum(v * u, axis=-1)
    got = pos_logit.pos_logit(_t(p.emb), _t(p.ctx), _t(c), _t(x))
    want = (v, u, jax.nn.sigmoid(logit) - 1.0, jax.nn.softplus(-logit))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-6, atol=1e-7)


def test_k2_plain_matches_jax():
    p = _params()
    pairs = _zipf_pairs(V, B)
    spec = jax_spec(_counts(pairs), HEAD, BLOCK)
    c, x = jnp.asarray(pairs[:, 0]), jnp.asarray(pairs[:, 1])
    v, u = p.emb[c], p.ctx[x]
    g_pos = jax.nn.sigmoid(jnp.sum(v * u, -1)) - 1.0
    k = jnp.float32(K)
    # gene2vec_tpu/sgns/step.py:736-746, 782-786, 828-831
    ctx_head, q_head = p.ctx[:HEAD], spec.q[:HEAD]
    logit = v @ ctx_head.T
    mask = (jnp.arange(HEAD)[None, :] != x[:, None]).astype(jnp.float32)
    g_head = k * q_head[None, :] * jax.nn.sigmoid(logit) * mask
    loss_head = k * jnp.sum(q_head[None, :] * mask * jax.nn.softplus(logit), -1)
    d_center = g_pos[:, None] * u + g_head @ ctx_head
    acc = jnp.zeros((V, D + 1)).at[:HEAD, :D].add(g_head.T @ v)
    acc = acc.at[:HEAD, D].add(k * q_head * jnp.sum(mask, axis=0))

    t_acc = torch.zeros((V, D + 1))
    dc, lh = noise_head.noise_head(
        _t(v), _t(u), _t(g_pos), _t(x), _t(p.ctx), _t(spec.q), HEAD, K, t_acc
    )
    np.testing.assert_allclose(dc.numpy(), np.asarray(d_center), rtol=1e-5, atol=1e-7)
    np.testing.assert_allclose(lh.numpy(), np.asarray(loss_head), rtol=1e-5, atol=1e-7)
    np.testing.assert_allclose(t_acc.numpy(), np.asarray(acc), rtol=1e-5, atol=1e-7)


@pytest.mark.parametrize("blocks", [[3, 3, 0, 1, 3, 2, 2, 0], [1, 1, 1, 1, 1, 1, 1, 1]])
def test_k3_plain_matches_jax_block_aggregation(blocks):
    """Against step.py:748-777, 833-847 with the reference's (nb, G)
    one-hot aggregation (_aggregate_tail_blocks): the port adds each
    group's payload straight into the accumulator, duplicates and the
    clamped, overlapping last block included."""
    p = _params()
    pairs = _zipf_pairs(V, B)
    spec = jax_spec(_counts(pairs), HEAD, BLOCK)
    nb, e = spec.nb, 2 * B
    assert nb == 4 and V - HEAD < nb * BLOCK  # the last block overlaps
    g = e // GROUP
    blk = jnp.asarray(np.array(blocks, np.int32))
    x = jnp.concatenate([jnp.asarray(pairs[:, 1]), jnp.asarray(pairs[:, 0])])
    v = p.emb[jnp.concatenate([jnp.asarray(pairs[:, 0]), jnp.asarray(pairs[:, 1])])]
    k = jnp.float32(K)
    starts = jnp.minimum(HEAD + blk * BLOCK, V - BLOCK)
    ctx_blk = jax.vmap(lambda s: jax.lax.dynamic_slice(p.ctx, (s, 0), (BLOCK, D)))(starts)
    w_blk = jax.vmap(lambda s: jax.lax.dynamic_slice(spec.tail_w, (s,), (BLOCK,)))(starts)
    vg, cg = v.reshape(g, e // g, D), x.reshape(g, e // g)
    logit = jnp.einsum("ged,gsd->ges", vg, ctx_blk)
    row_ids = starts[:, None] + jnp.arange(BLOCK)[None, :]
    mask = (row_ids[:, None, :] != cg[:, :, None]).astype(jnp.float32)
    w_tail = k * w_blk[:, None, :]
    g_tail = w_tail * jax.nn.sigmoid(logit) * mask
    loss_tail = jnp.sum(w_tail * mask * jax.nn.softplus(logit), -1).reshape(e)
    d_tail = jnp.einsum("ges,gsd->ged", g_tail, ctx_blk).reshape(e, D)
    payload = jnp.concatenate([
        jnp.einsum("ges,ged->gsd", g_tail, vg),
        (w_tail[:, 0, :] * jnp.sum(mask, axis=1))[:, :, None],
    ], axis=2)
    acc_blocks = jstep._aggregate_tail_blocks(blk, payload, nb)
    acc = jnp.zeros((V, D + 1)).at[HEAD : HEAD + (nb - 1) * BLOCK].add(
        acc_blocks[:-1].reshape((nb - 1) * BLOCK, D + 1)
    )
    acc = acc.at[V - BLOCK : V].add(acc_blocks[-1])

    t_dc = torch.zeros((e, D))
    t_acc = torch.zeros((V, D + 1))
    lt = noise_tail.noise_tail(
        _t(v), _t(x), _t(p.ctx), _t(spec.tail_w), _t(blk), HEAD, BLOCK, e // g,
        K, t_dc, t_acc,
    )
    np.testing.assert_allclose(lt.numpy(), np.asarray(loss_tail), rtol=1e-5, atol=1e-7)
    np.testing.assert_allclose(t_dc.numpy(), np.asarray(d_tail), rtol=1e-5, atol=1e-7)
    np.testing.assert_allclose(t_acc.numpy(), np.asarray(acc), rtol=1e-5, atol=2e-7)


@pytest.mark.parametrize("combiner", ["capped", "sum", "mean"])
def test_k4_plain_matches_jax(combiner):
    rng = np.random.RandomState(4)
    e = 2 * B
    emb = rng.randn(V, D).astype(np.float32)
    ctx = rng.randn(V, D).astype(np.float32)
    centers = rng.randint(0, V, e).astype(np.int32)
    centers[:40] = 7  # 40 > 32 duplicates: the capped divisor binds
    contexts = rng.randint(0, V, e).astype(np.int32)
    d_center = rng.randn(e, D).astype(np.float32)
    v = rng.randn(e, D).astype(np.float32)
    g_pos = rng.randn(e).astype(np.float32)
    acc_ctx0 = np.zeros((V, D + 1), np.float32)
    acc_ctx0[:HEAD] = rng.rand(HEAD, D + 1) * 50  # noise rows + heavy weights
    lr = 0.0125
    want_emb = jstep._apply_row_updates(
        jnp.asarray(emb), jnp.asarray(centers), jnp.asarray(d_center),
        jnp.ones((e,)), lr, combiner, jnp.float32,
    )
    acc = jstep._scatter_accumulator(
        V, jnp.asarray(contexts), jnp.asarray(g_pos)[:, None] * jnp.asarray(v),
        jnp.ones((e,)), jnp.float32,
    ) + jnp.asarray(acc_ctx0)
    want_ctx = jstep._finalize_row_updates(jnp.asarray(ctx), acc, lr, combiner)
    t = [_t(emb), _t(ctx), torch.zeros((V, D + 1)), _t(acc_ctx0)]
    row_update.row_update(*t, _t(centers), _t(contexts), _t(d_center), _t(v),
                          _t(g_pos), lr, combiner)
    np.testing.assert_allclose(t[0].numpy(), np.asarray(want_emb), atol=2e-6)
    np.testing.assert_allclose(t[1].numpy(), np.asarray(want_ctx), atol=2e-6)
    np.testing.assert_array_equal(
        tstep._row_divisor(t[3][:, D], combiner).numpy(),
        np.asarray(jstep._row_divisor(acc[:, D], combiner)),
    )


def test_examples_from_pairs_matches():
    pairs = _zipf_pairs(V, 64)
    for both in (True, False):
        jc, jx = jstep._examples_from_pairs(jnp.asarray(pairs), both)
        tc, tx = tstep._examples_from_pairs(_t(pairs), both)
        np.testing.assert_array_equal(tc.numpy(), np.asarray(jc))
        np.testing.assert_array_equal(tx.numpy(), np.asarray(jx))


# -- one whole step ------------------------------------------------------------


def _whole_step(pairs, counts, combiner="capped", layout=None, v=V, strat_group=GROUP,
                shared_groups=0, monkeypatch=None, need_last=True, both=True):
    """Run one JAX ``sgns_step`` and the port's on the same inputs."""
    if monkeypatch is not None:
        monkeypatch.setattr(jstep, "_DENSE_HEAD_PRECISION", jax.lax.Precision.HIGHEST)
    jp = _params(v=v)
    spec = jax_spec(counts, HEAD, BLOCK)
    e = pairs.shape[0] * (2 if both else 1)
    group = e // shared_groups if shared_groups else strat_group
    g = tstep.num_tail_groups(e, group)
    key, blocks = _key_with(spec.nb, g, need_last)
    kw = dict(negatives=K, combiner=combiner, strat_group=strat_group,
              shared_groups=shared_groups, both_directions=both)
    lay = {}
    if layout is not None:
        batch_pairs, quotas, head, mid = layout
        lay = dict(positive_head=head, positive_mid=mid, pos_quotas=quotas)
    noise = NoiseTable(prob=jnp.ones((v,)) / v, alias=jnp.arange(v, dtype=jnp.int32))
    want, wloss = jstep.sgns_step(
        jp, jnp.asarray(pairs), noise, key, jnp.float32(0.05),
        negative_mode="stratified", stratified=spec, **kw, **lay,
    )
    tp = from_jax_params(np.asarray(jp.emb), np.asarray(jp.ctx))
    got, gloss = tstep.sgns_step(
        tp, _t(pairs), 0.05, stratified=build_stratified_spec(counts, HEAD, BLOCK),
        blocks=_t(blocks), **kw, **lay,
    )
    np.testing.assert_allclose(float(gloss), float(wloss), rtol=1e-5)
    np.testing.assert_allclose(got.emb.numpy(), np.asarray(want.emb), atol=2e-6)
    np.testing.assert_allclose(got.ctx.numpy(), np.asarray(want.ctx), atol=2e-6)
    return blocks


@pytest.mark.parametrize("combiner", ["capped", "sum", "mean"])
def test_step_plain_layout_matches(combiner):
    pairs = _zipf_pairs(V, B, seed=1)
    blocks = _whole_step(pairs, _counts(pairs), combiner)
    assert (blocks == 3).any()  # the clamped last block was drawn


@pytest.mark.parametrize("bounds", [8, 64, (8, 24), (16, 64)])
def test_step_segmented_layouts_match(bounds, monkeypatch):
    """Head-only [HH|HT|TT] and head+mid [HH|HM|HT|MM|MT|TT] batches: the
    reference moves slab rows by one-hot matmuls, the port gathers them."""
    corpus = _zipf_pairs(V, B, seed=2)
    pools, quotas = jax_segment(corpus, bounds, B)
    batch = np.concatenate([p[:q] for p, q in zip(pools, quotas)], axis=0)
    head, mid = (bounds, 0) if np.isscalar(bounds) else (bounds[0], bounds[1] - bounds[0])
    _whole_step(batch, _counts(corpus), layout=(B, quotas, head, mid),
                monkeypatch=monkeypatch)


def test_step_capped_divisor_binds_on_duplicated_row():
    pairs = _zipf_pairs(V, B, seed=3)
    pairs[:45, 0] = 5
    # every occurrence is one center and one context example: > 32 each
    assert np.sum(pairs == 5) > 32
    for combiner in ("capped", "sum"):
        _whole_step(pairs, _counts(pairs), combiner)


def test_step_shared_groups_and_one_direction():
    pairs = _zipf_pairs(V, B, seed=4)
    _whole_step(pairs, _counts(pairs), shared_groups=4)
    _whole_step(pairs, _counts(pairs), both=False, need_last=False)


def test_step_vocab_with_overlapping_last_block():
    """V = 300: tail 268 rows in blocks of 64 → nb = 5, last start clamps
    to 236, overlapping block 3 (rows 224-287) by 52 rows."""
    v = 300
    pairs = _zipf_pairs(v, B, seed=5)
    counts = _counts(pairs, v)
    spec = jax_spec(counts, HEAD, BLOCK)
    assert spec.nb == 5 and v - BLOCK < HEAD + (spec.nb - 1) * BLOCK
    blocks = _whole_step(pairs, counts, v=v)
    assert (blocks == spec.nb - 1).any()


def test_step_draws_blocks_from_generator():
    pairs = _zipf_pairs(V, B, seed=6)
    spec = build_stratified_spec(_counts(pairs), HEAD, BLOCK)
    outs = []
    for _ in range(2):
        p = from_jax_params(*map(np.asarray, _params()))
        p, loss = tstep.sgns_step(p, _t(pairs), 0.05, stratified=spec,
                                  generator=torch.Generator().manual_seed(3))
        outs.append((float(loss), p.ctx.clone()))
    assert outs[0][0] == outs[1][0] and torch.equal(outs[0][1], outs[1][1])
    with pytest.raises(ValueError, match="blocks must have shape"):
        tstep.sgns_step(p, _t(pairs), 0.05, stratified=spec,
                        blocks=torch.zeros(3, dtype=torch.int32))
