"""The port's shared-pool and per-example noise modes (K5a, K5b) and K4's
generic entry points held against the JAX package on the CPU.

The alias table is built on the host by both packages and must be array
identical.  The JAX step draws its noise inside
(``sample_negatives(noise, key, shape)``); the tests recompute those
draws from the same key and hand them to the port as ``negs=``.
Tolerances: one step — tables within 1e-6 of each row's largest value
(float32 sums in another order), loss within 1e-6 relative."""

import warnings

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from gene2vec_tpu.data import negative_sampling as jns
from gene2vec_tpu.sgns import step as jstep
from gene2vec_tpu.sgns.model import SGNSParams as JParams
from gene2vec_tpu.sgns.model import init_params_numpy
from gene2vec_tpu_torch.data import negative_sampling as tns
from gene2vec_tpu_torch.kernels import per_example, row_update, shared_pool
from gene2vec_tpu_torch.sgns import step as tstep
from gene2vec_tpu_torch.sgns.model import from_jax_params

V, D, B, K = 257, 16, 128, 5
ROW_RTOL, LOSS_RTOL = 1e-6, 1e-6


def _zipf_pairs(v, n, seed=0):
    rng = np.random.RandomState(seed)
    p = 1.0 / np.arange(1, v + 1)
    p /= p.sum()
    return rng.choice(v, size=(n, 2), p=p).astype(np.int32)


def _counts(pairs, v=V):
    return np.bincount(pairs.reshape(-1), minlength=v).astype(np.int64) + 1


def _params(seed=0, v=V, d=D):
    p = init_params_numpy(seed, v, d)
    ctx = np.random.RandomState(seed + 1).randn(v, d).astype(np.float32) * 0.1
    return JParams(emb=p.emb, ctx=jnp.asarray(ctx))


def _t(x):
    return torch.from_numpy(np.array(x))


def assert_rows_close(got, want, rtol=ROW_RTOL):
    """Each row's max error within ``rtol`` x that row's max |want|."""
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    err = np.abs(got - want).reshape(len(want), -1).max(1)
    lim = rtol * np.abs(want).reshape(len(want), -1).max(1)
    bad = np.flatnonzero(err > lim)
    assert bad.size == 0, f"rows {bad[:5]}: err {err[bad[:5]]} > {lim[bad[:5]]}"


# -- the alias table ----------------------------------------------------------


@pytest.mark.parametrize("counts", [
    [7], [3, 3, 3, 3], [1, 1000], [5, 1, 1, 2, 9, 9, 1],
    list(_counts(_zipf_pairs(V, 500))), list(np.arange(1, 600)),
], ids=["single", "ties", "skew", "small", "zipf", "ramp"])
def test_alias_table_is_array_identical(counts):
    probs = jns.noise_distribution(np.asarray(counts))
    want = jns.build_alias_table(probs)
    got = tns.build_alias_table(tns.noise_distribution(np.asarray(counts)))
    np.testing.assert_array_equal(got.prob.numpy(), np.asarray(want.prob))
    np.testing.assert_array_equal(got.alias.numpy(), np.asarray(want.alias))
    assert got.prob.dtype == torch.float32 and got.alias.dtype == torch.int32


def test_sampler_draws_the_noise_distribution():
    counts = _counts(_zipf_pairs(64, 2000), 64)
    s = tns.NegativeSampler(counts)
    draws = s.sample(torch.Generator().manual_seed(0), (400_000,))
    assert draws.dtype == torch.int32 and int(draws.min()) >= 0 and int(draws.max()) < 64
    freq = np.bincount(draws.numpy(), minlength=64) / draws.numel()
    np.testing.assert_allclose(freq, s.probs, atol=3e-3)
    again = s.sample(torch.Generator().manual_seed(0), (400_000,))
    assert torch.equal(draws, again)


# -- the kernels' plain versions and K4's generic entry points ------------------


def _k5a_draws(case, pairs, k):
    """Each case's (B, k) draws: random ids, then the case's pattern."""
    negs = np.array(jax.random.randint(jax.random.PRNGKey(3), (B, k), 0, V), np.int32)
    if case == "all_masked":
        negs[:] = pairs[:, 1:2]  # every draw hits its positive
    elif case == "hot_row":
        negs[:, -1] = 0  # one id drawn by every example
    else:
        negs[:, 0] = pairs[:, 1]  # every example's first draw hits its positive
    return negs


@pytest.mark.parametrize("case,k,bf16", [
    ("fused", K, False), ("all_masked", K, False), ("hot_row", K, False),
    ("k1", 1, False), ("bf16_ctx", K, True),
], ids=["fused", "all_masked", "hot_row", "k1", "bf16_ctx"])
def test_k5a_plain_matches_jax(case, k, bf16):
    """K5a's plain version against the reference's noise half and its one
    fused ctx scatter of the positive contexts and the draws
    (step.py:320-332), which K5a's accumulator now holds."""
    p = _params()
    if bf16:  # a bfloat16 ctx; the reference upcasts its rows to float32
        p = JParams(emb=p.emb, ctx=p.ctx.astype(jnp.bfloat16))
    pairs = _zipf_pairs(V, B)
    c, x = jnp.asarray(pairs[:, 0]), jnp.asarray(pairs[:, 1])
    negs = _k5a_draws(case, pairs, k)
    loss, (d_center, d_pos, d_neg), mask = jstep.sgns_loss_and_grads(p, c, x, jnp.asarray(negs))
    want_acc = jstep._scatter_accumulator(
        V, jnp.concatenate([x, jnp.asarray(negs.reshape(-1))]),
        jnp.concatenate([d_pos, d_neg.reshape(-1, D)]),
        jnp.concatenate([jnp.ones_like(x, jnp.float32), mask.reshape(-1)]), jnp.float32)
    v, u = p.emb[c], p.ctx[x].astype(jnp.float32)
    g_pos = jax.nn.sigmoid(jnp.sum(v * u, -1)) - 1.0
    ctx = _t(p.ctx.astype(jnp.float32))
    ctx = ctx.to(torch.bfloat16) if bf16 else ctx  # exact: the values are bf16's
    acc = torch.zeros((V, D + 1))
    dc, ln = per_example.per_example(_t(v), _t(u), _t(g_pos), _t(x), _t(negs), ctx, acc)
    assert_rows_close(dc.numpy(), d_center)
    want_loss = jax.nn.softplus(-jnp.sum(v * u, -1)) + ln.numpy()
    np.testing.assert_allclose(float(np.mean(np.asarray(want_loss))), float(loss),
                               rtol=LOSS_RTOL)
    np.testing.assert_allclose(acc.numpy(), np.asarray(want_acc), rtol=1e-6, atol=1e-7)
    if case == "all_masked":  # only the positive contexts reach the accumulator
        np.testing.assert_array_equal(acc[:, D].numpy(), np.bincount(pairs[:, 1], minlength=V))


@pytest.mark.parametrize("groups", [1, 8])
def test_k5b_plain_matches_jax(groups):
    p = _params()
    pairs = _zipf_pairs(V, B, seed=1)
    e = B
    pool = np.array(jax.random.randint(jax.random.PRNGKey(4), (groups * 24,), 0, V), np.int32)
    pool[0] = pairs[0, 1]  # a collision with a positive
    c, x = jnp.asarray(pairs[:, 0]), jnp.asarray(pairs[:, 1])
    p_j = JParams(emb=p.emb, ctx=p.ctx)
    want, wloss = jstep._step_shared(p_j, c, x, jnp.asarray(pool), K, groups,
                                     jnp.float32(0.05), jnp.float32, "sum")
    v, u = p.emb[c], p.ctx[x]
    g_pos = jax.nn.sigmoid(jnp.sum(v * u, -1)) - 1.0
    acc = torch.zeros((V, D + 1))
    dc, ln = shared_pool.shared_pool(_t(v), _t(u), _t(g_pos), _t(x), _t(pool), _t(p.ctx),
                                     K, groups, acc)
    lp = np.asarray(jax.nn.softplus(-jnp.sum(v * u, -1)))
    np.testing.assert_allclose(float(np.mean(lp + ln.numpy())), float(wloss), rtol=LOSS_RTOL)
    # the emb update is -lr·d_center, one row per example ("sum", no dups
    # of a center weigh in through the divisor)
    emb = _t(p.emb).clone()
    acc_e = torch.zeros((V, D + 1))
    row_update.scatter_rows(acc_e, _t(pairs[:, 0]), dc, torch.ones(e))
    row_update.finalize_rows(emb, acc_e, 0.05, "sum")
    assert_rows_close(emb.numpy(), want.emb)
    ctx = _t(p.ctx).clone()
    row_update.scatter_rows(acc, _t(pairs[:, 1]), _t(g_pos[:, None] * v), torch.ones(e))
    row_update.finalize_rows(ctx, acc, 0.05, "sum")
    assert_rows_close(ctx.numpy(), want.ctx)


@pytest.mark.parametrize("combiner", ["capped", "sum", "mean"])
def test_k4_generic_entry_points_match_jax(combiner):
    rng = np.random.RandomState(5)
    rows = 40
    table = rng.randn(rows, D).astype(np.float32)
    idx = rng.randint(0, rows, 300).astype(np.int32)
    idx[:50] = 3  # 50 > 32 example units: the capped divisor binds
    grads = rng.randn(300, D).astype(np.float32)
    weights = rng.rand(300).astype(np.float32) * 2
    acc_j = jstep._scatter_accumulator(rows, jnp.asarray(idx), jnp.asarray(grads),
                                       jnp.asarray(weights), jnp.float32)
    want = jstep._finalize_row_updates(jnp.asarray(table), acc_j, 0.0125, combiner)
    acc = torch.zeros((rows, D + 1))
    row_update.scatter_rows(acc, _t(idx), _t(grads), _t(weights))
    np.testing.assert_allclose(acc.numpy(), np.asarray(acc_j), rtol=1e-6, atol=1e-6)
    t = _t(table).clone()
    row_update.finalize_rows(t, acc, 0.0125, combiner)
    assert_rows_close(t.numpy(), want)
    with pytest.raises(ValueError, match="combiner"):
        row_update.finalize_rows(t, acc, 0.1, "max")


# -- one whole step ------------------------------------------------------------


def _jax_draws(noise, key, shape):
    return np.asarray(jns.sample_negatives(noise, key, shape))


def _whole_step(mode, pairs, combiner="capped", both=True, **kw):
    """One JAX ``sgns_step`` and the port's on the same inputs and draws;
    returns the draws."""
    jp = _params()
    counts = _counts(pairs)
    jnoise = jns.build_alias_table(jns.noise_distribution(counts))
    key = jax.random.PRNGKey(11)
    e = pairs.shape[0] * (2 if both else 1)
    if mode == "shared":
        g, per = tstep.shared_pool_layout(e, K, kw.get("shared_pool", 1024),
                                          kw.get("shared_pool_auto", True),
                                          kw.get("shared_groups", 0), both)
        shape = (g * per,)
    else:
        shape = (e, K)
    negs = _jax_draws(jnoise, key, shape)
    want, wloss = jstep.sgns_step(
        jp, jnp.asarray(pairs), jnoise, key, jnp.float32(0.05), negatives=K,
        both_directions=both, combiner=combiner, negative_mode=mode, **kw,
    )
    tp = from_jax_params(np.asarray(jp.emb), np.asarray(jp.ctx))
    got, gloss = tstep.sgns_step(
        tp, _t(pairs), 0.05, negative_mode=mode, negs=_t(negs), negatives=K,
        both_directions=both, combiner=combiner, **kw,
    )
    np.testing.assert_allclose(float(gloss), float(wloss), rtol=LOSS_RTOL)
    assert_rows_close(got.emb.numpy(), want.emb)
    assert_rows_close(got.ctx.numpy(), want.ctx)
    return negs


@pytest.mark.parametrize("mode", ["per_example", "shared"])
@pytest.mark.parametrize("combiner", ["capped", "sum", "mean"])
def test_step_matches(mode, combiner):
    pairs = _zipf_pairs(V, B, seed=2)
    pairs[:45, 0] = 5  # a row past the capped divisor's 32 units
    negs = _whole_step(mode, pairs, combiner)
    assert (negs == 0).any()  # the hot head row is drawn, duplicates and all


@pytest.mark.parametrize("mode", ["per_example", "shared"])
def test_step_one_direction(mode):
    _whole_step(mode, _zipf_pairs(V, B, seed=3), both=False)


def test_shared_step_explicit_groups_and_pools():
    pairs = _zipf_pairs(V, B, seed=4)
    _whole_step("shared", pairs, shared_groups=4)
    _whole_step("shared", pairs, shared_groups=8, shared_pool=64, shared_pool_auto=False)
    with pytest.warns(UserWarning, match="adjusted to"):
        _whole_step("shared", pairs, shared_pool=100, shared_pool_auto=False)


def test_shared_pool_layout_matches_the_reference_sizing():
    # auto: G = E/32, P/G = ceil(0.8·32·K) rounded to 8 = 128
    assert tstep.shared_pool_layout(8192, 5) == (256, 128)
    assert tstep.shared_pool_layout(256, 5, shared_groups=4) == (4, 256)
    with pytest.raises(ValueError, match="cannot be split"):
        tstep.shared_pool_layout(256, 5, shared_pool=16, shared_pool_auto=False,
                                 shared_groups=8)
    with pytest.raises(ValueError, match="does not divide"):
        tstep.shared_pool_layout(256, 5, shared_groups=3)
    with pytest.warns(UserWarning, match="no divisor near"):
        tstep.shared_pool_layout(2 * 389, 5)
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        assert tstep.shared_pool_layout(256, 5, shared_pool=64, shared_pool_auto=False) == (8, 8)


def test_step_draws_from_a_generator_and_checks_shapes():
    pairs = _zipf_pairs(V, B, seed=6)
    noise = tns.build_alias_table(tns.noise_distribution(_counts(pairs)))
    outs = []
    for _ in range(2):
        p = from_jax_params(*map(np.asarray, _params()))
        p, loss = tstep.sgns_step(p, _t(pairs), 0.05, negative_mode="per_example",
                                  noise=noise, generator=torch.Generator().manual_seed(3))
        outs.append((float(loss), p.ctx.clone()))
    assert outs[0][0] == outs[1][0] and torch.equal(outs[0][1], outs[1][1])
    with pytest.raises(ValueError, match="negs must have shape"):
        tstep.sgns_step(p, _t(pairs), 0.05, negative_mode="per_example",
                        negs=torch.zeros((3, K), dtype=torch.int32))
    with pytest.raises(ValueError, match="unknown negative_mode"):
        tstep.sgns_step(p, _t(pairs), 0.05, negative_mode="pool")
    with pytest.raises(ValueError, match="stratified' only"):
        tstep.sgns_step(p, _t(pairs), 0.05, negative_mode="shared", noise=noise,
                        positive_head=8, pos_quotas=(32, 32, 64))


@pytest.mark.parametrize("mode,scatters", [("per_example", 1), ("shared", 2)])
def test_sampled_steps_scatter_calls(monkeypatch, mode, scatters):
    """K5a adds the positive contexts' rows itself (the reference's one
    fused ctx scatter), so the per_example step calls K4's generic scatter
    for the centers alone; the shared step scatters centers and contexts."""
    calls = []
    orig = tstep.scatter_rows
    monkeypatch.setattr(tstep, "scatter_rows", lambda *a: calls.append(a) or orig(*a))
    pairs = _zipf_pairs(V, B, seed=7)
    noise = tns.build_alias_table(tns.noise_distribution(_counts(pairs)))
    p = from_jax_params(*map(np.asarray, _params()))
    tstep.sgns_step(p, _t(pairs), 0.05, negative_mode=mode, noise=noise,
                    generator=torch.Generator().manual_seed(3))
    centers, contexts = tstep._examples_from_pairs(_t(pairs))
    assert [torch.equal(c[1], x) for c, x in zip(calls, (centers, contexts))] == [True] * scatters
