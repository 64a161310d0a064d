"""Wide tables, past the card's narrow tiles, held on the CPU.

On the card every kernel of the training steps and the serving scans
takes any table width: K2/K3/K5b stage launch 1 as d-slices past whole
rows, K6 walks rows in 512-column parts past 512, K7/K8 stage d-slices of
their tiles past whole rows (``tests/test_torch_cuda.py`` holds each
against its plain version one past each old limit and at D = 1024).
Here, on the CPU: the staged scan's launch plans at wide rows, and the
port's plain stratified and hierarchical-softmax steps at D = 640 (past
K2/K3's float32 584 and K6's 512) against the JAX steps, at the bars of
``tests/test_torch_step.py`` (loss rtol 1e-5, tables atol 2e-6) and
``tests/test_torch_cbow_hs.py`` (each row within 1e-6 of its largest
value, loss rtol 1e-6): the reference behaviour the card must reach; and
the float32 steps against JAX's float64 steps, the witness behind the
bf16 whole-step bar of ``chip_smoke.compare_bf16_tables``.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from gene2vec_tpu.data import negative_sampling as jns
from gene2vec_tpu.data.negative_sampling import NoiseTable
from gene2vec_tpu.data.negative_sampling import build_stratified_spec as jax_spec
from gene2vec_tpu.sgns import cbow_hs as jcbow
from gene2vec_tpu.sgns import huffman as jhuff
from gene2vec_tpu.sgns import step as jstep
from gene2vec_tpu.sgns.model import SGNSParams as JParams
from gene2vec_tpu.sgns.model import init_params_numpy
from gene2vec_tpu_torch.data.negative_sampling import build_stratified_spec
from gene2vec_tpu_torch.kernels import _topk
from gene2vec_tpu_torch.sgns import cbow_hs as tcbow
from gene2vec_tpu_torch.sgns import step as tstep
from gene2vec_tpu_torch.sgns.model import from_jax_params

V, B, WIDE = 257, 128, 640
HEAD, BLOCK, GROUP, K = 32, 64, 32, 5
KINDS = ("float32", "bfloat16", "int8")
#: (kind, the widest whole-row multiple of 8, the first d-sliced one) at a
#: batch of 64 over the bench vocabulary on 132 multiprocessors
OLD_LIMITS = [("float32", 792, 800), ("bfloat16", 1512, 1520), ("int8", 2720, 2728)]


def _smem(p: _topk.Plan, d: int, kind: str) -> int:
    """A scan block's dynamic shared memory under plan ``p``."""
    tile = (_topk.sliced_tile_bytes(p.dslice, kind, p.rows) if p.dslice
            else _topk.staged_tile_bytes(d, kind, p.rows))
    return (2 * tile + _topk.staged_query_bytes(d, kind, p.qb) + 4 * p.qb * p.tile
            + _topk.SELECT_BYTES)


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("d", [1024, 4096])
@pytest.mark.parametrize("batch", [1, 64])
def test_plan_staged_plans_wide_rows(kind, d, batch):
    p = _topk.plan_staged(24447, 10, batch, d, kind, 132)
    whole = _topk.staged_smem(d, kind, 1, 32, 32) <= _topk.SMEM_BUDGET
    assert (p.dslice == 0) == whole
    if p.dslice:
        assert p.dslice % 32 == 0 and 32 <= p.dslice < d and p.rows == _topk.SLICED_ROWS
    assert _smem(p, d, kind) <= _topk.SMEM_BUDGET
    assert p.tile % p.rows == 0 and p.ntiles * p.tile >= 24447
    assert 1 <= p.qb <= min(batch, _topk.QG_MAX)


@pytest.mark.parametrize("kind,whole,sliced", OLD_LIMITS)
def test_plan_staged_keeps_whole_rows_to_the_old_limits(kind, whole, sliced):
    """Widths the whole-row layout took keep it (the main path's plans do
    not move); the first width it refused is d-sliced."""
    assert _topk.plan_staged(24447, 10, 64, whole, kind, 132).dslice == 0
    assert _topk.plan_staged(24447, 10, 64, sliced, kind, 132).dslice > 0
    assert _topk.plan_staged(24447, 10, 64, 200, kind, 132).dslice == 0


@pytest.mark.parametrize("kind", KINDS)
def test_plan_staged_refuses_only_a_query_wider_than_the_block(kind):
    """The one width limit left: four staged query rows (sixteen for int8)
    must fit half a scan block, about 13,000 columns."""
    _topk.plan_staged(3001, 5, 3, 12_800, kind, 132)
    with pytest.raises(ValueError, match="do not fit a scan block, not even in d-slices"):
        _topk.plan_staged(3001, 5, 3, 20_000, kind, 132)


def _zipf_pairs(v, n, seed):
    rng = np.random.RandomState(seed)
    p = 1.0 / np.arange(1, v + 1)
    p /= p.sum()
    return rng.choice(v, size=(n, 2), p=p).astype(np.int32)


def _t(x):
    return torch.from_numpy(np.array(x))


def _rows_close(got, want, rtol=1e-6):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    err = np.abs(got - want).reshape(len(want), -1).max(1)
    lim = rtol * np.abs(want).reshape(len(want), -1).max(1)
    bad = np.flatnonzero(err > lim)
    assert bad.size == 0, f"rows {bad[:5]}: err {err[bad[:5]]} > {lim[bad[:5]]}"


@pytest.mark.parametrize("combiner", ["capped", "sum"])
def test_wide_stratified_step_matches_jax(combiner):
    pairs = _zipf_pairs(V, B, seed=1)
    counts = np.bincount(pairs.reshape(-1), minlength=V).astype(np.int64) + 1
    p = init_params_numpy(0, V, WIDE)
    ctx = np.random.RandomState(1).randn(V, WIDE).astype(np.float32) * 0.1
    jp = JParams(emb=p.emb, ctx=jnp.asarray(ctx))
    spec = jax_spec(counts, HEAD, BLOCK)
    g = tstep.num_tail_groups(2 * B, GROUP)
    key = jax.random.PRNGKey(3)
    blocks = np.asarray(jax.random.randint(key, (g,), 0, spec.nb)).astype(np.int32)
    kw = dict(negatives=K, combiner=combiner, strat_group=GROUP)
    noise = NoiseTable(prob=jnp.ones((V,)) / V, alias=jnp.arange(V, dtype=jnp.int32))
    want, wloss = jstep.sgns_step(jp, jnp.asarray(pairs), noise, key, jnp.float32(0.05),
                                  negative_mode="stratified", stratified=spec, **kw)
    tp = from_jax_params(np.asarray(jp.emb), np.asarray(jp.ctx))
    got, gloss = tstep.sgns_step(tp, _t(pairs), 0.05,
                                 stratified=build_stratified_spec(counts, HEAD, BLOCK),
                                 blocks=_t(blocks), **kw)
    np.testing.assert_allclose(float(gloss), float(wloss), rtol=1e-5)
    np.testing.assert_allclose(got.emb.numpy(), np.asarray(want.emb), atol=2e-6)
    np.testing.assert_allclose(got.ctx.numpy(), np.asarray(want.ctx), atol=2e-6)


@pytest.mark.parametrize("cbow", [False, True], ids=["sg_hs", "cbow_hs"])
@pytest.mark.parametrize("depth", [0, 10])
def test_wide_hs_step_matches_jax(cbow, depth):
    pairs = _zipf_pairs(V, B, seed=2)
    counts = np.bincount(pairs.reshape(-1), minlength=V).astype(np.int64) + 1
    tree = jhuff.build_huffman_tree(counts)
    rng = np.random.RandomState(4)
    emb = (rng.randn(V, WIDE) * 0.1).astype(np.float32)
    node = (rng.randn(tree.num_nodes, WIDE) * 0.1).astype(np.float32)
    if depth:
        split = jhuff.split_shallow(tree, depth)
        pts, cds, lens, sign = (split.points_deep, split.codes_deep, split.lengths_deep,
                                split.sign)
    else:
        split, sign = None, None
        pts, cds, lens = tree.points, tree.codes, tree.lengths
    jp = JParams(emb=jnp.asarray(emb), ctx=jnp.asarray(node))
    want, wloss = jcbow.hs_step(
        jp, jnp.asarray(pairs), jnp.asarray(pts), jnp.asarray(cds), jnp.asarray(lens),
        jnp.float32(0.05), shallow_sign=None if sign is None else jnp.asarray(sign),
        n_shallow=split.n_shallow if split else 0, cbow=cbow)
    got, gloss = tcbow.hs_step(
        from_jax_params(emb, node), _t(pairs), _t(pts), _t(cds), _t(lens), 0.05,
        shallow=None if split is None else tcbow.shallow_on(split, "cpu"), cbow=cbow)
    np.testing.assert_allclose(float(gloss), float(wloss), rtol=1e-6)
    _rows_close(got.emb.numpy(), want.emb)
    _rows_close(got.ctx.numpy(), want.ctx)


#: phase 2g's step shape (chip_smoke.wide_width_check) and its bench-recipe
#: stratified layout
W_V, W_B = 3001, 4096
W_HEAD, W_BLOCK, W_GROUP = 256, 512, 256


#: the negative-sampling kinds of the witness (``cbow``: the SGNS step on
#: the swapped pairs, stratified noise, as ``CBOWHSTrainer`` runs it)
SGNS_KINDS = {"stratified": "stratified", "cbow": "stratified",
              "per_example": "per_example", "shared": "shared"}


def _float64_witness(kind, d):
    """(start tables, a function of no arguments that runs the port's
    float32 plain step, JAX's float64 step) for ``kind`` at phase 2g's
    shape: Zipf pairs, bf16-valued tables of scale 0.1, the stratified
    blocks, the alias draws of the sampled modes (JAX's own, handed to the
    port) or the Huffman tree at depth 10."""
    from chip_smoke import HS_DEPTH, zipf_ids

    rng = np.random.RandomState(3)
    pairs = np.stack([zipf_ids(rng, W_B, W_V), zipf_ids(rng, W_B, W_V)], 1)
    counts = np.sort(np.bincount(pairs.reshape(-1), minlength=W_V) + 1)[::-1].copy()
    if kind == "cbow":
        pairs = np.ascontiguousarray(pairs[:, ::-1])
    mode = SGNS_KINDS.get(kind)
    tree = jhuff.build_huffman_tree(counts) if mode is None else None
    gen = torch.Generator().manual_seed(3)
    start = [(torch.randn((n, d), generator=gen) * 0.1).to(torch.bfloat16).float()
             for n in (W_V, tree.num_nodes if tree else W_V)]
    port = {}
    with jax.enable_x64(True):  # the step draws its blocks as ``blocks`` does here
        jp = JParams(*(jnp.asarray(t.numpy().astype(np.float64)) for t in start))
        lr = jnp.float64(0.025)
        key = jax.random.PRNGKey(3)
        if mode == "stratified":
            spec = jax_spec(counts, W_HEAD, W_BLOCK)
            g = tstep.num_tail_groups(2 * W_B, W_GROUP)
            blocks = np.asarray(jax.random.randint(key, (g,), 0, spec.nb)).astype(np.int32)
            noise = NoiseTable(prob=jnp.ones((W_V,)) / W_V,
                               alias=jnp.arange(W_V, dtype=jnp.int32))
            exact, _ = jstep.sgns_step(jp, jnp.asarray(pairs), noise, key, lr,
                                       negative_mode="stratified", stratified=spec,
                                       negatives=K, strat_group=W_GROUP,
                                       compute_dtype=jnp.float64)
            port = {"stratified": build_stratified_spec(counts, W_HEAD, W_BLOCK),
                    "blocks": _t(blocks), "strat_group": W_GROUP}
        elif mode is not None:
            noise = jns.build_alias_table(jns.noise_distribution(counts))
            shape = ((2 * W_B, K) if mode == "per_example"
                     else (np.prod(tstep.shared_pool_layout(2 * W_B, K)),))
            negs = np.asarray(jns.sample_negatives(noise, key, shape))
            exact, _ = jstep.sgns_step(jp, jnp.asarray(pairs), noise, key, lr,
                                       negative_mode=mode, negatives=K,
                                       compute_dtype=jnp.float64)
            port = {"negative_mode": mode, "negs": _t(negs)}
        else:
            split = jhuff.split_shallow(tree, HS_DEPTH)
            exact, _ = jcbow.hs_step(
                jp, jnp.asarray(pairs), jnp.asarray(split.points_deep),
                jnp.asarray(split.codes_deep), jnp.asarray(split.lengths_deep), lr,
                shallow_sign=jnp.asarray(split.sign), n_shallow=split.n_shallow,
                cbow=kind == "cbow_hs", compute_dtype=jnp.float64)
        exact = [np.asarray(exact.emb), np.asarray(exact.ctx)]

    def step():
        tp = tstep.SGNSParams(start[0].clone(), start[1].clone())
        if mode is not None:
            got, _ = tstep.sgns_step(tp, _t(pairs), 0.025, negatives=K, **port)
        else:
            got, _ = tcbow.hs_step(tp, _t(pairs), _t(split.points_deep),
                                   _t(split.codes_deep), _t(split.lengths_deep), 0.025,
                                   cbow=kind == "cbow_hs",
                                   shallow=tcbow.shallow_on(split, "cpu"))
        return [got.emb, got.ctx]

    return start, step, exact


#: torch's CPU thread counts the witness runs at (a GEMM's split of a long
#: reduction depends on it)
WITNESS_THREADS = (1, 8)


@pytest.mark.parametrize("kind,d", [("stratified", 200), ("stratified", 1024),
                                    ("sg_hs", 1024), ("cbow_hs", 1024),
                                    ("cbow", 200), ("cbow", 1024),
                                    ("per_example", 1024), ("shared", 1024)])
def test_float32_step_error_model(kind, d):
    """The witness behind ``chip_smoke.TABLE_ULPS``: the port's plain step
    in float32 (the sums behind every bfloat16 write-back) against the JAX
    step in float64 at phase 2g's shape (V 3001, E 8192), with torch on 1
    and on 8 CPU threads.  Each element is within F32_ULPS float32 ulps of
    |t| + |t - new| plus TABLE_ULPS / 2 of the table's largest |t - new| of
    the exact result, so two float32 steps (the card's and the CPU's)
    differ by at most the whole bar.  The element term alone does not hold
    even for float32 itself, and the element's row's largest update
    undercounts the error on the Huffman tree's nodes: run with -s for the
    readings."""
    from chip_smoke import F32_ULPS, TABLE_ULPS

    start, step, exact = _float64_witness(kind, d)
    eps = 2.0 ** -23
    threads = torch.get_num_threads()
    try:
        for n in WITNESS_THREADS:
            torch.set_num_threads(n)
            got = step()
            for name, new, want, t in zip(("emb", "out table"), got, exact, start):
                t = t.numpy().astype(np.float64)
                diff = np.abs(new.numpy().astype(np.float64) - want)
                upd = np.abs(t - want)
                own = F32_ULPS * eps * (np.abs(t) + upd)
                moved = upd.max(1) > 0  # rows the step left alone are equal on both sides
                assert np.all(diff[~moved] == 0)
                row = eps * upd[moved].max(1, keepdims=True)
                table = eps * upd.max()
                print(f"{kind} D {d} {n} threads {name}: "
                      f"{float((diff / np.maximum(own, 1e-300)).max()):.1f}x the element "
                      f"term alone; {float((diff[moved] / row).max()):.1f} float32 ulps of "
                      f"the row's largest update, {float(diff.max() / table):.1f} of the "
                      "table's")
                assert (diff > own).any()  # the element term alone is not float32's error
                assert np.all(diff <= own + TABLE_ULPS / 2 * table), (
                    n, name, float(diff.max() / table))
    finally:
        torch.set_num_threads(threads)
