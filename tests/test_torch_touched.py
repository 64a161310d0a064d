"""K4's touched-rows finalize held against the JAX package on the CPU.

The reference finalizes every row of both tables; the port finalizes
only the rows each step's producers wrote (``row_update.Touched``, and
in ``row_update`` the rows it scatters into).  For one step of every objective and
noise mode, at float32 and at bfloat16 with stochastic rounding, the
rows the reference changed must lie inside the port's set, and the
port's plain step run with that set must match the reference at the
step-parity tests' tolerances (float32: each row within 1e-6 of its
largest value; bfloat16: every element equal or one ulp apart, on at
most 1e-3 of them).  The plain finalize over a set is bitwise the
all-rows finalize wherever the rows outside the set have +0
accumulators.  The kernel's argument layer (the row set it is handed,
the flag workspaces) is checked here too; the kernel itself runs in
``tests/test_torch_cuda.py`` on the card."""

import ctypes

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from gene2vec_tpu.data import negative_sampling as jns
from gene2vec_tpu.sgns import cbow_hs as jcbow
from gene2vec_tpu.sgns import huffman as jhuff
from gene2vec_tpu.sgns import step as jstep
from gene2vec_tpu.sgns.model import SGNSParams as JParams
from gene2vec_tpu_torch.data import negative_sampling as tns
from gene2vec_tpu_torch.kernels import row_update
from gene2vec_tpu_torch.kernels.row_update import Touched
from gene2vec_tpu_torch.sgns import cbow_hs as tcbow
from gene2vec_tpu_torch.sgns import step as tstep
from gene2vec_tpu_torch.sgns.model import from_jax_params

V, D, B, K = 1031, 16, 128, 5
HEAD, BLOCK, GROUP = 32, 64, 32
ROW_RTOL, LOSS_RTOL = 1e-6, 1e-6
ULP_SHARE = 1e-3
KINDS = ("stratified", "per_example", "shared", "sg_hs", "cbow_hs")


def _t(x):
    return torch.from_numpy(np.array(x))


def _bits(x) -> np.ndarray:
    """Each element's bits (float32 or bfloat16), as integers."""
    if isinstance(x, torch.Tensor):
        x = x.contiguous()
        return x.view(torch.int16 if x.dtype == torch.bfloat16 else torch.int32).numpy()
    x = np.asarray(x)
    return x.view(np.uint16 if x.dtype.itemsize == 2 else np.uint32).astype(np.int64)


def _changed(before, after) -> set:
    """Rows with an element whose bits changed."""
    b = _bits(before).astype(np.int64) & 0xFFFFFFFF
    a = _bits(after).astype(np.int64) & 0xFFFFFFFF
    return set(np.flatnonzero((a != b).any(1)).tolist())


def _zipf_pairs(n, seed):
    rng = np.random.RandomState(seed)
    p = 1.0 / np.arange(1, V + 1)
    p /= p.sum()
    return rng.choice(V, size=(n, 2), p=p).astype(np.int32)


def _tables(out_rows, bf16, seed):
    rng = np.random.RandomState(seed)
    dtype = jnp.bfloat16 if bf16 else jnp.float32
    emb = jnp.asarray(rng.uniform(-0.5 / D, 0.5 / D, (V, D)) * 40, dtype)
    ctx = jnp.asarray(rng.randn(out_rows, D) * 0.1, dtype)
    return JParams(emb=emb, ctx=ctx)


def _salts(key) -> np.ndarray:
    return np.asarray(jax.random.bits(key, (2,), jnp.uint32)).astype(np.int64)


def _assert_matches(got, want, bf16, label):
    if bf16:
        g = _bits(got).astype(np.int64)
        w = _bits(want).astype(np.int64)

        def ordered(bits):
            mag = bits & 0x7FFF
            return np.where(bits & 0x8000, -mag, mag)

        ulps = np.abs(ordered(g & 0xFFFF) - ordered(w & 0xFFFF))
        assert ulps.max() <= 1, f"{label}: {int(ulps.max())} ulps apart"
        assert float((ulps > 0).mean()) <= ULP_SHARE, f"{label}: too many elements an ulp apart"
        return
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    err = np.abs(got - want).max(1)
    lim = ROW_RTOL * np.abs(want).max(1)
    bad = np.flatnonzero(err > lim)
    assert bad.size == 0, f"{label}: rows {bad[:5]} off by {err[bad[:5]]} > {lim[bad[:5]]}"


def _jax_and_port_step(kind, bf16):
    """One step of ``kind`` in both packages on the same inputs and draws:
    (start tables, reference result, port result, the port's finalize
    row sets in call order)."""
    pairs = _zipf_pairs(B, seed=2)
    pairs[:45, 0] = 5  # a row past the capped divisor's 32 units
    counts = np.bincount(pairs.reshape(-1), minlength=V).astype(np.int64) + 1
    key = jax.random.PRNGKey(11)
    hs = kind.endswith("_hs")
    if hs:
        tree = jhuff.build_huffman_tree(counts)
        split = jhuff.split_shallow(tree, 3)
        jp = _tables(tree.num_nodes, bf16, seed=1)
        want, wloss = jcbow.hs_step(
            jp, jnp.asarray(pairs), jnp.asarray(split.points_deep),
            jnp.asarray(split.codes_deep), jnp.asarray(split.lengths_deep), jnp.float32(0.05),
            cbow=kind == "cbow_hs", shallow_sign=jnp.asarray(split.sign),
            n_shallow=split.n_shallow, sr_key=key if bf16 else None)
        salts = np.stack([_salts(k) for k in jax.random.split(key)]) if bf16 else None

        def port(tp):
            return tcbow.hs_step(
                tp, _t(pairs), _t(split.points_deep), _t(split.codes_deep),
                _t(split.lengths_deep), 0.05, cbow=kind == "cbow_hs",
                shallow=tcbow.shallow_on(split, "cpu"), sr_salts=salts)
    else:
        jp = _tables(V, bf16, seed=1)
        jnoise = jns.build_alias_table(jns.noise_distribution(counts))
        e = 2 * B
        kw = dict(negatives=K, negative_mode=kind, strat_group=GROUP)
        if kind == "stratified":
            spec_j = jns.build_stratified_spec(counts, HEAD, BLOCK)
            g = tstep.num_tail_groups(e, GROUP)
            draws = dict(stratified=tns.build_stratified_spec(counts, HEAD, BLOCK),
                         blocks=_t(jax.random.randint(key, (g,), 0, spec_j.nb)))
            kw_j = dict(stratified=spec_j)
        else:
            shape = ((int(np.prod(tstep.shared_pool_layout(e, K))),) if kind == "shared"
                     else (e, K))
            draws = dict(negs=_t(jns.sample_negatives(jnoise, key, shape)))
            kw_j = {}
        want, wloss = jstep.sgns_step(jp, jnp.asarray(pairs), jnoise, key, jnp.float32(0.05),
                                      bf16_stochastic_round=bf16, **kw, **kw_j)
        salts = (np.stack([_salts(jax.random.fold_in(key, 0x51EB)),
                           _salts(jax.random.fold_in(key, 0x51EC))]) if bf16 else None)

        def port(tp):
            return tstep.sgns_step(tp, _t(pairs), 0.05, sr_salts=salts, **kw, **draws)

    sets = []
    plain_rows = row_update._plain_rows

    def spy(touched, device, scattered=None):
        rows = plain_rows(touched, device, scattered)
        sets.append(None if rows is None else set(rows.tolist()))
        return rows

    row_update._plain_rows = spy
    try:
        got, gloss = port(from_jax_params(jp.emb, jp.ctx))
    finally:
        row_update._plain_rows = plain_rows
    np.testing.assert_allclose(float(gloss), float(wloss), rtol=LOSS_RTOL)
    return jp, want, got, sets


@pytest.mark.parametrize("bf16", [False, True], ids=["f32", "bf16_sr"])
@pytest.mark.parametrize("kind", KINDS)
def test_touched_sets_cover_the_rows_the_reference_changes(kind, bf16):
    start, want, got, sets = _jax_and_port_step(kind, bf16)
    assert len(sets) == 2 and None not in sets, sets
    rows_emb, rows_out = sets
    for label, before, after, rows, n in (("emb", start.emb, want.emb, rows_emb, V),
                                          ("out table", start.ctx, want.ctx, rows_out,
                                           start.ctx.shape[0])):
        changed = _changed(before, after)
        assert changed, f"{kind} {label}: the reference changed no row"
        missing = sorted(changed - rows)
        assert not missing, f"{kind} {label}: rows {missing[:5]} changed outside the set"
        assert len(rows) < n, f"{kind} {label}: the set is every row"
    _assert_matches(got.emb, want.emb, bf16, f"{kind} emb")
    _assert_matches(got.ctx, want.ctx, bf16, f"{kind} out table")


# -- the plain finalize over a set against the all-rows finalize ----------------


ROWS = 45


def _finalize_case(case, rng):
    """(touched, scattered ids) of a case."""
    blocks = torch.tensor([0, 1, 1, 9], dtype=torch.int32)  # a repeat; 9 clamps
    if case == "duplicates":
        return Touched(ids=torch.tensor([[3, 3, 7], [7, 0, 3]], dtype=torch.int32)), None
    if case == "overlaps":
        return Touched(prefix=6, blocks=blocks, block=8, limit=ROWS), None
    if case == "empty":
        return Touched(), None
    if case == "scattered":
        return Touched(ids=torch.tensor([5], dtype=torch.int32)), torch.tensor(
            [2, 2, 11], dtype=torch.int32)
    if case == "last_row":
        return Touched(ids=torch.tensor([ROWS - 1], dtype=torch.int32)), None
    if case == "paths":
        points = torch.from_numpy(rng.randint(0, ROWS, (6, 4)).astype(np.int32))
        lengths = torch.tensor([0, 4, 2, 1, 3, 4], dtype=torch.int32)
        targets = torch.tensor([1, 2, 2, 5, 0], dtype=torch.int32)
        return Touched(prefix=2, paths=(points, lengths, targets)), None
    if case == "negative_zero":
        return Touched(ids=torch.tensor([4, 12], dtype=torch.int32)), None
    raise ValueError(case)


CASES = ("duplicates", "overlaps", "empty", "scattered", "last_row", "paths", "negative_zero")


def _case_acc(case, seed):
    """(the finalize's set — the case's rows and its scattered ids — the
    accumulator its producers and scatter wrote, the rows outside the
    set): +0 there."""
    rng = np.random.RandomState(seed)
    touched, scattered = _finalize_case(case, rng)
    acc = torch.zeros((ROWS, D + 1))
    rows = touched.rows(torch.device("cpu")).unique()
    if scattered is not None:
        grads = torch.from_numpy(rng.randn(len(scattered), D).astype(np.float32))
        row_update.scatter_rows_plain(acc, scattered, grads, torch.ones(len(scattered)))
        rows = torch.cat([rows, scattered.long()]).unique()
        touched = touched._replace(ids=(*touched.id_lists(), scattered))
    payload = torch.from_numpy(rng.randn(len(rows), D + 1).astype(np.float32))
    payload[:, D] = torch.from_numpy(rng.randint(0, 80, len(rows)).astype(np.float32))
    acc.index_add_(0, rows, payload)
    if case == "negative_zero":
        acc[4, 0] = -0.0  # a −0 payload written into a listed row
    outside = [r for r in range(ROWS) if r not in set(rows.tolist())]
    assert not _bits(acc[outside]).any()
    return touched, acc, outside


@pytest.mark.parametrize("write_back", ["f32", "bf16_sr", "bf16_rn"])
@pytest.mark.parametrize("case", CASES)
def test_touched_finalize_is_bitwise_the_all_rows_finalize(case, write_back):
    """Duplicate ids, overlapping and clamped blocks, no rows at all,
    scattered ids as a second id list, the last row, Huffman paths and a
    −0 payload in a listed row: the finalize over the set equals the
    all-rows finalize bit for bit, and the rows outside keep their bits."""
    dtype = torch.float32 if write_back == "f32" else torch.bfloat16
    salts = (0x243F6A88, 0x85A308D3) if write_back == "bf16_sr" else None
    rng = np.random.RandomState(100 + CASES.index(case))
    table = torch.from_numpy(rng.randn(ROWS, D).astype(np.float32)).to(dtype)
    table[4, 0] = -0.0  # a −0 element in a listed row
    for combiner in ("capped", "sum", "mean"):
        touched, acc, outside = _case_acc(case, CASES.index(case))
        got, want = table.clone(), table.clone()
        row_update.finalize_rows(got, acc, 0.0125, combiner, salts, touched)
        row_update.finalize_rows(want, acc, 0.0125, combiner, salts)
        assert np.array_equal(_bits(got), _bits(want)), f"{case} {combiner}"
        assert np.array_equal(_bits(got[outside]), _bits(table[outside]))


def test_an_unlisted_negative_zero_payload_is_the_one_inexact_skip():
    """The rule's boundary: an accumulator element −0 outside the set over a
    −0 table element — the all-rows finalize writes −0 − lr·(−0) = +0, the
    touched one keeps −0.  No producer writes −0 (each adds into a zeroed
    accumulator), which is why skipping is exact on the step's path."""
    table = torch.zeros((4, D))
    table[2, 0] = -0.0
    acc = torch.zeros((4, D + 1))
    acc[2, 0] = -0.0
    got, want = table.clone(), table.clone()
    row_update.finalize_rows(got, acc, 0.0125, "capped", None, Touched(ids=torch.tensor(
        [0], dtype=torch.int32)))
    row_update.finalize_rows(want, acc, 0.0125, "capped")
    assert _bits(got)[2, 0] != _bits(want)[2, 0]


def test_row_update_plain_takes_the_scattered_rows_and_the_sets():
    rng = np.random.RandomState(1)
    e = 40
    emb = torch.from_numpy(rng.randn(ROWS, D).astype(np.float32))
    ctx = torch.from_numpy(rng.randn(ROWS, D).astype(np.float32))
    centers = torch.from_numpy(rng.randint(0, ROWS, e).astype(np.int32))
    contexts = torch.from_numpy(rng.randint(0, 10, e).astype(np.int32))
    d_center = torch.from_numpy(rng.randn(e, D).astype(np.float32))
    v = torch.from_numpy(rng.randn(e, D).astype(np.float32))
    g_pos = torch.from_numpy(rng.rand(e).astype(np.float32) - 1)
    acc_ctx0 = torch.zeros((ROWS, D + 1))
    acc_ctx0[:5] = torch.from_numpy(rng.rand(5, D + 1).astype(np.float32) * 50)  # a head
    acc_ctx0[29:37] = 1.5  # the block of draw 3: rows [5 + 3·8, +8)
    sets = (Touched(), Touched(prefix=5, blocks=torch.tensor([3], dtype=torch.int32),
                                block=8, limit=ROWS))
    got = [emb.clone(), ctx.clone(), torch.zeros((ROWS, D + 1)), acc_ctx0.clone()]
    want = [emb.clone(), ctx.clone(), torch.zeros((ROWS, D + 1)), acc_ctx0.clone()]
    row_update.row_update(*got, centers, contexts, d_center, v, g_pos, 0.02, "capped",
                          touched=sets)
    row_update.row_update(*want, centers, contexts, d_center, v, g_pos, 0.02, "capped")
    for g, w in zip(got, want):
        assert np.array_equal(_bits(g), _bits(w))


# -- the kernel's argument layer -------------------------------------------------


def test_row_set_carries_each_part_and_checks_it():
    cpu = torch.device("cpu")
    ids = torch.tensor([[1, 2], [3, 4]], dtype=torch.int32)
    more = torch.tensor([9, 9, 0], dtype=torch.int32)
    blocks = torch.tensor([0, 5], dtype=torch.int32)
    points = torch.zeros((7, 3), dtype=torch.int32)
    lengths = torch.ones((7,), dtype=torch.int32)
    targets = torch.tensor([1, 2, 6], dtype=torch.int32)
    s = row_update._row_set(Touched(ids=(ids, more), prefix=4, blocks=blocks, block=8,
                                    limit=50, paths=(points, lengths, targets)), 50, cpu)
    assert (s.ids0, s.n_ids0, s.ids1, s.n_ids1) == (ids.data_ptr(), 4, more.data_ptr(), 3)
    assert s.prefix == 4
    assert (s.blocks, s.n_blocks, s.block, s.limit) == (blocks.data_ptr(), 2, 8, 50)
    assert (s.points, s.lengths, s.targets) == (points.data_ptr(), lengths.data_ptr(),
                                                targets.data_ptr())
    assert (s.n_targets, s.path_len) == (3, 3)
    one = row_update._row_set(Touched(ids=more), 50, cpu)  # one tensor: the first list
    assert (one.ids0, one.n_ids0, one.ids1, one.n_ids1) == (more.data_ptr(), 3, None, 0)
    for empty in (row_update._row_set(Touched(), 50, cpu),
                  row_update._row_set(None, 50, cpu)):  # None: every row, unflagged
        assert (empty.n_ids0, empty.n_ids1, empty.prefix, empty.n_blocks,
                empty.n_targets) == (0, 0, 0, 0, 0)
    with pytest.raises(TypeError, match="int32"):
        row_update._row_set(Touched(ids=ids.long()), 50, cpu)
    with pytest.raises(ValueError, match="id lists"):
        row_update._row_set(Touched(ids=(ids, more, more)), 50, cpu)
    with pytest.raises(ValueError, match="prefix"):
        row_update._row_set(Touched(prefix=51), 50, cpu)
    with pytest.raises(ValueError, match="limit"):
        row_update._row_set(Touched(blocks=blocks, block=8, limit=60), 50, cpu)
    with pytest.raises(ValueError, match="contiguous"):
        row_update._row_set(Touched(ids=ids.t()), 50, cpu)


def test_flag_workspaces_stay_with_an_address_and_advance_a_generation():
    """A workspace stays with its key — the device, the call's stream, the
    row count and row_update's slot — not with an accumulator's address:
    a call flags and finalizes its rows before it returns, so any such
    workspace serves.  Each call advances its generation, and a wrap
    zeroes the flags."""
    cpu = torch.device("cpu")
    s1, s2 = ctypes.c_void_p(0), ctypes.c_void_p(64)
    ws = row_update._flags(9, cpu, s1)
    assert row_update._flags(9, cpu, ctypes.c_void_p(0)) is ws
    assert ws.flags.shape == (9 + 2,)  # the rows' flags, the barrier's counters
    gen = ws.gen
    ws.advance()  # a call: its flags of generation gen now count as clean
    assert row_update._flags(9, cpu, s1) is ws and ws.gen == gen + 1
    assert row_update._flags(9, cpu, s1, slot=1) is not ws  # row_update's second table
    assert row_update._flags(9, cpu, s2) is not ws  # another stream
    assert row_update._flags(4, cpu, s1) is not ws  # another row count
    ws.flags[3] = 7
    ws.gen = 0xFFFFFFFF
    ws.advance()  # wraps: the flags start over from zero
    assert ws.gen == 1 and not bool(ws.flags.any())
    row_update._workspaces.clear()


def test_a_finalize_takes_only_the_rows_it_is_given():
    """A scatter leaves nothing for a later finalize: with other
    accumulators scattered into and finalized in between, a finalize
    given the scattered ids is bitwise every row's, and one given no rows
    changes nothing."""
    rng = np.random.RandomState(4)
    idx = torch.tensor([3, 8, 3, 40], dtype=torch.int32)
    acc = torch.zeros((ROWS, D + 1))
    row_update.scatter_rows(acc, idx, torch.from_numpy(rng.randn(4, D).astype(np.float32)),
                            torch.ones(4))
    for k in range(70):
        other, t = torch.zeros((ROWS, D + 1)), torch.zeros((ROWS, D))
        row_update.scatter_rows(other, idx[:1], torch.ones((1, D)), torch.ones(1))
        row_update.finalize_rows(t, other, 0.5, "sum", None, Touched(ids=idx[:1]))
    table = torch.from_numpy(rng.randn(ROWS, D).astype(np.float32))
    got, want, none = table.clone(), table.clone(), table.clone()
    row_update.finalize_rows(got, acc, 0.0125, "capped", None, Touched(ids=idx))
    row_update.finalize_rows(want, acc, 0.0125, "capped")
    row_update.finalize_rows(none, acc, 0.0125, "capped", None, Touched())
    assert np.array_equal(_bits(got), _bits(want))
    assert np.array_equal(_bits(none), _bits(table))
    assert not np.array_equal(_bits(got), _bits(table))
