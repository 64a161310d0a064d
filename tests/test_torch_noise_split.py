"""The 3xTF32 split that K2, K3 and K5b compute their products with,
modelled in numpy and held against float64 at the default step's shapes
(K5b: the shared pool's auto layout, G = 256 groups of E/G = 32 examples
against P/G = 128 pool rows each).

The card kernels (``csrc/noise_tc.cuh``) split each float32 operand x into
hi = rna(x) and lo = rna(x - hi) — rna rounds to tf32's 10 mantissa bits,
ties away from zero — and sum a_lo*b_hi + a_hi*b_lo + a_hi*b_hi in
float32; a bfloat16 table operand is exact in tf32 and takes the two
passes a_lo*b + a_hi*b.  Products of tf32 values are exact in float32, so
the model's only other rounding is the float32 sum.  The budget the card
must meet is ``chip_smoke.REL_TOL`` (each d_center / accumulator row within
2e-5 of its max |float32 plain|, each loss element within 2e-5 of itself):
the model has to stay far inside it against the float32 plain product, so
that the tensor cores' own sum order and the atomics' have room, and be as
close to float64 as float32 arithmetic itself is.
"""

import numpy as np
import pytest

from chip_smoke import REL_TOL

D, E, H, S = 200, 8192, 256, 512
EG, PG = 32, 128  # K5b's auto layout: examples and pool rows a group
#: the model's share of REL_TOL against the float32 plain product: its
#: worst row error over the row's max
MODEL_SHARE = 0.25
#: its error against float64 over float32 arithmetic's, at most
F32_FACTOR = 1.5


def tf32_rna(x):
    """x rounded to tf32 (10 mantissa bits), ties away from zero, as the
    kernel's bit operation (bits + 0x1000) & 0xffffe000."""
    bits = np.asarray(x, np.float32).view(np.uint32)
    return ((bits + np.uint32(0x1000)) & np.uint32(0xFFFFE000)).view(np.float32)


def split(x):
    x = np.asarray(x, np.float32)
    hi = tf32_rna(x)
    return hi, tf32_rna(x - hi)


def product(a, b, b_exact=False):
    """a @ b as the kernels form it: three tf32 passes (two when b is exact
    in tf32), each product exact, summed in float32."""
    a_hi, a_lo = split(a)
    if b_exact:
        assert np.array_equal(tf32_rna(b), b)
        return (a_lo @ b).astype(np.float32) + (a_hi @ b).astype(np.float32)
    b_hi, b_lo = split(b)
    return ((a_lo @ b_hi).astype(np.float32) + (a_hi @ b_lo).astype(np.float32)
            + (a_hi @ b_hi).astype(np.float32))


def zipf_ids(rng, n, v):
    p = 1.0 / np.arange(1, v + 1)
    return rng.choice(v, size=n, p=p / p.sum())


def row_error(got, want):
    """Each row's max error over its max |want| (the card's "rows" rule)."""
    return float((np.abs(got - want).max(1) / np.abs(want).max(1)).max())


def step_operands(seed=0, v_size=24447):
    """chip_smoke's kernel-check inputs, narrowed: N(0, 0.1) tables, Zipf
    ids, v gathered from emb and g = K*q*sigmoid(logit) of the head."""
    rng = np.random.RandomState(seed)
    emb = (rng.randn(v_size, D) * 0.1).astype(np.float32)
    ctx = (rng.randn(v_size, D) * 0.1).astype(np.float32)
    v = emb[zipf_ids(rng, E, v_size)]
    q = 1.0 / np.arange(1, H + 1) ** 0.75
    q = (q / q.sum() * 0.5).astype(np.float32)
    logit = v.astype(np.float64) @ ctx[:H].T.astype(np.float64)
    g = (5 * q[None, :] / (1 + np.exp(-logit))).astype(np.float32)
    return v, ctx, g


def test_tf32_rna_rounds_to_nearest_ties_away():
    one = np.float32(1.0)
    ulp = np.float32(2.0 ** -10)  # tf32's spacing at 1
    x = np.array([one + ulp / 2, one + ulp / 2 - np.float32(2 ** -23), -(one + ulp / 2),
                  one + 3 * ulp / 2], np.float32)
    np.testing.assert_array_equal(tf32_rna(x), [one + ulp, one, -(one + ulp), one + 2 * ulp])
    hi, lo = split(np.float32(np.pi))
    assert float(hi) + float(lo) == pytest.approx(np.pi, rel=2 ** -21)


@pytest.mark.parametrize("name", ["logits (k = D)", "d_center (k = S)", "acc rows (k = E)"])
@pytest.mark.parametrize("b_bf16", [False, True])
def test_split_products_stay_well_inside_the_card_budget(name, b_bf16):
    """Each of the step's three products, contractions of 200, 512 and
    8192: the model's worst row error against the float32 product within
    MODEL_SHARE of REL_TOL, and against float64 within F32_FACTOR of the
    float32 product's.  On bfloat16 tables the table operand is exact (2
    passes)."""
    v, ctx, g = step_operands()
    if b_bf16:  # the table as bfloat16 (round to nearest even), upcast
        bits = ctx.view(np.uint32)
        ctx = ((bits + 0x7FFF + ((bits >> 16) & 1)) & 0xFFFF0000).astype(np.uint32).view(
            np.float32)
    if name.startswith("logits"):
        a, b, exact = v, ctx[:S].T, b_bf16
    elif name.startswith("d_center"):
        rows = np.tile(ctx[:H], (2, 1))  # k = 512: the head twice
        a, b, exact = np.concatenate([g, g], 1), rows, b_bf16
    else:
        a, b, exact = g.T, v, False  # both float32 whatever the table
    got = product(a, b, exact)
    plain = (a @ b).astype(np.float32)
    exact64 = a.astype(np.float64) @ b.astype(np.float64)
    assert row_error(got, plain) <= MODEL_SHARE * REL_TOL
    assert row_error(got, exact64) <= F32_FACTOR * row_error(plain, exact64)


def test_one_tf32_pass_would_miss_the_budget():
    """Plain TF32 (hi x hi only) is ~1e-3 off: why the kernels split."""
    v, ctx, _ = step_operands()
    a, b = v[:512], ctx[:S].T
    want = a.astype(np.float64) @ b.astype(np.float64)
    assert row_error((tf32_rna(a) @ tf32_rna(b)).astype(np.float32), want) > 10 * REL_TOL


def pool_operands(groups=64, seed=1, v_size=24447):
    """K5b's operands for ``groups`` of the auto layout's groups: v rows,
    each group's P/G pool rows (Zipf draws, so rows repeat) and g =
    scale * sigmoid(logit) * mask (scale = K*G/P = 5/128)."""
    rng = np.random.RandomState(seed)
    emb = (rng.randn(v_size, D) * 0.1).astype(np.float32)
    ctx = (rng.randn(v_size, D) * 0.1).astype(np.float32)
    v = emb[zipf_ids(rng, groups * EG, v_size)].reshape(groups, EG, D)
    contexts = zipf_ids(rng, groups * EG, v_size).reshape(groups, EG)
    pool = zipf_ids(rng, groups * PG, v_size).reshape(groups, PG)
    rows = ctx[pool]                                              # (G, P/G, D)
    logit = np.einsum("ged,gsd->ges", v.astype(np.float64), rows.astype(np.float64))
    mask = pool[:, None, :] != contexts[:, :, None]
    g = (5.0 / PG * mask / (1 + np.exp(-logit))).astype(np.float32)
    return v, rows, g


@pytest.mark.parametrize("name", ["logits (k = D)", "d_center (k = P/G)", "acc rows (k = E/G)"])
@pytest.mark.parametrize("b_bf16", [False, True])
def test_shared_pool_products_stay_well_inside_the_card_budget(name, b_bf16):
    """K5b's three products on noise_tc.cuh's split, group by group:
    contractions of D = 200, P/G = 128 and E/G = 32.  The card holds K5b
    to K2/K3's REL_TOL; the model's worst row error against the float32
    product stays within MODEL_SHARE of it, and against float64 within
    F32_FACTOR of the float32 product's.  bfloat16 pool rows are exact in
    tf32 (2 passes)."""
    v, rows, g = pool_operands()
    if b_bf16:
        bits = rows.view(np.uint32)
        rows = ((bits + 0x7FFF + ((bits >> 16) & 1)) & 0xFFFF0000).astype(np.uint32).view(
            np.float32)
    got, plain, exact64 = [], [], []
    for vg, rg, gg in zip(v, rows, g):
        if name.startswith("logits"):
            a, b, exact = vg, rg.T, b_bf16
        elif name.startswith("d_center"):
            a, b, exact = gg, rg, b_bf16
        else:
            a, b, exact = gg.T, vg, False  # both float32 whatever the table
        got.append(product(a, b, exact))
        plain.append((a @ b).astype(np.float32))
        exact64.append(a.astype(np.float64) @ b.astype(np.float64))
    got, plain, exact64 = (np.concatenate(x) for x in (got, plain, exact64))
    assert row_error(got, plain) <= MODEL_SHARE * REL_TOL
    assert row_error(got, exact64) <= F32_FACTOR * row_error(plain, exact64)
