"""The port's BucketedTopKEngine (plain kernel versions, CPU) against the
JAX package's, on the same tables, indexes and queries, in all three
index modes.

Ids must be identical except at a near-tie: where the two engines return
different rows at one position, the exact cosine of the port's row lies
within 1e-6 of the reference's score there (float32 sums in another
order move a score by an ulp).  Each test counts its near-ties and holds
them to a handful; scores agree within 1e-6.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gene2vec_tpu.serve import ann as jann
from gene2vec_tpu.serve.engine import BucketedTopKEngine as JaxEngine
from gene2vec_tpu.serve.registry import LoadedModel as JaxModel
from gene2vec_tpu_torch.serve import ann
from gene2vec_tpu_torch.serve.engine import BucketedTopKEngine, SimilarityEngine
from gene2vec_tpu_torch.serve.registry import LoadedModel

V, D = 3000, 32
TOL = 1e-6


def l2_normalize(x):
    return x / np.maximum(np.linalg.norm(x, axis=1, keepdims=True), 1e-12)


def clustered_table(rows, dim, clusters, seed=0, spread=0.35):
    rng = np.random.RandomState(seed)
    cent = rng.randn(clusters, dim).astype(np.float32)
    x = cent[rng.randint(0, clusters, rows)]
    return l2_normalize(x + spread * rng.randn(rows, dim).astype(np.float32))


def random_table(rows, dim, seed=0):
    return l2_normalize(np.random.RandomState(seed).randn(rows, dim).astype(np.float32))


def queries(x, n, seed):
    rng = np.random.RandomState(seed)
    q = x[rng.choice(x.shape[0], n, replace=False)] * 3.0  # gene rows
    q[1::2] += 0.1 * rng.randn(len(q[1::2]), x.shape[1]).astype(np.float32)  # vectors
    return q.astype(np.float32)


def jax_fields(index):
    return {
        "table_q": np.asarray(index.table_q), "scale": np.asarray(index.scale),
        "centroids": None if index.centroids is None else np.asarray(index.centroids),
        "lists": None if index.lists is None else np.asarray(index.lists),
        "mode": index.mode, "crc": index.crc,
    }


def both_indexes(x, mode, **kw):
    if mode == "exact":
        return None, None
    j = jann.build_index(x, mode, **kw)
    return j, ann.from_jax_index(jax_fields(j), device="cpu")


def run_both(mode, x, q, k, valid=None, nprobe=8, index_kw=None):
    j_idx, t_idx = both_indexes(x[:valid] if valid else x, mode, **(index_kw or {}))
    if valid and mode != "exact":
        pad = x.shape[0] - valid
        j_idx = jann.build_index(x[:valid], mode, pad_rows=pad, **(index_kw or {}))
        t_idx = ann.from_jax_index(jax_fields(j_idx), device="cpu")
    je = JaxEngine(max_batch=64, index=mode, nprobe=nprobe)
    te = BucketedTopKEngine(max_batch=64, index=mode, nprobe=nprobe)
    if mode == "exact":
        want = je.top_k(jnp.asarray(x), q, k, valid=valid)
        got = te.top_k(torch.from_numpy(x), q, k, valid=valid)
    else:
        want = je.top_k_ann(j_idx, jnp.asarray(x), q, k, valid=valid)
        got = te.top_k_ann(t_idx, torch.from_numpy(x), q, k, valid=valid)
    return got, want


def check_same(got, want, x, q):
    """Scores within TOL; ids equal except at near-ties.  Returns the
    near-tie count."""
    (gs, gi), (ws, wi) = got, want
    gs, gi, ws, wi = map(np.asarray, (gs, gi, ws, wi))
    assert gs.shape == ws.shape and gi.shape == wi.shape
    fin = np.isfinite(ws)
    assert np.array_equal(np.isfinite(gs), fin)
    if fin.any():
        assert np.abs(gs[fin] - ws[fin]).max() <= TOL
    qn = l2_normalize(q)
    ties = 0
    for b, p in zip(*np.nonzero(gi != wi)):
        own = float(qn[b] @ x[gi[b, p]])
        assert abs(own - ws[b, p]) <= TOL, (b, p, own, ws[b, p])
        ties += 1
    return ties


@pytest.mark.parametrize("mode", ["exact", "quant", "ivf"])
@pytest.mark.parametrize("k", [1, 10, 100])
def test_engine_matches_reference(mode, k):
    x = clustered_table(V, D, clusters=40, seed=1)
    q = queries(x, 24, seed=k)
    got, want = run_both(mode, x, q, k, index_kw={"clusters": 40} if mode == "ivf" else None)
    ties = check_same(got, want, x, q)
    assert ties <= 2, f"{ties} near-ties"


@pytest.mark.parametrize("mode", ["exact", "quant", "ivf"])
def test_valid_prefix_masks_pad_rows(mode):
    """A table carrying zero pad rows past ``valid``: no pad row is ever
    returned, and the answer is the reference's."""
    x = random_table(20, 8, seed=2)
    padded = np.concatenate([x, np.zeros((12, 8), np.float32)])
    q = x[:4].copy()
    got, want = run_both(mode, padded, q, 10, valid=20, nprobe=4,
                         index_kw={"clusters": 4} if mode == "ivf" else None)
    assert (np.asarray(got[1]) < 20).all()
    check_same(got, want, padded, q)


def test_ivf_honors_a_caller_valid_prefix():
    x = random_table(64, 8, seed=2)
    idx = ann.build_index(x, "ivf", clusters=4, device="cpu")
    e = BucketedTopKEngine(max_batch=8, index="ivf", nprobe=4)
    _, rows = e.top_k_ann(idx, torch.from_numpy(x), x[:4], 10, valid=30)
    assert (rows < 30).all()


def test_k_beyond_the_candidates_pads_with_minus_inf():
    """IVF with one probe of a short list: fewer candidates than k, so
    the tail is -inf with row 0, as the reference returns it."""
    x = random_table(64, 8, seed=3)
    got, want = run_both("ivf", x, x[:2].copy(), 32, nprobe=1, index_kw={"clusters": 16})
    assert not np.isfinite(np.asarray(got[0])).all()
    assert np.array_equal(np.asarray(got[1]), np.asarray(want[1]))
    check_same(got, want, x, x[:2])


def test_bucketing_matches_reference():
    je, te = JaxEngine(max_batch=48), BucketedTopKEngine(max_batch=48)
    assert te.buckets == je.buckets and te.max_batch == je.max_batch
    for n in (1, 3, 17, 48):
        assert te.bucket(n) == je.bucket(n)
    for k in (1, 5, 257, 600):
        assert te.k_bucket(k, 500) == je.k_bucket(k, 500)
        kb = te.k_bucket(k, 500)
        assert te.r_bucket(kb, 500) == je.r_bucket(kb, 500)
    with pytest.raises(ValueError):
        te.bucket(65)
    assert SimilarityEngine is BucketedTopKEngine


@pytest.mark.parametrize("mode", ["exact", "quant", "ivf"])
def test_shape_counts_stop_growing_once_warm(mode):
    x = random_table(512, 16, seed=4)
    idx = None if mode == "exact" else ann.build_index(x, mode, device="cpu")
    e = BucketedTopKEngine(max_batch=16, index=mode)
    unit = torch.from_numpy(x)

    def sweep():
        for n in (1, 2, 3, 5, 9, 16):
            for k in (1, 3, 10):
                if idx is None:
                    e.top_k(unit, x[:n], k)
                else:
                    e.top_k_ann(idx, unit, x[:n], k)

    sweep()
    warm = e.cache_size(mode)
    assert warm == len(e.buckets) * 3  # buckets x k-buckets (rb follows kb)
    sweep()
    assert e.cache_size(mode) == warm
    assert "exact" in e.cache_sizes()


def _models(x, tokens, mode):
    j_idx, t_idx = both_indexes(x, mode)
    idx = {t: i for i, t in enumerate(tokens)}
    jm = JaxModel(dim=x.shape[1], iteration=1, tokens=tuple(tokens), index=idx, emb=x,
                  unit=jnp.asarray(x), source="mem", meta={}, ann=j_idx)
    tm = LoadedModel(dim=x.shape[1], iteration=1, tokens=tuple(tokens), index=idx, emb=x,
                     unit=torch.from_numpy(x), source="mem", meta={}, ann=t_idx)
    return jm, tm


@pytest.mark.parametrize("mode", ["exact", "quant", "ivf"])
def test_similar_batch_and_topk_rows_match_reference(mode):
    x = clustered_table(1000, 16, clusters=20, seed=5)
    tokens = [f"G{i}" for i in range(1000)]
    jm, tm = _models(x, tokens, mode)
    q = queries(x, 9, seed=6)
    je = JaxEngine(max_batch=16, index=mode)
    te = BucketedTopKEngine(max_batch=16, index=mode)
    want = je.similar_batch(jm, list(q), 11)
    got = te.similar_batch(tm, list(q), 11)
    assert [[t for t, _ in row] for row in got] == [[t for t, _ in row] for row in want]
    for g, w in zip(got, want):
        assert np.abs(np.array([s for _, s in g]) - [s for _, s in w]).max() <= TOL
    gs, gr = te.topk_rows(tm, q, 7)
    ws, wr = je.topk_rows(jm, q, 7)
    assert gr.dtype == np.int64 and np.array_equal(gr, wr)
    assert te.similar_batch(tm, [], 5) == []


def test_long_rescore_tail_matches_reference():
    """rescore_mult = 32 at k = 257 (k-bucket 512): a rescore tail of
    rb = 16,384 rows, past the 8,192 one merge block sorts — the card's
    kernels merge such lists in device memory; the engine answers as the
    reference's, whose tail has no upper bound (engine.py:203-207)."""
    x = clustered_table(20000, 16, clusters=200, seed=3)
    q = queries(x, 4, seed=5)
    j_idx, t_idx = both_indexes(x, "quant")
    je = JaxEngine(max_batch=64, index="quant", rescore_mult=32)
    te = BucketedTopKEngine(max_batch=64, index="quant", rescore_mult=32)
    assert te.r_bucket(te.k_bucket(257, 20000), 20000) == 16384
    want = je.top_k_ann(j_idx, jnp.asarray(x), q, 257)
    got = te.top_k_ann(t_idx, torch.from_numpy(x), q, 257)
    assert check_same(got, want, x, q) <= 2


@pytest.mark.parametrize("keep,rows", [(16384, 24447), (8193, 9000), (24447, 24447)])
def test_plan_accepts_lists_longer_than_a_merge_block(keep, rows):
    from gene2vec_tpu_torch.kernels import _topk

    p = _topk.plan_staged(rows, keep, 64, 200, "int8", sms=132)
    assert p.ntiles == -(-rows // p.tile) and p.slot == min(keep, p.tile)
    # each query's region holds its runs and its keep survivors in whole
    # SORT_MAX runs (the final block sorts and merges them there)
    assert p.stride == max(p.ntiles * p.slot, -(-keep // _topk.SORT_MAX) * _topk.SORT_MAX)
    assert p.scratch == 64 * p.stride
    # a list scan's keep past SORT_MAX takes the chunked route, its runs
    # and survivors laid out the same way
    q = _topk.plan_list(rows, keep, 64, 200, "int8", 8, 0, sms=132)
    assert q.route == 1 and q.nseg == -(-rows // q.share) and q.slot == min(keep, q.share)
    assert q.stride == max(q.nseg * q.slot, -(-keep // _topk.SORT_MAX) * _topk.SORT_MAX)
    with pytest.raises(ValueError, match="keep"):
        _topk.plan_list(rows, rows + 1, 1, 200, "int8", 8, 0)
