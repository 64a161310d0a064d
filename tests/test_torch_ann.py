"""The port's ANN index and scan plain versions against the JAX package's
``serve/ann.py``: the host build (quantization, k-means, lists, CRC,
centroid cache) byte for byte, the approximate scans bitwise, the exact
rescore within 1e-6, and recall at the real vocab geometry."""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gene2vec_tpu.serve import ann as jann
from gene2vec_tpu_torch.kernels import ivf_scan, quant_scan, rescore
from gene2vec_tpu_torch.serve import ann
from gene2vec_tpu_torch.serve.engine import BucketedTopKEngine


def l2_normalize(x):
    return x / np.maximum(np.linalg.norm(x, axis=1, keepdims=True), 1e-12)


def clustered_table(rows, dim, clusters, seed=0, spread=0.35):
    rng = np.random.RandomState(seed)
    cent = rng.randn(clusters, dim).astype(np.float32)
    x = cent[rng.randint(0, clusters, rows)]
    return l2_normalize(x + spread * rng.randn(rows, dim).astype(np.float32))


def random_table(rows, dim, seed=0):
    return l2_normalize(np.random.RandomState(seed).randn(rows, dim).astype(np.float32))


def skewed_table(rows=512, dim=8, seed=0):
    """90% of the rows around one point: its list overflows the cap and
    the overflow spills to the next-nearest centroids."""
    rng = np.random.RandomState(seed)
    x = rng.randn(rows, dim).astype(np.float32)
    x[: int(0.9 * rows)] = 1.0 + 0.05 * rng.randn(int(0.9 * rows), dim)
    return l2_normalize(x).astype(np.float32)


def jax_fields(index):
    return {
        "table_q": np.asarray(index.table_q), "scale": np.asarray(index.scale),
        "centroids": None if index.centroids is None else np.asarray(index.centroids),
        "lists": None if index.lists is None else np.asarray(index.lists),
        "mode": index.mode, "crc": index.crc,
    }


# -- host build, byte for byte -------------------------------------------------


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_quantize_rows_byte_equal(seed):
    x = random_table(300, 24, seed=seed)
    x[5] = 0.0  # a zero row
    q, s = ann.quantize_rows(x)
    jq, js = jann.quantize_rows(x)
    assert q.tobytes() == jq.tobytes() and s.tobytes() == js.tobytes()


@pytest.mark.parametrize("make,clusters", [
    (lambda: clustered_table(2000, 16, clusters=32, seed=1), 32),
    (lambda: random_table(1000, 12, seed=3), None),
    (skewed_table, 16),
])
def test_kmeans_and_lists_byte_equal(make, clusters):
    x = make()
    c = clusters or ann.default_clusters(x.shape[0])
    assert c == (clusters or jann.default_clusters(x.shape[0]))
    cent = ann.kmeans_centroids(x, c, seed=5)
    jcent = jann.kmeans_centroids(x, c, seed=5)
    assert cent.tobytes() == jcent.tobytes()
    lists = ann.build_lists(x, cent)
    assert lists.tobytes() == jann.build_lists(x, jcent).tobytes()
    # every row in exactly one list
    ids = lists[lists >= 0]
    assert sorted(ids.tolist()) == list(range(x.shape[0]))


def test_skewed_table_takes_the_overflow_spill():
    x = skewed_table()
    cent = ann.kmeans_centroids(x, 16, seed=0)
    lists = ann.build_lists(x, cent)
    nearest = np.argmax(x @ cent.T, axis=1)
    assert np.bincount(nearest, minlength=16).max() > lists.shape[1]
    assert lists.tobytes() == jann.build_lists(x, cent).tobytes()


def test_table_crc_and_bytes_per_query_match():
    x = random_table(100, 8, seed=4)
    assert ann.table_crc(x) == jann.table_crc(x)
    for mode, kw in (("exact", {}), ("quant", {"r": 64}),
                     ("ivf", {"r": 64, "clusters": 40, "list_len": 8, "nprobe": 4})):
        assert ann.bytes_per_query(mode, 24447, 200, **kw) == jann.bytes_per_query(
            mode, 24447, 200, **kw)


def test_centroid_cache_is_shared_between_packages(tmp_path):
    x = clustered_table(1500, 16, clusters=20, seed=2)
    cache = str(tmp_path / "ann_cache")
    j = jann.build_index(x, "ivf", clusters=20, cache_dir=cache, tag="t")
    t = ann.build_index(x, "ivf", clusters=20, cache_dir=cache, tag="t", device="cpu")
    assert t.built_from_cache and not j.built_from_cache
    assert t.lists.numpy().tobytes() == np.asarray(j.lists).tobytes()
    assert t.centroids.numpy().tobytes() == np.asarray(j.centroids).tobytes()
    # and the other way round
    cache2 = str(tmp_path / "ann_cache2")
    t2 = ann.build_index(x, "ivf", clusters=20, cache_dir=cache2, tag="t", device="cpu")
    j2 = jann.build_index(x, "ivf", clusters=20, cache_dir=cache2, tag="t")
    assert j2.built_from_cache and not t2.built_from_cache
    assert np.asarray(j2.lists).tobytes() == t2.lists.numpy().tobytes()


def test_forged_or_stale_cache_is_ignored(tmp_path):
    x = clustered_table(800, 8, clusters=10, seed=6)
    crc = ann.table_crc(x)
    path = tmp_path / ann._cache_name("t", 10, crc)
    bogus = np.full((10, 4), 3, np.int32)
    np.savez(path, centroids=np.zeros((10, 8), np.float32), lists=bogus,
             meta=json.dumps({"crc": crc ^ 1}))
    idx = ann.build_index(x, "ivf", clusters=10, cache_dir=str(tmp_path), tag="t",
                          device="cpu")
    assert not idx.built_from_cache
    assert idx.lists.numpy().tobytes() == jann.build_lists(
        x, jann.kmeans_centroids(x, 10)).tobytes()
    path.write_bytes(b"not a zip file")
    again = ann.build_index(x, "ivf", clusters=10, cache_dir=str(tmp_path), tag="t",
                            device="cpu")
    assert not again.built_from_cache
    assert ann._load_centroid_cache(str(path), crc) is not None  # rebuilt, rewritten


def test_oracles_agree():
    x = random_table(700, 16, seed=7)
    q = np.random.RandomState(8).randn(40, 16).astype(np.float32)
    o = ann.exact_oracle(x, q, 10)
    assert np.array_equal(o, jann.exact_oracle(x, q, 10))
    found = np.roll(o, 1, axis=0)
    found[::2] = o[::2]
    assert ann.recall_at_k(found, o) == jann.recall_at_k(found, o)


def test_index_placement_and_stats():
    x = random_table(64, 8, seed=9)
    idx = ann.build_index(x, "quant", pad_rows=4, device="cpu")
    ref = jann.build_index(x, "quant", pad_rows=4)
    assert idx.table_q.dtype == torch.int8 and idx.table_q.shape == (68, 8)
    assert idx.table_q.numpy().tobytes() == np.asarray(ref.table_q).tobytes()
    assert idx.scale.numpy().tobytes() == np.asarray(ref.scale).tobytes()
    assert ann.index_stats(idx) == {**jann.index_stats(ref), "build_seconds": ann.index_stats(
        idx)["build_seconds"]}
    bf = ann.build_index(x, "quant", quant_dtype="bf16", device="cpu")
    jbf = jann.build_index(x, "quant", quant_dtype="bf16")
    assert bf.table_q.view(torch.int16).numpy().tobytes() == np.asarray(
        jbf.table_q).view(np.int16).tobytes()
    assert ann.from_jax_index(jax_fields(jbf), device="cpu").table_q.view(
        torch.int16).numpy().tobytes() == np.asarray(jbf.table_q).view(np.int16).tobytes()


# -- the scans' plain versions against the reference ---------------------------


def _scan_inputs(seed, rows=1200, dim=24, b=16):
    x = clustered_table(rows, dim, clusters=24, seed=seed)
    rng = np.random.RandomState(seed + 100)
    q = x[rng.choice(rows, b, replace=False)] * 2.0 + 0.1 * rng.randn(b, dim).astype(np.float32)
    qn = np.asarray(jax.jit(jann._normalize)(jnp.asarray(q)))
    j = jann.build_index(x, "ivf", clusters=24)
    return x, qn, j, ann.from_jax_index(jax_fields(j), device="cpu")


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_quant_scan_plain_is_bitwise_the_reference(seed):
    """The int32 sums are exact and the rescale runs in the reference's
    order, so the approximate scores are bitwise equal (compared with the
    reference jitted, as its engine runs it)."""
    x, qn, j, t = _scan_inputs(seed)
    want = np.asarray(jax.jit(jann._approx_scores)(jnp.asarray(qn), j.table_q, j.scale))
    got = quant_scan.quant_scores_plain(torch.from_numpy(qn), t.table_q, t.scale).numpy()
    assert got.view(np.int32).tobytes() == want.view(np.int32).tobytes()
    s, r = quant_scan.quant_scan_plain(torch.from_numpy(qn), t.table_q, t.scale, 64, 1100)
    ws, wr = jax.lax.top_k(jnp.where(jnp.arange(1200) < 1100, want, -jnp.inf), 64)
    assert np.array_equal(r.numpy(), np.asarray(wr))
    assert s.numpy().view(np.int32).tobytes() == np.asarray(ws).view(np.int32).tobytes()


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_ivf_scan_plain_is_bitwise_the_reference(seed):
    x, qn, j, t = _scan_inputs(seed)
    pos = np.random.RandomState(seed).randint(0, 1200, (16, 96)).astype(np.int32)
    want = np.asarray(jax.jit(jann._gathered_approx)(
        jnp.asarray(qn), j.table_q, j.scale, jnp.asarray(pos)))
    got = ivf_scan.gathered_scores_plain(torch.from_numpy(qn), t.table_q, t.scale,
                                         torch.from_numpy(pos)).numpy()
    assert got.view(np.int32).tobytes() == want.view(np.int32).tobytes()
    # the whole probe + scan: the reference's kernel body up to its rescore
    cs = jnp.asarray(qn) @ j.centroids.T
    _, ci = jax.lax.top_k(cs, 4)
    cand = j.lists[ci].reshape(16, -1)
    ok = (cand >= 0) & (cand < 1150)
    jpos = jnp.where(ok, cand, 0)
    approx = jnp.where(ok, jax.jit(jann._gathered_approx)(
        jnp.asarray(qn), j.table_q, j.scale, jpos), -jnp.inf)
    rs, rpos = jax.lax.top_k(approx, 64)
    s, r = ivf_scan.ivf_scan_plain(torch.from_numpy(qn), t.centroids, t.lists, t.table_q,
                                   t.scale, 4, 64, 1150)
    assert np.array_equal(r.numpy(), np.asarray(jnp.take_along_axis(jpos, rpos, axis=1)))
    assert s.numpy().view(np.int32).tobytes() == np.asarray(rs).view(np.int32).tobytes()


@pytest.mark.parametrize("k", [1, 10, 64])
def test_rescore_plain_returns_the_reference_rows(k):
    x, qn, j, t = _scan_inputs(3)
    rng = np.random.RandomState(k)
    ri = rng.randint(0, 1200, (16, 64)).astype(np.int32)
    ok = rng.rand(16, 64) > 0.2
    ok[0] = False  # an all-masked query: -inf scores, row 0
    ws, wi = jax.jit(jann._rescore_topk, static_argnums=4)(
        jnp.asarray(qn), jnp.asarray(x), jnp.asarray(ri), jnp.asarray(ok), k)
    approx = torch.from_numpy(np.where(ok, 0.5, -np.inf).astype(np.float32))
    gs, gi = rescore.rescore_plain(torch.from_numpy(qn), torch.from_numpy(x),
                                   torch.from_numpy(ri), approx, k)
    ws, wi = np.asarray(ws), np.asarray(wi)
    fin = np.isfinite(ws)
    assert np.array_equal(np.isfinite(gs.numpy()), fin)
    assert np.abs(gs.numpy()[fin] - ws[fin]).max() <= 1e-6
    # rows equal except at a near-tie (two reference scores within 1e-6)
    moved = gi.numpy() != wi
    for b, p in zip(*np.nonzero(moved)):
        row = ws[b][np.isfinite(ws[b])]
        assert np.any(np.abs(np.delete(row, p) - ws[b, p]) <= 1e-6)
    assert moved.sum() <= 2


# -- recall at the real geometry (the plain versions on the CPU) ----------------


def test_recall_at_real_vocab_geometry():
    """A clustered table at the 24,447-gene vocab must hold recall@10 >=
    0.99 for quant AND ivf, as the reference's test_ann.py holds."""
    v = 24447
    x = clustered_table(v, 64, clusters=256, seed=5)
    q = x[np.random.RandomState(11).choice(v, 64, False)]
    oracle = ann.exact_oracle(x, q, 10)
    engine = BucketedTopKEngine(max_batch=64, index="ivf", nprobe=32)
    unit = torch.from_numpy(x)
    for mode, kw in (("quant", {}), ("ivf", {"clusters": 256})):
        index = ann.build_index(x, mode, device="cpu", **kw)
        _, idx = engine.top_k_ann(index, unit, q, 10)
        assert ann.recall_at_k(idx, oracle) >= 0.99, mode


def test_build_index_needs_cuda_unless_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ann.build_index(random_table(32, 4), "quant")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ann.from_jax_index({"table_q": np.zeros((2, 2), np.int8), "scale": np.ones(2)})
