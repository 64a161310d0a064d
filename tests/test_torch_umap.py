"""The port's UMAP (``gene2vec_tpu_torch/viz/umap.py``) and the plain
versions of K15 (graph) and K16 (iteration) against the JAX package's
``viz/umap.py`` on the CPU.

Tolerances, each with its reason:
- ``fit_ab``: bitwise (the same numpy code);
- the smooth-kNN weights from the same distances: 1e-6 absolute (w lies
  in [0, 1]; the bisection's sum of k exponentials runs in another order
  and torch's exp is not XLA's, so σ moves by the sum's last bits over its
  slope; measured ≤ 2.7e-7);
- the graph from the same d²: the neighbours equal in order, P within 5e-6
  absolute (measured ≤ 1.2e-6); the CSR union of the same (idx, w),
  densified, bitwise the reference's union of them;
- the sparse plain coef: bitwise the dense plain coef of the densified
  graph (the same torch ops on the same values);
- the graph from the points: the neighbour sets equal on inputs whose
  k-th and (k+1)-th distances lie further apart than the two d²'s largest
  difference (asserted), P within 1e-3 absolute — d² cancels for close
  points (≈ 2⁻²⁴·(sq_i + sq_j) an entry), which moves ρ and every weight
  of the row (measured ≤ 5.1e-4); the tie rule on integer points, where
  both d² are exact, equal to ``lax.top_k``'s;
- one iteration from the reference's own (y, P), and each of ten from the
  reference's state: every coordinate of y′ within 1e-5 of lr·terms +
  max|y′|, terms = |rowsum·y_i| + Σ_j |coef_ij|·|y_j| in float64 (the force
  cancels, and the clip is 1-Lipschitz, so a clip decision that flips
  where the force lies that near ±4 stays inside the bar; such forces are
  counted; measured ≤ 3.7e-6).
"""

import dataclasses
from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gene2vec_tpu.viz import umap as ref
from gene2vec_tpu_torch.kernels import umap_graph, umap_step
from gene2vec_tpu_torch.viz import umap as port

TERMS_TOL = 1e-5


def _blobs(n_per=50, d=20, k=3, seed=0):
    rng = np.random.RandomState(seed)
    centers = rng.randn(k, d) * 6.0
    x = np.concatenate([centers[i] + rng.randn(n_per, d) for i in range(k)]).astype(np.float32)
    return x, np.repeat(np.arange(k), n_per)


def _points(seed, n_per, pca):
    x, _ = _blobs(n_per, seed=seed)
    return ref.pca_reduce(x, pca) if pca else x


CASES = [(0, 50, 10), (1, 100, 10), (2, 60, 0), (3, 100, 50)]   # N = 150-300
#: the same shapes from a seed whose rows keep their k-th and (k + 1)-th
#: distances apart (k = 5 and 15), as test_graph_from_the_points asserts
POINT_CASES = [(5, 50, 10), (5, 100, 10), (5, 60, 0), (5, 100, 50)]


def test_config_defaults_and_bf16_refused():
    assert dataclasses.asdict(port.UMAPConfig()) == dataclasses.asdict(ref.UMAPConfig())
    with pytest.raises(NotImplementedError, match="A6h"):
        port.UMAPConfig(compute_dtype="bfloat16")


@pytest.mark.parametrize("min_dist,spread,fixed_b", [
    (0.1, 1.0, None), (0.1, 1.0, 0.875), (0.25, 1.5, None), (0.5, 2.0, 0.875)])
def test_fit_ab_is_bitwise(min_dist, spread, fixed_b):
    assert port.fit_ab(min_dist, spread, fixed_b) == ref.fit_ab(min_dist, spread, fixed_b)


@pytest.mark.parametrize("k", [1, 5, 15, 40])
def test_smooth_knn_weights_match(k):
    rng = np.random.RandomState(k)
    knn_d = np.sort(rng.gamma(2.0, 1.5, (200, k)).astype(np.float32), axis=1)
    knn_d[:7] = knn_d[:7, :1]  # rows whose neighbours all lie at one distance
    want = np.asarray(ref._smooth_knn_weights(jnp.asarray(knn_d), k))
    got = port._smooth_knn_weights(torch.from_numpy(knn_d), k).numpy()
    assert np.abs(got - want).max() <= 1e-6


def _masked(d2):
    return np.where(np.eye(len(d2), dtype=bool), np.inf, d2)


def _from_dense(p):
    """The CSR graph of a dense P (its nonzero entries, rows in column
    order)."""
    pt = torch.from_numpy(np.asarray(p, np.float32))
    rows, cols = torch.nonzero(pt, as_tuple=True)
    rowptr = torch.zeros(pt.shape[0] + 1, dtype=torch.int32)
    rowptr[1:] = torch.cumsum(torch.bincount(rows, minlength=pt.shape[0]), 0)
    return umap_graph.Graph(rowptr, cols.to(torch.int32), pt[rows, cols])


@pytest.mark.parametrize("k", [5, 15])
@pytest.mark.parametrize("seed,n_per,pca", CASES)
def test_graph_from_the_same_distances(seed, n_per, pca, k):
    x = _points(seed, n_per, pca)
    d2 = np.array(ref._squared_distances(jnp.asarray(x)))
    _, want_idx = jax.lax.top_k(-jnp.asarray(_masked(d2)), k)
    idx, w = umap_graph.knn_weights(torch.from_numpy(d2), k)
    np.testing.assert_array_equal(idx.numpy(), np.asarray(want_idx))
    want = np.asarray(ref._fuzzy_graph(jnp.asarray(x), k))
    g = umap_graph.fuzzy_union(idx, w)
    got = umap_graph.to_dense(g).numpy()
    assert np.abs(got - want).max() <= 5e-6
    np.testing.assert_array_equal(got, got.T)
    # the reference's own union of these (idx, w): the same bits
    with mock.patch.object(ref, "_smooth_knn_weights", lambda d, kk: jnp.asarray(w.numpy())):
        union = np.asarray(ref._fuzzy_graph(jnp.asarray(x), k))
    assert np.array_equal(got.view(np.int32), union.view(np.int32))


def _star(n=100, d=200, seed=0):
    """A hub: point 0 at the origin, the rest on the unit sphere in random
    directions (pairwise ~√2 apart), so every point has the hub nearest."""
    rng = np.random.RandomState(seed)
    v = rng.randn(n - 1, d)
    return np.concatenate([np.zeros((1, d)), v / np.linalg.norm(v, axis=1, keepdims=True)]
                          ).astype(np.float32)


def _triples(groups=40, seed=0):
    """Tight triples far apart: at k = 3 each point's third neighbour lies
    in another triple, its weight exp(−shifted/σ) underflows to 0."""
    rng = np.random.RandomState(seed)
    centers = rng.randn(groups, 2) * 50.0
    return np.repeat(centers, 3, axis=0) + rng.randn(3 * groups, 2) * 1e-2


@pytest.mark.parametrize("case", ["blobs", "star", "triples"])
def test_graph_csr_invariants(case):
    """The CSR graph: rows in ascending column order, no diagonal, no
    stored zero, the pattern and the values symmetric bit for bit, every
    edge of the lists present; the star's hub holds every other point
    (in-degree past 2k); the triples' zero weights leave no entry."""
    x = {"blobs": lambda: _points(0, 50, 10), "star": _star,
         "triples": lambda: _triples().astype(np.float32)}[case]()
    k = 3 if case != "blobs" else 15
    d2 = port._squared_distances(torch.from_numpy(x))
    idx, w = umap_graph.knn_weights(d2, k)
    g = umap_graph.fuzzy_union(idx, w)
    n = len(x)
    assert g.rowptr.dtype == torch.int32 and g.col.dtype == torch.int32
    assert g.rowptr[0] == 0 and g.rowptr[-1] == g.nnz and g.n == n
    rp, col, val = g.rowptr.numpy(), g.col.numpy(), g.val.numpy()
    rows = np.repeat(np.arange(n), np.diff(rp))
    for i in range(n):
        assert (np.diff(col[rp[i]:rp[i + 1]]) > 0).all()
    assert (rows != col).all() and (val != 0).all()
    dense = umap_graph.to_dense(g).numpy()
    assert np.array_equal(dense.view(np.int32), dense.T.view(np.int32))
    assert np.count_nonzero(dense) == g.nnz
    nz = w.numpy() != 0
    assert (dense[np.repeat(np.arange(n), k)[nz.ravel()], idx.numpy().ravel()[nz.ravel()]] != 0).all()
    if case == "star":
        assert (idx.numpy()[1:, 0] == 0).all()
        assert rp[1] - rp[0] == n - 1 > 2 * k
    if case == "triples":
        assert (w.numpy() == 0).any()
        assert g.nnz < len(set(zip(rows, col)) | {(j, i) for i, j in zip(
            np.repeat(np.arange(n), k), idx.numpy().ravel())})


@pytest.mark.parametrize("k", [5, 15])
@pytest.mark.parametrize("seed,n_per,pca", POINT_CASES)
def test_graph_from_the_points(seed, n_per, pca, k):
    x = _points(seed, n_per, pca)
    d2_ref = np.asarray(ref._squared_distances(jnp.asarray(x)))
    d2 = port._squared_distances(torch.from_numpy(x)).numpy()
    s = np.sort(_masked(d2_ref), axis=1)
    # in every row the k-th and (k+1)-th distances lie apart by more than
    # twice the two d²'s largest difference among the row's k + 1 nearest
    near = _masked(d2_ref) <= s[:, k:k + 1]
    row_err = np.where(near, np.abs(d2 - d2_ref), 0.0).max(axis=1)
    assert (s[:, k] - s[:, k - 1] > 2 * row_err).all()
    want = np.asarray(ref._fuzzy_graph(jnp.asarray(x), k))
    got = umap_graph.to_dense(port._fuzzy_graph(torch.from_numpy(x), k)).numpy()
    np.testing.assert_array_equal(got > 0, want > 0)  # the same edges
    assert np.abs(got - want).max() <= 1e-3


@pytest.mark.parametrize("k", [1, 4, 15, 59])
def test_ties_go_to_the_lower_index(k):
    """Integer points with duplicates: every distance exact on both sides
    and tied many times over; the neighbours are lax.top_k's, in order."""
    rng = np.random.RandomState(k)
    pts = rng.randint(-3, 4, (12, 5)).astype(np.float32)
    x = np.repeat(pts, 5, axis=0)[rng.permutation(60)]
    d2 = np.asarray(ref._squared_distances(jnp.asarray(x)))
    assert np.array_equal(d2, np.round(d2))
    _, want = jax.lax.top_k(-jnp.asarray(_masked(d2)), k)
    idx, _ = umap_graph.knn_weights(port._squared_distances(torch.from_numpy(x)), k)
    np.testing.assert_array_equal(idx.numpy(), np.asarray(want))


class _JitSpy:
    """Stands in for the reference module's ``jax`` so that ``umap_layout``'s
    jitted ``iterate`` is kept and each of its calls recorded (inputs and
    output): the reference's own iteration and states."""

    def __init__(self):
        self.calls = []
        self.fn = None

    def __getattr__(self, name):
        return getattr(jax, name)

    def jit(self, fn, *args, **kwargs):
        jitted = jax.jit(fn, *args, **kwargs)
        self.fn = jitted

        def call(*a):
            out = jitted(*a)
            self.calls.append(([np.array(v) for v in a], np.array(out)))
            return out

        return call


def _reference_run(monkeypatch, x, cfg):
    spy = _JitSpy()
    monkeypatch.setattr(ref, "jax", spy)
    y = ref.umap_layout(x, cfg)
    monkeypatch.setattr(ref, "jax", jax)
    return spy, y


def _constants(cfg):
    a, b = ref.fit_ab(cfg.min_dist, cfg.spread, fixed_b=0.875 if cfg.fast_kernel else None)
    return umap_step.constants(a, b, cfg.repulsion, cfg.fast_kernel)


def _terms_error(p, y, got, want, c, lr):
    """max |got − want| over lr·terms + max|want| (float64 terms from the
    plain coef), and the forces within TERMS_TOL·terms of ±4."""
    pt, yt = torch.from_numpy(p), torch.from_numpy(y)
    coef = umap_step.coef_plain(pt, yt, c).double()
    y64 = yt.double()
    rowsum = coef.sum(1, keepdim=True)
    terms = ((rowsum * y64).abs() + coef.abs() @ y64.abs()).numpy()
    force = (rowsum * y64 - coef @ y64).numpy()
    err = np.abs(got.astype(np.float64) - want) / (lr * terms + np.abs(want).max())
    near = int((np.abs(np.abs(force) - 4.0) <= TERMS_TOL * terms).sum())
    return float(err.max()), near


@pytest.mark.parametrize("fast", [True, False])
@pytest.mark.parametrize("seed,n_per,pca", CASES)
def test_one_iteration_matches(monkeypatch, seed, n_per, pca, fast):
    x, _ = _blobs(n_per, seed=seed)
    cfg = ref.UMAPConfig(pca_dims=pca or 20, n_iters=2, fast_kernel=fast)
    spy, _ = _reference_run(monkeypatch, x, cfg)
    (y, p, it), _ = spy.calls[0]
    c = _constants(cfg)
    for y_in, it_in in ((y, 0), (y * 0.1, 1)):   # the start, and a layout 10× denser
        want = np.asarray(spy.fn(y_in, p, np.float32(it_in)))
        lr = umap_step.learning_rate(cfg.learning_rate, it_in, cfg.n_iters)
        got = umap_step.step(_from_dense(p), torch.from_numpy(y_in), c, lr).numpy()
        err, _ = _terms_error(p, y_in, got, want, c, lr)
        assert err <= TERMS_TOL, (it_in, err)


@pytest.mark.parametrize("fast", [True, False])
@pytest.mark.parametrize("seed,n_per,pca", CASES[:2])
def test_ten_iterations_match(monkeypatch, seed, n_per, pca, fast):
    """Each of ten iterations from the reference's own state (its recorded
    calls), learning rates from the port's float32 schedule."""
    x, _ = _blobs(n_per, seed=seed)
    cfg = ref.UMAPConfig(pca_dims=pca, n_iters=10, n_neighbors=10, fast_kernel=fast)
    spy, _ = _reference_run(monkeypatch, x, cfg)
    assert len(spy.calls) == 10
    c = _constants(cfg)
    near = 0
    for it, ((y, p, it_ref), want) in enumerate(spy.calls):
        assert float(it_ref) == it
        lr = umap_step.learning_rate(cfg.learning_rate, it, cfg.n_iters)
        got = umap_step.step(_from_dense(p), torch.from_numpy(y), c, lr).numpy()
        err, n_near = _terms_error(p, y, got, want, c, lr)
        assert err <= TERMS_TOL, (it, err)
        near += n_near
    print(f"N {len(x)}: ten iterations within the bar; forces within it of ±4: {near}")


@pytest.mark.parametrize("fast", [True, False])
@pytest.mark.parametrize("n", [2, 5, 16, 300])
def test_graph_coef_is_bitwise_the_dense_coef(n, fast):
    """The sparse plain coef (every pair's p = 0 term, the full formula at
    the stored entries, 0 on the diagonal) is the dense plain coef of the
    densified graph bit for bit, from the start and from a layout 10×
    denser."""
    x = port.pca_reduce(_blobs(-(-n // 3), seed=n)[0][:n], 10)
    g = port._fuzzy_graph(torch.from_numpy(x), min(15, n - 1))
    c, y = port.start(x, port.UMAPConfig(fast_kernel=fast), "cpu")
    for yy in (y, y * 0.1):
        got = umap_step.coef_graph_plain(g, yy, c)
        want = umap_step.coef_plain(umap_graph.to_dense(g), yy, c)
        assert torch.equal(got.view(torch.int32), want.view(torch.int32))


@pytest.mark.parametrize("fast", [True, False])
@pytest.mark.parametrize("seed,n_per,pca", CASES[:2])
def test_one_iteration_from_the_csr(monkeypatch, seed, n_per, pca, fast):
    """One iteration from the port's own CSR graph against the reference's
    iterate on that graph densified, within the terms bar."""
    x, _ = _blobs(n_per, seed=seed)
    cfg = ref.UMAPConfig(pca_dims=pca, n_iters=2, fast_kernel=fast)
    spy, _ = _reference_run(monkeypatch, x, cfg)
    (y, _, _), _ = spy.calls[0]
    xp = port.pca_reduce(x, pca)
    g = port._fuzzy_graph(torch.from_numpy(xp), cfg.n_neighbors)
    p = umap_graph.to_dense(g).numpy()
    c = _constants(cfg)
    want = np.asarray(spy.fn(y, p, np.float32(0)))
    lr = umap_step.learning_rate(cfg.learning_rate, 0, cfg.n_iters)
    got = umap_step.step(g, torch.from_numpy(y), c, lr).numpy()
    err, _ = _terms_error(p, y, got, want, c, lr)
    assert err <= TERMS_TOL, err


def test_fuzzy_graph_and_start_equal_the_references(monkeypatch):
    """umap_layout's graph is the reference's within the points' bar and
    its start (PCA-2 scaled to init_scale) is the reference's bit for bit."""
    x, _ = _blobs(40)
    cfg = ref.UMAPConfig(pca_dims=10, n_iters=1)
    spy, _ = _reference_run(monkeypatch, x, cfg)
    (y0, p, _), _ = spy.calls[0]
    seen = []
    monkeypatch.setattr(umap_step, "step", lambda p_, y_, *a, **k: seen.append(
        (umap_graph.to_dense(p_).numpy(), y_.numpy().copy())) or y_)
    port.umap_layout(x, port.UMAPConfig(pca_dims=10, n_iters=1), device="cpu")
    np.testing.assert_array_equal(seen[0][1], y0)
    assert np.abs(seen[0][0] - p).max() <= 1e-3


def test_layout_separates_blobs():
    """As tests/test_viz.py asks of the reference: inter-cluster mean
    distance over twice the intra-cluster mean."""
    x, labels = _blobs()
    y = port.umap_layout(x, port.UMAPConfig(pca_dims=10, n_iters=200, n_neighbors=10, seed=0),
                         device="cpu")
    assert y.shape == (x.shape[0], 2) and y.dtype == np.float32
    assert np.isfinite(y).all()
    dists = np.linalg.norm(y[:, None] - y[None, :], axis=-1)
    same = labels[:, None] == labels[None, :]
    np.fill_diagonal(same, False)
    intra = dists[same].mean()
    inter = dists[~same & ~np.eye(len(y), dtype=bool)].mean()
    assert inter > 2.0 * intra, (intra, inter)


def test_callback_every_fifty_iterations():
    x, _ = _blobs(20)
    seen = []
    y = port.umap_layout(x, port.UMAPConfig(pca_dims=5, n_iters=120),
                         callback=lambda it, yy: seen.append((it, yy)), device="cpu")
    assert [it for it, _ in seen] == [50, 100]
    assert all(yy.shape == y.shape for _, yy in seen)


@pytest.mark.parametrize("n", [2, 5, 15, 16])
def test_n_neighbors_clamps_at_small_n(monkeypatch, n):
    """N ≤ k: the neighbours clamp to N − 1, as the reference's (and
    umap-learn's) do; the graph then holds every pair."""
    x = np.random.RandomState(n).randn(n, 6).astype(np.float32)
    cfg = ref.UMAPConfig(pca_dims=4, n_iters=3)
    spy, want = _reference_run(monkeypatch, x, cfg)
    ks = []
    real = umap_graph.knn_weights
    monkeypatch.setattr(umap_graph, "knn_weights", lambda d2, k: ks.append(k) or real(d2, k))
    got = port.umap_layout(x, port.UMAPConfig(pca_dims=4, n_iters=3), device="cpu")
    assert ks == [min(15, n - 1)]
    assert got.shape == (n, 2) and np.isfinite(got).all()
    assert np.abs(got - want).max() <= 1e-3 * max(1.0, np.abs(want).max())


def test_non_finite_layout_raises():
    x = np.random.RandomState(0).randn(12, 4).astype(np.float32)
    with pytest.raises(FloatingPointError, match="non-finite"):
        port.umap_layout(x, port.UMAPConfig(pca_dims=4, n_iters=2, learning_rate=float("nan")),
                         device="cpu")
