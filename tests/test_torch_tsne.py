"""The port's exact t-SNE (``gene2vec_tpu_torch/viz/tsne.py``) and the plain
versions of K10c (calibration) and K10 (iteration) against the JAX
package's ``viz/tsne.py`` on the CPU.

Tolerances, each with its reason:
- ``pca_reduce``: bitwise (the same numpy code);
- ``_squared_distances``: 1e-5 of the matrix's largest entry — the float32
  product x·xᵀ sums in another order than XLA's (measured ≤ 5e-7);
- P from the same d²: a relative 5e-5 on every entry — the calibration's
  sums and exponential differ from XLA's in the last bits, and β is a
  bisection root (measured ≤ 1.1e-5);
- P from the points: a relative 1e-3 — d²'s rounding (≈ 2⁻²⁴·(sq_i +
  sq_j) an entry) times β (measured ≤ 2e-4);
- one iteration from the same P, y, vel and gains: y and vel within 1e-5
  of their largest entry, gains equal (measured ≤ 3.3e-6);
- ten iterations, both switches crossed (exaggeration and momentum at 5):
  each step from the reference's own state within the one-step bars, a
  gains decision allowed to differ on at most 1% of entries (a gradient
  within rounding of zero decides its sign); the free-running layout
  within 5e-3 of its scale (measured ≤ 7e-4: such flips grow through the
  exaggerated steps — the layout is chaotic over thousands).
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gene2vec_tpu.config import TSNEConfig as RefConfig
from gene2vec_tpu.io.emb_io import write_matrix_txt
from gene2vec_tpu.viz import tsne as ref
from gene2vec_tpu_torch.cli import tsne as tsne_cli
from gene2vec_tpu_torch.config import TSNEConfig
from gene2vec_tpu_torch.kernels import tsne_calibrate, tsne_step
from gene2vec_tpu_torch.viz import tsne as port

CPU = "cpu"


def _blobs(n_per=50, d=20, k=3, seed=0):
    rng = np.random.RandomState(seed)
    centers = rng.randn(k, d) * 6.0
    x = np.concatenate([centers[i] + rng.randn(n_per, d) for i in range(k)]).astype(np.float32)
    return x, np.repeat(np.arange(k), n_per)


def _points(n_per, pca):
    x, _ = _blobs(n_per)
    return ref.pca_reduce(x, pca) if pca else x


CASES = [(50, 10), (50, 0), (100, 10), (100, 0)]   # N = 150-300, with and without PCA


def test_config_defaults_and_bf16_refused():
    assert dataclasses.asdict(TSNEConfig()) == dataclasses.asdict(RefConfig())
    with pytest.raises(NotImplementedError, match="bfloat16"):
        TSNEConfig(compute_dtype="bfloat16")


@pytest.mark.parametrize("dims", [5, 10, 50])
def test_pca_reduce_is_bitwise(dims):
    x, _ = _blobs(d=30)
    np.testing.assert_array_equal(port.pca_reduce(x, dims), ref.pca_reduce(x, dims))


@pytest.mark.parametrize("n_per,pca", CASES)
def test_squared_distances(n_per, pca):
    x = _points(n_per, pca)
    want = np.asarray(ref._squared_distances(jnp.asarray(x)))
    got = port._squared_distances(torch.from_numpy(x)).numpy()
    assert (got >= 0).all()
    assert np.abs(got - want).max() <= 1e-5 * want.max()


@pytest.mark.parametrize("n_per,pca", CASES)
def test_calibration_matches_the_reference(n_per, pca):
    x = _points(n_per, pca)
    d2 = np.asarray(ref._squared_distances(jnp.asarray(x)))
    want = np.asarray(ref._calibrate_p(jnp.asarray(d2), 30.0))
    got = tsne_calibrate.calibrate(torch.from_numpy(d2), 30.0).numpy()
    assert (np.abs(got - want) / want).max() <= 5e-5
    np.testing.assert_array_equal(got, got.T)
    assert abs(got.sum() - 1.0) < 1e-5
    via_points = port._calibrate_points(torch.from_numpy(x), 30.0).numpy()
    want_points = np.asarray(ref._calibrate_points(jnp.asarray(x), 30.0))
    assert (np.abs(via_points - want_points) / want_points).max() <= 1e-3


def test_conditional_row_slabs_equal_the_whole():
    """The row-range entry (launch 1 on a slab, the long-row route's
    check) gives the whole matrix's rows."""
    d2 = port._squared_distances(torch.from_numpy(_points(40, 10)))
    whole = tsne_calibrate.conditional(d2, 30.0)
    for row0, rows in ((0, 7), (33, 50), (110, 10)):
        part = tsne_calibrate.conditional(d2[row0:row0 + rows].contiguous(), 30.0, row0)
        np.testing.assert_array_equal(part.numpy(), whole[row0:row0 + rows].numpy())
        assert (part[torch.arange(rows), row0 + torch.arange(rows)] == 0).all()
    assert tsne_calibrate.staged(24447) and tsne_calibrate.staged(57000)
    assert not tsne_calibrate.staged(60000)


def _ref_segment(cfg, p, y, vel, gains, start, steps):
    n = y.shape[0]
    out = ref._segment(cfg, 2, jnp.asarray(p), jnp.asarray(y), jnp.asarray(vel),
                       jnp.asarray(gains), start, steps, n)
    return [np.asarray(a) for a in out]


def _port_segment(cfg, p, y, vel, gains, start, steps):
    ts = [torch.from_numpy(np.array(a, np.float32)) for a in (y, vel, gains)]
    port._segment(cfg, torch.from_numpy(p), *ts, start, steps)
    return [t.numpy() for t in ts]


def _scaled(got, want):
    return np.abs(got - want).max() / np.abs(want).max()


SWITCH = {"exaggeration_iters": 5, "momentum_switch_iter": 5}


@pytest.mark.parametrize("n_per,pca", CASES)
def test_one_iteration_matches(n_per, pca):
    x = _points(n_per, pca)
    p = np.asarray(ref._calibrate_points(jnp.asarray(x), 30.0))
    n = p.shape[0]
    rng = np.random.RandomState(1)
    # a start and a mid-run state (vel and gains away from their init)
    for y, vel, gains, start in (
        ((rng.randn(n, 2) * 1e-4).astype(np.float32), np.zeros((n, 2), np.float32),
         np.ones((n, 2), np.float32), 0),
        (rng.randn(n, 2).astype(np.float32) * 5, rng.randn(n, 2).astype(np.float32),
         rng.uniform(0.01, 3, (n, 2)).astype(np.float32), 7),
    ):
        want = _ref_segment(RefConfig(**SWITCH), p, y, vel, gains, start, 1)
        got = _port_segment(TSNEConfig(**SWITCH), p, y, vel, gains, start, 1)
        assert _scaled(got[0], want[0]) <= 1e-5 and _scaled(got[1], want[1]) <= 1e-5
        np.testing.assert_array_equal(got[2], want[2])


@pytest.mark.parametrize("n_per,pca", CASES)
def test_ten_iterations_match(n_per, pca):
    x = _points(n_per, pca)
    p = np.asarray(ref._calibrate_points(jnp.asarray(x), 30.0))
    n = p.shape[0]
    y0 = (np.random.RandomState(0).randn(n, 2) * 1e-4).astype(np.float32)
    state = [y0, np.zeros((n, 2), np.float32), np.ones((n, 2), np.float32)]
    flips = 0
    for it in range(10):   # each step from the reference's own state
        want = _ref_segment(RefConfig(**SWITCH), p, *state, it, 1)
        got = _port_segment(TSNEConfig(**SWITCH), p, *state, it, 1)
        assert _scaled(got[0], want[0]) <= 1e-5, it
        flips += int((got[2] != want[2]).sum())
        state = want
    assert flips <= 0.01 * n * 2 * 10
    start = (y0, np.zeros((n, 2), np.float32), np.ones((n, 2), np.float32))
    want = _ref_segment(RefConfig(**SWITCH), p, *start, 0, 10)
    got = _port_segment(TSNEConfig(**SWITCH), p, *start, 0, 10)
    assert _scaled(got[0], want[0]) <= 5e-3
    print(f"N {n}: ten iterations, layout within {_scaled(got[0], want[0]):.2e} of its "
          f"scale; stepwise gains decisions that differ: {flips}")


def test_step_updates_in_place_and_workspace_checks():
    p = torch.from_numpy(np.full((6, 6), 1 / 36, np.float32))
    y = torch.from_numpy(np.random.RandomState(0).randn(6, 2).astype(np.float32))
    vel, gains = torch.zeros(6, 2), torch.ones(6, 2)
    ids = [t.data_ptr() for t in (y, vel, gains)]
    want = tsne_step.step_plain(p, y.clone(), vel.clone(), gains.clone(), 12.0, 0.5, 200.0)
    tsne_step.step_(p, y, vel, gains, 12.0, 0.5, 200.0)
    assert [t.data_ptr() for t in (y, vel, gains)] == ids
    for got, w in zip((y, vel, gains), want):
        torch.testing.assert_close(got, w, rtol=0, atol=0)
    assert float(y.mean(0).abs().max()) <= 1e-6 * float(y.abs().max())  # centred
    ws = tsne_step.workspace(6, "cpu")
    assert ws.partials.shape == (1,) and ws.ticket.item() == 0


def test_fit_separates_blobs_at_500_iterations():
    x, labels = _blobs()
    out = port.TSNE(config=TSNEConfig(pca_dims=10, n_iter=500, seed=0), device=CPU).fit(
        x, log=lambda s: None)
    y = out[500]
    assert y.shape == (x.shape[0], 2) and y.dtype == np.float32
    dists = np.linalg.norm(y[:, None] - y[None, :], axis=-1)
    same = labels[:, None] == labels[None, :]
    np.fill_diagonal(same, False)
    intra = dists[same].mean()
    inter = dists[~same & ~np.eye(len(y), dtype=bool)].mean()
    assert inter > 2.0 * intra, (intra, inter)


def test_snapshots_share_one_run():
    x, _ = _blobs(n_per=30)
    cfg = TSNEConfig(pca_dims=10, seed=0)
    out = port.TSNE(config=cfg, device=CPU).fit(x, snapshot_iters=[50, 150],
                                                log=lambda s: None)
    assert set(out) == {50, 150}
    assert not np.allclose(out[50], out[150])
    # a snapshot is the layout of a run of that length
    again = port.TSNE(config=cfg, device=CPU).fit(x, snapshot_iters=[50], log=lambda s: None)
    np.testing.assert_array_equal(again[50], out[50])
    # the start matches the reference's: same P (within its bar), same init
    first = port.TSNE(config=cfg, device=CPU).fit(x, snapshot_iters=[1], log=lambda s: None)
    want = ref.TSNE(config=RefConfig(pca_dims=10, seed=0)).fit(x, snapshot_iters=[1],
                                                               log=lambda s: None)
    assert _scaled(first[1], want[1]) <= 1e-3


def test_sweep_files_match_the_reference(tmp_path):
    x, _ = _blobs(n_per=20)
    toks = [f"G{i}" for i in range(len(x))]
    emb = tmp_path / "emb.txt"
    write_matrix_txt(str(emb), toks, x)
    cfg = dict(pca_dims=10, exaggeration_iters=5, momentum_switch_iter=5)
    written = port.run_tsne_sweep(str(emb), str(tmp_path / "port"), iters=[1, 3],
                                  config=TSNEConfig(**cfg), log=lambda s: None, device=CPU)
    ref.run_tsne_sweep(str(emb), str(tmp_path / "ref"), iters=[1, 3],
                       config=RefConfig(**cfg), log=lambda s: None)
    assert [p.split("/")[-1] for p in written] == ["labels.txt", "tsne_iter_1.txt",
                                                   "tsne_iter_3.txt"]
    assert (tmp_path / "port" / "labels.txt").read_text() == \
        (tmp_path / "ref" / "labels.txt").read_text()
    for it in (1, 3):
        got = np.loadtxt(tmp_path / "port" / f"tsne_iter_{it}.txt")
        want = np.loadtxt(tmp_path / "ref" / f"tsne_iter_{it}.txt")
        assert got.shape == want.shape == (len(x), 2)
        assert _scaled(got, want) <= 1e-3


def test_cli_runs_and_flags_are_the_references(tmp_path):
    from gene2vec_tpu.cli import tsne as ref_cli

    def flags(parser):
        return {s for a in parser._actions for s in a.option_strings}

    assert flags(tsne_cli.build_parser()) == flags(ref_cli.build_parser()) | {"--device"}
    x, _ = _blobs(n_per=15)
    emb = tmp_path / "emb.txt"
    write_matrix_txt(str(emb), [f"G{i}" for i in range(len(x))], x)
    out = tmp_path / "tsne"
    assert tsne_cli.main([str(emb), str(out), "--iters", "5", "20", "--pca-dims", "10",
                          "--device", "cpu"]) == 0
    labels = (out / "labels.txt").read_text().split()
    assert sorted(labels) == sorted(f"G{i}" for i in range(len(x)))
    for it in (5, 20):
        assert np.loadtxt(out / f"tsne_iter_{it}.txt").shape == (len(x), 2)
