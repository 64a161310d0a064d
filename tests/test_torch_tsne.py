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


def _bisection_states(d2, perplexity, iters=tsne_calibrate.ITERS):
    """``conditional_plain``'s bisection, its (β, lo, hi) after every
    step: a list of iters + 1 triples of (R,) tensors, the start first."""
    r, n = d2.shape
    target = torch.tensor(np.log(perplexity), dtype=torch.float32)
    eye = torch.eye(r, n, dtype=torch.bool)
    beta, lo, hi = torch.ones(r), torch.zeros(r), torch.full((r,), float("inf"))
    states = [(beta, lo, hi)]
    for _ in range(iters):
        w = torch.where(eye, 0.0, torch.exp(-d2 * beta[:, None]))
        sum_w = torch.clamp_min(torch.sum(w, dim=1), 1e-12)
        h = torch.log(sum_w) + beta * torch.sum(d2 * w, dim=1) / sum_w
        too_high = h > target
        lo = torch.where(too_high, beta, lo)
        hi = torch.where(too_high, hi, beta)
        beta = torch.where(torch.isinf(hi), beta * 2.0, (lo + hi) / 2.0)
        states.append((beta, lo, hi))
    return states


def _early_exit_conditional(d2, perplexity):
    """K10c's early exit on the plain bisection: each row stops at the
    first step that leaves its (β, lo, hi) unchanged, and P_cond comes from
    that state.  Returns (P_cond, the steps each row took)."""
    states = _bisection_states(d2, perplexity)
    r = d2.shape[0]
    steps = torch.full((r,), len(states) - 1, dtype=torch.int64)
    stopped = torch.zeros(r, dtype=torch.bool)
    final = [t.clone() for t in states[-1]]
    for k in range(1, len(states)):
        same = torch.ones(r, dtype=torch.bool)
        for a, b in zip(states[k], states[k - 1]):
            same &= (a == b)
        new = same & ~stopped
        steps[new] = k
        for t, v in zip(final, states[k]):
            t[new] = v[new]
        stopped |= same
    beta = final[0]
    w = torch.where(torch.eye(r, dtype=torch.bool), 0.0, torch.exp(-d2 * beta[:, None]))
    sum_w = torch.clamp_min(torch.sum(w, dim=1), 1e-12)
    return w / sum_w[:, None], steps


@pytest.mark.parametrize("n_per,pca", CASES)
def test_early_exit_bisection_is_the_50_step_one(n_per, pca):
    """A row's bisection step is a function of (β, lo, hi) alone, so once a
    step leaves them unchanged every later step does too: stopping there
    (K10c's early exit) gives the 50-step P_cond bit for bit, and agrees
    with the reference's calibration as the plain version does."""
    x = _points(n_per, pca)
    d2 = port._squared_distances(torch.from_numpy(x))
    states = _bisection_states(d2, 30.0)
    fixed = torch.zeros(d2.shape[0], dtype=torch.bool)
    for k in range(1, len(states)):
        same = torch.ones_like(fixed)
        for a, b in zip(states[k], states[k - 1]):
            same &= (a == b)
        assert bool((same | ~fixed).all())  # once fixed, always fixed
        fixed |= same
    got, steps = _early_exit_conditional(d2, 30.0)
    want = tsne_calibrate.conditional_plain(d2, 30.0)
    assert torch.equal(got.view(torch.int32), want.view(torch.int32))
    assert int(steps.max()) < tsne_calibrate.ITERS
    ref_p = np.asarray(ref._calibrate_p(jnp.asarray(d2.numpy()), 30.0))
    sym = tsne_calibrate.symmetrize_plain(got).numpy()
    assert (np.abs(sym - ref_p) / ref_p).max() <= 5e-5
    print(f"N {d2.shape[0]}: steps to the fixed point {int(steps.min())}-{int(steps.max())}, "
          f"mean {float(steps.float().mean()):.1f}")


def test_routes_and_padded_rows():
    """Launch 1's route by width (shared memory up to 57,856 columns);
    P's rows on the card padded to a multiple of 32 floats, and the checks
    K10c and K10 hold P to."""
    assert [tsne_calibrate.staged(n) for n in (5, 24447, 57856, 57857)] == \
        [True] * 3 + [False]
    assert [tsne_calibrate.row_pitch(n) for n in (1, 32, 33, 24447, 60000)] == \
        [32, 32, 64, 24448, 60000]
    p = tsne_calibrate.empty_rows(5, 40, "cpu")
    assert p.shape == (5, 40) and p.stride() == (64, 1)
    tsne_calibrate.check_pitch(p, "p", 5, 40)
    for bad, match in ((torch.zeros(5, 40), "floats apart"),
                       (torch.zeros(5, 96)[:, :40], "floats apart"),
                       (torch.zeros(4, 64)[:, :40], "shape"),
                       (torch.zeros(5, 64, dtype=torch.float64)[:, :40], "float32")):
        with pytest.raises((ValueError, TypeError), match=match):
            tsne_calibrate.check_pitch(bad, "p", 5, 40)


def test_plain_versions_take_padded_rows():
    """The plain iteration and symmetrization on P's padded view give what
    they give on the contiguous P, bit for bit."""
    x = _points(50, 10)
    p = tsne_calibrate.calibrate(port._squared_distances(torch.from_numpy(x)), 30.0)
    n = p.shape[0]
    padded = tsne_calibrate.empty_rows(n, n, "cpu")
    padded.copy_(p)
    assert torch.equal(tsne_calibrate.symmetrize_plain(padded), tsne_calibrate.symmetrize_plain(p))
    rng = np.random.RandomState(2)
    state = [torch.from_numpy(a) for a in (rng.randn(n, 2).astype(np.float32),
                                           rng.randn(n, 2).astype(np.float32),
                                           rng.uniform(0.01, 3, (n, 2)).astype(np.float32))]
    for a, b in zip(tsne_step.step_plain(padded, *state, 12.0, 0.5, 200.0),
                    tsne_step.step_plain(p, *state, 12.0, 0.5, 200.0)):
        assert torch.equal(a, b)


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


def _split_step(p, y, vel, gains, exaggeration, momentum, lr):
    """One iteration with K10's association of the sums
    (``split_sums_plain``), then the plain epilogue."""
    gy_ext = tsne_step.split_sums_plain(p, y, exaggeration)
    grad = 4.0 * (gy_ext[:, 2:] * y - gy_ext[:, :2])
    same_sign = torch.sign(grad) == torch.sign(vel)
    gains = torch.clamp_min(torch.where(same_sign, gains * 0.8, gains + 0.2), 0.01)
    vel = momentum * vel - lr * gains * grad
    y = y + vel
    return y - torch.mean(y, dim=0), vel, gains


def _terms_errors(p, state, got, want, exaggeration, lr):
    """``chip_smoke.k10_check``'s measure in float64 on the CPU: vel's
    error over its update's terms 4·lr·gains·(|rowsum·y| + Σ|g|·|y|) where
    the gains agree, y's over those terms plus max|y|, and the gains that
    differ where the gradient does not cancel to within K10_TOL (1e-4) of
    its terms."""
    y = state[0].astype(np.float64)
    n = y.shape[0]
    sq = (y * y).sum(1)
    num = 1.0 / (1.0 + np.maximum(sq[:, None] + sq[None, :] - 2.0 * y @ y.T, 0.0))
    g = (exaggeration * p.astype(np.float64) - num / (num.sum() - n)) * num
    rowsum = g.sum(1, keepdims=True)
    mag = np.abs(rowsum * y) + np.abs(g) @ np.abs(y)
    ratio = np.abs(rowsum * y - g @ y) / (mag + 1e-300)
    terms = 4.0 * lr * np.maximum(got[2], want[2]) * mag
    same = got[2] == want[2]
    v_err = (np.abs(got[1] - want[1]) / terms)[same].max()
    y_err = (np.abs(got[0] - want[0]) / (terms + np.abs(want[0]).max()))[same].max()
    return v_err, y_err, int((~same & (ratio > 1e-4)).sum())


@pytest.mark.parametrize("n_per,pca", CASES)
def test_split_association_matches_the_reference(n_per, pca):
    """K10 sums g's attractive and repulsive parts apart (exag·Σ P·num·[y,
    1] − (1/Z)·Σ num²·[y, 1]).  In float32 that association holds one
    iteration to the reference's from the start (exaggerated) within the
    one-step bar, y and vel within 1e-5 of their largest entries.  From
    the reference's own states 300 and 1,000 iterations in, where P ≈
    num/Z, the parts exceed g several-fold and the gradient nearly cancels
    (vel ~1e-3 of y), that bar fails for the reference's own association
    too (the plain iteration: y 5.3e-5 of its scale at 300, vel 0.12 of
    its at 1,000): there both are held to the card's bar, K10_TOL = 1e-4
    of the update's terms (``chip_smoke.k10_check``), gains differing only
    where the gradient cancels (measured: the split ≤ 1.4e-5, the plain
    ≤ 1.3e-5)."""
    x = _points(n_per, pca)
    p = np.asarray(ref._calibrate_points(jnp.asarray(x), 30.0))
    n = p.shape[0]
    cfg = RefConfig()
    y0 = (np.random.RandomState(0).randn(n, 2) * 1e-4).astype(np.float32)
    start = [y0, np.zeros((n, 2), np.float32), np.ones((n, 2), np.float32)]
    pt = torch.from_numpy(p.copy())
    for it in (0, 300, 1000):
        state = start if it == 0 else _ref_segment(cfg, p, *start, 0, it)
        exag = cfg.early_exaggeration if it < cfg.exaggeration_iters else 1.0
        mom = cfg.momentum_start if it < cfg.momentum_switch_iter else cfg.momentum_final
        want = _ref_segment(cfg, p, *state, it, 1)
        got = _split_step(pt, *(torch.from_numpy(np.array(a, np.float32)) for a in state),
                          exag, mom, cfg.learning_rate)
        got = [t.numpy() for t in got]
        if it == 0:
            assert _scaled(got[0], want[0]) <= 1e-5 and _scaled(got[1], want[1]) <= 1e-5
            np.testing.assert_array_equal(got[2], want[2])
            continue
        plain = _port_segment(TSNEConfig(), p, *state, it, 1)
        for label, out in (("split", got), ("plain", plain)):
            v_err, y_err, bad = _terms_errors(p, state, out, want, exag, cfg.learning_rate)
            assert v_err <= 1e-4 and y_err <= 1e-4 and bad == 0, (label, it, v_err, y_err, bad)
            print(f"N {n}, iteration {it}, {label}: vel {v_err:.2e} and y {y_err:.2e} of the "
                  f"terms")


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
    assert ws.partials.shape == (1, 4) and ws.sync.tolist() == [0, 0]
    assert ws.rows.shape == (6, tsne_step.ROW_WORDS)


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
