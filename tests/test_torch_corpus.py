"""The port's corpus builder (``gene2vec_tpu_torch/corpus``) and K11's plain
version against the JAX package's ``corpus/builder.py`` on the CPU.

The pandas and numpy parts must be equal.  The float32 mask (the port's
``backend="torch"``, K11's plain version here) must equal the reference's
jax mask and its float64 numpy mask except on pairs whose float64 |corr|
lies within ``EPS_N = (n + 2)·2⁻²⁴`` of the threshold: float32's dot over
n terms of standardized columns (Σz² = n − 1) plus the cast of z.  Those
pairs are counted, never hidden.
"""

import json
import os

import numpy as np
import pandas as pd
import pytest

from gene2vec_tpu.cli import generate_pairs as ref_cli
from gene2vec_tpu.corpus import builder as ref
from gene2vec_tpu_torch.cli import generate_pairs as port_cli
from gene2vec_tpu_torch.corpus import builder as port
from gene2vec_tpu_torch.kernels import coexpr_mask

CPU = "cpu"


def _toy_query(root, n_samples=25, seed=0):
    """Two studies, 'ENSG|SYM' ids with a duplicate and an empty symbol, a
    low-count gene and a planted correlated pair (``tests/test_corpus.py``'s
    directory)."""
    rng = np.random.RandomState(seed)
    samples = [f"S{i}" for i in range(2 * n_samples)]
    gene_ids = ["ENSG01|GA", "ENSG02|GB", "ENSG03|GC", "ENSG04|GD",
                "ENSG05|DUP", "ENSG06|DUP", "ENSG07|", "ENSG08|GLOW"]
    ens = [g.split("|")[0] for g in gene_ids]
    tpm = rng.rand(len(samples), len(ens)) * 10
    tpm[:, 1] = tpm[:, 0] * 3.0 + 0.01 * rng.rand(len(samples))
    tpm[0, 2] = 0.0
    counts = (tpm * 100).round()
    counts[:, 7] = 0.0
    studies = ["ST1"] * n_samples + ["ST2"] * n_samples
    return _write_query(root, samples, studies, gene_ids, tpm, counts)


def _write_query(root, samples, studies, gene_ids, tpm, counts):
    d = os.path.join(root, "query", "data")
    os.makedirs(d)
    pd.DataFrame({"SRA Study": studies}, index=pd.Index(samples, name="Run")).to_csv(
        os.path.join(d, "SRARunTable.csv"))
    ens = [g.split("|")[0] for g in gene_ids]
    pd.DataFrame(tpm, index=pd.Index(samples, name="run"), columns=ens).to_csv(
        os.path.join(d, "gene_counts_TPM.csv"))
    cdf = pd.DataFrame(counts.T, columns=samples)
    cdf.insert(0, "gene_id", gene_ids)
    cdf.to_csv(os.path.join(d, "gene_counts.csv"), index=False)
    return os.path.join(root, "query")


def _module_query(root, seed=3, genes=300, studies=((25, "SA"), (35, "SB"), (12, "SC"))):
    """60 samples in two kept studies (and one of 12, dropped) × 300 genes:
    planted co-expression modules, low-count genes, empty and duplicate
    symbols, zeros."""
    rng = np.random.RandomState(seed)
    n_total = sum(n for n, _ in studies)
    samples = [f"R{i}" for i in range(n_total)]
    labels = [s for n, s in studies for _ in range(n)]
    logv = rng.randn(n_total, genes)
    for m in range(12):  # modules of 8 genes: corr ~0.95-0.99
        cols = rng.choice(genes, 8, replace=False)
        factor = rng.randn(n_total)
        logv[:, cols] = factor[:, None] + rng.uniform(0.1, 0.3, 8) * rng.randn(n_total, 8)
    tpm = np.exp2(logv + 4.0)
    tpm[rng.rand(*tpm.shape) < 0.01] = 0.0
    counts = np.round(tpm * 3)
    gene_ids = [f"ENSG{i:05d}|S{i}" for i in range(genes)]
    for i in range(0, 20):
        gene_ids[i] = f"ENSG{i:05d}|"                 # empty symbol
    for i in range(20, 30):
        gene_ids[i] = f"ENSG{i:05d}|DUP{i % 4}"       # duplicates
    counts[:, 30:40] = 0.0                             # below the count filter
    return _write_query(root, samples, labels, gene_ids, tpm, counts)


def _near(corr64, thr, n):
    return np.abs(corr64 - thr) <= coexpr_mask.eps_n(n)


def _assert_mask_agrees(got, want, x, thr, backend):
    """got == want except on pairs within EPS_N of thr (float64 |corr|);
    returns how many of those differ."""
    corr64 = ref.abs_correlation(x, backend="numpy")
    n = x.shape[0]
    assert got.shape == want.shape == corr64.shape
    diff = got != want
    near = _near(corr64, thr, n)
    far = diff & ~near
    assert not far.any(), f"{backend}: {int(far.sum())} pairs differ outside EPS_N"
    return int((diff & near).sum())


def _planted(n, g, thr, seed):
    """An (n, g) matrix with column 1 at |corr| = thr to column 0, a
    zero-variance column 2 and a near-copy pair (4, 5)."""
    rng = np.random.RandomState(seed)
    x = rng.randn(n, g)
    a = x[:, 0] - x[:, 0].mean()
    b = rng.randn(n)
    b -= b.mean()
    b -= a * (a @ b) / (a @ a)
    a /= np.linalg.norm(a)
    b /= np.linalg.norm(b)
    x[:, 1] = thr * a + np.sqrt(1 - thr * thr) * b
    x[:, 2] = 7.0
    if g > 5:
        x[:, 5] = x[:, 4] + 0.01 * rng.randn(n)
    return x


def test_half_min_and_split_ids():
    x = np.array([[0.0, 4.0], [2.0, 0.0]])
    assert port.half_min(x) == ref.half_min(x) == 1.0
    with pytest.raises(ValueError):
        port.half_min(np.zeros((2, 2)))
    ids = ["E1|A", "E2", "E3|", "E4|B|C"]
    assert port._split_gene_ids(ids) == ref._split_gene_ids(ids)


@pytest.mark.parametrize("ensembl", [True, False])
def test_cleaning_frames_equal_the_reference(tmp_path, ensembl):
    q = _module_query(str(tmp_path))
    data = pd.read_csv(f"{q}/data/gene_counts_TPM.csv", index_col=0)
    counts = pd.read_csv(f"{q}/data/gene_counts.csv")
    ids = data.index[:25].tolist()
    ghm = ref.half_min(data.values)
    for kw in ({}, {"global_half_min": ghm, "min_total_counts": 50.0}):
        fn_ref = ref.clean_and_normalize if ensembl else ref.gene_annotated_data
        fn_port = port.clean_and_normalize if ensembl else port.gene_annotated_data
        want = fn_ref(data, counts, ids, **kw)
        got = fn_port(data, counts, ids, **kw)
        pd.testing.assert_frame_equal(got, want)
        # the builder's jobs carry only the study's own rows and columns
        sliced = fn_port(data.loc[ids], counts[["gene_id", *ids]], ids,
                         **{"global_half_min": ghm, **kw})
        pd.testing.assert_frame_equal(sliced, fn_ref(data, counts, ids,
                                                     **{"global_half_min": ghm, **kw}))


@pytest.mark.parametrize("shape,seed", [((30, 12), 0), ((25, 8), 1), ((40, 13), 2),
                                        ((60, 300), 3)])
def test_abs_correlation_torch_backend_matches_both(shape, seed):
    x = np.random.RandomState(seed).randn(*shape)
    x[:, 5] = 7.0  # zero variance
    got = port.abs_correlation(x, backend="torch", device=CPU)
    np.testing.assert_allclose(got, ref.abs_correlation(x, "numpy"), atol=1e-6, rtol=0)
    np.testing.assert_allclose(got, ref.abs_correlation(x, "jax"), atol=1e-6, rtol=0)
    np.testing.assert_array_equal(port.abs_correlation(x, backend="numpy"),
                                  ref.abs_correlation(x, "numpy"))
    assert (got[5] == 0).all()


#: (n, g, thr): tests/test_corpus.py's sizes, then g not a multiple of 8 or 32
MASK_CASES = [(30, 12, 0.9), (25, 8, 0.9), (40, 13, 0.9), (40, 13, 1.0),
              (24, 13, 0.9), (24, 33, 0.9), (60, 100, 0.5), (160, 300, 0.9),
              (60, 300, 0.3), (21, 33, 1.0), (40, 100, 0.0)]


@pytest.mark.parametrize("n,g,thr", MASK_CASES)
def test_mask_equals_jax_and_numpy_outside_eps(n, g, thr):
    x = _planted(n, g, min(thr, 0.95), seed=n + g)
    got = port.abs_correlation_mask(x, thr, backend="torch", device=CPU)
    flips_jax = _assert_mask_agrees(got, ref.abs_correlation_mask(x, thr, backend="jax"),
                                    x, thr, "jax")
    flips_np = _assert_mask_agrees(got, ref.abs_correlation_mask(x, thr, backend="numpy"),
                                   x, thr, "numpy")
    assert flips_jax <= 2 and flips_np <= 2  # at most the planted pair, both ways
    print(f"n {n} g {g} thr {thr}: pairs within EPS_N that differ: jax {flips_jax}, "
          f"numpy {flips_np}")
    np.testing.assert_array_equal(got, got.T)
    assert not got[2].any() and not got[:, 2].any()  # zero-variance column
    if thr >= 1.0:
        assert not got.any()
    elif thr < 0.95:
        assert got[4, 5] and got[5, 4]
    np.testing.assert_array_equal(
        port.abs_correlation_mask(x, thr, backend="numpy"),
        ref.abs_correlation_mask(x, thr, backend="numpy"))


def test_planted_pair_at_the_threshold_is_inside_eps():
    """|corr| = thr exactly (to float64 rounding) is a pair the float32
    mask may take either way: it lies inside EPS_N, and the mask agrees
    with numpy on every other pair."""
    for n, thr in ((24, 0.9), (160, 0.9), (64, 0.5)):
        x = _planted(n, 40, thr, seed=n)
        corr64 = ref.abs_correlation(x, "numpy")
        assert abs(corr64[0, 1] - thr) < 1e-12
        assert _near(corr64, thr, n)[0, 1]
        got = port.abs_correlation_mask(x, thr, backend="torch", device=CPU)
        assert got[0, 1] == got[1, 0]
        _assert_mask_agrees(got, ref.abs_correlation_mask(x, thr, "numpy"), x, thr, "numpy")


def test_eps_n_covers_float32_error():
    """EPS_N bounds the float32 product's distance from float64 on
    standardized columns: measured over random studies it stays below."""
    worst = 0.0
    for n in (20, 24, 64, 160):
        x = np.random.RandomState(n).randn(n, 200)
        corr64 = ref.abs_correlation(x, "numpy")
        z, _ = ref._standardized_columns(x)
        import torch

        zt = torch.from_numpy(z.astype(np.float32))
        c32 = torch.clamp(torch.abs(zt.T @ zt) / (n - 1), 0, 1).numpy()
        err = np.abs(c32.astype(np.float64) - corr64).max()
        worst = max(worst, err / coexpr_mask.eps_n(n))
    assert worst < 1.0, worst


@pytest.mark.parametrize("thr", [-0.1, 0.0, 0.1, 0.3, 0.5, 0.9, 0.999999, 1.0, 1.5])
@pytest.mark.parametrize("n", [2, 7, 21, 24, 160, 985])
def test_sum_threshold_is_the_references_epilogue(n, thr):
    """K11 tests |sum| ≥ a* (``coexpr_mask.sum_threshold``) where the
    reference divides, clips and compares (builder.py:166-170).  On ±2¹⁷
    float32 patterns about a* (about +inf where a* is NaN: no sum passes),
    their negatives, ±inf, NaN, ±0 and seeded random sums in [−n, n], the
    test equals numpy's float32 epilogue everywhere, and jax.numpy's
    wherever XLA's CPU keeps the sum and its quotient: it flushes
    subnormals to 0, where numpy, the first design's ``__fdiv_rn`` and
    the card keep IEEE's."""
    import jax.numpy as jnp

    a = coexpr_mask.sum_threshold(n, thr)
    t32 = np.float32(thr)
    assert np.isnan(a) == (t32 >= 1) and (a == 0.0) == (t32 < 0)
    centre = 0x7F800000 if np.isnan(a) else int(np.float32(a).view(np.uint32))
    pats = np.arange(max(0, centre - 2 ** 17), min(0x7F800000, centre + 2 ** 17) + 1)
    v = pats.astype(np.uint32).view(np.float32)
    rand = np.random.RandomState(n).uniform(-n, n, 100_000).astype(np.float32)
    v = np.concatenate([v, -v, rand, np.float32([np.inf, -np.inf, np.nan, 0.0, -0.0])])
    ours = np.abs(v) >= np.float32(a)
    with np.errstate(all="ignore"):
        quot = np.abs(v) / np.float32(n - 1)
        np.testing.assert_array_equal(ours, np.clip(quot, np.float32(0.0), np.float32(1.0)) > t32)
    ref = np.asarray(jnp.clip(jnp.abs(jnp.asarray(v)) / (n - 1), 0.0, 1.0) > thr)
    tiny = np.float32(np.finfo(np.float32).tiny)
    flushed = (v != 0) & ((np.abs(v) < tiny) | (quot < tiny))
    np.testing.assert_array_equal(ours[~flushed], ref[~flushed])
    if 0 < t32 < 1:  # a* is normal: the whole window is held to the reference
        assert not flushed[:2 * len(pats)].any()


@pytest.mark.parametrize("g", [1, 7, 31, 32, 33, 64, 70, 300])
def test_word_packing_round_trips(g):
    import torch

    rng = np.random.RandomState(g)
    bits = rng.rand(g, g) < 0.3
    words = coexpr_mask.pack_plain(torch.from_numpy(bits))
    assert words.dtype == torch.int32 and words.shape == (g, -(-g // 32))
    np.testing.assert_array_equal(coexpr_mask.unpack(words, g).numpy(), bits)
    # bit b of word w is column 32w + b
    w = words.numpy().view(np.uint32)
    i, j = np.nonzero(bits)
    assert ((w[i, j // 32] >> (j % 32).astype(np.uint32)) & 1).all()


def _near_lines(query, thr, min_study_samples=20):
    """Pair lines of either direction whose float64 |corr| lies within
    EPS_N of thr in some study: the lines a float32 mask may add or drop."""
    data = pd.read_csv(f"{query}/data/gene_counts_TPM.csv", index_col=0)
    counts = pd.read_csv(f"{query}/data/gene_counts.csv")
    table = pd.read_csv(f"{query}/data/SRARunTable.csv", index_col=0)
    data = data.loc[table.index.tolist()]
    ghm = ref.half_min(data.values)
    out = set()
    vc = table["SRA Study"].value_counts()
    for s in vc.index[vc >= min_study_samples]:
        ids = table.index[table["SRA Study"] == s].tolist()
        normed = ref.gene_annotated_data(data, counts, ids, global_half_min=ghm)
        corr64 = ref.abs_correlation(normed.values, "numpy")
        genes = list(normed.columns)
        for r, c in zip(*np.nonzero(_near(corr64, thr, len(ids)))):
            if r != c:
                out.add(f"{genes[r]} {genes[c]}")
    return out


def _assert_lines_agree(got, want, allowed):
    extra = set(got) ^ set(want)
    assert extra <= allowed, sorted(extra - allowed)[:5]
    common = set(got) & set(want)
    assert [p for p in got if p in common] == [p for p in want if p in common]
    return len(extra)


@pytest.mark.parametrize("kind,parallel,backend", [
    ("toy", False, "torch"), ("toy", True, "torch"), ("modules", False, "torch"),
    ("modules", True, "torch"), ("modules", False, "numpy"), ("modules", True, "numpy")])
def test_build_pairs_lines_equal_the_reference(tmp_path, kind, parallel, backend):
    q = (_toy_query if kind == "toy" else _module_query)(str(tmp_path))
    want = ref.build_pairs(q, log=lambda s: None)
    out = tmp_path / "pairs.txt"
    got = port.build_pairs(q, str(out), parallel=parallel, num_workers=2, backend=backend,
                           device=CPU, log=lambda s: None)
    assert out.read_text(encoding="utf-8") == "\n".join(got)
    if backend == "numpy":
        assert got == want
    else:
        flips = _assert_lines_agree(got, want, _near_lines(q, 0.9))
        print(f"{kind}: {len(got)} lines, {flips} within EPS_N differ")
    if kind == "toy":
        assert "GA GB" in got and "GB GA" in got
    else:
        assert len(got) > 300  # the planted modules


def _events(run_dir):
    with open(os.path.join(run_dir, "events.jsonl"), encoding="utf-8") as f:
        recs = [json.loads(x) for x in f if x.strip()]
    return {(r["type"], r["name"]) for r in recs}, recs


@pytest.mark.parametrize("parallel", [False, True])
def test_run_dir_carries_the_reference_names(tmp_path, parallel):
    """The reference's serial build gives the names; its parallel build
    (a forked pool, not run here beside JAX's threads) replaces the
    per-study spans by one ``correlate_studies`` span and ``study``
    events (``gene2vec_tpu/corpus/builder.py:300-323``)."""
    q = _toy_query(str(tmp_path))
    ref.build_pairs(q, str(tmp_path / "r.txt"), log=lambda s: None,
                    run_dir=str(tmp_path / "run_ref"))
    port.build_pairs(q, str(tmp_path / "p.txt"), parallel=parallel, num_workers=2,
                     device=CPU, log=lambda s: None, run_dir=str(tmp_path / "run_port"))
    names_ref, _ = _events(str(tmp_path / "run_ref"))
    names_port, recs = _events(str(tmp_path / "run_port"))
    if parallel:
        names_ref = (names_ref - {("span_start", "study"), ("span_end", "study")}) | {
            ("span_start", "correlate_studies"), ("span_end", "correlate_studies"),
            ("event", "study")}
    assert names_port == names_ref
    probe = [r for r in recs if r["name"] == "probe"]
    assert len(probe) == 1 and probe[0]["attrs"]["host_rss_bytes"] > 0
    with open(tmp_path / "run_port" / "manifest.json", encoding="utf-8") as f:
        manifest = json.load(f)
    assert manifest["name"] == "generate_pairs"
    assert manifest["config"]["backend"] == "torch"
    assert manifest["backend"]["platform"] in ("cpu", "gpu")
    prom = (tmp_path / "run_port" / "metrics.prom").read_text()
    for name in ("studies_total", "pairs_total", "host_rss_bytes"):
        assert name in prom


def _flags(parser):
    return {s for a in parser._actions for s in a.option_strings}


def test_cli_flags_are_the_references_plus_device():
    ref_flags, port_flags = _flags(ref_cli.build_parser()), _flags(port_cli.build_parser())
    assert port_flags == ref_flags | {"--device"}
    backend = [a for a in port_cli.build_parser()._actions if "--backend" in a.option_strings][0]
    assert backend.choices == ("torch", "numpy") and backend.default == "torch"
    args = port_cli.build_parser().parse_args(["--query", "q", "--out", "o"])
    want = ref_cli.build_parser().parse_args(["--query", "q", "--out", "o"])
    for k in ("corr_threshold", "min_study_samples", "min_total_counts", "parallel",
              "num_workers", "ensembl", "run_dir"):
        assert getattr(args, k) == getattr(want, k)
    assert args.device == "cuda"


def test_cli_writes_the_pair_file(tmp_path, capsys):
    q = _toy_query(str(tmp_path))
    out = tmp_path / "pairs.txt"
    assert port_cli.main(["--query", q, "--out", str(out), "--device", "cpu"]) == 0
    assert out.read_text(encoding="utf-8") == "\n".join(ref.build_pairs(q, log=lambda s: None))
    assert "total co-expression gene pairs" in capsys.readouterr().out


def test_corpus_config_matches_the_reference():
    import dataclasses

    from gene2vec_tpu.config import CorpusConfig as RefConfig
    from gene2vec_tpu_torch.config import CorpusConfig

    assert dataclasses.asdict(CorpusConfig()) == dataclasses.asdict(RefConfig())


def test_device_path_hands_the_kernel_a_row_major_z(monkeypatch):
    """pandas gives column-major values; the CUDA path must still pass the
    kernel's argument checks (here it reaches the stubbed loader)."""
    from gene2vec_tpu_torch.kernels import _args, build

    def fake_load(name):
        raise RuntimeError("kernel library unavailable")

    frame = pd.DataFrame(np.random.RandomState(0).randn(30, 12))
    assert not frame.values.flags.c_contiguous
    monkeypatch.setattr(build, "load", fake_load)
    monkeypatch.setattr(_args, "on_cpu", lambda *t: False)
    with pytest.raises(RuntimeError, match="unavailable"):
        port.abs_correlation_mask(frame.values, 0.9, device=CPU)
