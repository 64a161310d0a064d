"""Pair-corpus builder: per-study co-expression thresholding — the port of
``gene2vec_tpu/corpus/builder.py``.

The recipe (``src/generate_gene_pairs.py``), kept exactly:

* keep studies with ≥ ``min_study_samples`` samples;
* per study: drop genes whose per-study total raw counts are < 10, replace
  zeros with half of the **global** non-zero minimum of the full TPM
  matrix (a reference quirk, kept), log2;
* optionally map ``ENSEMBL|SYMBOL`` gene ids to symbols, dropping empty
  and non-unique symbols;
* |Pearson correlation| > threshold emits a pair; the scan over the full
  symmetric matrix emits both (i, j) and (j, i), diagonal excluded.

The pandas and numpy parts are the reference's, bit for bit.  Correlation
is ZᵀZ/(n−1) with Z the column-standardized matrix (float64 on the host;
zero-variance columns all-zero, so they never pass).  Backends:

* ``"torch"`` (the default): Z cast to float32 and thresholded on the
  device by K11 (``kernels/coexpr_mask.py``), which writes only packed
  bits; on the CPU (``device="cpu"``) its plain torch version.  It differs
  from ``"numpy"`` only on pairs whose float64 |corr| lies within
  ``EPS_N = (n + 2)·2⁻²⁴`` of the threshold, as the reference's own
  ``"jax"`` backend does;
* ``"numpy"``: the reference's float64 host path.

``parallel=True`` runs a ``spawn`` process pool.  With ``"numpy"`` each
worker builds its study's pairs, as the reference's pool does; with
``"torch"`` the workers only clean and normalize (pandas, on the CPU) and
this process runs K11 for each study, in study order, on the one card.
"""

from __future__ import annotations

import os
from typing import Callable, List, Optional, Sequence, Tuple

import numpy as np

MIN_TOTAL_COUNTS = 10.0
BACKENDS = ("torch", "numpy")


def half_min(x: np.ndarray) -> float:
    """Half of the smallest positive entry (zero-replacement value)."""
    pos = x[x > 0]
    if pos.size == 0:
        raise ValueError("matrix has no positive entries")
    return float(pos.min() / 2.0)


def _split_gene_ids(gene_ids: Sequence[str]) -> Tuple[List[str], List[str]]:
    """'ENSEMBL|SYMBOL' ids → (ensembl list, symbol list; '' if absent)."""
    ens, sym = [], []
    for gid in gene_ids:
        parts = str(gid).split("|")
        ens.append(parts[0])
        sym.append(parts[1] if len(parts) > 1 else "")
    return ens, sym


def clean_and_normalize(
    data,
    gene_counts,
    sample_ids: Optional[List[str]] = None,
    *,
    min_total_counts: float = MIN_TOTAL_COUNTS,
    global_half_min: Optional[float] = None,
):
    """Per-study cleaned + log2 TPM slice (pandas in, pandas out).

    ``data``: samples × genes TPM; ``gene_counts``: raw counts with a
    ``gene_id`` column and per-sample columns.  Gene totals are computed
    over the study's samples; the zero-replacement half-min over the
    **global** matrix.
    """
    import pandas as pd

    if sample_ids is None:
        sample_ids = data.index.tolist()
    ens, _ = _split_gene_ids(gene_counts["gene_id"])
    totals = pd.Series(index=ens, data=gene_counts.loc[:, sample_ids].sum(axis=1).values)
    keep = totals >= min_total_counts
    sub = data.loc[sample_ids, keep.values].copy()
    hm = half_min(data.values) if global_half_min is None else global_half_min
    sub = sub.replace(0.0, hm)
    return np.log2(sub)


def gene_annotated_data(
    data,
    gene_counts,
    sample_ids: Optional[List[str]] = None,
    *,
    min_total_counts: float = MIN_TOTAL_COUNTS,
    global_half_min: Optional[float] = None,
):
    """clean_and_normalize + rename columns to gene symbols, keeping only
    genes with a non-empty, unique symbol."""
    normed = clean_and_normalize(
        data, gene_counts, sample_ids,
        min_total_counts=min_total_counts, global_half_min=global_half_min,
    )
    ens, sym = _split_gene_ids(gene_counts["gene_id"])
    names = dict(zip(ens, sym))
    normed = normed.rename(columns=names)
    normed = normed.loc[:, normed.columns != ""]
    vc = normed.columns.value_counts()
    return normed.loc[:, vc.index[vc == 1]]


def _standardized_columns(matrix: np.ndarray):
    """(z, n): columns centered and scaled to unit sample-variance in
    float64; zero-variance columns become all-zero (they can never pass a
    positive threshold — pandas' NaN-never-compares behavior)."""
    x = np.asarray(matrix, dtype=np.float64)
    n = x.shape[0]
    mean = x.mean(axis=0)
    std = x.std(axis=0, ddof=1)
    ok = std > 0
    return np.where(ok, (x - mean) / np.where(ok, std, 1.0), 0.0), n


def _device_z(matrix: np.ndarray, device):
    """The float32 standardized matrix on the resolved device, and n."""
    import torch

    from gene2vec_tpu_torch.device import resolve_device

    dev = resolve_device(device)
    z, n = _standardized_columns(matrix)
    # pandas hands back column-major values: the kernel takes row-major z
    return torch.from_numpy(np.ascontiguousarray(z, dtype=np.float32)).to(dev), n


def abs_correlation(matrix: np.ndarray, backend: str = "torch", device=None) -> np.ndarray:
    """|Pearson correlation| between columns, as a standardized matmul
    (``"torch"``: one float32 ``torch.matmul`` on ``device``, the library
    product the reference leaves to XLA)."""
    if backend == "torch":
        import torch

        zt, n = _device_z(matrix, device)
        corr = (torch.abs(torch.matmul(zt.T, zt)) / (n - 1)).cpu().numpy()
    elif backend == "numpy":
        z, n = _standardized_columns(matrix)
        corr = np.abs(z.T @ z) / (n - 1)
    else:
        raise ValueError(f"unknown backend {backend!r}")
    return np.clip(corr, 0.0, 1.0)


def abs_correlation_mask(
    matrix: np.ndarray, threshold: float, backend: str = "torch", device=None
) -> np.ndarray:
    """(genes, genes) bool mask of ``|corr| > threshold``.

    ``"torch"`` thresholds on the device (K11 on a CUDA device, its plain
    version on the CPU) and brings back packed bits — genes²/8 bytes —
    which the host unpacks."""
    if backend != "torch":
        return abs_correlation(matrix, backend=backend) > threshold
    from gene2vec_tpu_torch.kernels import coexpr_mask

    zt, _ = _device_z(matrix, device)
    words = coexpr_mask.coexpr_mask(zt, threshold).cpu()
    return coexpr_mask.unpack(words, zt.shape[1]).numpy()


def coexpression_pairs(
    normed, *, corr_threshold: float = 0.9, backend: str = "torch", device=None
) -> List[str]:
    """'g1 g2' lines for every |corr| > threshold column pair — both
    directions, no self-pairs, in row-major order."""
    genes = list(normed.columns)
    mask = abs_correlation_mask(normed.values, corr_threshold, backend=backend, device=device)
    rows, cols = mask.nonzero()
    return [f"{genes[r]} {genes[c]}" for r, c in zip(rows, cols) if r != c]


def _study_normed(args):
    data, gene_counts, sample_ids, ensembl, _, min_total_counts, ghm, _ = args
    fn = clean_and_normalize if ensembl else gene_annotated_data
    return fn(data, gene_counts, sample_ids, min_total_counts=min_total_counts,
              global_half_min=ghm)


def _study_pairs(args, device=None) -> List[str]:
    corr_threshold, backend = args[4], args[7]
    return coexpression_pairs(_study_normed(args), corr_threshold=corr_threshold,
                              backend=backend, device=device)


def build_pairs(
    query_dir: str,
    out_path: Optional[str] = None,
    *,
    corr_threshold: float = 0.9,
    min_study_samples: int = 20,
    min_total_counts: float = MIN_TOTAL_COUNTS,
    ensembl: bool = False,
    parallel: bool = False,
    num_workers: Optional[int] = None,
    backend: str = "torch",
    device=None,
    log: Callable[[str], None] = print,
    run_dir: Optional[str] = None,
) -> List[str]:
    """End-to-end: query dir (``data/SRARunTable.csv``,
    ``data/gene_counts_TPM.csv``, ``data/gene_counts.csv``) → pair lines,
    optionally written to ``out_path``.  ``backend="torch"`` runs on
    ``device`` (``None``/"cuda": the GPU, raising without one; "cpu" only
    when asked).

    ``run_dir`` observes the build: manifest + per-study spans/pair
    counts, under the reference's span, counter and event names."""
    if backend not in BACKENDS:
        raise ValueError(f"unknown backend {backend!r}")
    if backend == "torch":
        from gene2vec_tpu_torch.device import resolve_device

        device = resolve_device(device)
    run = None
    if run_dir is not None:
        from gene2vec_tpu_torch.obs.run import Run

        run = Run(
            run_dir, name="generate_pairs",
            config={
                "query_dir": query_dir, "corr_threshold": corr_threshold,
                "min_study_samples": min_study_samples,
                "min_total_counts": min_total_counts, "ensembl": ensembl,
                "parallel": parallel, "backend": backend,
            },
            # device facts are annotated after the correlation work, as
            # the reference does
            probe_devices=False,
        )
    try:
        return _build_pairs_observed(
            query_dir, out_path, corr_threshold, min_study_samples,
            min_total_counts, ensembl, parallel, num_workers, backend, device,
            log, run,
        )
    finally:
        if run is not None:
            run.close()


def _build_pairs_observed(
    query_dir, out_path, corr_threshold, min_study_samples,
    min_total_counts, ensembl, parallel, num_workers, backend, device, log, run,
) -> List[str]:
    import contextlib

    import pandas as pd

    span = run.span if run is not None else (lambda name, **a: contextlib.nullcontext({}))

    with span("load_inputs"):
        run_table = pd.read_csv(os.path.join(query_dir, "data", "SRARunTable.csv"),
                                index_col=0)
        data = pd.read_csv(os.path.join(query_dir, "data", "gene_counts_TPM.csv"),
                           index_col=0)
        gene_counts = pd.read_csv(os.path.join(query_dir, "data", "gene_counts.csv"))
        data = data.loc[run_table.index.tolist()]

    study_counts = run_table["SRA Study"].value_counts()
    studies = study_counts.index[study_counts >= min_study_samples].tolist()
    log(f"{len(studies)} studies with ≥{min_study_samples} samples")

    ghm = half_min(data.values)  # global, computed once (reference quirk)
    jobs = []
    for s in studies:
        ids = run_table.index[run_table["SRA Study"] == s].tolist()
        # each job carries only its study's samples: the cleaning reads no
        # other row or count column once the global half-min is given
        jobs.append((data.loc[ids], gene_counts[["gene_id", *ids]], ids, ensembl,
                     corr_threshold, min_total_counts, ghm, backend))
    if parallel and len(jobs) > 1:
        import multiprocessing as mp

        # pool workers carry no tracer; the map is one span, per-study
        # pair counts land as events afterwards
        with span("correlate_studies", n_studies=len(jobs), parallel=True):
            ctx = mp.get_context("spawn")
            with ctx.Pool(num_workers or os.cpu_count()) as pool:
                if backend == "numpy":
                    results = pool.map(_study_pairs, jobs)
                else:
                    # workers clean on the CPU; the card thresholds here,
                    # one study after another
                    results = [
                        coexpression_pairs(normed, corr_threshold=corr_threshold,
                                           backend=backend, device=device)
                        for normed in pool.imap(_study_normed, jobs)
                    ]
        if run is not None:
            for s, r in zip(studies, results):
                run.event("study", study=str(s), n_pairs=len(r))
    else:
        results = []
        for s, j in zip(studies, jobs):
            with span("study", study=str(s), n_samples=len(j[2])) as out:
                r = _study_pairs(j, device)
                out["n_pairs"] = len(r)
            results.append(r)

    pairs = [p for r in results for p in r]
    if run is not None:
        run.registry.counter("studies_total").inc(len(studies))
        run.registry.counter("pairs_total").inc(len(pairs))
        run.annotate_backend()
        run.probe()
    log(f"{len(pairs):,} total co-expression gene pairs computed")
    if out_path is not None:
        with span("write_output", path=out_path):
            with open(out_path, "w", encoding="utf-8") as f:
                f.write("\n".join(pairs))
        log(f"wrote {out_path}")
    return pairs
