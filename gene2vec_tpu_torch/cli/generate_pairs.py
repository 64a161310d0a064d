"""Co-expression pair-corpus construction CLI — the reference's
``gene2vec_tpu/cli/generate_pairs.py`` on the GPU.

    python -m gene2vec_tpu_torch.cli.generate_pairs --query Q --out O
        [--corr-threshold 0.9] [--min-study-samples 20] [--parallel]
        [--ensembl] [--backend {torch,numpy}] [--device {cuda,cpu}]

The reference's flags (``src/generate_gene_pairs.py:12-42``).  ``--backend
torch`` (the default) thresholds each study's correlations on the device
with K11 in float32; ``--backend numpy`` is the reference's default
float64 host path.  The two differ only on pairs whose float64 |corr| lies
within float32 rounding of the threshold, EPS_N = (n + 2)·2⁻²⁴ for a study
of n samples, as the reference's own ``--backend jax`` does.
``--device`` defaults to ``cuda``; without a GPU the torch backend fails
unless ``--device cpu`` is given.
"""

from __future__ import annotations

import argparse
import sys
from typing import List, Optional

from gene2vec_tpu_torch.config import CorpusConfig


def build_parser() -> argparse.ArgumentParser:
    d = CorpusConfig()
    p = argparse.ArgumentParser(
        prog="generate-pairs",
        description="Build a gene co-expression pair corpus from a query "
                    "directory (data/SRARunTable.csv, data/gene_counts_TPM.csv, "
                    "data/gene_counts.csv).",
    )
    p.add_argument("--query", required=True, help="query directory")
    p.add_argument("--out", required=True, help="output pair-file path")
    p.add_argument("--corr-threshold", type=float, default=d.corr_threshold)
    p.add_argument("--min-study-samples", type=int, default=d.min_study_samples)
    p.add_argument("--min-total-counts", type=float, default=d.min_total_counts)
    p.add_argument(
        "--parallel", action="store_true",
        help="per-study worker processes (spawned) for the pandas cleaning; "
             "with --backend torch the card thresholds the studies in order",
    )
    p.add_argument("--num-workers", type=int, default=d.num_workers)
    p.add_argument(
        "--ensembl", action="store_true",
        help="keep ENSEMBL ids instead of annotating gene symbols",
    )
    p.add_argument(
        "--backend", choices=("torch", "numpy"), default="torch",
        help="torch: float32 correlation threshold on the device (K11); numpy: "
             "the reference's float64 host path.  They differ only on pairs "
             "within (n + 2)·2⁻²⁴ of the threshold (n: the study's samples)",
    )
    p.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                   help="device of the torch backend")
    p.add_argument(
        "--run-dir", default=None,
        help="observe the build: manifest.json + events.jsonl with per-study spans",
    )
    return p


def main(argv: Optional[List[str]] = None) -> int:
    args = build_parser().parse_args(argv)
    from gene2vec_tpu_torch.corpus.builder import build_pairs

    build_pairs(
        args.query,
        args.out,
        corr_threshold=args.corr_threshold,
        min_study_samples=args.min_study_samples,
        min_total_counts=args.min_total_counts,
        ensembl=args.ensembl,
        parallel=args.parallel,
        num_workers=args.num_workers or None,
        backend=args.backend,
        device=args.device,
        run_dir=args.run_dir,
    )
    return 0


if __name__ == "__main__":
    sys.exit(main())
