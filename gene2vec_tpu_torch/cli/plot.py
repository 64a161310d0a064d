"""Embedding plot CLI — ``src/plot_gene2vec.py`` parity on the GPU (the
reference's ``gene2vec_tpu/cli/plot.py``).

    python -m gene2vec_tpu_torch.cli.plot emb_file out_prefix
        [--method {auto,umap,tsne,pca}] [--components {2,3}] [--annotate]
        [--seed N] [--device {cuda,cpu}]

Writes ``<out_prefix>.json`` and an ``.html`` (plotly) or ``.png``
(matplotlib); where neither package is installed, the json alone.  The default reduction is UMAP (K15, K16).  ``--device``
defaults to ``cuda``; without a GPU the CLI fails unless ``--device cpu``
is given.
"""

from __future__ import annotations

import argparse
import sys
from typing import List, Optional


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="plot",
        description="Reduce an embedding to 2-D/3-D and export an "
                    "interactive scatter (json + html/png).",
    )
    p.add_argument("emb_file")
    p.add_argument("out_prefix", help="output path prefix (no extension)")
    p.add_argument(
        "--method", choices=("auto", "umap", "tsne", "pca"), default="auto"
    )
    p.add_argument("--components", type=int, choices=(2, 3), default=2)
    p.add_argument(
        "--annotate", action="store_true",
        help="query NCBI gene info via mygene (network; gated)",
    )
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    return p


def main(argv: Optional[List[str]] = None) -> int:
    args = build_parser().parse_args(argv)
    from gene2vec_tpu_torch.device import resolve_device
    from gene2vec_tpu_torch.viz.plot import plot_gene2vec

    resolve_device(args.device)  # fail before any file is written
    plot_gene2vec(
        args.emb_file,
        args.out_prefix,
        method=args.method,
        n_components=args.components,
        annotate=args.annotate,
        seed=args.seed,
        device=args.device,
    )
    return 0


if __name__ == "__main__":
    sys.exit(main())
