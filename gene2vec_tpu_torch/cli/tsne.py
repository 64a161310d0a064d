"""t-SNE sweep CLI — ``src/tsne_multi_core.py`` parity on the GPU (the
reference's ``gene2vec_tpu/cli/tsne.py``).

    python -m gene2vec_tpu_torch.cli.tsne emb_file out_dir [--iters 100 5000 ...]
        [--device {cuda,cpu}]

One exact t-SNE run snapshots the layout at every requested iteration
count and writes ``labels.txt`` plus ``tsne_iter_<n>.txt`` per snapshot.
``--device`` defaults to ``cuda``; without a GPU the CLI fails unless
``--device cpu`` is given.
"""

from __future__ import annotations

import argparse
import sys
from typing import List, Optional

from gene2vec_tpu_torch.config import TSNEConfig


def build_parser() -> argparse.ArgumentParser:
    d = TSNEConfig()
    p = argparse.ArgumentParser(
        prog="tsne",
        description="Project an embedding to 2-D, writing labels + "
                    "coordinates per snapshot iteration.",
    )
    p.add_argument("emb_file")
    p.add_argument("out_dir")
    p.add_argument(
        "--iters", type=int, nargs="+",
        default=[100, 5000, 10000, 20000, 50000, 100000],
        help="snapshot iteration counts (reference sweep values)",
    )
    p.add_argument("--pca-dims", type=int, default=d.pca_dims)
    p.add_argument("--perplexity", type=float, default=d.perplexity)
    p.add_argument("--learning-rate", type=float, default=d.learning_rate)
    p.add_argument("--seed", type=int, default=d.seed)
    p.add_argument("--no-shuffle", action="store_true")
    p.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    return p


def main(argv: Optional[List[str]] = None) -> int:
    args = build_parser().parse_args(argv)
    config = TSNEConfig(
        pca_dims=args.pca_dims,
        perplexity=args.perplexity,
        learning_rate=args.learning_rate,
        n_iter=max(args.iters),
        seed=args.seed,
    )
    from gene2vec_tpu_torch.device import resolve_device
    from gene2vec_tpu_torch.viz.tsne import run_tsne_sweep

    resolve_device(args.device)  # fail before any file is written
    run_tsne_sweep(
        args.emb_file,
        args.out_dir,
        iters=args.iters,
        config=config,
        shuffle_seed=None if args.no_shuffle else args.seed,
        device=args.device,
    )
    return 0


if __name__ == "__main__":
    sys.exit(main())
