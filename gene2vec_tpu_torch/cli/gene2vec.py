"""Embedding-training CLI — the reference's shape
(``gene2vec_tpu/cli/gene2vec.py``), on the GPU.

    python -m gene2vec_tpu_torch.cli.gene2vec <data_dir> <export_dir> [pattern]
        [--device {cuda,cpu}] [--dim 200] [--iters 10] ...

Same positionals and the same flags for what this port supports; the
default configuration is the reference's.  ``--device`` defaults to
``cuda`` and the CLI fails without a GPU unless ``--device cpu`` is given.
"""

from __future__ import annotations

import argparse
import sys
from typing import List, Optional

from gene2vec_tpu_torch.config import SGNSConfig


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="gene2vec",
        description="Train gene embeddings from a directory of pair files.",
    )
    p.add_argument("data_dir", help="directory of gene-pair text files")
    p.add_argument("export_dir", help="output directory for embeddings")
    p.add_argument(
        "ending_pattern", nargs="?", default="txt",
        help="filename suffix of corpus files (default: txt)",
    )
    p.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    d = SGNSConfig()
    p.add_argument("--dim", type=int, default=d.dim)
    p.add_argument("--iters", type=int, default=d.num_iters)
    p.add_argument("--min-count", type=int, default=d.min_count)
    p.add_argument("--negatives", type=int, default=d.negatives)
    p.add_argument("--lr", type=float, default=d.lr)
    p.add_argument("--min-lr", type=float, default=d.min_lr)
    p.add_argument("--batch-pairs", type=int, default=d.batch_pairs)
    p.add_argument("--seed", type=int, default=d.seed)
    p.add_argument("--combiner", choices=("capped", "mean", "sum"), default=d.combiner)
    p.add_argument("--strat-head", type=int, default=d.strat_head,
                   help="stratified: exact-expectation noise head rows")
    p.add_argument("--strat-group", type=int, default=d.strat_group,
                   help="stratified: examples per tail-block draw")
    p.add_argument("--strat-block", type=int, default=d.strat_block,
                   help="stratified: rows per random tail block")
    p.add_argument("--positive-head", type=int, default=d.positive_head,
                   help="class-segmented batch layout: head band rows (0 disables)")
    p.add_argument("--positive-mid", type=int, default=d.positive_mid,
                   help="class-segmented batch layout: mid band rows (0 disables)")
    p.add_argument("--no-txt-output", action="store_true",
                   help="skip matrix-txt / word2vec-format exports per iteration")
    return p


def main(argv: Optional[List[str]] = None) -> int:
    args = build_parser().parse_args(argv)
    config = SGNSConfig(
        dim=args.dim,
        num_iters=args.iters,
        min_count=args.min_count,
        negatives=args.negatives,
        lr=args.lr,
        min_lr=args.min_lr,
        batch_pairs=args.batch_pairs,
        seed=args.seed,
        combiner=args.combiner,
        strat_head=args.strat_head,
        strat_group=args.strat_group,
        strat_block=args.strat_block,
        positive_head=args.positive_head,
        positive_mid=args.positive_mid,
        txt_output=not args.no_txt_output,
    )
    from gene2vec_tpu_torch.data.pipeline import PairCorpus
    from gene2vec_tpu_torch.device import resolve_device
    from gene2vec_tpu_torch.io.pair_reader import load_corpus
    from gene2vec_tpu_torch.sgns.train import SGNSTrainer

    device = resolve_device(args.device)  # fail before reading the corpus
    print(f"loading corpus from {args.data_dir} (*.{args.ending_pattern})")
    vocab, pairs = load_corpus(args.data_dir, args.ending_pattern,
                               min_count=config.min_count)
    corpus = PairCorpus(vocab, pairs)
    print(f"{corpus.num_pairs:,} pairs, vocab {corpus.vocab_size:,}, device {device}")
    SGNSTrainer(corpus, config, device=device).run(args.export_dir)
    return 0


if __name__ == "__main__":
    sys.exit(main())
