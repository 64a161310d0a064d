"""Intrinsic-evaluation CLI: the pathway/random "target function" — the
reference's ``gene2vec_tpu/cli/evaluate.py``.

    python -m gene2vec_tpu_torch.cli.evaluate emb_file gmt_file [--json] [--out PATH]

prints the score ``src/evaluation_target_function.py`` computes (pathways
over 50 genes skipped, fixed seed 35 for the random-pair denominator).
``--json`` (optionally with ``--out PATH``) emits the provenance-stamped
JSON document instead.  ``--graph-dir DIR`` evaluates a finalized
``knn_graph`` batch artifact (``cli.batch``) instead of an embedding file:
the pathway hit rate of each gene's neighbours against degree-matched
random ones, as the fleet that built the graph served them.  The
evaluation is numpy on the host: it has no device work.
"""

from __future__ import annotations

import argparse
import json
import sys
from typing import List, Optional

from gene2vec_tpu_torch.eval.target_function import (
    MAX_PATHWAY_GENES,
    RANDOM_PAIR_GENES,
    RANDOM_SEED,
    graph_neighborhood_ratio,
    target_function,
)


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="evaluate",
        description="Pathway-vs-random cosine similarity ratio of an "
                    "embedding file.",
    )
    p.add_argument("emb_file", nargs="?", default=None,
                   help="matrix-txt or word2vec-format embedding (optional "
                        "when --graph-dir evaluates a precomputed kNN graph)")
    p.add_argument("gmt_file", help="MSigDB .gmt pathway file")
    p.add_argument("--graph-dir", default=None, metavar="DIR",
                   help="evaluate a finalized knn_graph batch artifact "
                        "(batch/) instead of an embedding file: pathway "
                        "neighbourhood hit rate vs degree-matched random, as "
                        "served by the fleet that built the graph")
    p.add_argument("--max-pathway-genes", type=int, default=MAX_PATHWAY_GENES)
    p.add_argument("--num-random-genes", type=int, default=RANDOM_PAIR_GENES)
    p.add_argument("--seed", type=int, default=RANDOM_SEED)
    p.add_argument("--json", action="store_true",
                   help="emit a provenance-stamped JSON document "
                        "(schema_version/command/created_unix) instead "
                        "of the bare score")
    p.add_argument("--out", default=None, metavar="PATH",
                   help="also write the stamped JSON document to PATH "
                        "(stdout format still follows --json)")
    return p


def main(argv: Optional[List[str]] = None) -> int:
    args = build_parser().parse_args(argv)
    if args.graph_dir:
        facts = graph_neighborhood_ratio(
            args.graph_dir,
            args.gmt_file,
            max_pathway_genes=args.max_pathway_genes,
            seed=args.seed,
        )
        body = {
            "schema": "gene2vec-tpu/graph-eval/v1",
            "graph_dir": args.graph_dir,
            "gmt_file": args.gmt_file,
            **facts,
        }
        score = facts["ratio"]
    else:
        if not args.emb_file:
            raise SystemExit("error: need an emb_file (or --graph-dir)")
        score = target_function(
            args.emb_file,
            args.gmt_file,
            max_pathway_genes=args.max_pathway_genes,
            num_random_genes=args.num_random_genes,
            seed=args.seed,
        )
        body = {
            "schema": "gene2vec-tpu/intrinsic-eval/v1",
            "trained_target_func_ratio": score,
            "emb_file": args.emb_file,
            "gmt_file": args.gmt_file,
            "max_pathway_genes": args.max_pathway_genes,
            "num_random_genes": args.num_random_genes,
            "seed": args.seed,
        }
    if args.json or args.out:
        from gene2vec_tpu_torch.obs.ledger import provenance_stamp

        doc = provenance_stamp(body)
        if args.out:
            with open(args.out, "w", encoding="utf-8") as f:
                json.dump(doc, f, indent=1)
    if args.json:
        print(json.dumps(doc))
    else:
        print(score)
    return 0


if __name__ == "__main__":
    sys.exit(main())
