"""GeneView dashboard CLI — the reference's ``gene2vec_tpu/cli/dashboard.py``
(``src/gene2vec_dash_app.py:17-27`` parity, ``--figure-json``, with the
annotation-source flags the reference hardcodes as absolute paths,
``:37,84``).  The dashboard runs on the host (dash, gated); it needs no
device.  ``--graph-dir`` (a ``knn_graph`` batch artifact, ``cli.batch``)
answers the Neighbors box from the precomputed graph.

    python -m gene2vec_tpu_torch.cli.dashboard --figure-json fig.json
        [--go-obo go-basic.obo --gene2go gene2go] [--reactome FILE]
        [--serve-url http://127.0.0.1:PORT] [--graph-dir DIR]
"""

from __future__ import annotations

import argparse
import sys
from typing import List, Optional


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="dashboard",
        description="Interactive GeneView dashboard for a gene embedding "
        "figure (requires the dash package).",
    )
    p.add_argument("--figure-json", required=True, dest="json",
                   help="plotly-json scatter exported by the plot CLI")
    p.add_argument("--go-obo", default=None, help="go-basic.obo path")
    p.add_argument("--gene2go", default=None, help="NCBI gene2go path")
    p.add_argument("--reactome", default=None,
                   help="NCBI2Reactome_All_Levels.txt path")
    p.add_argument("--go-table", default=None,
                   help="flat TSV (term, gene, description) alternative")
    p.add_argument("--reactome-table", default=None)
    p.add_argument("--taxid", type=int, action="append", default=None,
                   help="filter gene2go to these tax ids (repeatable)")
    p.add_argument("--species", action="append", default=None,
                   help="filter the reactome table to these species")
    p.add_argument("--host", default="127.0.0.1")
    p.add_argument("--port", type=int, default=8050)
    p.add_argument("--debug", action="store_true")
    p.add_argument("--serve-url", default=None,
                   help="base URL of a running `python -m gene2vec_tpu_torch."
                        "cli.serve` instance; adds a live neighbor-search "
                        "box backed by its /v1/similar endpoint")
    p.add_argument("--serve-k", type=int, default=10,
                   help="neighbors fetched per --serve-url lookup")
    p.add_argument("--graph-dir", default=None, metavar="DIR",
                   help="a finalized knn_graph batch artifact (batch/): "
                        "the Neighbors box answers from the precomputed "
                        "graph without a live server, and falls back to it "
                        "when --serve-url is unreachable")
    return p


def main(argv: Optional[List[str]] = None) -> int:
    args = build_parser().parse_args(argv)
    from gene2vec_tpu_torch.viz.dash_app import serve

    serve(
        args.json,
        go_table=args.go_table,
        reactome_table=args.reactome_table,
        go_obo=args.go_obo,
        gene2go=args.gene2go,
        reactome_file=args.reactome,
        taxids=args.taxid,
        species=args.species,
        host=args.host,
        port=args.port,
        debug=args.debug,
        serve_url=args.serve_url,
        serve_k=args.serve_k,
        graph_dir=args.graph_dir,
    )
    return 0


if __name__ == "__main__":
    sys.exit(main())
