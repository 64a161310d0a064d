"""GeneView dashboard — the port of ``gene2vec_tpu/viz/dash_app.py``
(``src/gene2vec_dash_app.py`` parity).  Host-side: no device.

The reference's Dash app loads the plotly-JSON scatter exported by the plot
generator, shows GO-term and Reactome-pathway dropdowns in a fixed dark
sidebar (Darkly theme + ``src/assets/bootstrap.css`` dropdown overrides),
recolors member genes on selection (active yellow, inactive
near-invisible, ``src/gene2vec_dash_app.py:65,189-235``), and prints a
description panel per selected term (``:237-281``).

Design here: the data/logic layer — GO-DAG parsing (``go-basic.obo``),
``gene2go`` annotations, the Reactome table, marker restyling, and the
description text — is dependency-free and unit-tested (the formats are
plain text; goatools/ete3 are optional conveniences, not requirements).
Only ``serve()`` needs dash (gated); the dark styling ships as our own
``assets/geneview.css``.  A precomputed kNN-graph directory (``graph_dir``,
a ``knn_graph`` batch artifact) answers the Neighbors box without a live
server (:func:`load_graph_neighbors`).
"""

from __future__ import annotations

import dataclasses
import json
import os
from typing import Dict, List, Optional, Sequence, Tuple

#: the reference's exact marker colors (``src/gene2vec_dash_app.py:65``)
ACTIVE_COLOR = "rgba(226,255,0,1)"
INACTIVE_COLOR = "rgba(10, 10, 10, 0.01)"
BASE_COLOR = "#636efa"


def load_figure_json(path: str) -> dict:
    with open(path, "r", encoding="utf-8") as f:
        return json.load(f)


def parse_annotation_table(
    path: str, id_col: int = 0, gene_col: int = 1, name_col: Optional[int] = 2
) -> Tuple[Dict[str, List[str]], Dict[str, str]]:
    """TSV of (term id, gene, [description]) rows → (term → genes,
    term → description)."""
    members: Dict[str, List[str]] = {}
    descriptions: Dict[str, str] = {}
    with open(path, "r", encoding="utf-8") as f:
        for line in f:
            parts = line.rstrip("\n").split("\t")
            if len(parts) <= max(id_col, gene_col):
                continue
            term, gene = parts[id_col], parts[gene_col]
            if not term or not gene:
                continue
            members.setdefault(term, []).append(gene)
            if name_col is not None and len(parts) > name_col:
                descriptions.setdefault(term, parts[name_col])
    return members, descriptions


def load_gmt_terms(path: str) -> Tuple[Dict[str, List[str]], Dict[str, str]]:
    """MSigDB .gmt as (term → genes, term → url/description)."""
    members: Dict[str, List[str]] = {}
    descriptions: Dict[str, str] = {}
    with open(path, "r", encoding="utf-8") as f:
        for line in f:
            fields = line.rstrip("\n").split("\t")
            if len(fields) < 3:
                continue
            members[fields[0]] = [g for g in fields[2:] if g]
            descriptions[fields[0]] = fields[1]
    return members, descriptions


def highlight_genes(figure: dict, selected: Sequence[str]) -> dict:
    """Recolor the scatter: selected genes active-yellow, the rest
    near-invisible; empty selection restores the base color.  Pure function
    over the figure dict (the reference mutates the same fields in its
    callback, ``src/gene2vec_dash_app.py:189-235``)."""
    out = json.loads(json.dumps(figure))  # deep copy
    sel = set(selected)
    for trace in out.get("data", []):
        genes = trace.get("customdata") or trace.get("text") or []
        if not sel:
            trace.setdefault("marker", {})["color"] = BASE_COLOR
            continue
        trace.setdefault("marker", {})["color"] = [
            ACTIVE_COLOR if g in sel else INACTIVE_COLOR for g in genes
        ]
    return out


def term_options(
    members: Dict[str, List[str]], descriptions: Dict[str, str]
) -> List[dict]:
    """Dropdown options sorted by term id."""
    return [
        {
            "label": f"{term} — {descriptions.get(term, '')}".rstrip(" —"),
            "value": term,
        }
        for term in sorted(members)
    ]


@dataclasses.dataclass
class GOTerm:
    """One ``[Term]`` of a GO DAG with the fields the description panel
    shows (``src/gene2vec_dash_app.py:252-257``): level = shortest
    distance to a root, depth = longest."""

    id: str
    name: str = ""
    namespace: str = ""
    parents: Tuple[str, ...] = ()
    level: int = 0
    depth: int = 0


def parse_obo(path: str) -> Dict[str, GOTerm]:
    """Dependency-free ``go-basic.obo`` parser: ``[Term]`` stanzas with
    id/name/namespace/is_a, levels and depths computed over the ``is_a``
    DAG.  goatools' GODag offers the same (and is used by the reference,
    ``src/gene2vec_dash_app.py:30-44``); the format is 4 fields of plain
    text, so the framework does not require the package.  Obsolete terms
    are dropped, ``alt_id``s alias their term."""
    terms: Dict[str, GOTerm] = {}
    alt: Dict[str, str] = {}
    cur: Optional[dict] = None

    def flush(c):
        if c is None or "id" not in c or c.get("obsolete"):
            return
        terms[c["id"]] = GOTerm(
            id=c["id"],
            name=c.get("name", ""),
            namespace=c.get("namespace", ""),
            parents=tuple(c.get("is_a", ())),
        )
        for a in c.get("alt_id", ()):
            alt[a] = c["id"]

    with open(path, "r", encoding="utf-8") as f:
        for line in f:
            line = line.strip()
            if line == "[Term]":
                flush(cur)
                cur = {}
            elif line.startswith("[") and line.endswith("]"):  # [Typedef]…
                flush(cur)
                cur = None
            elif cur is not None and ": " in line:
                key, _, val = line.partition(": ")
                if key == "id":
                    cur["id"] = val
                elif key == "name":
                    cur["name"] = val
                elif key == "namespace":
                    cur["namespace"] = val
                elif key == "is_a":
                    cur.setdefault("is_a", []).append(val.split(" ! ")[0])
                elif key == "alt_id":
                    cur.setdefault("alt_id", []).append(val)
                elif key == "is_obsolete" and val == "true":
                    cur["obsolete"] = True
    flush(cur)

    level: Dict[str, int] = {}
    depth: Dict[str, int] = {}

    def walk(tid: str, acc: Dict[str, int], agg) -> int:
        if tid in acc:
            return acc[tid]
        acc[tid] = 0  # cycle guard (GO is acyclic; malformed input isn't)
        ps = [p for p in terms[tid].parents if p in terms]
        acc[tid] = agg(walk(p, acc, agg) for p in ps) + 1 if ps else 0
        return acc[tid]

    for tid, term in terms.items():
        terms[tid] = dataclasses.replace(
            term, level=walk(tid, level, min), depth=walk(tid, depth, max)
        )
    for a, tid in alt.items():
        terms.setdefault(a, terms[tid])
    return terms


def parse_gene2go(
    path: str, taxids: Optional[Sequence[int]] = None
) -> Dict[str, List[str]]:
    """NCBI ``gene2go`` TSV → GO id → member gene (Entrez) ids, optionally
    filtered to ``taxids`` (the reference filters to the figure's Tax ID
    column via goatools, ``src/gene2vec_dash_app.py:38-41``)."""
    keep = {str(t) for t in taxids} if taxids else None
    # dict-as-ordered-set per term: broad GO terms collect >10k genes and
    # real gene2go files are tens of millions of rows — list membership
    # scans would be quadratic per term
    members: Dict[str, dict] = {}
    with open(path, "r", encoding="utf-8") as f:
        for line in f:
            if line.startswith("#") or not line.strip():
                continue
            parts = line.rstrip("\n").split("\t")
            if len(parts) < 3:
                continue
            tax, gene, go_id = parts[0], parts[1], parts[2]
            if keep is not None and tax not in keep:
                continue
            members.setdefault(go_id, {})[gene] = None
    return {go_id: list(genes) for go_id, genes in members.items()}


def load_reactome_table(
    path: str, species: Optional[Sequence[str]] = None
) -> Tuple[Dict[str, List[str]], Dict[str, dict]]:
    """``NCBI2Reactome_All_Levels.txt`` (entrez, reactome id, url, name,
    evidence, species) → (pathway → entrez members, pathway → info);
    optional species filter (the reference translates the figure's taxids
    via ete3 and filters, ``src/gene2vec_dash_app.py:84-96``)."""
    keep = set(species) if species else None
    members: Dict[str, dict] = {}  # dict-as-ordered-set (see parse_gene2go)
    info: Dict[str, dict] = {}
    with open(path, "r", encoding="utf-8") as f:
        for line in f:
            parts = line.rstrip("\n").split("\t")
            if len(parts) < 6:
                continue
            entrez, rid, url, name, _, sp = parts[:6]
            if keep is not None and sp not in keep:
                continue
            members.setdefault(rid, {})[entrez] = None
            info.setdefault(
                rid, {"name": name, "url": url, "species": sp}
            )
    return {rid: list(g) for rid, g in members.items()}, info


def fetch_neighbors(
    serve_url: str, gene: str, k: int = 10, timeout_s: float = 2.0
) -> Optional[List[Tuple[str, float]]]:
    """Top-k neighbor list for ``gene`` from a running serve instance
    (``GET /v1/similar?gene=...&k=...``, ``cli/serve.py``).  Returns
    ``None`` on ANY failure — server down, unknown gene, bad URL — so
    callers fall back to the figure-json path instead of crashing the
    dashboard (stdlib urllib only; no client dependency)."""
    import urllib.parse
    import urllib.request

    url = (
        f"{serve_url.rstrip('/')}/v1/similar?"
        + urllib.parse.urlencode({"gene": gene, "k": k})
    )
    try:
        with urllib.request.urlopen(url, timeout=timeout_s) as resp:
            doc = json.load(resp)
        return [
            (n["gene"], float(n["score"]))
            for n in doc["results"][0]["neighbors"]
        ]
    except Exception:
        return None


def load_graph_neighbors(graph_dir: str):
    """Neighbor lookup over a PRECOMPUTED kNN graph — a finalized
    ``knn_graph`` batch artifact (``batch/``)
    — as a ``(gene, k) -> [(gene, score), ...] | None`` callable with
    the same contract as :func:`fetch_neighbors`.  The offline
    fallback for dashboards with no live ``--serve-url``: the graph
    was built through the serving stack, so the neighbors shown are
    exactly what the fleet would have answered.  Loads lazily on the
    first lookup and returns ``None`` per-gene on any failure
    (missing/corrupt artifact, unknown gene) so the dashboard
    degrades instead of crashing."""
    state = {}

    def lookup(gene, k=10):
        if "graph" not in state:
            try:
                from gene2vec_tpu_torch.batch.artifact import load_graph

                tokens, ids, scores, _meta = load_graph(graph_dir)
                state["graph"] = (
                    {t: i for i, t in enumerate(tokens)},
                    tokens, ids, scores,
                )
            except Exception:
                state["graph"] = None
        if state["graph"] is None:
            return None
        index, tokens, ids, scores = state["graph"]
        row = index.get(gene)
        if row is None:
            return None
        n = min(int(k), ids.shape[1])
        return [
            (tokens[int(ids[row, j])], float(scores[row, j]))
            for j in range(n)
        ]

    return lookup


def go_description(
    term: GOTerm, member_genes: Sequence[str], gene_rep: str = "Gene Symbol"
) -> str:
    """The GO description panel text (``src/gene2vec_dash_app.py:252-257``)."""
    return (
        f"GO ID: {term.id}\nName: {term.name}\n"
        f"Namespace: {term.namespace}\nLevel: {term.level}\n"
        f"Depth: {term.depth}\n{gene_rep}: {', '.join(member_genes)}"
    )


def reactome_description(
    rid: str, info: dict, member_genes: Sequence[str],
    gene_rep: str = "Gene Symbol",
) -> str:
    """The Reactome description panel text (``:267-276``)."""
    return (
        f"Reactome ID: {rid}\nName: {info.get('name', '')}\n"
        f"Species: {info.get('species', '')}\nurl: {info.get('url', '')}\n"
        f"{gene_rep}: {', '.join(member_genes)}"
    )


def go_dag_descriptions(obo_path: str) -> Dict[str, str]:
    """GO id → name.  Uses goatools when installed (the reference's path,
    ``src/gene2vec_dash_app.py:30-44``); otherwise the built-in parser."""
    try:
        from goatools.obo_parser import GODag

        dag = GODag(obo_path, prt=None)
        return {go_id: term.name for go_id, term in dag.items()}
    except ImportError:
        return {tid: t.name for tid, t in parse_obo(obo_path).items()}


def build_app_state(
    figure_json: str,
    go_table: Optional[str] = None,
    reactome_table: Optional[str] = None,
    go_obo: Optional[str] = None,
    gene2go: Optional[str] = None,
    reactome_file: Optional[str] = None,
    taxids: Optional[Sequence[int]] = None,
    species: Optional[Sequence[str]] = None,
) -> dict:
    """Everything ``serve`` shows, assembled without dash: the figure, the
    per-source term→members tables, term descriptions (rich GOTerm/Reactome
    info when the obo/gene2go/reactome files are given, flat TSV tables
    otherwise), and dropdown options.  Unit-testable."""
    state = {
        "figure": load_figure_json(figure_json),
        "sources": {},  # kind -> {"members", "describe", "options"}
    }

    def add(kind, members, describe, label_desc):
        state["sources"][kind] = {
            "members": members,
            "describe": describe,
            "options": term_options(members, label_desc),
        }

    if go_obo and gene2go:
        dag = parse_obo(go_obo)
        members = parse_gene2go(gene2go, taxids)
        members = {t: g for t, g in members.items() if t in dag}

        def describe_go(term, genes, dag=dag):
            return go_description(dag[term], genes)

        add("GO", members, describe_go, {t: dag[t].name for t in members})
    elif go_table:
        members, desc = parse_annotation_table(go_table)
        add("GO", members, lambda t, g, d=desc: d.get(t, ""), desc)
    if reactome_file:
        members, info = load_reactome_table(reactome_file, species)

        def describe_r(term, genes, info=info):
            return reactome_description(term, info.get(term, {}), genes)

        add("Reactome", members, describe_r,
            {t: info[t]["name"] for t in members})
    elif reactome_table:
        members, desc = parse_annotation_table(reactome_table)
        add("Reactome", members, lambda t, g, d=desc: d.get(t, ""), desc)
    return state


def serve(
    figure_json: str,
    go_table: Optional[str] = None,
    reactome_table: Optional[str] = None,
    go_obo: Optional[str] = None,
    gene2go: Optional[str] = None,
    reactome_file: Optional[str] = None,
    taxids: Optional[Sequence[int]] = None,
    species: Optional[Sequence[str]] = None,
    host: str = "127.0.0.1",
    port: int = 8050,
    debug: bool = False,
    run: bool = True,
    serve_url: Optional[str] = None,
    serve_k: int = 10,
    graph_dir: Optional[str] = None,
):  # pragma: no cover - needs dash + a browser
    """Launch the GeneView dashboard (requires the dash package).

    Layout parity with the reference (``src/gene2vec_dash_app.py:100-186``):
    a fixed dark sidebar — GeneView title, Gene Ontology dropdown, Reactome
    dropdown, read-only description textarea — beside the scatter; dark
    dropdown styling ships as the package's own ``assets/geneview.css``
    (behavioral stand-in for the reference's Darkly overrides).  Pass
    ``run=False`` to get the wired app back without serving (tests).

    With ``serve_url`` (a running ``cli.serve`` instance) the sidebar
    grows a *Neighbors* search box: typing a gene highlights its live
    top-``serve_k`` cosine neighbors from ``/v1/similar`` and prints
    them in the description panel — no pre-exported similarity figure
    needed.  Lookup failures (server down, unknown gene) degrade to the
    base coloring; the figure-json annotation dropdowns keep working
    either way.

    ``graph_dir`` (a finalized ``knn_graph`` batch artifact,
    ``batch/``) gives the same Neighbors box WITHOUT a live server
    — and serves as the fallback when ``serve_url`` is also set but
    unreachable: the precomputed graph answers what the fleet that
    built it would have."""
    try:
        import dash
        from dash import dcc, html
        from dash.dependencies import Input, Output, State
    except ImportError as e:
        raise ImportError(
            "the GeneView dashboard requires the dash package; the figure "
            "json/html exports from viz.plot work without it"
        ) from e

    state = build_app_state(
        figure_json, go_table, reactome_table, go_obo, gene2go,
        reactome_file, taxids, species,
    )
    figure = state["figure"]
    sources = state["sources"]

    app = dash.Dash(
        "GeneView",
        assets_folder=os.path.join(os.path.dirname(__file__), "assets"),
    )
    sidebar_children = [html.H2("GeneView", className="display-8"), html.Hr()]
    for kind, src in sources.items():
        sidebar_children += [
            html.Div(
                [
                    html.H4(
                        "Gene Ontology" if kind == "GO" else f"{kind} ID",
                        className="display-8",
                    ),
                    html.Hr(),
                    dcc.Dropdown(
                        id=f"dd-{kind.lower()}", options=src["options"]
                    ),
                ],
                className="geneview-dropdown",
            )
        ]
    neighbor_lookup = (
        load_graph_neighbors(graph_dir) if graph_dir else None
    )
    if serve_url or graph_dir:
        sidebar_children += [
            html.Div(
                [
                    html.H4("Neighbors", className="display-8"),
                    html.Hr(),
                    dcc.Input(
                        id="gene-search", type="text", debounce=True,
                        placeholder="gene symbol...",
                        className="geneview-search",
                    ),
                ],
                className="geneview-dropdown",
            )
        ]
    sidebar_children += [
        html.Div(
            [
                html.H5("Description", className="display-8"),
                html.Hr(),
                dcc.Textarea(
                    id="description", readOnly=True, value="",
                    className="geneview-description",
                ),
            ]
        )
    ]
    app.layout = html.Div(
        [
            html.Div(sidebar_children, className="geneview-sidebar"),
            dcc.Graph(
                id="scatter", figure=figure, className="geneview-graph"
            ),
        ],
        className="dash-bootstrap",
    )

    inputs = [Input(f"dd-{k.lower()}", "value") for k in sources]
    kinds = list(sources)
    if serve_url or graph_dir:
        inputs.append(Input("gene-search", "value"))

    def _selected(values):
        """(kind, term) for the triggering control; kind ``"__serve__"``
        when it was the neighbor search box; (None, None) when it was
        CLEARED (value None) — callers must reset, not no_update, or the
        near-invisible highlight state sticks forever."""
        ctx = dash.callback_context
        trigger = ctx.triggered[0]["prop_id"].split(".")[0]
        if (serve_url or graph_dir) and trigger == "gene-search":
            gene = values[-1]
            return ("__serve__", gene.strip()) if gene and gene.strip() \
                else (None, None)
        for kind, value in zip(kinds, values):
            if f"dd-{kind.lower()}" == trigger and value:
                return kind, value
        return None, None

    # both callbacks (figure + description) fire per keystroke; a short
    # TTL memo makes them share ONE /v1/similar round trip — and caches
    # failures too, so an unreachable server blocks one timeout, not two
    _neighbor_memo: Dict[str, tuple] = {}

    def _neighbor_genes(gene):
        """The gene + its live neighbors, or None when the serve lookup
        failed (fall back to base coloring rather than erroring)."""
        import time

        now = time.monotonic()
        cached = _neighbor_memo.get(gene)
        if cached is not None and now - cached[0] < 5.0:
            hits = cached[1]
        else:
            hits = (
                fetch_neighbors(serve_url, gene, serve_k)
                if serve_url else None
            )
            if hits is None and neighbor_lookup is not None:
                # no live server (or it failed): the precomputed
                # batch-built graph answers instead
                hits = neighbor_lookup(gene, serve_k)
            _neighbor_memo[gene] = (now, hits)
            while len(_neighbor_memo) > 64:
                _neighbor_memo.pop(next(iter(_neighbor_memo)))
        if hits is None:
            return None, None
        return [gene] + [g for g, _ in hits], hits

    if sources or serve_url or graph_dir:
        # figure-only dashboards have no callbacks
        @app.callback(
            Output("scatter", "figure"), inputs, State("scatter", "figure")
        )
        def show_genes(*args):
            values, fig = args[:-1], args[-1]
            kind, term = _selected(values)
            if kind is None:  # cleared: restore the base coloring
                return highlight_genes(fig or figure, [])
            if kind == "__serve__":
                genes, _ = _neighbor_genes(term)
                return highlight_genes(fig or figure, genes or [])
            genes = sources[kind]["members"].get(term, [])
            return highlight_genes(fig or figure, genes)

        @app.callback(Output("description", "value"), inputs)
        def show_description(*values):
            kind, term = _selected(values)
            if kind is None:
                return ""
            if kind == "__serve__":
                genes, hits = _neighbor_genes(term)
                if hits is None:
                    source = serve_url or f"graph {graph_dir}"
                    return (
                        f"{term}: neighbor lookup failed "
                        f"({source} unreachable or unknown gene)"
                    )
                return f"Nearest to {term}:\n" + "\n".join(
                    f"{g}\t{s:.4f}" for g, s in hits
                )
            genes = sources[kind]["members"].get(term, [])
            return sources[kind]["describe"](term, genes)

    if run:
        app.run(host=host, port=port, debug=debug)
    return app
