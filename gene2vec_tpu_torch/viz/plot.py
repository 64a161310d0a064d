"""Interactive scatter of the embedding — the port of
``gene2vec_tpu/viz/plot.py`` (``src/plot_gene2vec.py`` parity).

Pipeline: load embedding → 2-D/3-D reduction (UMAP by default: K15 and
K16 on the GPU, ``viz/umap.py``; t-SNE: K10c and K10, ``viz/tsne.py``;
PCA on the host) → optional NCBI annotation via mygene (gated) → figure
exported as ``.json`` always, then ``.html`` when plotly is installed,
else a matplotlib ``.png``, else no image, logged (the dash app consumes
the json, ``src/gene2vec_dash_app.py:68``).

``device``: ``"cuda"`` (the default; raises without a GPU) or ``"cpu"``
for the UMAP and t-SNE reductions.  UMAP at 3 components stays umap-learn's
(gated); t-SNE at 3 components runs on the CPU only (K10 is 2-D).
"""

from __future__ import annotations

import json
import os
from typing import Dict, List, Optional, Sequence

import numpy as np

from gene2vec_tpu_torch.io.emb_io import load_embedding_any


def reduce_embedding(
    matrix: np.ndarray,
    method: str = "auto",
    n_components: int = 2,
    seed: int = 0,
    device: Optional[str] = None,
) -> np.ndarray:
    """2-D/3-D coordinates via umap | tsne | pca (auto prefers umap, the
    reference's choice, at 2 components; an installed umap-learn serves
    n_components != 2, which the full-batch layout doesn't implement)."""
    if method == "auto":
        method = "umap" if n_components == 2 else "tsne"
    if method == "umap":
        if n_components == 2:
            from gene2vec_tpu_torch.viz.umap import UMAPConfig, umap_layout

            return umap_layout(matrix, UMAPConfig(seed=seed), device=device)
        try:
            import umap
        except ImportError as e:
            raise ImportError(
                "method='umap' with n_components != 2 requires the "
                "umap-learn package; use method='tsne' or method='pca'"
            ) from e
        return np.asarray(
            umap.UMAP(
                n_components=n_components, random_state=seed
            ).fit_transform(matrix),
            np.float32,
        )
    if method == "tsne":
        from gene2vec_tpu_torch.config import TSNEConfig
        from gene2vec_tpu_torch.viz.tsne import TSNE

        cfg = TSNEConfig(seed=seed, n_iter=1000)
        return TSNE(config=cfg, n_components=n_components, device=device).fit(
            matrix, log=lambda s: None
        )[cfg.n_iter]
    if method == "pca":
        from gene2vec_tpu_torch.viz.tsne import pca_reduce

        return pca_reduce(matrix, n_components)
    raise ValueError(f"unknown reduction method {method!r}")


def infer_gene_rep(x) -> str:
    """Classify a gene identifier so annotation can pick the right query
    scope (``src/plot_gene2vec.py:62-72``): ints are Entrez IDs, strings
    containing ``ENS`` are Ensembl IDs, anything else is a gene symbol.
    Numeric strings (Entrez IDs read from a text embedding file) are also
    classified as Entrez."""
    if isinstance(x, (int, np.integer)):
        return "Entrez ID"
    if isinstance(x, str):
        if "ENS" in x:
            return "Ensembl ID"
        if x.isdigit():
            return "Entrez ID"
        return "Gene Symbol"
    raise TypeError(f"cannot infer gene representation of {type(x).__name__}")


#: mygene querymany scope per representation (``src/plot_gene2vec.py:84-96``)
_REP_SCOPE = {
    "Gene Symbol": "symbol",
    "Entrez ID": "entrezgene",
    "Ensembl ID": "ensembl.gene",
}


def query_gene_info(genes: Sequence[str]) -> Dict[str, dict]:
    """NCBI annotation via mygene (``src/plot_gene2vec.py:74-96``); the
    query scope follows :func:`infer_gene_rep` of the first gene; gated."""
    try:
        import mygene
    except ImportError as e:
        raise ImportError(
            "gene annotation requires the mygene package; pass "
            "annotate=False to skip"
        ) from e
    mg = mygene.MyGeneInfo()
    scope = _REP_SCOPE[infer_gene_rep(genes[0])] if genes else "symbol"
    res = mg.querymany(
        list(genes), scopes=scope, fields="name,summary,symbol,entrezgene",
        species="human",
    )
    return {r["query"]: r for r in res if not r.get("notfound")}


def scatter_payload(
    tokens: Sequence[str],
    coords: np.ndarray,
    info: Optional[Dict[str, dict]] = None,
) -> dict:
    """Plotly-figure-shaped dict (consumed by the dash app and exports)."""
    dims = coords.shape[1]
    hover: List[str] = []
    for t in tokens:
        meta = (info or {}).get(t)
        hover.append(
            f"{t}<br>{meta['name']}" if meta and "name" in meta else str(t)
        )
    trace = {
        "type": "scatter3d" if dims == 3 else "scattergl",
        "mode": "markers",
        "x": coords[:, 0].tolist(),
        "y": coords[:, 1].tolist(),
        "text": hover,
        "customdata": list(tokens),
        "marker": {"size": 3, "opacity": 0.8},
    }
    if dims == 3:
        trace["z"] = coords[:, 2].tolist()
    return {
        "data": [trace],
        "layout": {"title": {"text": "gene2vec embedding"}, "height": 800},
    }


def export_figure(payload: dict, out_prefix: str, log=print) -> List[str]:
    """Write ``<prefix>.json`` always; ``.html`` via plotly when installed,
    else a matplotlib ``.png`` fallback.  Where neither is installed the
    json is all that is written, and ``log`` says so (the reference raises
    matplotlib's ImportError after writing the json)."""
    json_path = out_prefix + ".json"
    with open(json_path, "w", encoding="utf-8") as f:
        json.dump(payload, f)
    written = [json_path]
    try:
        import plotly.graph_objects as go
    except ImportError:
        go = None
    if go is not None:
        fig = go.Figure(payload)
        html = out_prefix + ".html"
        fig.write_html(html)
        written.append(html)
        return written
    try:
        import matplotlib
    except ImportError:
        log("no image drawn: neither plotly nor matplotlib is installed")
        return written
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    trace = payload["data"][0]
    fig, ax = plt.subplots(figsize=(10, 10))
    ax.scatter(trace["x"], trace["y"], s=2, alpha=0.6)
    ax.set_title(payload["layout"]["title"]["text"])
    png = out_prefix + ".png"
    fig.savefig(png, dpi=150)
    plt.close(fig)
    written.append(png)
    return written


def plot_gene2vec(
    emb_path: str,
    out_prefix: str,
    method: str = "auto",
    n_components: int = 2,
    annotate: bool = False,
    seed: int = 0,
    log=print,
    device: Optional[str] = None,
) -> List[str]:
    """End-to-end ``src/plot_gene2vec.py`` flow."""
    tokens, matrix = load_embedding_any(emb_path)
    log(f"{len(tokens)} genes loaded; reducing with {method}")
    coords = reduce_embedding(matrix, method, n_components, seed, device=device)
    info = query_gene_info(tokens) if annotate else None
    payload = scatter_payload(tokens, coords, info)
    os.makedirs(os.path.dirname(os.path.abspath(out_prefix)), exist_ok=True)
    written = export_figure(payload, out_prefix, log=log)
    log(f"wrote {', '.join(written)}")
    return written
