"""The port's plot, GTEx and dashboard stages (``gene2vec_tpu_torch/viz/
{plot,gtex,dash_app}.py``, ``cli/{plot,dashboard}.py``) against the JAX
package's on the CPU: the same inputs, the same outputs (PCA bitwise; UMAP
within ``tests/test_torch_umap.py``'s bars; every host function equal)."""

import http.server
import json
import os
import sys
import threading

import numpy as np
import pytest
import torch

from gene2vec_tpu.io.emb_io import write_matrix_txt
from gene2vec_tpu.viz import dash_app as ref_dash
from gene2vec_tpu.viz import gtex as ref_gtex
from gene2vec_tpu.viz import plot as ref_plot
from gene2vec_tpu_torch.cli import dashboard as dash_cli
from gene2vec_tpu_torch.cli import plot as plot_cli
from gene2vec_tpu_torch.viz import dash_app, gtex, plot


def _blobs(n_per=50, d=20, k=3, seed=0):
    rng = np.random.RandomState(seed)
    centers = rng.randn(k, d) * 6.0
    return np.concatenate([centers[i] + rng.randn(n_per, d) for i in range(k)]).astype(np.float32)


def _have(module):
    try:
        __import__(module)
        return True
    except ImportError:
        return False


@pytest.mark.parametrize("dims", [2, 3])
def test_reduce_embedding_pca_is_bitwise(dims):
    x = _blobs(20)
    np.testing.assert_array_equal(plot.reduce_embedding(x, "pca", dims),
                                  ref_plot.reduce_embedding(x, "pca", dims))


def _separation(y, labels):
    dists = np.linalg.norm(y[:, None] - y[None, :], axis=-1)
    same = labels[:, None] == labels[None, :]
    np.fill_diagonal(same, False)
    return dists[~same & ~np.eye(len(y), dtype=bool)].mean() / dists[same].mean()


def _label_agreement(y, labels, k=5):
    """The share of each point's k nearest layout neighbours in its blob."""
    d = np.linalg.norm(y[:, None] - y[None, :], axis=-1)
    np.fill_diagonal(d, np.inf)
    return float((labels[np.argsort(d, axis=1)[:, :k]] == labels[:, None]).mean())


@pytest.mark.parametrize("method", ["umap", "auto"])
def test_reduce_embedding_umap_matches(method):
    """Both sides' default UMAP (400 iterations) on the same blobs.  A
    free-running layout is chaotic (a clip decision that flips where the
    force lies within rounding of ±4 moves that point, and the difference
    grows), so the layouts are held by structure: both separate the blobs
    (inter over intra mean distance past 2) and keep each point's layout
    neighbours in its blob alike (within 0.05)."""
    x = _blobs(30)
    labels = np.repeat(np.arange(3), 30)
    got = plot.reduce_embedding(x, method, device="cpu")
    want = ref_plot.reduce_embedding(x, method)
    assert got.shape == want.shape == (90, 2) and np.isfinite(got).all()
    assert _separation(got, labels) > 2.0 and _separation(want, labels) > 2.0
    assert abs(_label_agreement(got, labels) - _label_agreement(want, labels)) <= 0.05


def test_reduce_embedding_tsne_three_components_on_the_cpu():
    x = _blobs(15, d=8)
    got = plot.reduce_embedding(x, "tsne", 3, device="cpu")
    assert got.shape == (45, 3) and np.isfinite(got).all()


def test_tsne_three_components_refused_on_the_card(monkeypatch):
    """K10 iterates 2-D layouts: 3 components on the card raise before any
    work, with a message; the CPU takes them (above)."""
    import gene2vec_tpu_torch.device as device

    monkeypatch.setattr(device, "resolve_device", lambda d=None: torch.device("cuda"))
    with pytest.raises(NotImplementedError, match="2-D"):
        plot.reduce_embedding(_blobs(10, d=8), "tsne", 3)


def test_umap_three_components_gated():
    if _have("umap"):
        pytest.skip("umap-learn installed; gating not exercised")
    for mod in (plot, ref_plot):
        with pytest.raises(ImportError, match="umap"):
            mod.reduce_embedding(np.zeros((10, 4), np.float32), method="umap", n_components=3)


def test_unknown_method_raises():
    with pytest.raises(ValueError, match="unknown reduction"):
        plot.reduce_embedding(np.zeros((4, 3), np.float32), "mds")


@pytest.mark.parametrize("x", [7157, np.int64(7), "7157", "ENSG00000141510", "TP53", "ENS",
                               "", "A1BG-AS1"])
def test_infer_gene_rep_equals_the_references(x):
    assert plot.infer_gene_rep(x) == ref_plot.infer_gene_rep(x)


def test_infer_gene_rep_rejects_floats():
    with pytest.raises(TypeError):
        plot.infer_gene_rep(3.14)
    assert plot._REP_SCOPE == ref_plot._REP_SCOPE


def test_query_gene_info_gated():
    if _have("mygene"):
        pytest.skip("mygene installed; gating not exercised")
    with pytest.raises(ImportError, match="mygene"):
        plot.query_gene_info(["TP53"])


@pytest.mark.parametrize("dims", [2, 3])
@pytest.mark.parametrize("info", [None, {"G1": {"name": "gene one"}, "G2": {"symbol": "x"}}])
def test_scatter_payload_equals_the_references(dims, info):
    toks = [f"G{i}" for i in range(5)]
    coords = np.random.RandomState(dims).randn(5, dims).astype(np.float32)
    assert plot.scatter_payload(toks, coords, info) == ref_plot.scatter_payload(toks, coords, info)


def test_export_figure_writes_json_and_an_image(tmp_path):
    toks = [f"G{i}" for i in range(30)]
    payload = plot.scatter_payload(toks, np.random.RandomState(0).randn(30, 2))
    written = plot.export_figure(payload, str(tmp_path / "fig"))
    ref_written = ref_plot.export_figure(payload, str(tmp_path / "ref"))
    assert [os.path.splitext(w)[1] for w in written] == \
        [os.path.splitext(w)[1] for w in ref_written]
    assert json.load(open(written[0])) == json.load(open(ref_written[0])) == payload
    assert written[1].endswith((".html", ".png")) and os.path.getsize(written[1]) > 10_000


def test_cli_plot_without_image_packages_writes_the_json_alone(monkeypatch, tmp_path, capsys):
    """Where neither plotly nor matplotlib imports, ``cli.plot`` writes the
    json the reference writes first, logs that no image was drawn and
    exits 0 (the reference raises matplotlib's ImportError there)."""
    for name in ("plotly", "plotly.graph_objects", "matplotlib", "matplotlib.pyplot"):
        monkeypatch.setitem(sys.modules, name, None)
    x = _blobs(10, d=6)
    toks = [f"G{i}" for i in range(len(x))]
    write_matrix_txt(str(tmp_path / "emb.txt"), toks, x)
    out = tmp_path / "o" / "fig"
    assert plot_cli.main([str(tmp_path / "emb.txt"), str(out), "--method", "pca",
                          "--device", "cpu"]) == 0
    assert sorted(os.listdir(tmp_path / "o")) == ["fig.json"]
    assert json.load(open(str(out) + ".json"))["data"][0]["customdata"] == toks
    logged = capsys.readouterr().out
    assert "no image drawn: neither plotly nor matplotlib is installed" in logged
    assert f"wrote {out}.json\n" in logged
    with pytest.raises(ImportError):
        ref_plot.export_figure(plot.scatter_payload(toks, x[:, :2]), str(tmp_path / "ref"))


def test_plot_gene2vec_pca_files_equal_the_references(tmp_path):
    x = _blobs(15, d=8)
    toks = [f"G{i}" for i in range(len(x))]
    write_matrix_txt(str(tmp_path / "emb.txt"), toks, x)
    logs = []
    plot.plot_gene2vec(str(tmp_path / "emb.txt"), str(tmp_path / "a" / "fig"), method="pca",
                       log=logs.append)
    ref_plot.plot_gene2vec(str(tmp_path / "emb.txt"), str(tmp_path / "b" / "fig"),
                           method="pca", log=lambda s: None)
    assert json.load(open(tmp_path / "a" / "fig.json")) == \
        json.load(open(tmp_path / "b" / "fig.json"))
    assert logs[0] == f"{len(x)} genes loaded; reducing with pca"


def test_cli_plot_end_to_end_on_the_cpu(tmp_path):
    """``cli.plot`` with its default method (UMAP, 2 components) and
    ``--device cpu``: the json holds every gene with finite coordinates,
    beside an image; the reference's flags all parse."""
    x = _blobs(20, d=8)
    toks = [f"G{i}" for i in range(len(x))]
    write_matrix_txt(str(tmp_path / "emb.txt"), toks, x)
    out = str(tmp_path / "out" / "fig")
    assert plot_cli.main([str(tmp_path / "emb.txt"), out, "--device", "cpu"]) == 0
    trace = json.load(open(out + ".json"))["data"][0]
    assert trace["customdata"] == toks
    assert np.isfinite(trace["x"]).all() and len(trace["y"]) == len(toks)
    assert os.path.exists(out + ".png") or os.path.exists(out + ".html")
    from gene2vec_tpu.cli import plot as ref_cli

    ours = {a.dest: a.default for a in plot_cli.build_parser()._actions}
    theirs = {a.dest: a.default for a in ref_cli.build_parser()._actions}
    assert ours == {**theirs, "device": "cuda"}


def test_cli_plot_without_a_gpu_raises_before_writing(monkeypatch, tmp_path):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    x = _blobs(10, d=4)
    write_matrix_txt(str(tmp_path / "emb.txt"), [f"G{i}" for i in range(len(x))], x)
    for extra in ([], ["--device", "cuda"], ["--method", "pca"]):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            plot_cli.main([str(tmp_path / "emb.txt"), str(tmp_path / "o" / "fig"), *extra])
    assert not (tmp_path / "o").exists()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        plot.plot_gene2vec(str(tmp_path / "emb.txt"), str(tmp_path / "p" / "fig"))


def _gtex_inputs(tmp_path):
    rng = np.random.RandomState(0)
    genes = [f"G{i}" for i in range(40)]
    (tmp_path / "labels.txt").write_text("\n".join(genes) + "\n")
    np.savetxt(tmp_path / "coords.txt", rng.randn(40, 2))
    (tmp_path / "Liver_specific_genes.txt").write_text(
        "gene z\n" + "\n".join(f"G{i} {rng.randn() + 2:.3f}" for i in range(10)))
    (tmp_path / "Lung_specific_genes.txt").write_text(
        "\n".join(f"G{i} {rng.randn() * 3:.3f}" for i in range(5, 30)) + "\nG99 1.0\n")
    return genes


def test_gtex_loaders_equal_the_references(tmp_path):
    _gtex_inputs(tmp_path)
    lab, coords = gtex.load_tsne_layout(str(tmp_path / "labels.txt"), str(tmp_path / "coords.txt"))
    rlab, rcoords = ref_gtex.load_tsne_layout(str(tmp_path / "labels.txt"),
                                              str(tmp_path / "coords.txt"))
    assert lab == rlab
    np.testing.assert_array_equal(coords, rcoords)
    for name in ("Liver_specific_genes.txt", "Lung_specific_genes.txt"):
        path = str(tmp_path / name)
        assert gtex.load_tissue_zscores(path) == ref_gtex.load_tissue_zscores(path)
    np.savetxt(tmp_path / "short.txt", np.zeros((3, 2)))
    with pytest.raises(ValueError, match="rows vs"):
        gtex.load_tsne_layout(str(tmp_path / "labels.txt"), str(tmp_path / "short.txt"))


def test_gtex_figures_equal_the_references(tmp_path):
    _gtex_inputs(tmp_path)
    args = (str(tmp_path / "labels.txt"), str(tmp_path / "coords.txt"),
            str(tmp_path / "*specific_genes.txt"))
    written = gtex.run_gtex_figures(*args, str(tmp_path / "figs"), log=lambda s: None)
    ref_written = ref_gtex.run_gtex_figures(*args, str(tmp_path / "ref"), log=lambda s: None)
    assert [os.path.basename(w) for w in written] == \
        [os.path.basename(w) for w in ref_written] == ["Liver.png", "Lung.png"]
    for w, r in zip(written, ref_written):
        assert os.path.getsize(w) > 10_000
        assert abs(os.path.getsize(w) - os.path.getsize(r)) <= 0.01 * os.path.getsize(r)


def test_shifted_colormap_equals_the_references():
    for mid in (0.2, 0.5, 0.9):
        ours, theirs = gtex.shifted_colormap(mid), ref_gtex.shifted_colormap(mid)
        grid = np.linspace(0, 1, 33)
        np.testing.assert_array_equal(ours(grid), theirs(grid))
    assert gtex.Z_CLIP == ref_gtex.Z_CLIP


_OBO = """format-version: 1.2

[Term]
id: GO:0000001
name: root process
namespace: biological_process

[Term]
id: GO:0000002
name: child process
namespace: biological_process
alt_id: GO:0000099
is_a: GO:0000001 ! root process

[Term]
id: GO:0000003
name: grandchild
namespace: biological_process
is_a: GO:0000002 ! child process
is_a: GO:0000001 ! root process

[Term]
id: GO:0000004
name: gone
is_obsolete: true

[Typedef]
id: part_of
"""


def _dash_files(tmp_path):
    (tmp_path / "go.obo").write_text(_OBO)
    (tmp_path / "gene2go").write_text(
        "#tax_id\tGeneID\tGO_ID\tEvidence\n"
        "9606\tA\tGO:0000002\tIEA\n9606\tB\tGO:0000002\tIDA\n"
        "9606\tA\tGO:0000002\tIDA\n10090\t999\tGO:0000003\tIEA\n9606\tC\tGO:0000404\tIEA\n")
    (tmp_path / "reactome.txt").write_text(
        "A\tR-HSA-1\thttp://r/1\tApoptosis\tTAS\tHomo sapiens\n"
        "B\tR-HSA-1\thttp://r/1\tApoptosis\tTAS\tHomo sapiens\n"
        "999\tR-MMU-9\thttp://r/9\tMouse thing\tTAS\tMus musculus\nshort\tline\n")
    (tmp_path / "go.tsv").write_text("GO:1\tA\tthing one\nGO:1\tB\tthing one\nGO:2\tC\tother\n"
                                     "\tX\tno term\nGO:3\tD\n")
    (tmp_path / "p.gmt").write_text("P1\thttp://u\tA\tB\nP2\tdesc\tC\t\tD\nbad\n")
    (tmp_path / "fig.json").write_text(json.dumps(
        {"data": [{"customdata": ["A", "B", "C"], "x": [0, 1, 2]}], "layout": {}}))


def test_dash_parsers_equal_the_references(tmp_path):
    _dash_files(tmp_path)
    f = lambda name: str(tmp_path / name)  # noqa: E731
    assert dash_app.load_figure_json(f("fig.json")) == ref_dash.load_figure_json(f("fig.json"))
    assert dash_app.parse_annotation_table(f("go.tsv")) == \
        ref_dash.parse_annotation_table(f("go.tsv"))
    assert dash_app.parse_annotation_table(f("go.tsv"), 1, 0, None) == \
        ref_dash.parse_annotation_table(f("go.tsv"), 1, 0, None)
    assert dash_app.load_gmt_terms(f("p.gmt")) == ref_dash.load_gmt_terms(f("p.gmt"))
    ours, theirs = dash_app.parse_obo(f("go.obo")), ref_dash.parse_obo(f("go.obo"))
    assert {k: dataclasses_tuple(v) for k, v in ours.items()} == \
        {k: dataclasses_tuple(v) for k, v in theirs.items()}
    for taxids in (None, [9606], [10090, 9606]):
        assert dash_app.parse_gene2go(f("gene2go"), taxids) == \
            ref_dash.parse_gene2go(f("gene2go"), taxids)
    for species in (None, ["Homo sapiens"]):
        assert dash_app.load_reactome_table(f("reactome.txt"), species) == \
            ref_dash.load_reactome_table(f("reactome.txt"), species)
    assert dash_app.go_dag_descriptions(f("go.obo")) == ref_dash.go_dag_descriptions(f("go.obo"))


def dataclasses_tuple(term):
    return (term.id, term.name, term.namespace, term.parents, term.level, term.depth)


@pytest.mark.parametrize("selected", [[], ["B"], ["A", "C", "Z"]])
def test_highlight_and_options_equal_the_references(selected):
    figure = {"data": [{"type": "scattergl", "customdata": ["A", "B", "C"], "x": [0, 1, 2]},
                       {"text": ["C", "D"]}, {}], "layout": {}}
    assert dash_app.highlight_genes(figure, selected) == \
        ref_dash.highlight_genes(figure, selected)
    assert "marker" not in figure["data"][0]  # a pure function
    members = {"GO:2": ["C"], "GO:1": ["A", "B"], "GO:3": []}
    desc = {"GO:1": "thing one", "GO:3": ""}
    assert dash_app.term_options(members, desc) == ref_dash.term_options(members, desc)
    assert (dash_app.ACTIVE_COLOR, dash_app.INACTIVE_COLOR, dash_app.BASE_COLOR) == \
        (ref_dash.ACTIVE_COLOR, ref_dash.INACTIVE_COLOR, ref_dash.BASE_COLOR)


def test_descriptions_and_app_state_equal_the_references(tmp_path):
    _dash_files(tmp_path)
    f = lambda name: str(tmp_path / name)  # noqa: E731
    term = dash_app.GOTerm("GO:7", "name", "ns", ("GO:1",), 2, 3)
    rterm = ref_dash.GOTerm("GO:7", "name", "ns", ("GO:1",), 2, 3)
    for rep in ("Gene Symbol", "Entrez ID"):
        assert dash_app.go_description(term, ["A", "B"], rep) == \
            ref_dash.go_description(rterm, ["A", "B"], rep)
        info = {"name": "Apoptosis", "url": "http://r/1", "species": "Homo sapiens"}
        assert dash_app.reactome_description("R-HSA-1", info, ["A"], rep) == \
            ref_dash.reactome_description("R-HSA-1", info, ["A"], rep)
    for kw in ({"go_obo": f("go.obo"), "gene2go": f("gene2go"), "reactome_file": f("reactome.txt")},
               {"go_table": f("go.tsv"), "reactome_table": f("go.tsv")},
               {"go_obo": f("go.obo"), "gene2go": f("gene2go"), "taxids": [9606],
                "reactome_file": f("reactome.txt"), "species": ["Homo sapiens"]}, {}):
        ours = dash_app.build_app_state(f("fig.json"), **kw)
        theirs = ref_dash.build_app_state(f("fig.json"), **kw)
        assert ours["figure"] == theirs["figure"]
        assert set(ours["sources"]) == set(theirs["sources"])
        for kind, src in ours["sources"].items():
            rsrc = theirs["sources"][kind]
            assert src["members"] == rsrc["members"] and src["options"] == rsrc["options"]
            for t, genes in src["members"].items():
                assert src["describe"](t, genes) == rsrc["describe"](t, genes)


class _Similar(http.server.BaseHTTPRequestHandler):
    """A local stand-in for ``/v1/similar``: neighbours of TP53, 404 else."""

    def do_GET(self):  # noqa: N802
        if "gene=TP53" in self.path:
            body = json.dumps({"results": [{"neighbors": [
                {"gene": "MDM2", "score": 0.9}, {"gene": "CDKN1A", "score": 0.5}]}]}).encode()
            self.send_response(200)
        else:
            body = b"{}"
            self.send_response(404)
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)

    def log_message(self, *args):
        pass


def test_fetch_neighbors_equals_the_references():
    server = http.server.HTTPServer(("127.0.0.1", 0), _Similar)
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    try:
        url = f"http://127.0.0.1:{server.server_port}"
        for gene in ("TP53", "NOPE"):
            assert dash_app.fetch_neighbors(url, gene, 2) == ref_dash.fetch_neighbors(url, gene, 2)
        assert dash_app.fetch_neighbors(url, "TP53") == [("MDM2", 0.9), ("CDKN1A", 0.5)]
    finally:
        server.shutdown()
        server.server_close()


def test_serve_gated_and_graph_dir_refused(tmp_path):
    """A graph dir that holds no finalized artifact answers no neighbour
    (the dashboard degrades, as the reference's does); the graph lookup
    itself is held against the reference in ``tests/test_torch_batch.py``.
    Serving stays gated on dash."""
    assert dash_app.load_graph_neighbors(str(tmp_path))("G1", 3) is None
    if _have("dash"):
        pytest.skip("dash installed; gating not exercised")
    with pytest.raises(ImportError, match="dash"):
        dash_app.serve("/nonexistent.json")
    with pytest.raises(ImportError, match="dash"):
        dash_cli.main(["--figure-json", "/nonexistent.json"])
    with pytest.raises(ImportError, match="dash"):
        dash_app.serve(str(tmp_path / "fig.json"), graph_dir=str(tmp_path))
    with pytest.raises(ImportError, match="dash"):
        dash_cli.main(["--figure-json", "f.json", "--graph-dir", str(tmp_path)])


def test_dashboard_flags_are_the_references():
    from gene2vec_tpu.cli import dashboard as ref_cli

    ours = {a.dest: a.default for a in dash_cli.build_parser()._actions}
    theirs = {a.dest: a.default for a in ref_cli.build_parser()._actions}
    assert ours == theirs
    css = os.path.join(os.path.dirname(dash_app.__file__), "assets", "geneview.css")
    ref_css = os.path.join(os.path.dirname(ref_dash.__file__), "assets", "geneview.css")
    assert open(css).read() == open(ref_css).read()
