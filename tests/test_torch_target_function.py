"""The port's intrinsic evaluation (``gene2vec_tpu_torch/eval/
target_function.py``, ``cli/evaluate.py``) against the JAX package's: a
numpy copy, so every score is equal, on a synthetic ``.gmt`` and
embedding (the MSigDB file is not in the image)."""

import json

import numpy as np
import pytest

from gene2vec_tpu.cli import evaluate as ref_cli
from gene2vec_tpu.eval import target_function as ref
from gene2vec_tpu.io.emb_io import write_matrix_txt, write_word2vec_format
from gene2vec_tpu_torch.cli import evaluate as port_cli
from gene2vec_tpu_torch.eval import target_function as port


def _embedding(seed=1, n_pathways=8, genes_per=6, dim=16, background=1500):
    rng = np.random.RandomState(seed)
    tokens, rows, pathways = [], [], {}
    for p in range(n_pathways):
        center = rng.randn(dim) * 3
        members = []
        for g in range(genes_per):
            tokens.append(f"P{p}G{g}")
            rows.append(center + rng.randn(dim) * 0.3)
            members.append(f"P{p}G{g}")
        pathways[f"PW{p}"] = members
    for i in range(background):
        tokens.append(f"BG{i}")
        rows.append(rng.randn(dim))
    return tokens, np.asarray(rows, np.float32), pathways


def _write_gmt(path, pathways, extra=True):
    lines = [f"{name}\turl\t" + "\t".join(genes) for name, genes in pathways.items()]
    if extra:
        lines.append("BIG\turl\t" + "\t".join(f"BG{i}" for i in range(51)))  # > 50: skipped
        lines.append("EXACT50\turl\t" + "\t".join(f"BG{i}" for i in range(50)))
        lines.append("ABSENT\turl\tNOPE1\tNOPE2")                           # < 2 present
        lines.append("ONE\turl\tP0G0\tNOPE")
        lines.append("SHORT\turl")                                           # < 3 fields
        lines.append("EMPTYFIELDS\turl\tP1G0\t\tP1G1\t")
    path.write_text("\n".join(lines) + "\n", encoding="utf-8")
    return str(path)


def test_load_gmt_equals_the_reference(tmp_path):
    _, _, pathways = _embedding()
    gmt = _write_gmt(tmp_path / "x.gmt", pathways)
    for max_genes in (50, 5, 60):
        assert port.load_gmt(gmt, max_genes) == ref.load_gmt(gmt, max_genes)


def test_pairwise_cosine_and_unit_rows_equal_the_reference():
    rng = np.random.RandomState(0)
    mat = rng.randn(17, 9)
    mat[3] = 0.0
    np.testing.assert_array_equal(port._unit_rows(mat), ref._unit_rows(mat))
    unit = ref._unit_rows(mat)
    assert port.mean_pairwise_cosine(unit) == ref.mean_pairwise_cosine(unit)
    with pytest.raises(ValueError):
        port.mean_pairwise_cosine(unit[:1])


@pytest.mark.parametrize("shuffle", [False, True])
def test_scores_equal_the_reference(shuffle):
    tokens, matrix, pathways = _embedding()
    if shuffle:
        matrix = matrix[np.random.RandomState(4).permutation(len(matrix))]
    for kw in ({}, {"num_random_genes": 300, "seed": 7}):
        assert port.target_function_arrays(tokens, matrix, pathways, **kw) == \
            ref.target_function_arrays(tokens, matrix, pathways, **kw)
        assert port.random_pair_similarity(tokens, matrix, **{
            k.replace("num_random_genes", "num_genes"): v for k, v in kw.items()}) == \
            ref.random_pair_similarity(tokens, matrix, **{
                k.replace("num_random_genes", "num_genes"): v for k, v in kw.items()})
    assert port.pathway_similarities(tokens, matrix, pathways) == \
        ref.pathway_similarities(tokens, matrix, pathways)
    with pytest.raises(ValueError):
        port.pathway_similarities(tokens, matrix, {"X": ["NOPE"]})


@pytest.mark.parametrize("fmt", ["w2v", "matrix"])
def test_target_function_file_equals_the_reference(tmp_path, fmt):
    tokens, matrix, pathways = _embedding(seed=2)
    emb = tmp_path / f"emb_{fmt}.txt"
    (write_word2vec_format if fmt == "w2v" else write_matrix_txt)(str(emb), tokens, matrix)
    gmt = _write_gmt(tmp_path / "p.gmt", pathways)
    assert port.target_function(str(emb), gmt) == ref.target_function(str(emb), gmt)
    clean = _write_gmt(tmp_path / "clean.gmt", pathways, extra=False)
    got = port.target_function(str(emb), clean)
    assert got == ref.target_function(str(emb), clean) and np.isfinite(got)


def _run(main, argv, capsys):
    assert main(argv) == 0
    return capsys.readouterr().out


def test_cli_output_equals_the_reference(tmp_path, capsys):
    tokens, matrix, pathways = _embedding(seed=3)
    emb = tmp_path / "emb_w2v.txt"
    write_word2vec_format(str(emb), tokens, matrix)
    gmt = _write_gmt(tmp_path / "p.gmt", pathways)
    for extra in ([], ["--max-pathway-genes", "5", "--num-random-genes", "100",
                       "--seed", "3"]):
        argv = [str(emb), gmt, *extra]
        assert _run(port_cli.main, argv, capsys) == _run(ref_cli.main, argv, capsys)
        got = json.loads(_run(port_cli.main, [*argv, "--json", "--out",
                                              str(tmp_path / "p.json")], capsys))
        want = json.loads(_run(ref_cli.main, [*argv, "--json", "--out",
                                              str(tmp_path / "r.json")], capsys))
        for doc in (got, want):
            assert doc.pop("created_unix") > 0
            doc.pop("command")
        assert got == want
        with open(tmp_path / "p.json", encoding="utf-8") as f:
            on_disk = json.load(f)
        assert on_disk["trained_target_func_ratio"] == got["trained_target_func_ratio"]
        assert on_disk["schema_version"] == 1


def test_cli_refuses_graph_dir(tmp_path, capsys):
    """``--graph-dir`` refuses a directory that holds no finalized kNN-graph
    artifact, as the reference does (the artifact path is ported: the
    graph variant's parity is in ``tests/test_torch_batch.py``), and the
    command refuses to run without an embedding or a graph."""
    tokens, matrix, pathways = _embedding(seed=3)
    gmt = _write_gmt(tmp_path / "p.gmt", pathways)
    for cli in (port_cli, ref_cli):
        with pytest.raises(IOError, match="ARTIFACT.json"):
            cli.main(["--graph-dir", str(tmp_path), gmt])
    with pytest.raises(SystemExit) as err:
        port_cli.main([gmt])
    assert err.value.code not in (0, None)


def test_cli_flags_are_the_references():
    def flags(parser):
        return {s for a in parser._actions for s in a.option_strings}

    assert flags(port_cli.build_parser()) == flags(ref_cli.build_parser())


def test_provenance_stamp_equals_the_reference():
    from gene2vec_tpu.obs.ledger import provenance_stamp as ref_stamp
    from gene2vec_tpu_torch.obs.ledger import provenance_stamp

    got, want = provenance_stamp({"a": 1}), ref_stamp({"a": 1})
    assert set(got) == set(want) and got["command"] == want["command"]
    assert provenance_stamp({"schema_version": 3})["schema_version"] == 3
