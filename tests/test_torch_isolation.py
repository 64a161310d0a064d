"""The PyTorch port stands alone: it imports neither ``jax`` nor anything of
``gene2vec_tpu`` (nor does ``chip_smoke.py``), and its
entry points refuse to run on the CPU unless the CPU is asked for."""

import ast
import os
import pkgutil
import re
import subprocess
import sys
import types

import numpy as np
import pytest
import torch

import gene2vec_tpu_torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG = os.path.join(ROOT, "gene2vec_tpu_torch")


def _port_modules():
    return sorted(
        m.name for m in pkgutil.walk_packages([PKG], prefix="gene2vec_tpu_torch.")
    )


def _port_sources():
    out = [os.path.join(ROOT, "chip_smoke.py")]
    for dirpath, _, names in os.walk(PKG):
        out += [os.path.join(dirpath, n) for n in names if n.endswith(".py")]
    return sorted(out)


#: the serving slice's modules, which the scans below must reach
SERVING_MODULES = {
    "gene2vec_tpu_torch.cli.serve", "gene2vec_tpu_torch.obs.registry",
    "gene2vec_tpu_torch.obs.trace", "gene2vec_tpu_torch.serve.ann",
    "gene2vec_tpu_torch.serve.batcher", "gene2vec_tpu_torch.serve.engine",
    "gene2vec_tpu_torch.serve.eventloop", "gene2vec_tpu_torch.serve.registry",
    "gene2vec_tpu_torch.serve.routes", "gene2vec_tpu_torch.serve.server",
    "gene2vec_tpu_torch.serve.tenancy", "gene2vec_tpu_torch.kernels.topk_exact",
    "gene2vec_tpu_torch.kernels.quant_scan", "gene2vec_tpu_torch.kernels.ivf_scan",
    "gene2vec_tpu_torch.kernels.rescore", "gene2vec_tpu_torch.kernels._topk",
}


def test_importing_every_module_loads_no_jax():
    """Every module imports with a CPU-only torch and pulls in no JAX;
    no kernel library is built or loaded at import (they build at first
    use on the card)."""
    mods = _port_modules()
    assert "gene2vec_tpu_torch.sgns.step" in mods and len(mods) > 30
    assert SERVING_MODULES <= set(mods)
    code = (
        "import importlib, json, sys\n"
        f"for m in {mods!r}: importlib.import_module(m)\n"
        "import chip_smoke\n"
        "from gene2vec_tpu_torch.kernels import build\n"
        "assert not build._libs, sorted(build._libs)\n"
        "bad = sorted(k for k in sys.modules if k == 'jax' or k.startswith('jax.')"
        " or k == 'gene2vec_tpu' or k.startswith('gene2vec_tpu.'))\n"
        "print(json.dumps(bad))\n"
    )
    # -S: no site hooks, so nothing but the code above imports anything
    env = dict(os.environ, PYTHONPATH=os.pathsep.join([ROOT, *sys.path[1:]]))
    res = subprocess.run(
        [sys.executable, "-S", "-c", code], capture_output=True, text=True,
        cwd=ROOT, env=env, timeout=120,
    )
    assert res.returncode == 0, res.stderr
    assert res.stdout.strip().splitlines()[-1] == "[]"


#: the third slice's modules (every objective and noise mode)
OBJECTIVE_MODULES = {
    "gene2vec_tpu_torch.kernels.per_example", "gene2vec_tpu_torch.kernels.shared_pool",
    "gene2vec_tpu_torch.kernels.hs", "gene2vec_tpu_torch.sgns.cbow_hs",
    "gene2vec_tpu_torch.sgns.huffman", "gene2vec_tpu_torch.data.negative_sampling",
}


def test_sources_scan_covers_the_serving_slice():
    """The scans reach the serving slice's modules and the third slice's."""
    scanned = {os.path.relpath(p, ROOT) for p in _port_sources()}
    assert OBJECTIVE_MODULES <= set(_port_modules())
    for mod in SERVING_MODULES | OBJECTIVE_MODULES:
        assert mod.replace(".", "/") + ".py" in scanned


def _imported_port_modules(path):
    with open(path, encoding="utf-8") as f:
        tree = ast.parse(f.read(), path)
    out = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.ImportFrom) and (node.module or "").startswith(
                "gene2vec_tpu_torch"):
            out.add(node.module)
        elif isinstance(node, ast.Import):
            out |= {a.name for a in node.names if a.name.startswith("gene2vec_tpu_torch")}
    return out


def test_sources_scan_covers_the_bf16_slice():
    """The fourth slice's new sources are scanned: ``kernels/stream_scale.py``
    by the import scans; ``csrc/k12_stream_scale.cu``, like every CUDA
    source, includes only the package's own headers and the toolkit's; and
    every port module that ``tests/test_torch_bf16.py`` drives (a test may
    import both packages) is one the import scans cover."""
    mods = set(_port_modules())
    scanned = {os.path.relpath(p, ROOT) for p in _port_sources()}
    assert "gene2vec_tpu_torch/kernels/stream_scale.py" in scanned
    csrc = os.path.join(PKG, "kernels", "csrc")
    sources = sorted(os.listdir(csrc))
    assert "k12_stream_scale.cu" in sources
    for name in sources:
        with open(os.path.join(csrc, name), encoding="utf-8") as f:
            text = f.read()
        for inc in re.findall(r'^#include "([^"]+)"', text, re.M):
            assert inc in sources, (name, inc)
    used = _imported_port_modules(os.path.join(ROOT, "tests", "test_torch_bf16.py"))
    assert used and {m for m in used if m != "gene2vec_tpu_torch"} <= mods | {
        m.rsplit(".", 1)[0] for m in mods}


@pytest.mark.parametrize("path", _port_sources(), ids=lambda p: os.path.relpath(p, ROOT))
def test_sources_import_no_jax(path):
    with open(path, encoding="utf-8") as f:
        tree = ast.parse(f.read(), path)
    names = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names += [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.append(node.module or "")
    bad = [n for n in names if n.split(".")[0] in ("jax", "jaxlib", "gene2vec_tpu", "flax")]
    assert not bad, f"{path} imports {bad}"


def _tiny_corpus():
    from gene2vec_tpu_torch.data.pipeline import PairCorpus
    from gene2vec_tpu_torch.io.vocab import Vocab

    pairs = np.array([[0, 1], [1, 2], [2, 3], [3, 0]] * 8, dtype=np.int32)
    return PairCorpus(Vocab([f"G{i}" for i in range(4)], np.full(4, 16)), pairs)


def test_trainer_needs_cuda_unless_cpu_is_asked(monkeypatch):
    from gene2vec_tpu_torch.sgns.train import SGNSTrainer

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        SGNSTrainer(_tiny_corpus())
    with pytest.raises(RuntimeError, match="no CUDA device"):
        SGNSTrainer(_tiny_corpus(), device="cuda")
    tr = SGNSTrainer(_tiny_corpus(), device="cpu")
    assert tr.device.type == "cpu" and tr.stratified.q.device.type == "cpu"


def test_cli_needs_cuda_unless_cpu_is_asked(monkeypatch, tmp_path):
    from gene2vec_tpu_torch.cli import gene2vec

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    data = tmp_path / "data"
    data.mkdir()
    (data / "p.txt").write_text("A B\nB C\nC A\n" * 10)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        gene2vec.main([str(data), str(tmp_path / "out")])
    assert not (tmp_path / "out").exists()
    assert gene2vec.main([
        str(data), str(tmp_path / "out"), "--device", "cpu", "--dim", "8",
        "--iters", "1", "--no-txt-output",
    ]) == 0


def test_cuda_tensor_never_takes_the_plain_version(monkeypatch):
    """A wrapper picks the plain version only for CPU tensors: on a CUDA
    tensor it goes to the kernel (here: the kernel loader, which is
    stubbed to fail) and never falls back."""
    from gene2vec_tpu_torch.kernels import _args, build, pos_logit

    calls = []

    def fake_load(name):
        calls.append(name)
        raise RuntimeError("kernel library unavailable")

    monkeypatch.setattr(build, "load", fake_load)
    monkeypatch.setattr(_args, "on_cpu", lambda *t: False)
    monkeypatch.setattr(pos_logit, "pos_logit_plain", lambda *a: pytest.fail("plain"))
    emb = torch.zeros(4, 3)
    ids = torch.zeros(2, dtype=torch.int32)
    with pytest.raises(RuntimeError, match="unavailable"):
        pos_logit.pos_logit(emb, emb, ids, ids)
    assert calls == ["k1_pos_logit"]


def test_serve_needs_cuda_unless_cpu_is_asked(monkeypatch, tmp_path):
    from gene2vec_tpu_torch.cli import serve
    from gene2vec_tpu_torch.serve.registry import ModelRegistry

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        serve.main(["--export-dir", str(tmp_path), "--port", "0"])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ModelRegistry(str(tmp_path))
    # on the CPU when asked: an empty export dir is the next failure
    assert serve.main(["--export-dir", str(tmp_path), "--port", "0", "--device", "cpu"]) == 2


def _serving_calls():
    from gene2vec_tpu_torch.kernels import ivf_scan, quant_scan, rescore, topk_exact

    f = torch.zeros(4, 3)
    i8 = torch.zeros(4, 3, dtype=torch.int8)
    ids = torch.zeros(2, 2, dtype=torch.int32)
    return [
        (topk_exact, "topk_exact", "k7_topk_exact", lambda: topk_exact.topk_exact(f, f, 2)),
        (quant_scan, "quant_scan", "k8_quant_scan",
         lambda: quant_scan.quant_scan(f, i8, torch.ones(4), 2)),
        (ivf_scan, "ivf_scan", "k9_ivf_scan",
         lambda: ivf_scan.ivf_scan(f, f, torch.zeros(4, 2, dtype=torch.int32), i8,
                                   torch.ones(4), 1, 2)),
        (rescore, "rescore", "k9r_rescore",
         lambda: rescore.rescore(f[:2], f, ids, torch.zeros(2, 2), 1)),
        (rescore, "row_gather", "k9r_rescore",
         lambda: rescore.row_gather(f, torch.zeros(2, dtype=torch.int32))),
    ]


@pytest.mark.parametrize("case", range(5))
def test_serving_wrappers_on_cuda_never_take_the_plain_version(monkeypatch, case):
    from gene2vec_tpu_torch.kernels import _args, build

    mod, name, lib, call = _serving_calls()[case]
    loaded = []

    def fake_load(lib_name):
        loaded.append(lib_name)
        raise RuntimeError("kernel library unavailable")

    monkeypatch.setattr(build, "load", fake_load)
    monkeypatch.setattr(_args, "on_cpu", lambda *t: False)
    monkeypatch.setattr(mod, f"{name}_plain", lambda *a: pytest.fail("plain"))
    with pytest.raises(RuntimeError, match="unavailable"):
        call()
    assert loaded == [lib]


def test_package_turns_tf32_off():
    assert gene2vec_tpu_torch.__name__ == "gene2vec_tpu_torch"
    assert torch.backends.cuda.matmul.allow_tf32 is False
    assert torch.backends.cudnn.allow_tf32 is False


#: options the port now trains (objectives, noise modes and their knobs;
#: bfloat16 tables and their write-back rounding; the phase timeline off;
#: epochs that leave the caller's tables untouched; the background
#: checkpoint writer)
PORTED_OPTIONS = {"objective", "negative_mode", "hs_dense_depth", "shared_pool",
                  "shared_pool_auto", "table_dtype", "bf16_stochastic_round",
                  "timeline", "donate", "kernel_profile", "async_checkpoint"}


@pytest.mark.parametrize("field,value", [
    ("objective", "cbow"), ("negative_mode", "shared"),
    ("table_dtype", "bfloat16"), ("vocab_sharded", True),
    ("async_checkpoint", True), ("pos_layout_shards", 2), ("timeline", False),
    ("bf16_stochastic_round", False), ("hs_dense_depth", 4), ("shared_pool", 64),
    ("shared_pool_auto", False), ("data_axis", "x"), ("model_axis", "y"),
    ("donate", False), ("compute_dtype", "bfloat16"), ("kernel_profile", True),
])
def test_config_rejects_unported_options(field, value):
    """Options selecting code the port lacks raise (bf16 arithmetic inside
    the step among them); the objectives, noise modes, their knobs,
    bfloat16 tables, ``timeline=False``, ``donate=False``,
    ``kernel_profile`` and ``async_checkpoint``, ported since, are
    accepted as given."""
    from gene2vec_tpu_torch.config import SGNSConfig

    if field in PORTED_OPTIONS:
        assert getattr(SGNSConfig(**{field: value}), field) == value
        return
    with pytest.raises(NotImplementedError, match=field):
        SGNSConfig(**{field: value})


def _f1_corpus(v=120, n=1536, seed=0):
    from gene2vec_tpu_torch.data.pipeline import PairCorpus
    from gene2vec_tpu_torch.io.vocab import Vocab

    rng = np.random.RandomState(seed)
    p = 1.0 / np.arange(1, v + 1)
    p /= p.sum()
    pairs = rng.choice(v, size=(n, 2), p=p).astype(np.int32)
    counts = np.bincount(pairs.ravel(), minlength=v) + 1
    return PairCorpus(Vocab([f"G{i}" for i in range(v)], counts), pairs)


_F1_SMALL = dict(dim=8, batch_pairs=128, strat_head=16, strat_block=32, strat_group=32,
                 positive_head=8, positive_mid=16, num_iters=2, txt_output=False)


@pytest.mark.parametrize("objective", ["sgns", "sg_hs"])
def test_timeline_is_written_in_the_reference_phases(tmp_path, objective):
    """``timeline=True`` (the default) writes ``timeline.jsonl`` into the
    export dir, which the unchanged JAX package's ``read_timeline`` reads:
    host_ingest, dispatch, compute and ckpt_stage for every iteration."""
    from gene2vec_tpu.obs.timeline import TIMELINE_NAME, read_timeline
    from gene2vec_tpu_torch.config import SGNSConfig
    from gene2vec_tpu_torch.obs import timeline as port_timeline
    from gene2vec_tpu_torch.sgns.cbow_hs import make_trainer

    cfg = SGNSConfig(objective=objective, **_F1_SMALL)
    make_trainer(_f1_corpus(), cfg, device="cpu").run(str(tmp_path), log=lambda m: None)
    path = os.path.join(str(tmp_path), TIMELINE_NAME)
    recs = read_timeline(path)
    assert port_timeline.TIMELINE_NAME == TIMELINE_NAME
    assert port_timeline.read_timeline(path) == recs  # the port's copy reads the same
    for it in (1, 2):
        names = [r["name"] for r in recs if r.get("step") == it]
        assert names == ["host_ingest", "dispatch", "compute", "ckpt_stage"], (it, names)
    assert all(r["dur"] >= 0.0 for r in recs)


def test_timeline_off_writes_no_file(tmp_path):
    from gene2vec_tpu_torch.config import SGNSConfig
    from gene2vec_tpu_torch.obs.timeline import TIMELINE_NAME
    from gene2vec_tpu_torch.sgns.train import SGNSTrainer

    cfg = SGNSConfig(timeline=False, **_F1_SMALL)
    SGNSTrainer(_f1_corpus(), cfg, device="cpu").run(str(tmp_path), log=lambda m: None)
    assert os.path.exists(os.path.join(str(tmp_path), "training_log.csv"))
    assert not os.path.exists(os.path.join(str(tmp_path), TIMELINE_NAME))


@pytest.mark.parametrize("objective", ["sgns", "sg_hs"])
def test_donate_off_leaves_the_callers_tables_and_trains_the_same(objective):
    """``donate=False``: an epoch leaves the tables it was given bitwise as
    they were and returns tables bitwise equal to the default (in-place)
    epoch's on the same draws."""
    from gene2vec_tpu_torch.config import SGNSConfig
    from gene2vec_tpu_torch.sgns.cbow_hs import make_trainer
    from gene2vec_tpu_torch.sgns.train import epoch_generator

    corpus = _f1_corpus()
    out = {}
    for donate in (True, False):
        tr = make_trainer(corpus, SGNSConfig(objective=objective, donate=donate, **_F1_SMALL),
                          device="cpu")
        params = tr.init()
        before = [t.clone() for t in params]
        new, loss = tr.train_epoch(params, tr.draw_epoch(epoch_generator(1, 1)))
        out[donate] = ([t.clone() for t in new], float(loss))
        if donate:
            assert new.emb is params.emb and not torch.equal(params.emb, before[0])
        else:
            assert all(torch.equal(t, b) for t, b in zip(params, before))
            assert new.emb is not params.emb
    assert out[True][1] == out[False][1]
    assert all(torch.equal(a, b) for a, b in zip(out[True][0], out[False][0]))


def test_config_rejects_unknown_objectives_and_modes():
    from gene2vec_tpu_torch.config import SGNSConfig

    with pytest.raises(ValueError, match="objective"):
        SGNSConfig(objective="glove")
    with pytest.raises(ValueError, match="negative_mode"):
        SGNSConfig(negative_mode="uniform")
    with pytest.raises(ValueError, match="table_dtype"):
        SGNSConfig(table_dtype="float16")


def test_bf16_index_raises_on_the_card(monkeypatch):
    """K8/K9 scan bf16 tables too: on a CUDA tensor a bf16 index goes to
    the kernel (here: the loader, stubbed to raise) and never to the
    plain scan; a table of another type raises before any launch."""
    from gene2vec_tpu_torch.kernels import _args, build, ivf_scan, quant_scan

    loaded = []

    def fake_load(name):
        loaded.append(name)
        raise RuntimeError("kernel library unavailable")

    monkeypatch.setattr(build, "load", fake_load)
    monkeypatch.setattr(_args, "on_cpu", lambda *t: False)
    monkeypatch.setattr(quant_scan, "quant_scan_plain", lambda *a: pytest.fail("plain"))
    monkeypatch.setattr(ivf_scan, "ivf_scan_plain", lambda *a: pytest.fail("plain"))
    qn = torch.zeros(2, 4)
    table = torch.zeros(8, 4, dtype=torch.bfloat16)
    with pytest.raises(RuntimeError, match="unavailable"):
        quant_scan.quant_scan(qn, table, torch.ones(8), 4)
    with pytest.raises(RuntimeError, match="unavailable"):
        ivf_scan.ivf_scan(qn, torch.zeros(2, 4), torch.zeros(2, 4, dtype=torch.int32),
                          table, torch.ones(8), 1, 4)
    assert loaded == ["k8_quant_scan", "k9_ivf_scan"]
    with pytest.raises(TypeError, match="int8 or bfloat16"):
        quant_scan.quant_scan(qn, table.float(), torch.ones(8), 4)


def _shallow():
    """A two-level shallow-path layout for four tokens (K6's argument)."""
    from gene2vec_tpu_torch.sgns.huffman import ShallowPaths

    return ShallowPaths(torch.zeros(4, 2, dtype=torch.int32),
                        torch.zeros(4, 2, dtype=torch.int8), 2)


def _training_calls():
    from gene2vec_tpu_torch.kernels import (
        hs, noise_head, noise_tail, per_example, pos_logit, row_update, shared_pool)

    f = torch.zeros(4, 3)
    g = torch.zeros(4)
    acc = torch.zeros(4, 4)
    ids = torch.zeros(4, dtype=torch.int32)
    t = f.to(torch.bfloat16)  # a bfloat16 table
    salts = [[1, 2], [3, 4]]
    f32_calls = [
        (per_example, "per_example", "k5_per_example",
         lambda: per_example.per_example(f, f, g, ids, ids[:, None], f, acc)),
        (shared_pool, "shared_pool", "k5_shared",
         lambda: shared_pool.shared_pool(f, f, g, ids, ids, f, 5, 2, acc)),
        (hs, "hs", "k6_hs",
         lambda: hs.hs(f, f[:3], ids, ids, ids[:, None], torch.zeros(4, 1), ids,
                       _shallow(), acc[:3])),
        (row_update, "scatter_rows", "k4_row_update",
         lambda: row_update.scatter_rows(acc, ids, f, g)),
        (row_update, "finalize_rows", "k4_row_update",
         lambda: row_update.finalize_rows(f, acc, 0.1, "capped")),
    ]
    bf16_calls = [
        (pos_logit, "pos_logit", "k1_pos_logit", lambda: pos_logit.pos_logit(t, t, ids, ids)),
        (noise_head, "noise_head", "k2_noise_head",
         lambda: noise_head.noise_head(f, f, g, ids, t, g, 2, 5, acc)),
        (noise_tail, "noise_tail", "k3_noise_tail",
         lambda: noise_tail.noise_tail(f, ids, t, g, ids[:2], 0, 2, 2, 5, f, acc)),
        (row_update, "row_update", "k4_row_update",
         lambda: row_update.row_update(t, t, acc, acc, ids, ids, f, f, g, 0.1, "capped",
                                       salts)),
        (per_example, "per_example", "k5_per_example",
         lambda: per_example.per_example(f, f, g, ids, ids[:, None], t, acc)),
        (shared_pool, "shared_pool", "k5_shared",
         lambda: shared_pool.shared_pool(f, f, g, ids, ids, t, 5, 2, acc)),
        (hs, "hs", "k6_hs",
         lambda: hs.hs(t, t[:3], ids, ids, ids[:, None], torch.zeros(4, 1), ids,
                       _shallow(), acc[:3])),
        (row_update, "finalize_rows", "k4_row_update",
         lambda: row_update.finalize_rows(t, acc, 0.1, "capped", salts[0])),
    ]
    return f32_calls + bf16_calls


@pytest.mark.parametrize("case", range(13))
def test_training_wrappers_on_cuda_never_take_the_plain_version(monkeypatch, case):
    """K5a, K5b, K6 and K4's generic entry points, then (cases 5-12) every
    training kernel on bfloat16 tables: a CUDA tensor reaches the kernel
    (the loader, stubbed to raise), never the plain version."""
    from gene2vec_tpu_torch.kernels import _args, build

    mod, name, lib, call = _training_calls()[case]
    loaded = []

    def fake_load(lib_name):
        loaded.append(lib_name)
        raise RuntimeError("kernel library unavailable")

    monkeypatch.setattr(build, "load", fake_load)
    monkeypatch.setattr(_args, "on_cpu", lambda *t: False)
    monkeypatch.setattr(mod, f"{name}_plain", lambda *a: pytest.fail("plain"))
    with pytest.raises(RuntimeError, match="unavailable"):
        call()
    assert loaded == [lib]


def test_cbow_hs_trainer_needs_cuda_unless_cpu_is_asked(monkeypatch):
    from gene2vec_tpu_torch.config import SGNSConfig
    from gene2vec_tpu_torch.sgns.cbow_hs import CBOWHSTrainer, make_trainer

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for objective in ("cbow", "sg_hs", "cbow_hs"):
        cfg = SGNSConfig(objective=objective, dim=8)
        with pytest.raises(RuntimeError, match="no CUDA device"):
            make_trainer(_tiny_corpus(), cfg)
        tr = CBOWHSTrainer(_tiny_corpus(), cfg, device="cpu")
        assert tr.init().emb.device.type == "cpu"


#: the fifth slice's modules (GGIPNN, /v1/interaction, K13, K14)
GGIPNN_MODULES = {
    "gene2vec_tpu_torch.models.ggipnn", "gene2vec_tpu_torch.models.ggipnn_data",
    "gene2vec_tpu_torch.models.ggipnn_obs", "gene2vec_tpu_torch.models.ggipnn_train",
    "gene2vec_tpu_torch.eval.metrics", "gene2vec_tpu_torch.utils.metrics",
    "gene2vec_tpu_torch.obs.run", "gene2vec_tpu_torch.cli.ggipnn",
    "gene2vec_tpu_torch.serve.interaction", "gene2vec_tpu_torch.kernels.lane",
    "gene2vec_tpu_torch.kernels.staged_copy",
}


def test_sources_scan_covers_the_ggipnn_slice():
    """The fifth slice's modules import in the no-JAX subprocess above and
    are scanned; K13/K14's CUDA sources are built by ``build.py``; every
    port module the new tests drive is one the scans cover."""
    from gene2vec_tpu_torch.kernels import build

    mods = set(_port_modules())
    assert GGIPNN_MODULES <= mods
    scanned = {os.path.relpath(p, ROOT) for p in _port_sources()}
    for mod in GGIPNN_MODULES:
        assert mod.replace(".", "/") + ".py" in scanned
    assert {"k13_lane.cu", "k14_staged_copy.cu"} <= set(build.SOURCES.values())
    for test in ("test_torch_ggipnn.py", "test_torch_interaction.py", "test_torch_probes.py"):
        used = _imported_port_modules(os.path.join(ROOT, "tests", test))
        assert used and {m for m in used if m != "gene2vec_tpu_torch"} <= mods | {
            m.rsplit(".", 1)[0] for m in mods}


def test_ggipnn_needs_cuda_unless_cpu_is_asked(monkeypatch, tmp_path):
    from gene2vec_tpu_torch.cli import ggipnn
    from gene2vec_tpu_torch.config import GGIPNNConfig
    from gene2vec_tpu_torch.models.ggipnn_data import PairTextVocab
    from gene2vec_tpu_torch.models.ggipnn_train import GGIPNNTrainer

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    vocab = PairTextVocab().fit(["A B", "B C"])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        GGIPNNTrainer(GGIPNNConfig(embedding_dim=4), vocab)
    tr = GGIPNNTrainer(GGIPNNConfig(embedding_dim=4), vocab, device="cpu")
    assert tr.init_state().embedding.device.type == "cpu"
    for split in ("train", "valid", "test"):
        (tmp_path / f"{split}_text.txt").write_text("A B\nB C\nC A\nA C\n")
        (tmp_path / f"{split}_label.txt").write_text("1\n0\n1\n0\n")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ggipnn.main(["--data-dir", str(tmp_path), "--embedding-dim", "4"])
    assert ggipnn.main(["--data-dir", str(tmp_path), "--embedding-dim", "4",
                        "--batch-size", "2", "--device", "cpu"]) == 0


def _probe_calls():
    from gene2vec_tpu_torch.kernels import lane, staged_copy, stream_scale

    t = torch.zeros(4, 128)
    offs = torch.zeros(8, 128, dtype=torch.int32)
    x = torch.zeros(16, 8)
    return [
        (lane, "lane_gather", "k13_lane", lambda: lane.lane_gather(t, offs)),
        (lane, "lane_scatter", "k13_lane", lambda: lane.lane_scatter(t, t, offs)),
        (lane, "lane_gather", "k13_lane",
         lambda: lane.lane_gather(t.to(torch.bfloat16), offs)),
        (staged_copy, "staged_copy", "k14_staged_copy",
         lambda: staged_copy.staged_copy(x, 2.0, tile_rows=8)),
        (staged_copy, "staged_copy", "k14_staged_copy",
         lambda: staged_copy.staged_copy(x, 1.0, offset=torch.zeros(1, dtype=torch.int32),
                                         head=8)),
        (stream_scale, "stream_scale", "k12_stream_scale",
         lambda: stream_scale.stream_scale(x.to(torch.bfloat16), 2.0)),
    ]


@pytest.mark.parametrize("case", range(6))
def test_probe_wrappers_on_cuda_never_take_the_plain_version(monkeypatch, case):
    """K13, K14 and K12's bfloat16 instance: a CUDA tensor reaches the
    kernel (the loader, stubbed to raise), never the plain version."""
    from gene2vec_tpu_torch.kernels import _args, build

    mod, name, lib, call = _probe_calls()[case]
    loaded = []

    def fake_load(lib_name):
        loaded.append(lib_name)
        raise RuntimeError("kernel library unavailable")

    monkeypatch.setattr(build, "load", fake_load)
    monkeypatch.setattr(_args, "on_cpu", lambda *t: False)
    monkeypatch.setattr(mod, f"{name}_plain", lambda *a, **k: pytest.fail("plain"))
    with pytest.raises(RuntimeError, match="unavailable"):
        call()
    assert loaded == [lib]


def test_ggipnn_lookup_on_cuda_reaches_the_row_gather_kernel(monkeypatch):
    """The GGIPNN forward's table lookup is K9r's row gather: on a CUDA
    tensor it goes to the kernel (stubbed to raise), not ``table[ids]``."""
    from gene2vec_tpu_torch.kernels import _args, build, rescore
    from gene2vec_tpu_torch.models.ggipnn import GGIPNN

    loaded = []

    def fake_load(lib_name):
        loaded.append(lib_name)
        raise RuntimeError("kernel library unavailable")

    monkeypatch.setattr(build, "load", fake_load)
    monkeypatch.setattr(_args, "on_cpu", lambda *t: False)
    monkeypatch.setattr(rescore, "row_gather_plain", lambda *a: pytest.fail("plain"))
    model = GGIPNN(6, 4, (3, 3, 2))
    with pytest.raises(RuntimeError, match="unavailable"):
        model(torch.zeros((2, 2), dtype=torch.int32))
    assert loaded == ["k9r_rescore"]


#: the pipeline slice's modules (corpus with K11, t-SNE with K10c/K10, the
#: intrinsic evaluation)
PIPELINE_MODULES = {
    "gene2vec_tpu_torch.corpus", "gene2vec_tpu_torch.corpus.builder",
    "gene2vec_tpu_torch.viz", "gene2vec_tpu_torch.viz.tsne",
    "gene2vec_tpu_torch.eval.target_function", "gene2vec_tpu_torch.cli.generate_pairs",
    "gene2vec_tpu_torch.cli.tsne", "gene2vec_tpu_torch.cli.evaluate",
    "gene2vec_tpu_torch.obs.probes", "gene2vec_tpu_torch.obs.ledger",
    "gene2vec_tpu_torch.kernels.coexpr_mask", "gene2vec_tpu_torch.kernels.tsne_calibrate",
    "gene2vec_tpu_torch.kernels.tsne_step",
}


def test_sources_scan_covers_the_pipeline_slice():
    """The pipeline slice's modules import in the no-JAX subprocess above and
    are scanned; K10c/K10/K11's CUDA sources are built by ``build.py``;
    every port module the slice's tests drive is one the scans cover."""
    from gene2vec_tpu_torch.kernels import build

    mods = set(_port_modules())
    assert PIPELINE_MODULES <= mods
    scanned = {os.path.relpath(p, ROOT) for p in _port_sources()}
    for mod in PIPELINE_MODULES:
        path = mod.replace(".", "/")
        assert path + ".py" in scanned or path + "/__init__.py" in scanned
    assert {"k10c_tsne_calibrate.cu", "k10_tsne_step.cu",
            "k11_coexpr_mask.cu"} <= set(build.SOURCES.values())
    for test in ("test_torch_corpus.py", "test_torch_tsne.py",
                 "test_torch_target_function.py"):
        used = _imported_port_modules(os.path.join(ROOT, "tests", test))
        assert used and {m for m in used if m != "gene2vec_tpu_torch"} <= mods | {
            m.rsplit(".", 1)[0] for m in mods}


def _toy_query(root):
    import pandas as pd

    d = os.path.join(root, "q", "data")
    os.makedirs(d)
    samples = [f"S{i}" for i in range(20)]
    rng = np.random.RandomState(0)
    tpm = rng.rand(20, 4) * 10 + 1
    pd.DataFrame({"SRA Study": ["A"] * 20}, index=pd.Index(samples, name="Run")).to_csv(
        os.path.join(d, "SRARunTable.csv"))
    pd.DataFrame(tpm, index=pd.Index(samples, name="run"),
                 columns=["E1", "E2", "E3", "E4"]).to_csv(os.path.join(d, "gene_counts_TPM.csv"))
    counts = pd.DataFrame(np.round(tpm.T * 100), columns=samples)
    counts.insert(0, "gene_id", ["E1|A", "E2|B", "E3|C", "E4|D"])
    counts.to_csv(os.path.join(d, "gene_counts.csv"), index=False)
    return os.path.join(root, "q")


def test_corpus_needs_cuda_unless_cpu_is_asked(monkeypatch, tmp_path):
    from gene2vec_tpu_torch.cli import generate_pairs
    from gene2vec_tpu_torch.corpus import builder

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    q = _toy_query(str(tmp_path))
    for kw in ({}, {"device": "cuda"}):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            builder.build_pairs(q, log=lambda s: None, **kw)
        with pytest.raises(RuntimeError, match="no CUDA device"):
            builder.abs_correlation_mask(np.eye(4), 0.5, **kw)
    assert isinstance(builder.build_pairs(q, device="cpu", log=lambda s: None), list)
    # the reference's float64 host path needs no device
    assert isinstance(builder.build_pairs(q, backend="numpy", log=lambda s: None), list)
    out = tmp_path / "pairs.txt"
    with pytest.raises(RuntimeError, match="no CUDA device"):
        generate_pairs.main(["--query", q, "--out", str(out)])
    assert not out.exists()
    assert generate_pairs.main(["--query", q, "--out", str(out), "--device", "cpu"]) == 0
    assert generate_pairs.main(["--query", q, "--out", str(out), "--backend", "numpy"]) == 0


def test_tsne_needs_cuda_unless_cpu_is_asked(monkeypatch, tmp_path):
    from gene2vec_tpu_torch.cli import tsne as tsne_cli
    from gene2vec_tpu_torch.config import TSNEConfig
    from gene2vec_tpu_torch.io.emb_io import write_matrix_txt
    from gene2vec_tpu_torch.viz.tsne import TSNE

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    x = np.random.RandomState(0).randn(12, 4).astype(np.float32)
    cfg = TSNEConfig(pca_dims=0, perplexity=3.0)
    for dev in (None, "cuda"):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            TSNE(config=cfg, device=dev).fit(x, snapshot_iters=[2], log=lambda s: None)
    out = TSNE(config=cfg, device="cpu").fit(x, snapshot_iters=[2], log=lambda s: None)
    assert out[2].shape == (12, 2)
    emb = tmp_path / "emb.txt"
    write_matrix_txt(str(emb), [f"G{i}" for i in range(12)], x)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tsne_cli.main([str(emb), str(tmp_path / "t"), "--iters", "2"])
    assert not (tmp_path / "t").exists()
    assert tsne_cli.main([str(emb), str(tmp_path / "t"), "--iters", "2", "--perplexity", "3",
                          "--device", "cpu"]) == 0


def test_evaluate_runs_on_the_host_without_a_device(monkeypatch, tmp_path, capsys):
    """The intrinsic evaluation is numpy on the host: no device to ask for,
    and it runs where CUDA is absent."""
    from gene2vec_tpu_torch.cli import evaluate
    from gene2vec_tpu_torch.io.emb_io import write_word2vec_format

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    rng = np.random.RandomState(0)
    toks = [f"G{i}" for i in range(30)]
    write_word2vec_format(str(tmp_path / "e.txt"), toks, rng.randn(30, 4).astype(np.float32))
    (tmp_path / "p.gmt").write_text("P\turl\tG1\tG2\tG3\n")
    assert evaluate.main([str(tmp_path / "e.txt"), str(tmp_path / "p.gmt")]) == 0
    assert float(capsys.readouterr().out)
    assert not torch.cuda.is_initialized()


def _pipeline_calls():
    from gene2vec_tpu_torch.kernels import coexpr_mask, tsne_calibrate, tsne_step

    z = torch.zeros(6, 40)
    d2 = torch.zeros(5, 5)
    p = tsne_calibrate.empty_rows(5, 5, "cpu").zero_()  # P's rows as the card keeps them
    y = torch.zeros(5, 2)
    return [
        (coexpr_mask, "coexpr_mask", "k11_coexpr_mask",
         lambda: coexpr_mask.coexpr_mask(z, 0.9)),
        (tsne_calibrate, "conditional", "k10c_tsne_calibrate",
         lambda: tsne_calibrate.conditional(d2, 3.0)),
        (tsne_calibrate, "symmetrize", "k10c_tsne_calibrate",
         lambda: tsne_calibrate.symmetrize_(p)),
        (tsne_step, "step", "k10_tsne_step",
         lambda: tsne_step.step_(p, y, y.clone(), y.clone(), 12.0, 0.5, 200.0,
                                 ws=types.SimpleNamespace(n=5))),
    ]


@pytest.mark.parametrize("case", range(4))
def test_pipeline_wrappers_on_cuda_never_take_the_plain_version(monkeypatch, case):
    """K11, K10c's two launches and K10: a CUDA tensor reaches the kernel
    (the loader, stubbed to raise), never the plain version."""
    from gene2vec_tpu_torch.kernels import _args, build

    mod, name, lib, call = _pipeline_calls()[case]
    loaded = []

    def fake_load(lib_name):
        loaded.append(lib_name)
        raise RuntimeError("kernel library unavailable")

    monkeypatch.setattr(build, "load", fake_load)
    monkeypatch.setattr(_args, "on_cpu", lambda *t: False)
    monkeypatch.setattr(mod, f"{name}_plain", lambda *a, **k: pytest.fail("plain"))
    with pytest.raises(RuntimeError, match="unavailable"):
        call()
    assert loaded == [lib]


#: the UMAP slice's modules (UMAP with K15/K16, the plot exports, the GTEx
#: figures, the GeneView dashboard and their CLIs)
UMAP_MODULES = {
    "gene2vec_tpu_torch.viz.umap", "gene2vec_tpu_torch.viz.plot",
    "gene2vec_tpu_torch.viz.gtex", "gene2vec_tpu_torch.viz.dash_app",
    "gene2vec_tpu_torch.cli.plot", "gene2vec_tpu_torch.cli.dashboard",
    "gene2vec_tpu_torch.kernels.umap_graph", "gene2vec_tpu_torch.kernels.umap_step",
}


def test_sources_scan_covers_the_umap_slice():
    """The UMAP slice's modules import in the no-JAX subprocess above and
    are scanned; K15/K16's CUDA sources are built by ``build.py`` and their
    wrappers counted by ``kernels.launch_counts``; the dashboard's
    stylesheet is the package's own; every port module the slice's tests
    drive is one the scans cover."""
    from gene2vec_tpu_torch import kernels
    from gene2vec_tpu_torch.kernels import build

    mods = set(_port_modules())
    assert UMAP_MODULES <= mods
    scanned = {os.path.relpath(p, ROOT) for p in _port_sources()}
    for mod in UMAP_MODULES:
        assert mod.replace(".", "/") + ".py" in scanned
    assert {"k15_umap_graph.cu", "k16_umap_step.cu"} <= set(build.SOURCES.values())
    assert {"umap_graph", "umap_graph_union", "umap_graph_scan", "umap_graph_fill",
            "umap_graph_sort", "umap_step"} <= set(kernels.launch_counts())
    assert os.path.isfile(os.path.join(PKG, "viz", "assets", "geneview.css"))
    for test in ("test_torch_umap.py", "test_torch_plot.py"):
        used = _imported_port_modules(os.path.join(ROOT, "tests", test))
        assert used and {m for m in used if m != "gene2vec_tpu_torch"} <= mods | {
            m.rsplit(".", 1)[0] for m in mods}


def test_umap_needs_cuda_unless_cpu_is_asked(monkeypatch):
    from gene2vec_tpu_torch.viz.plot import reduce_embedding
    from gene2vec_tpu_torch.viz.umap import UMAPConfig, umap_layout

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    x = np.random.RandomState(0).randn(12, 4).astype(np.float32)
    cfg = UMAPConfig(pca_dims=4, n_iters=2)
    for dev in (None, "cuda"):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            umap_layout(x, cfg, device=dev)
        with pytest.raises(RuntimeError, match="no CUDA device"):
            reduce_embedding(x, "umap", device=dev)
    assert umap_layout(x, cfg, device="cpu").shape == (12, 2)
    assert reduce_embedding(x, "pca").shape == (12, 2)  # PCA is the host's: no device
    assert not torch.cuda.is_initialized()


def _umap_calls():
    from gene2vec_tpu_torch.kernels import tsne_calibrate, umap_graph, umap_step

    d2 = tsne_calibrate.empty_rows(5, 5, "cpu").zero_()
    idx = torch.zeros(5, 2, dtype=torch.int32)
    w = torch.zeros(5, 2)
    p = umap_graph.Graph(torch.zeros(6, dtype=torch.int32), torch.zeros(0, dtype=torch.int32),
                         torch.zeros(0))
    y = torch.zeros(5, 2)
    c = umap_step.constants(1.5, 0.875, 1.0, True)
    return [
        (umap_graph, "knn_weights", "k15_umap_graph", lambda: umap_graph.knn_weights(d2, 2)),
        (umap_graph, "fuzzy_union", "k15_umap_graph", lambda: umap_graph.fuzzy_union(idx, w)),
        (umap_step, "step", "k16_umap_step", lambda: umap_step.step(p, y, c, 1.0)),
    ]


@pytest.mark.parametrize("case", range(3))
def test_umap_wrappers_on_cuda_never_take_the_plain_version(monkeypatch, case):
    """K15's launch 1 and its union, and K16: a CUDA tensor reaches the kernel (the
    loader, stubbed to raise), never the plain version."""
    from gene2vec_tpu_torch.kernels import _args, build

    mod, name, lib, call = _umap_calls()[case]
    loaded = []

    def fake_load(lib_name):
        loaded.append(lib_name)
        raise RuntimeError("kernel library unavailable")

    monkeypatch.setattr(build, "load", fake_load)
    monkeypatch.setattr(_args, "on_cpu", lambda *t: False)
    monkeypatch.setattr(mod, f"{name}_plain", lambda *a, **k: pytest.fail("plain"))
    with pytest.raises(RuntimeError, match="unavailable"):
        call()
    assert loaded == [lib]


def test_dashboard_and_gtex_run_on_the_host_without_a_device(monkeypatch, tmp_path):
    """The GTEx figures and the dashboard's logic are host code: they run
    where CUDA is absent and never touch it."""
    from gene2vec_tpu_torch.viz import dash_app, gtex

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    (tmp_path / "labels.txt").write_text("A\nB\nC\n")
    np.savetxt(tmp_path / "coords.txt", np.eye(3)[:, :2])
    (tmp_path / "X_specific_genes.txt").write_text("A 1.0\nC 3.0\n")
    assert len(gtex.run_gtex_figures(str(tmp_path / "labels.txt"), str(tmp_path / "coords.txt"),
                                     str(tmp_path / "*specific_genes.txt"),
                                     str(tmp_path / "figs"), log=lambda s: None)) == 1
    (tmp_path / "fig.json").write_text('{"data": [{"customdata": ["A", "B"]}], "layout": {}}')
    (tmp_path / "go.tsv").write_text("GO:1\tA\tone\n")
    state = dash_app.build_app_state(str(tmp_path / "fig.json"), go_table=str(tmp_path / "go.tsv"))
    assert state["sources"]["GO"]["members"] == {"GO:1": ["A"]}
    assert not torch.cuda.is_initialized()


#: the quality tooling and run records' modules (the planted check, the
#: holdout protocol, goodput, and the trainers and registry they extend)
QUALITY_MODULES = {
    "gene2vec_tpu_torch.eval", "gene2vec_tpu_torch.eval.planted",
    "gene2vec_tpu_torch.eval.holdout", "gene2vec_tpu_torch.obs.goodput",
    "gene2vec_tpu_torch.obs.registry", "gene2vec_tpu_torch.obs.run",
    "gene2vec_tpu_torch.sgns.train", "gene2vec_tpu_torch.sgns.cbow_hs",
    "gene2vec_tpu_torch.models.ggipnn_train",
}


def test_sources_scan_covers_the_quality_slice():
    """The quality tooling's and run records' modules import in the no-JAX
    subprocess above and are scanned; every port module their tests drive
    is one the scans cover."""
    mods = set(_port_modules())
    assert QUALITY_MODULES <= mods
    scanned = {os.path.relpath(p, ROOT) for p in _port_sources()}
    for mod in QUALITY_MODULES - {"gene2vec_tpu_torch.eval"}:
        assert mod.replace(".", "/") + ".py" in scanned
    assert "gene2vec_tpu_torch/eval/__init__.py" in scanned
    for test in ("test_torch_quality.py", "test_torch_obs_run.py"):
        used = _imported_port_modules(os.path.join(ROOT, "tests", test))
        assert used and {m for m in used if m != "gene2vec_tpu_torch"} <= mods | {
            m.rsplit(".", 1)[0] for m in mods}


def test_quality_tooling_needs_cuda_unless_cpu_is_asked(monkeypatch):
    from gene2vec_tpu_torch.config import SGNSConfig
    from gene2vec_tpu_torch.sgns.train import train_epochs

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = SGNSConfig(dim=4, batch_pairs=8, strat_head=2, strat_block=2, strat_group=4)
    for dev in (None, "cuda"):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            train_epochs(_tiny_corpus(), cfg, 1, device=dev)
    emb, losses = train_epochs(_tiny_corpus(), cfg, 1, device="cpu")
    assert emb.shape == (4, 4) and len(losses) == 1
    assert not torch.cuda.is_initialized()


def test_chip_smoke_keeps_no_work_formula_of_its_own():
    """Every bound ``chip_smoke.py`` gives a kernel comes from the kernel
    modules' ``work`` functions through ``obs/profiler.py:bound``: the
    script defines no ``*_bound`` or ``*_work`` function, no ``bound``, and
    none of the card's peak rates."""
    with open(os.path.join(ROOT, "chip_smoke.py"), encoding="utf-8") as f:
        tree = ast.parse(f.read())
    defs = [n.name for n in ast.walk(tree) if isinstance(n, (ast.FunctionDef, ast.Lambda))
            and getattr(n, "name", "").endswith(("_bound", "_work", "_bytes"))]
    defs += [n.name for n in ast.walk(tree) if isinstance(n, ast.FunctionDef)
             and n.name == "bound"]
    assert defs == []
    assigned = {t.id for n in ast.walk(tree) if isinstance(n, ast.Assign)
                for t in n.targets if isinstance(t, ast.Name)}
    assert not {n for n in assigned if n.endswith(("_PER_S", "_OP_PER_S"))}


#: the serving fleet and its observability planes' modules
FLEET_MODULES = {
    "gene2vec_tpu_torch.obs.tracecontext", "gene2vec_tpu_torch.obs.trace",
    "gene2vec_tpu_torch.obs.alerts", "gene2vec_tpu_torch.obs.flight",
    "gene2vec_tpu_torch.obs.aggregate", "gene2vec_tpu_torch.obs.incident",
    "gene2vec_tpu_torch.serve.client", "gene2vec_tpu_torch.serve.fleet",
    "gene2vec_tpu_torch.cli.fleet", "gene2vec_tpu_torch.cli.obs",
}


def test_sources_scan_covers_the_fleet_slice():
    """The fleet slice's modules import in the no-JAX subprocess above and
    are scanned by the AST scan; every port module the slice's tests drive
    is one the scans cover."""
    mods = set(_port_modules())
    assert FLEET_MODULES <= mods
    scanned = {os.path.relpath(p, ROOT) for p in _port_sources()}
    for mod in FLEET_MODULES:
        assert mod.replace(".", "/") + ".py" in scanned
    for test in ("test_torch_fleet.py", "test_torch_tracing.py", "test_torch_alerts.py"):
        used = _imported_port_modules(os.path.join(ROOT, "tests", test))
        assert used and {m for m in used if m != "gene2vec_tpu_torch"} <= mods | {
            m.rsplit(".", 1)[0] for m in mods}


def test_fleet_replicas_are_the_ports_servers():
    """The supervisor spawns the port's ``cli.serve``, never the reference's,
    and ``cli.fleet`` refuses the flags of unported features (and a missing
    checkpoint, no replica) with exit 2 before it spawns anything."""
    from gene2vec_tpu_torch.cli import fleet as fleet_cli
    from gene2vec_tpu_torch.serve.fleet import FleetConfig, FleetSupervisor

    argv = FleetSupervisor("exp", FleetConfig(replicas=1), serve_args=["--device", "cpu"])._argv(0)
    assert argv[1:3] == ["-m", "gene2vec_tpu_torch.cli.serve"] and argv[-2:] == ["--device", "cpu"]
    for flags in (["--max-replicas", "2"], ["--shard-by-rows", "2"], ["--catalog", "c.json"],
                  ["--enable-shadow"], ["--jobs-dir", "j"], ["--swap-interval", "1"],
                  ["--ggipnn-checkpoint", "absent.npz"], ["--replicas", "0"]):
        assert fleet_cli.main(["--export-dir", "exp", *flags]) == 2
