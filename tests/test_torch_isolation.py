"""The PyTorch port stands alone: it imports neither ``jax`` nor anything of
``gene2vec_tpu`` (nor does ``chip_smoke.py``), and its entry points refuse
to run on the CPU unless the CPU is asked for."""

import ast
import os
import pkgutil
import subprocess
import sys

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


def test_sources_scan_covers_the_serving_slice():
    scanned = {os.path.relpath(p, ROOT) for p in _port_sources()}
    for mod in SERVING_MODULES:
        assert mod.replace(".", "/") + ".py" in scanned


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


@pytest.mark.parametrize("field,value", [
    ("objective", "cbow"), ("negative_mode", "shared"),
    ("table_dtype", "bfloat16"), ("vocab_sharded", True),
    ("async_checkpoint", True), ("pos_layout_shards", 2), ("timeline", False),
    ("bf16_stochastic_round", False), ("hs_dense_depth", 4), ("shared_pool", 64),
    ("shared_pool_auto", False), ("data_axis", "x"), ("model_axis", "y"),
    ("donate", False),
])
def test_config_rejects_unported_options(field, value):
    from gene2vec_tpu_torch.config import SGNSConfig

    with pytest.raises(NotImplementedError, match=field):
        SGNSConfig(**{field: value})


def test_bf16_index_raises_on_the_card(monkeypatch):
    """K8/K9 scan int8 tables; a bf16 index has only the plain scan, so on
    a CUDA tensor the call raises instead of falling back."""
    from gene2vec_tpu_torch.kernels import _args, ivf_scan, quant_scan

    monkeypatch.setattr(_args, "on_cpu", lambda *t: False)
    qn = torch.zeros(2, 4)
    table = torch.zeros(8, 4, dtype=torch.bfloat16)
    with pytest.raises(NotImplementedError, match="int8"):
        quant_scan.quant_scan(qn, table, torch.ones(8), 4)
    with pytest.raises(NotImplementedError, match="int8"):
        ivf_scan.ivf_scan(qn, torch.zeros(2, 4), torch.zeros(2, 4, dtype=torch.int32),
                          table, torch.ones(8), 1, 4)
