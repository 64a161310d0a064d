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


def test_importing_every_module_loads_no_jax():
    mods = _port_modules()
    assert "gene2vec_tpu_torch.sgns.step" in mods and len(mods) > 15
    code = (
        "import importlib, json, sys\n"
        f"for m in {mods!r}: importlib.import_module(m)\n"
        "import chip_smoke\n"
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
