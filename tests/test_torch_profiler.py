"""Kernel cost attribution (``obs/profiler.py``) and the kernels' work
counts, on the CPU, held against the JAX package's profiler where both
have a meaning.

The same tiny planted corpus trains through the reference's trainers and
the port's with ``kernel_profile=True``: both ``kernels.jsonl`` files carry
the record schema, names and call counts; both ``metrics.prom`` files the
``kernel_*`` gauges (the port's without ``kernel_lower_seconds`` and, on
the CPU, ``kernel_peak_memory_bytes``: it has no lowering step, and only
the card's allocator reports a peak); both goodput blocks a per-kernel
breakdown that sums to the compute bucket.  ``flops`` and bytes are not
compared: XLA's cost analysis counts its fused program, the port counts
what each hand-written kernel's function needs, and the two differ by
design.

The work counts: each moved function at the bench shapes gives the bound
PERF.md records where the shape alone fixes it, and each count that
depends on ids is held to a hand count on a small input.
"""

import json
import math
import os

import numpy as np
import pytest
import torch

from gene2vec_tpu.config import SGNSConfig as JConfig
from gene2vec_tpu.eval import planted as jplanted
from gene2vec_tpu.obs import goodput as ref_goodput
from gene2vec_tpu.obs import profiler as ref_profiler
from gene2vec_tpu.sgns.cbow_hs import CBOWHSTrainer as JCBOWHSTrainer
from gene2vec_tpu.sgns.train import SGNSTrainer as JTrainer
from gene2vec_tpu_torch import kernels
from gene2vec_tpu_torch.config import GGIPNNConfig, SGNSConfig
from gene2vec_tpu_torch.eval import planted
from gene2vec_tpu_torch.kernels import (
    coexpr_mask,
    hs,
    ivf_scan,
    lane,
    noise_head,
    noise_tail,
    per_example,
    pos_logit,
    quant_scan,
    rescore,
    row_update,
    shared_pool,
    staged_copy,
    stream_scale,
    topk_exact,
    tsne_calibrate,
    tsne_step,
    umap_graph,
    umap_step,
)
from gene2vec_tpu_torch.kernels.row_update import Touched
from gene2vec_tpu_torch.obs import goodput, profiler
from gene2vec_tpu_torch.obs.registry import MetricsRegistry
from gene2vec_tpu_torch.sgns.cbow_hs import CBOWHSTrainer
from gene2vec_tpu_torch.sgns.train import SGNSTrainer

#: the bench shapes (chip_smoke.py phase 2)
V, D = 24447, 200
#: a tiny planted corpus and a config its 200 genes fit
PAIRS_PER = 200
SMALL = dict(dim=16, batch_pairs=128, strat_head=32, strat_block=64, strat_group=32,
             positive_head=8, positive_mid=24, num_iters=2, txt_output=False)
HS_SMALL = dict(dim=16, batch_pairs=128, strat_head=32, strat_block=64, strat_group=32,
                num_iters=2, hs_dense_depth=3, txt_output=False)


def _toy(a, b):
    return (a @ b).sum(dim=1)


def _toy_args():
    rng = np.random.RandomState(0)
    return (torch.from_numpy(rng.randn(16, 8).astype(np.float32)),
            torch.from_numpy(rng.randn(8, 8).astype(np.float32)))


TOY_WORK = {"bytes": 4 * (16 * 8 + 8 * 8 + 16), "flops": 2 * 16 * 8 * 8}


# -- the module's surface against the reference's -----------------------------


def test_record_schema_and_names_equal_the_references():
    assert profiler.RECORD_SCHEMA == ref_profiler.RECORD_SCHEMA
    assert profiler.KERNELS_LOG_NAME == ref_profiler.KERNELS_LOG_NAME
    assert (profiler.CPU_PEAK_FLOPS, profiler.CPU_PEAK_BYTES) == (
        ref_profiler.CPU_PEAK_FLOPS, ref_profiler.CPU_PEAK_BYTES)


def test_peak_table_cpu_and_unknown_fallbacks():
    cpu = profiler.peak_table("cpu", "cpu")
    assert cpu == ref_profiler.peak_table("cpu", "cpu")
    assert cpu["provenance"] == "cpu-conservative"
    unk = profiler.peak_table("rocm", "gizmo9000")
    assert unk == ref_profiler.peak_table("rocm", "gizmo9000")
    assert unk["provenance"] == "unknown-conservative"
    # no rate of a TPU is the card's: a TPU kind is unknown here
    assert profiler.peak_table("tpu", "TPU v4")["provenance"] == "unknown-conservative"
    # an unknown card degrades, never raises
    assert profiler.peak_table("gpu", "Some Card 9")["provenance"] == "unknown-conservative"


def test_peak_table_h100_is_the_data_sheet():
    p = profiler.peak_table("gpu", "NVIDIA H100 80GB HBM3")
    assert p["provenance"] == "gpu-device-facts"
    assert (p["peak_flops_per_sec"], p["peak_bytes_per_sec"]) == (67e12, 3.35e12)
    assert (p["peak_tf32_ops_per_sec"], p["peak_bf16_ops_per_sec"],
            p["peak_int8_ops_per_sec"]) == (495e12, 989e12, 1979e12)
    assert p["peak_sfu_ops_per_sec"] == pytest.approx(4.18e12, rel=1e-3)


def test_backend_facts_follow_the_callers_device(monkeypatch):
    assert profiler.backend_facts("cpu") == {"platform": "cpu", "device_kind": "cpu"}
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert profiler.backend_facts() == {"platform": None, "device_kind": None}
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "get_device_name", lambda dev=None: "NVIDIA H100 80GB HBM3")
    facts = profiler.backend_facts()
    assert facts == {"platform": "gpu", "device_kind": "NVIDIA H100 80GB HBM3"}
    assert profiler.KernelProfiler().peaks["provenance"] == "gpu-device-facts"


@pytest.mark.parametrize("flops,nbytes,wall", [(50.0, 10.0, 1.0), (10.0, 50.0, 1.0),
                                               (None, 10.0, 1.0), (10.0, 10.0, None),
                                               (10.0, None, 2.0), (3e12, 2e12, 0.5)])
def test_utilization_equals_the_references(flops, nbytes, wall):
    for peaks in ({"peak_flops_per_sec": 100.0, "peak_bytes_per_sec": 100.0},
                  profiler.peak_table("cpu", "cpu")):
        assert (profiler.utilization(flops, nbytes, wall, peaks)
                == ref_profiler.utilization(flops, nbytes, wall, peaks))


def test_utilization_roofline_bound_and_operation_types():
    peaks = {"peak_flops_per_sec": 100.0, "peak_bytes_per_sec": 100.0}
    u = profiler.utilization(50.0, 10.0, 1.0, peaks)
    assert u["utilization"] == pytest.approx(0.5) and u["bound"] == "compute"
    assert profiler.utilization(10.0, 50.0, 1.0, peaks)["bound"] == "memory"
    # tensor-core work is held to its own rate: the same sum bound() takes
    h100 = profiler.peak_table("gpu", "NVIDIA H100 80GB HBM3")
    work = {"bytes": 1e9, "flops": 1e10, "tf32_ops": 1e12}
    ops = {k: work.get(k, 0.0) for k in profiler.OP_KEYS}
    wall = 0.01
    u = profiler.utilization(sum(ops.values()), work["bytes"], wall, h100, ops)
    assert u["flops_util"] == pytest.approx((1e10 / 67e12 + 1e12 / 495e12) / wall)
    assert u["utilization"] * wall * 1e3 == pytest.approx(profiler.bound(work)[0])


def test_bound_takes_the_special_function_unit_beside_the_rest():
    assert profiler.bound({"bytes": 3.35e9}) == (pytest.approx(1.0), "bytes")
    assert profiler.bound({"bytes": 0, "flops": 67e9}) == (pytest.approx(1.0), "operations")
    sfu = profiler.SFU_OP_PER_S
    # the SFU issues beside the FMA pipes: the larger, not the sum
    ms, by = profiler.bound({"bytes": 0, "sfu_ops": sfu * 2e-3, "flops": 67e9})
    assert (ms, by) == (pytest.approx(2.0), "operations")
    ms, _ = profiler.bound({"bytes": 0, "sfu_ops": sfu * 1e-3, "flops": 2 * 67e9})
    assert ms == pytest.approx(2.0)
    # ties go to the bytes, as the kernels line has them
    assert profiler.bound({"bytes": 3.35e9, "flops": 67e9})[1] == "bytes"


# -- records, kernels.jsonl and gauges ------------------------------------------


def test_attribute_records_work_and_the_build_it_triggered(monkeypatch):
    from gene2vec_tpu_torch.kernels import build

    clock = iter([10.0, 12.5])
    monkeypatch.setattr(build, "build_seconds", lambda: next(clock))
    p = profiler.KernelProfiler(device="cpu")
    rec = p.attribute("toy", _toy, _toy_args(), work=TOY_WORK)
    assert rec["flops"] == TOY_WORK["flops"] and rec["bytes_accessed"] == TOY_WORK["bytes"]
    assert rec["compile_s"] == pytest.approx(2.5) and rec["lower_s"] is None
    assert rec.get("peak_memory_bytes") is None  # the CPU has no allocator peak
    (merged,) = p.records()
    assert merged["calls"] == 0 and merged["best_wall_s"] is None
    assert merged["utilization"] is None
    best = p.measure("toy", _toy, _toy_args())
    assert best is not None and best > 0
    (merged,) = p.records()
    assert set(merged) == set(profiler.RECORD_SCHEMA)
    assert merged["calls"] == 3 and merged["best_wall_s"] == pytest.approx(best)
    assert merged["utilization"] > 0 and merged["bound"] in ("compute", "memory")


def test_attribute_never_raises():
    p = profiler.KernelProfiler(device="cpu")
    rec = p.attribute("broken", lambda x: x.nonsense(), (object(),))
    assert rec.get("flops") is None and "compile_s" not in rec
    (merged,) = p.records()
    assert merged["name"] == "broken" and merged["flops"] is None
    assert p.measure("broken", lambda: 1 / 0) is None


def test_kernels_jsonl_round_trip_and_gauges(tmp_path):
    reg = MetricsRegistry()
    p = profiler.KernelProfiler(run_dir=str(tmp_path), registry=reg, device="cpu")
    p.attribute("toy", _toy, _toy_args(), work=TOY_WORK)
    p.measure("toy", _toy, _toy_args())
    written = p.flush()
    assert (tmp_path / profiler.KERNELS_LOG_NAME).exists()
    back = profiler.read_kernels(str(tmp_path))
    assert [r["name"] for r in back] == ["toy"]
    assert back == ref_profiler.read_kernels(str(tmp_path))
    assert back[0]["flops"] == written[0]["flops"]
    assert back[0]["backend"]["provenance"] == "cpu-conservative"
    text = reg.prometheus_text()
    for metric in ("kernel_flops", "kernel_utilization", "kernel_compile_seconds",
                   "kernel_best_wall_seconds", "kernel_wall_seconds"):
        assert f'{metric}{{kernel="toy"}}' in text
    # the renderers are the reference's over the same records
    assert profiler.format_kernels(back) == ref_profiler.format_kernels(back)
    assert "toy" in profiler.format_kernels(back)
    assert profiler.kernel_summary(back) == ref_profiler.kernel_summary(back)
    assert profiler.kernel_summary(back)["top"][0]["wall_share"] == pytest.approx(1.0)


def test_read_kernels_nested_and_malformed(tmp_path):
    sub = tmp_path / "run"
    sub.mkdir()
    (sub / profiler.KERNELS_LOG_NAME).write_text(
        json.dumps({"name": "a", "flops": 1.0}) + "\n" + "{not json\n"
        + json.dumps({"name": "b"}) + "\n" + json.dumps([1, 2]) + "\n")
    recs = profiler.read_kernels(str(tmp_path))
    assert [r["name"] for r in recs] == ["a", "b"]
    assert recs == ref_profiler.read_kernels(str(tmp_path))
    assert profiler.read_kernels(str(tmp_path / "nothing-here")) == []


def test_goodput_kernel_breakdown_sums_to_compute_bucket():
    records = [{"name": "compute", "dur": 8.0}]
    for ks in ({"sgns_train_step": 6.0}, {"a": 6.0, "b": 10.0}):
        s = goodput.summarize(records, wall_s=10.0, pairs_total=100.0, kernel_seconds=ks)
        assert s == ref_goodput.summarize(records, wall_s=10.0, pairs_total=100.0,
                                          kernel_seconds=ks)
        assert sum(s["compute_kernels_s"].values()) == pytest.approx(s["buckets_s"]["compute"])


def test_trace_context_writes_a_chrome_trace(tmp_path):
    from gene2vec_tpu_torch.utils.profiling import trace_context

    with trace_context(None):
        pass
    with trace_context(str(tmp_path / "tr")):
        torch.ones(4).add_(1)
    (name,) = os.listdir(tmp_path / "tr")
    with open(tmp_path / "tr" / name) as f:
        assert "traceEvents" in json.load(f)


# -- the trainers against the reference's ---------------------------------------


def _prom_names(path, prefix):
    with open(path) as f:
        return {line.split("{")[0].split(" ")[0] for line in f
                if line.startswith(prefix)}


def _profiled_runs(tmp_path, port_cls, ref_cls, kw):
    vocab, corpus = planted.planted_corpus(pairs_per=PAIRS_PER)
    jvocab, jcorpus = jplanted.planted_corpus(pairs_per=PAIRS_PER)
    ours, theirs = str(tmp_path / "port"), str(tmp_path / "ref")
    port_cls(corpus, SGNSConfig(kernel_profile=True, **kw), device="cpu").run(
        ours, log=lambda m: None)
    ref_cls(jcorpus, JConfig(kernel_profile=True, **kw)).run(theirs, log=lambda m: None)
    return ours, theirs


def _check_against_the_reference(ours, theirs, name):
    recs = [profiler.read_kernels(d) for d in (ours, theirs)]
    assert [[r["name"] for r in rs] for rs in recs] == [[name], [name]]
    assert [sorted(rs[0]) for rs in recs] == [sorted(profiler.RECORD_SCHEMA)] * 2
    assert recs[0][0]["calls"] == recs[1][0]["calls"] == 2
    rec = recs[0][0]
    assert rec["flops"] > 0 and rec["bytes_accessed"] > 0 and rec["compile_s"] == 0.0
    assert rec["lower_s"] is None and rec["peak_memory_bytes"] is None
    assert rec["backend"]["provenance"] == "cpu-conservative" and rec["utilization"] > 0
    gauges = [_prom_names(os.path.join(d, "metrics.prom"), "kernel_") for d in (ours, theirs)]
    assert gauges[0] == gauges[1] - {"kernel_lower_seconds", "kernel_peak_memory_bytes"}
    assert "kernel_utilization" in gauges[0]
    for d in (ours, theirs):
        with open(os.path.join(d, "manifest.json")) as f:
            g = json.load(f)["goodput"]
        assert name in g["compute_kernels_s"]
        assert math.isclose(sum(g["compute_kernels_s"].values()), g["buckets_s"]["compute"],
                            abs_tol=1e-5)
    events = [json.loads(line) for line in open(os.path.join(ours, "events.jsonl"))]
    spans = [e for e in events if e["type"] == "span_end"]
    assert [e["attrs"].get("kernel") for e in spans if e["name"] == "kernel_attribution"] == [name]
    iters = sum(e["dur"] for e in spans if e["name"] == "iteration")
    assert abs(rec["wall_s"] - iters) <= 0.05 + 0.02 * iters


def test_sgns_run_profiles_as_the_reference_does(tmp_path):
    ours, theirs = _profiled_runs(tmp_path, SGNSTrainer, JTrainer, SMALL)
    _check_against_the_reference(ours, theirs, "sgns_train_step")


@pytest.mark.parametrize("objective", ["cbow_hs", "sg_hs", "cbow"])
def test_cbow_hs_run_profiles_as_the_reference_does(tmp_path, objective):
    ours, theirs = _profiled_runs(tmp_path, CBOWHSTrainer, JCBOWHSTrainer,
                                  dict(HS_SMALL, objective=objective))
    _check_against_the_reference(ours, theirs, "cbow_hs_step")


def test_profile_off_writes_no_kernel_records(tmp_path):
    _, corpus = planted.planted_corpus(pairs_per=PAIRS_PER)
    SGNSTrainer(corpus, SGNSConfig(**SMALL), device="cpu").run(str(tmp_path),
                                                               log=lambda m: None)
    assert not os.path.exists(tmp_path / profiler.KERNELS_LOG_NAME)
    with open(tmp_path / "manifest.json") as f:
        assert "compute_kernels_s" not in json.load(f)["goodput"]
    assert not _prom_names(tmp_path / "metrics.prom", "kernel_")


@pytest.mark.parametrize("kw", [
    SMALL, dict(SMALL, negative_mode="per_example"), dict(SMALL, negative_mode="shared"),
    dict(SMALL, table_dtype="bfloat16"), dict(HS_SMALL, objective="sg_hs"),
    dict(HS_SMALL, objective="cbow"), dict(HS_SMALL, objective="cbow_hs", hs_dense_depth=0),
], ids=["stratified", "per_example", "shared", "bf16", "sg_hs", "cbow", "cbow_hs_depth0"])
def test_profile_kernel_leaves_the_trainer_untouched(kw):
    """The attributed epoch runs on copies under iteration 0's draws: the
    caller's tables, the trainer's generator and the next epoch's result
    are those of a trainer never profiled; its count is the epoch's
    steps' counts summed."""
    _, corpus = planted.planted_corpus(pairs_per=PAIRS_PER)
    cls = CBOWHSTrainer if kw.get("objective", "sgns") != "sgns" else SGNSTrainer
    runs = []
    for profiled in (False, True):
        tr = cls(corpus, SGNSConfig(**kw), device="cpu")
        params = tr.init()
        before = (params.emb.clone(), params.ctx.clone())
        if profiled:
            p = profiler.KernelProfiler(device="cpu")
            rec = tr.profile_kernel(p, params=params)
            assert rec["flops"] > 0 and rec["bytes_accessed"] > 0
            assert torch.equal(params.emb, before[0]) and torch.equal(params.ctx, before[1])
        params, loss = tr.train_epoch(params)
        runs.append((params.emb.clone(), float(loss)))
    assert torch.equal(runs[0][0], runs[1][0]) and runs[0][1] == runs[1][1]


# -- serving ------------------------------------------------------------------------


def _export(tmp_path, v=300, d=16):
    from gene2vec_tpu_torch.io.checkpoint import save_iteration
    from gene2vec_tpu_torch.io.vocab import Vocab
    from gene2vec_tpu_torch.sgns.model import SGNSParams

    rng = np.random.RandomState(0)
    emb = rng.randn(v, d).astype(np.float32)
    save_iteration(str(tmp_path / "export"), d, 1,
                   SGNSParams(torch.from_numpy(emb), torch.from_numpy(emb * 0.5)),
                   Vocab([f"G{i}" for i in range(v)], np.full(v, 5)), txt_output=False)
    return str(tmp_path / "export")


@pytest.mark.parametrize("mode", ["exact", "quant", "ivf"])
def test_profile_buckets_publish_per_bucket_gauges(tmp_path, mode):
    from gene2vec_tpu_torch.serve.registry import ModelRegistry
    from gene2vec_tpu_torch.serve.server import ServeApp, ServeConfig

    reg = ModelRegistry(_export(tmp_path), index_mode=mode, device="cpu")
    assert reg.refresh()
    app = ServeApp(reg, ServeConfig(max_batch=8, index=mode, kernel_profile=True)).start()
    try:
        shapes = app.engine.cache_sizes()
        launches = kernels.launch_counts()
        costs = app.profile_kernels(k=4)
        assert set(costs) == {f"serve_topk_{mode}/b{b}" for b in app.engine.buckets}
        for name, rec in costs.items():
            assert rec["flops"] > 0 and rec["bytes_accessed"] > 0
            assert rec["mode"] == mode and rec["k_bucket"] == 4
            assert name.endswith(f"/b{rec['bucket']}")
            assert rec["compile_s"] is None and rec["lower_s"] is None
        # larger buckets do more work
        flops = [costs[f"serve_topk_{mode}/b{b}"]["flops"] for b in app.engine.buckets]
        assert flops == sorted(flops) and flops[0] < flops[-1]
        text = app.metrics.prometheus_text()
        for b in app.engine.buckets:
            assert f'kernel_flops{{kernel="serve_topk_{mode}/b{b}"}}' in text
            assert f'kernel_bytes_accessed{{kernel="serve_topk_{mode}/b{b}"}}' in text
        assert "kernel_wall_seconds" not in text
        # counting from shapes launches nothing and adds no served shape
        assert app.engine.cache_sizes() == shapes and kernels.launch_counts() == launches
        status, _ = app.handle("POST", "/v1/similar", {"genes": ["G1", "G2"], "k": 4})
        assert status == 200
    finally:
        app.stop()


def test_profile_buckets_needs_an_index_for_ann_modes():
    from gene2vec_tpu_torch.serve.engine import BucketedTopKEngine

    eng = BucketedTopKEngine(max_batch=2, index="ivf")
    with pytest.raises(ValueError, match="AnnIndex"):
        eng.profile_buckets(torch.eye(4), k=2)


def test_profile_kernels_is_empty_without_a_model_or_its_index(tmp_path):
    from gene2vec_tpu_torch.serve.registry import ModelRegistry
    from gene2vec_tpu_torch.serve.server import ServeApp, ServeConfig

    empty = ModelRegistry(str(tmp_path / "none"), device="cpu")
    assert ServeApp(empty, ServeConfig()).profile_kernels() == {}
    exact_only = ModelRegistry(_export(tmp_path), index_mode="exact", device="cpu")
    assert exact_only.refresh()
    assert ServeApp(exact_only, ServeConfig(index="ivf")).profile_kernels() == {}


def test_serve_cli_takes_kernel_profile():
    from gene2vec_tpu_torch.cli.serve import build_parser

    args = build_parser().parse_args(["--export-dir", "x", "--kernel-profile"])
    assert args.kernel_profile
    assert not build_parser().parse_args(["--export-dir", "x"]).kernel_profile


# -- GGIPNN ---------------------------------------------------------------------------


@pytest.mark.parametrize("embed_train", [False, True], ids=["frozen", "trained"])
def test_ggipnn_profile_kernel_leaves_the_trainer_untouched(embed_train):
    from chip_smoke import ggipnn_vocab
    from gene2vec_tpu_torch.models.ggipnn_train import GGIPNNTrainer, step_work

    cfg = GGIPNNConfig(embedding_dim=8, hidden_dims=(16, 4), batch_size=16,
                       embed_train=embed_train)
    tr = GGIPNNTrainer(cfg, ggipnn_vocab(40), device="cpu")
    tr.init_state()
    rng = np.random.RandomState(0)
    x = rng.randint(0, 40, (16, 2)).astype(np.int32)
    y = np.eye(2, dtype=np.float32)[rng.randint(0, 2, 16)]
    tr.train_step(*tr._tensors(x, y))  # Adam state to copy
    before = {k: v.clone() for k, v in tr.model.state_dict().items()}
    moments = [s["exp_avg"].clone() for s in tr.optimizer.state.values()]
    p = profiler.KernelProfiler(device="cpu")
    rec = tr.profile_kernel(p, None, None, x, y)
    assert rec["flops"] == step_work(tr.model, torch.from_numpy(x), embed_train)["flops"]
    for k, v in tr.model.state_dict().items():
        assert torch.equal(v, before[k]), k
    assert all(torch.equal(m, s["exp_avg"]) for m, s in zip(moments, tr.optimizer.state.values()))
    p.observe("ggipnn_step", 0.5, calls=4)
    (r,) = p.records()
    assert r["name"] == "ggipnn_step" and r["best_wall_s"] == pytest.approx(0.125)


def test_ggipnn_step_work_counts_the_gemms_and_adam():
    from gene2vec_tpu_torch.models.ggipnn import GGIPNN
    from gene2vec_tpu_torch.models.ggipnn_train import ADAM_OPS, step_work

    m = GGIPNN(10, 4, (6, 3), 2)
    ids = torch.tensor([[1, 2], [1, 3]], dtype=torch.int32)  # 3 distinct rows
    b = 2
    layers = [(8, 6), (6, 3), (3, 2)]
    params = sum(i * o + o for i, o in layers)
    gemm_flops = sum(2 * b * i * o for i, o in layers)
    gemm_bytes = sum(4 * (b * i + i * o + b * o) for i, o in layers)
    gather = 4 * 4 + (3 + 4) * 16
    frozen = step_work(m, ids, False)
    first = 2 * b * 8 * 6
    assert frozen["flops"] == 3 * gemm_flops - first + ADAM_OPS * params
    assert frozen["bytes"] == (gather + 3 * gemm_bytes - 4 * (b * 8 + 8 * 6 + b * 6)
                               + 28 * params)
    trained = step_work(m, ids, True)
    assert trained["flops"] == 3 * gemm_flops + 2 * b * 4 + ADAM_OPS * (params + 40)
    assert trained["bytes"] == gather + 3 * gemm_bytes + 4 * (40 + 4 * b * 4) + 28 * (params + 40)


# -- the work counts ---------------------------------------------------------------


def test_bounds_at_the_bench_shapes_are_the_recorded_ones():
    """PERF.md's bound column, where the shape alone fixes it: K10 at N
    24,447, K11 at n 160 / 24, K12 at 25 / 100 / 400 MB, K10c at 28.86 mean
    bisection steps (rounded to two places, so within its rounding) and at
    the reference's 51 passes."""
    def ms(work):
        return round(profiler.bound(work)[0], 4)

    assert ms(tsne_step.work(V)) == 0.7140
    assert profiler.bound(tsne_step.work(V))[1] == "bytes"
    assert [ms(coexpr_mask.work(n, V)) for n in (160, 24)] == [1.4273, 0.2141]
    assert [ms(stream_scale.work(mb * 2 ** 20 // 4, 4)) for mb in (25, 100, 400)] == [
        0.0157, 0.0626, 0.2504]
    assert profiler.bound(tsne_calibrate.work(V, V, 28.86 * V + V))[0] == pytest.approx(
        4.2674, abs=0.005 * V * V / profiler.SFU_OP_PER_S * 1e3 + 5e-5)
    assert ms(tsne_calibrate.work(V, V, 51 * V)) == 7.2889


def test_k1_to_k3_hand_counts():
    c, x = np.array([3, 3, 9, 4]), np.array([1, 1, 2, 1])
    w = pos_logit.work(c, x, 5, 4)
    assert w == {"bytes": 4 * (8 + 40 + 8) + 4 * (3 + 2) * 5, "flops": 40}
    w2 = noise_head.work(4, 6, 5, 2)
    assert w2["tf32_ops"] == 7 * 2 * 4 * 6 * 5 and w2["simt_flops"] == 3 * 2 * 4 * 6 * 5
    assert w2["bytes"] == 4 * (40 + 12 + 6 + 2 * 6 * 6 + 20) + 2 * 6 * 5
    # blocks of 4 rows after a head of 2 in 20 rows: starts 2, 6, 2 (repeat), 16 (clamped)
    w3 = noise_tail.work(torch.tensor([0, 1, 0, 9], dtype=torch.int32), 8, 2, 4, 20, 5)
    assert w3["block_rows"] == 12
    assert w3["bytes"] == 4 * (40 + 8 + 4 + 12 + 80 + 2 * 12 * 6 + 8) + 4 * 12 * 5
    assert w3["tf32_ops"] == 9 * 2 * 8 * 4 * 5


def test_k4_hand_counts():
    centers = torch.tensor([0, 0, 5], dtype=torch.int32)
    contexts = torch.tensor([7, 2, 2], dtype=torch.int32)
    sets = (Touched(), Touched(prefix=2, blocks=torch.tensor([1], dtype=torch.int32),
                               block=3, limit=10))
    w = row_update.work(centers, contexts, 4, 10, 4, sets)
    # emb {0, 5}; ctx {0, 1} ∪ {5, 6, 7} ∪ {7, 2}
    assert (w["emb_rows"], w["ctx_rows"]) == (2, 6)
    assert w["bytes"] == 4 * (6 + 24 + 3 + 8 * 5) + 2 * 4 * 8 * 4
    assert w["flops"] == 2 * 3 * 5 + 3 * 4 * 8
    assert row_update.work(centers, contexts, 4, 10, 2, sets, True)["flops"] == (
        w["flops"] + row_update.SR_HASH_OPS * 4 * 8)
    every = row_update.work(centers, contexts, 4, 10)
    assert (every["emb_rows"], every["ctx_rows"]) == (10, 10)
    assert row_update.scatter_work(centers, 4) == {"bytes": 4 * (3 + 12 + 3 + 2 * 2 * 5),
                                                   "flops": 15}
    negs = torch.tensor([[1, 2], [2, 2], [9, 1]], dtype=torch.int32)
    f = row_update.finalize_work(Touched(ids=(contexts, negs)), 10, 4, 2, salts=False)
    assert f["rows"] == 4 and f["bytes"] == 4 * (4 * 5 + 2 * 2 * 4) + 4 * (3 + 6)
    paths = (torch.tensor([[0, 1], [2, 0]], dtype=torch.int32), torch.tensor([2, 1]),
             torch.tensor([0, 0, 1], dtype=torch.int32))
    f = row_update.finalize_work(Touched(prefix=1, paths=paths), 6, 4)
    assert f["rows"] == 3  # {0} ∪ {0, 1} ∪ {2}
    assert f["bytes"] == 3 * (4 * 5 + 8 * 4) + 4 * (3 + 2 * 3)
    assert row_update.finalize_work(None, 6, 4)["rows"] == 6


def test_k5_hand_counts():
    contexts = np.array([1, 2, 3])
    negs = np.array([[4, 4], [5, 1], [6, 7]])
    w = per_example.work(contexts, negs, 5, 4)
    assert (w["draw_rows"], w["acc_rows"]) == (5, 7)
    assert w["bytes"] == 4 * (30 + 6 + 6 + 2 * 7 * 6 + 15 + 3) + 4 * 5 * 5
    assert w["flops"] == 5 * 3 * 2 * 5 + 2 * 3 * 5
    pool = np.array([1, 1, 2, 3, 3, 3, 4, 5])
    s = shared_pool.work(4, pool, 2, 5, 2)
    assert s["pool_rows"] == 5 and s["tf32_ops"] == 7 * 2 * 4 * 4 * 5
    assert s["bytes"] == 4 * (40 + 8 + 8 + 2 * 5 * 6 + 20 + 4) + 2 * 5 * 5


def test_k6_hand_count():
    from gene2vec_tpu_torch.sgns.huffman import ShallowPaths

    points = np.array([[5, 6, 0], [6, 0, 0], [7, 5, 6]], dtype=np.int32)
    lengths = np.array([2, 1, 3], dtype=np.int32)
    shallow = ShallowPaths(np.array([[0, 1], [0, 2], [1, 0]], dtype=np.int32),
                           np.array([[1, -1], [-1, 0], [1, 0]], dtype=np.int8), 3)
    inputs, targets = np.array([4, 4, 8]), np.array([0, 1, 0])
    w = hs.work(inputs, targets, points, lengths, shallow, 5, 4)
    assert (w["deep_entries"], w["shallow_entries"]) == (2 + 1 + 2, 2 + 1 + 2)
    assert (w["deep_nodes"], w["shallow_nodes"]) == (2, 2)  # {5, 6}; {0, 1}
    n_tg, n_nodes = 2, 4
    assert w["bytes"] == (4 * (6 + n_tg * 7 + 15 + 6 + 2 * n_nodes * 6) + n_tg * 3
                          + 4 * (2 + n_nodes) * 5)
    assert w["flops"] == 6 * 5 * 5 + 5 * 5 * 5
    assert hs.work(inputs, targets, points, lengths, None, 5)["shallow_entries"] == 0


def test_serving_and_probe_hand_counts():
    assert topk_exact.work(10, 4, 2, 3) == {"bytes": 4 * (40 + 8) + 48, "flops": 160.0}
    assert quant_scan.work(10, 4, 2, 3)["int8_ops"] == 160.0
    assert quant_scan.work(10, 4, 2, 3, "bfloat16")["bytes"] == 80 + 32 + 48
    lists = torch.tensor([[0, 1, -1], [2, 3, 4], [5, -1, -1]], dtype=torch.int32)
    centroids = torch.eye(3, 4)
    qn = torch.tensor([[0.0, 1.0, 0, 0], [1.0, 0, 0, 0]])
    cand = ivf_scan.probed(qn, centroids, lists, 1)
    assert sorted(cand.tolist()) == [0, 1, 2, 3, 4]
    w = ivf_scan.work(2, 4, 3, 1, 3, 2, 5, 5)
    assert w["bytes"] == 4 * 12 + 4 * 8 + 4 * 2 * 3 + 5 * 8 + 8 * 2 * 2
    assert (w["flops"], w["int8_ops"]) == (48.0, 40.0)
    approx = torch.tensor([[1.0, float("-inf")], [0.5, 0.2]])
    ri = torch.tensor([[3, 0], [3, 4]], dtype=torch.int32)
    assert rescore.candidates(approx, ri) == (3, 2)
    assert rescore.gather_work(np.array([1, 1, 2]), 16) == {"bytes": 12 + 5 * 16, "flops": 0.0}
    assert lane.gather_work(2, 3, 4)["bytes"] == 48 + 12
    assert lane.scatter_work(2, 3, 2) == {"bytes": 36 + 12, "flops": 12.0}
    assert staged_copy.work(2, 3) == {"bytes": 48, "flops": 6.0}


def test_umap_counts_follow_the_graphs_entries():
    n, k = 100, 15
    base = umap_graph.work(n, k, 0)
    assert umap_graph.work(n, k, 700)["bytes"] - base["bytes"] == 700 * 8
    assert base["sfu_ops"] == n * (k + 1) * 65
    s = umap_step.work(n, 700)
    assert s["flops"] == 23.0 * n * (n - 1) / 2 + 8.0 * 700
    assert s["sfu_ops"] == 4 * n * (n - 1) / 2 and umap_step.work(n, 0, False)["sfu_ops"] == (
        3 * n * (n - 1) / 2)
    assert umap_graph.dense_work(n)["bytes"] == 2.0 * n * n * 4


def test_epoch_work_sums_each_steps_kernels():
    """An epoch's count is its steps' counts at their own ids: the
    stratified step's K1-K4 from the batch and its drawn blocks."""
    from gene2vec_tpu_torch.sgns.step import sgns_step_work
    from gene2vec_tpu_torch.sgns.train import epoch_generator

    _, corpus = planted.planted_corpus(pairs_per=PAIRS_PER)
    kw = dict(SMALL, positive_head=0, positive_mid=0, shuffle_each_iter=False)
    tr = SGNSTrainer(corpus, SGNSConfig(**kw), device="cpu")
    draws = tr.draw_epoch(epoch_generator(1, 0))
    got = tr.epoch_work(draws)
    spec, bp = tr.noise.stratified, kw["batch_pairs"]
    want = {}
    for step in range(tr.num_batches):
        batch = tr.pairs[step * bp:(step + 1) * bp]
        e = 2 * bp
        centers = torch.cat([batch[:, 0], batch[:, 1]])
        contexts = torch.cat([batch[:, 1], batch[:, 0]])
        blocks = torch.from_numpy(draws.blocks[step])
        parts = [pos_logit.work(centers, contexts, 16),
                 noise_head.work(e, spec.head, 16),
                 noise_tail.work(blocks, e, spec.head, spec.block, spec.tail_w.shape[0], 16),
                 row_update.work(centers, contexts, 16, corpus.vocab_size, 4, (
                     Touched(), Touched(prefix=spec.head, blocks=blocks, block=spec.block,
                                        limit=spec.tail_w.shape[0])))]
        step_total = {}
        for p in parts:
            profiler.add_work(step_total, p)
        assert step_total == sgns_step_work(batch, 16, corpus.vocab_size, stratified=spec,
                                            blocks=blocks)
        profiler.add_work(want, step_total)
    assert got == want


# -- K6's accumulator check ------------------------------------------------------------


def test_k6_reference_sum_lies_within_the_row_bar_of_the_plain_accumulator():
    """The float64 sum of the plain version's float32 terms (the sum the
    card's K6 check holds the kernel's accumulator to) against the plain
    version's own float32 accumulator, at phase 2c's depth and the default
    Zipf counts, scaled down (V 2,001, D 40, E 2,048): every row within
    the 2e-5 row bar, the weight column exact."""
    from chip_smoke import REL_TOL, row_bar_share, zipf_ids
    from gene2vec_tpu_torch.sgns.cbow_hs import shallow_on
    from gene2vec_tpu_torch.sgns.huffman import build_huffman_tree, split_shallow

    v, d, e = 2001, 40, 2048
    rng = np.random.RandomState(0)
    counts = np.sort(np.bincount(zipf_ids(rng, 200_000, v), minlength=v) + 1)[::-1].copy()
    split = split_shallow(build_huffman_tree(counts), 10)
    gen = torch.Generator().manual_seed(0)
    emb = torch.randn((v, d), generator=gen) * 0.1
    node = torch.randn((v - 1, d), generator=gen) * 0.1
    args = (emb, node, torch.from_numpy(zipf_ids(rng, e, v)),
            torch.from_numpy(zipf_ids(rng, e, v)),
            *(torch.from_numpy(a) for a in (split.points_deep, split.codes_deep,
                                           split.lengths_deep)),
            shallow_on(split, "cpu"))
    acc = torch.zeros((v - 1, d + 1))
    hs.hs_plain(*args, acc)
    ref = hs.acc_reference(torch.zeros_like(acc), hs.path_terms(*args))
    assert ref.dtype == torch.float64
    share = row_bar_share(torch, acc[:, :d].double(), ref[:, :d])
    assert share < 1.0, share
    assert torch.equal(acc[:, d].double(), ref[:, d])
    assert REL_TOL == 2e-5
    # the reference adds to what the accumulator held
    base = torch.ones_like(acc)
    assert torch.equal(hs.acc_reference(base, hs.path_terms(*args)), ref + 1.0)
