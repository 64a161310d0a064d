"""The port's run records (``obs/goodput.py``, ``obs/registry.py``,
``obs/run.py`` and both trainers' ``run``, GGIPNN's
``run_classification(run_dir=)``) held against the JAX package on the CPU.

Everything here is host bookkeeping, so the bar is equality: the goodput
summary of the same timeline records, the Prometheus text and CSV of the
same registry operations, the manifest and event keys of the same ``Run``
calls, and the reference's own config hash and report over the port's run
directories (only clock readings differ, and the tests leave them out).
"""

import csv
import json
import math
import os

import numpy as np
import pytest

from gene2vec_tpu.config import GGIPNNConfig as RefGGIPNNConfig
from gene2vec_tpu.config import SGNSConfig as JConfig
from gene2vec_tpu.data.pipeline import PairCorpus as JCorpus
from gene2vec_tpu.io import checkpoint as jckpt
from gene2vec_tpu.io.vocab import Vocab as JVocab
from gene2vec_tpu.obs import aggregate as ref_aggregate
from gene2vec_tpu.obs import goodput as ref_goodput
from gene2vec_tpu.obs import registry as ref_registry
from gene2vec_tpu.obs import report as ref_report
from gene2vec_tpu.obs import run as ref_run
from gene2vec_tpu.obs.trace import read_events
from gene2vec_tpu.sgns.cbow_hs import CBOWHSTrainer as JCBOWHSTrainer
from gene2vec_tpu.sgns.train import SGNSTrainer as JTrainer
from gene2vec_tpu_torch.config import GGIPNNConfig, SGNSConfig
from gene2vec_tpu_torch.data.pipeline import PairCorpus
from gene2vec_tpu_torch.io.vocab import Vocab
from gene2vec_tpu_torch.models.ggipnn_train import run_classification
from gene2vec_tpu_torch.obs import goodput, registry, run
from gene2vec_tpu_torch.sgns.cbow_hs import CBOWHSTrainer
from gene2vec_tpu_torch.sgns.train import SGNSTrainer
from test_torch_train import SMALL, _zipf_corpus

RECORDS = [
    [],
    [{"name": "host_ingest", "dur": 0.5}, {"name": "dispatch", "dur": 2.0},
     {"name": "compute", "dur": 1.25}, {"name": "ckpt_stage", "dur": 0.75},
     {"name": "eval", "dur": 3.0}],
    # overlapping phases past the wall clock: scaled down to fit it
    [{"name": "dispatch", "dur": 9.0}, {"name": "h2d_stage", "dur": 4.0},
     {"name": "checkpoint", "dur": 1.0}, {"name": "collective_wait", "dur": -1.0},
     {"name": "compute_wait"}],
]


@pytest.mark.parametrize("records", RECORDS, ids=["none", "phases", "overlap"])
@pytest.mark.parametrize("wall,preempted", [(10.0, 0.0), (6.0, 1.5), (0.0, 0.0)])
def test_goodput_classify_and_summarize_equal(records, wall, preempted):
    assert goodput.BUCKETS == ref_goodput.BUCKETS
    assert goodput.PHASE_BUCKET == ref_goodput.PHASE_BUCKET
    got = goodput.classify(records, wall, preempted)
    assert got == ref_goodput.classify(records, wall, preempted)
    assert math.isclose(sum(got.values()), wall, abs_tol=1e-12)
    for kw in ({}, {"pairs_total": 4096.0, "peak_pairs_per_sec": 2048.0},
               {"pairs_total": 100.0, "kernel_seconds": {"k1": 1.0, "k2": 0.0, "k3": 2.5}},
               {"pairs_total": 100.0, "kernel_seconds": {"k1": 40.0}}):
        assert (goodput.summarize(records, wall, preempted_s=preempted, **kw)
                == ref_goodput.summarize(records, wall, preempted_s=preempted, **kw))


def _runs(tmp_path, **kw):
    cfg = {"dim": 8, "lr": 0.5, "name": "x"}
    return (run.Run(str(tmp_path / "port"), name="t", config=cfg, probe_devices=False, **kw),
            ref_run.Run(str(tmp_path / "ref"), name="t", config=cfg, probe_devices=False, **kw))


def test_goodput_stamp_writes_the_references_manifest_and_gauges(tmp_path):
    summary = ref_goodput.summarize(RECORDS[1], 10.0, pairs_total=4096.0,
                                    kernel_seconds={"k1": 1.0})
    ours, theirs = _runs(tmp_path)
    goodput.stamp(ours, summary)
    ref_goodput.stamp(theirs, summary)
    assert ours.registry.prometheus_text() == theirs.registry.prometheus_text()
    ours.close()
    theirs.close()
    for r in (ours, theirs):
        with open(os.path.join(r.run_dir, "manifest.json")) as f:
            assert json.load(f)["goodput"] == summary


def _registry_ops(mod, tmp_path, tag):
    """One sequence of registry operations; returns (registry, csv path,
    the histogram)."""
    reg = mod.MetricsRegistry()
    reg.max_label_sets = 3
    reg.counter("pairs_total").inc(5)
    reg.counter("requests", labels={"route": '/v1/"sim"\n\\x'}).inc()
    for i in range(5):  # past the cap: collapsed and counted
        reg.gauge("lag", labels={"target": f"t{i}"}).set(i)
    g = reg.gauge("level")
    g.set(2.5)
    g.inc(0.25)
    g.inc()
    h = reg.histogram("step_seconds")
    for v in (0.001, 0.5, 3.0, 7000.0):
        h.observe(v)
    assert reg.remove("lag", labels={"target": "t1"})
    assert not reg.remove("lag", labels={"target": "nope"})
    path = os.path.join(str(tmp_path), f"{tag}.csv")
    reg.attach_csv(path)
    reg.log_row(1, {"loss": 0.5, "pairs_per_sec": 1000.0, "flag": True})
    reg.log_row(2, {"loss": 0.25, "pairs_per_sec": 1500.0, "stalls": 1})
    snap = os.path.join(str(tmp_path), f"{tag}.prom")
    assert reg.maybe_snapshot(snap, 15.0, now=100.0)
    assert not reg.maybe_snapshot(snap, 15.0, now=110.0)
    assert reg.maybe_snapshot(snap, 15.0, now=116.0)
    reg.close()
    return reg, path, h


def test_registry_operations_give_the_references_text_and_csv(tmp_path):
    ours, our_csv, h = _registry_ops(registry, tmp_path, "port")
    theirs, their_csv, rh = _registry_ops(ref_registry, tmp_path, "ref")
    assert ours.prometheus_text() == theirs.prometheus_text()
    with open(tmp_path / "port.prom") as a, open(tmp_path / "ref.prom") as b:
        assert a.read() == b.read()
    for name in ("count", "sum", "mean", "max"):
        assert getattr(h, name) == getattr(rh, name)
    assert registry.Histogram("empty").max == ref_registry.Histogram("empty").max == 0.0

    def rows(path):
        with open(path) as f:
            return [{k: v for k, v in r.items() if k != "time"} for r in csv.DictReader(f)]

    assert rows(our_csv) == rows(their_csv) and len(rows(our_csv)) == 2
    for raw in ('a\\"b\\nc\\\\d', "plain", "trailing\\", "odd\\q"):
        assert registry.unescape_label_value(raw) == ref_registry.unescape_label_value(raw)
    samples = ref_aggregate.parse_prometheus(ours.prometheus_text())
    assert {"route": '/v1/"sim"\n\\x'} in [dict(s.labels) for s in samples]


def _keys(events):
    return [(e["type"], e.get("name"), sorted(e.get("attrs") or {})) for e in events]


def test_run_step_log_row_and_mark_interrupted_write_the_references_keys(tmp_path):
    ours, theirs = _runs(tmp_path, snapshot_interval_s=0.0)
    for r in (ours, theirs):
        r.registry.attach_csv(os.path.join(r.run_dir, "training_log.csv"))
        with r.step("iteration", iteration=1, pairs=64) as out:
            out["loss"] = 0.5
        r.log_row(1, {"loss": 0.5, "seconds": 0.1})
        r.mark_interrupted("signal", signal=15, completed_iteration=1)
        r.close()
    manifests = []
    for r in (ours, theirs):
        with open(os.path.join(r.run_dir, "manifest.json")) as f:
            manifests.append(json.load(f))
        assert os.path.exists(os.path.join(r.run_dir, "metrics.prom"))
    assert set(manifests[0]) == set(manifests[1])
    for k in ("interrupted", "interrupted_reason", "signal", "completed_iteration",
              "config", "config_hash", "name"):
        assert manifests[0][k] == manifests[1][k], k
    ev = [read_events(os.path.join(r.run_dir, "events.jsonl")) for r in (ours, theirs)]
    assert _keys(ev[0]) == _keys(ev[1])
    assert ("span_end", "iteration", ["iteration", "loss", "pairs"]) in _keys(ev[0])
    prom = [ref_aggregate.parse_prometheus(open(os.path.join(r.run_dir, "metrics.prom")).read())
            for r in (ours, theirs)]
    assert ([s.name for s in prom[0]] == [s.name for s in prom[1]]
            and "step_seconds_count" in [s.name for s in prom[0]])


def _check_run_dir(d, want_hash, iterations, dim):
    """The reference run's records in export dir ``d``."""
    for name in ("manifest.json", "events.jsonl", "metrics.prom", "training_log.csv",
                 "timeline.jsonl"):
        assert os.path.exists(os.path.join(d, name)), name
    with open(os.path.join(d, "manifest.json")) as f:
        manifest = json.load(f)
    assert manifest["config_hash"] == want_hash
    g = manifest["goodput"]
    assert math.isclose(sum(g["buckets_s"].values()), g["wall_s"], abs_tol=1e-5)
    assert g["pairs_total"] > 0 and g["buckets_s"]["compute"] > 0
    events = read_events(os.path.join(d, "events.jsonl"))
    steps = [e for e in events if e["type"] == "span_end" and e["name"] == "iteration"]
    assert [e["attrs"]["iteration"] for e in steps] == list(range(1, iterations + 1))
    with open(os.path.join(d, "metrics.prom")) as f:
        names = {s.name for s in ref_aggregate.parse_prometheus(f.read())}
    assert {"pairs_total", "goodput_compute_fraction", "loss", "step_seconds_count"} <= names
    with open(os.path.join(d, "training_log.csv")) as f:
        rows = list(csv.DictReader(f))
    assert [int(r["step"]) for r in rows] == list(range(1, iterations + 1))
    assert set(rows[0]) == {"loss", "pairs_per_sec", "seconds", "step", "time"}
    for it in range(1, iterations + 1):
        _, _, meta = jckpt.load_iteration(d, dim, it)
        assert meta["config_hash"] == want_hash
    report = ref_report.format_report(d)
    assert f"config hash: {want_hash}" in report and "goodput: compute" in report
    assert "iteration" in report and "throughput:" in report


def test_sgns_run_writes_the_references_records(tmp_path):
    toks, counts, pairs = _zipf_corpus()
    tr = SGNSTrainer(PairCorpus(Vocab(toks, counts), pairs), SGNSConfig(**SMALL), device="cpu")
    jt = JTrainer(JCorpus(JVocab(toks, counts), pairs), JConfig(**SMALL))
    tr.run(str(tmp_path), log=lambda m: None)
    _check_run_dir(str(tmp_path), ref_run.config_hash(jt.config), 2, SMALL["dim"])


@pytest.mark.parametrize("objective", ["cbow_hs", "cbow"])
def test_cbow_hs_run_writes_the_references_records(tmp_path, objective):
    toks, counts, pairs = _zipf_corpus()
    kw = dict(dim=16, batch_pairs=128, num_iters=2, objective=objective, hs_dense_depth=3,
              strat_head=32, strat_block=64, strat_group=32)
    tr = CBOWHSTrainer(PairCorpus(Vocab(toks, counts), pairs), SGNSConfig(**kw), device="cpu")
    jt = JCBOWHSTrainer(JCorpus(JVocab(toks, counts), pairs), JConfig(**kw))
    logs = []
    tr.run(str(tmp_path), log=logs.append)
    assert logs[0].startswith(f"gene2vec [{objective}] dimension 16 iteration 1 done")
    _check_run_dir(str(tmp_path), ref_run.config_hash(jt.config), 2, 16)
    _, _, meta = jckpt.load_iteration(str(tmp_path), 16, 2)
    assert meta["objective"] == objective


def test_ggipnn_run_writes_goodput_and_timeline(tmp_path):
    rng = np.random.RandomState(0)
    data = tmp_path / "data"
    data.mkdir()
    for split, n in (("train", 96), ("valid", 32), ("test", 32)):
        a, b = rng.randint(0, 40, n), rng.randint(0, 40, n)
        (data / f"{split}_text.txt").write_text("".join(f"G{i} G{j}\n" for i, j in zip(a, b)))
        (data / f"{split}_label.txt").write_text("".join(f"{int(i % 2 == j % 2)}\n"
                                                         for i, j in zip(a, b)))
    kw = dict(embedding_dim=8, hidden_dims=(16, 4), batch_size=16, num_epochs=2,
              evaluate_every=4, checkpoint_every=6)
    rd = str(tmp_path / "run")
    run_classification(str(data), None, GGIPNNConfig(**kw), log=lambda m: None, run_dir=rd,
                       device="cpu")
    with open(os.path.join(rd, "manifest.json")) as f:
        manifest = json.load(f)
    assert manifest["config_hash"] == ref_run.config_hash(RefGGIPNNConfig(**kw))
    g = manifest["goodput"]
    assert math.isclose(sum(g["buckets_s"].values()), g["wall_s"], abs_tol=1e-5)
    assert g["pairs_total"] == 12 * 16  # 6 steps an epoch, batch 16
    from gene2vec_tpu.obs.timeline import read_timeline

    phases = {r["name"] for r in read_timeline(os.path.join(rd, "timeline.jsonl"))}
    assert phases == {"host_ingest", "dispatch", "compute"}
    assert "goodput: compute" in ref_report.format_report(rd)
