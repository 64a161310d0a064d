"""The port's resilience package (``gene2vec_tpu_torch/resilience/``) held
against the reference's on the CPU: the snapshot writers' bytes, the verify
cache, the async writer, the preemption handler, the chaos helpers, and the
crash contract of both trainers, GGIPNN and their CLIs — a drained or
SIGKILLed run, rerun, ends bitwise on the uninterrupted run's tables, and
``--async-checkpoint`` is bitwise the inline save.
"""

import csv
import json
import re
import os
import signal
import sys
import threading
import time

import numpy as np
import pytest

from gene2vec_tpu.io import checkpoint as ref_ckpt
from gene2vec_tpu.io.vocab import Vocab as RefVocab
from gene2vec_tpu.resilience import chaos as ref_chaos
from gene2vec_tpu.resilience import snapshot as ref_snap
from gene2vec_tpu.resilience.async_writer import AsyncCheckpointWriter as RefWriter
from gene2vec_tpu.resilience.preempt import EXIT_PREEMPTED as REF_EXIT_PREEMPTED
from gene2vec_tpu.sgns.model import SGNSParams as RefParams
from gene2vec_tpu_torch.config import SGNSConfig
from gene2vec_tpu_torch.data.pipeline import PairCorpus
from gene2vec_tpu_torch.io import checkpoint as ckpt
from gene2vec_tpu_torch.io.vocab import Vocab
from gene2vec_tpu_torch.obs import trace
from gene2vec_tpu_torch.obs.registry import MetricsRegistry
from gene2vec_tpu_torch.resilience import chaos
from gene2vec_tpu_torch.resilience import snapshot as snap
from gene2vec_tpu_torch.resilience.async_writer import (
    AsyncCheckpointWriter,
    CheckpointWriteError,
)
from gene2vec_tpu_torch.resilience.preempt import EXIT_PREEMPTED, PreemptionHandler

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

V, N = 120, 768
SMALL = dict(dim=8, batch_pairs=128, strat_head=16, strat_block=32, strat_group=32,
             positive_head=8, positive_mid=16, num_iters=3, txt_output=False)
CONFIGS = {
    "sgns_f32": {},
    "sgns_bf16_sr": {"table_dtype": "bfloat16"},
    "cbow_hs": {"objective": "cbow_hs", "hs_dense_depth": 2},
}


def _corpus(v=V, n=N, seed=0):
    rng = np.random.RandomState(seed)
    p = 1.0 / np.arange(1, v + 1)
    p /= p.sum()
    pairs = rng.choice(v, size=(n, 2), p=p).astype(np.int32)
    counts = np.bincount(pairs.ravel(), minlength=v).astype(np.int64) + 1
    return PairCorpus(Vocab([f"G{i}" for i in range(v)], counts), pairs)


def _trainer(corpus, **overrides):
    from gene2vec_tpu_torch.sgns.cbow_hs import make_trainer

    return make_trainer(corpus, SGNSConfig(**dict(SMALL, **overrides)), device="cpu")


def _tables(export_dir, it, dim=SMALL["dim"]):
    with np.load(ckpt.ckpt_prefix(str(export_dir), dim, it) + ".npz") as z:
        return np.array(z["emb"]), np.array(z["ctx"])


def _manifest(export_dir):
    with open(os.path.join(str(export_dir), "manifest.json")) as f:
        return json.load(f)


def _drain_at(handler, iteration):
    """A ``log`` that triggers ``handler`` at iteration ``iteration``'s
    done line (the line before its checkpoint, where the CLI drills send
    SIGTERM)."""
    def log(msg):
        if f"iteration {iteration} done" in msg:
            handler.trigger(signal.SIGTERM)
    return log


def _quiet(msg):
    pass


@pytest.fixture(autouse=True)
def _no_buffered_spans():
    """Servers and writers outside a run buffer ambient spans for the next
    run's tracer: leave none behind for later tests in this process."""
    yield
    with trace._pending_lock:
        trace._pending.clear()


# -- snapshot: the write half -------------------------------------------------


@pytest.fixture
def frozen_clock(monkeypatch):
    """Both packages' manifests stamp ``created_unix``; one clock makes
    their bytes comparable."""
    monkeypatch.setattr(snap.time, "time", lambda: 1_700_000_000.25)
    monkeypatch.setattr(ref_snap.time, "time", lambda: 1_700_000_000.25)


@pytest.mark.parametrize("writer", ["bytes", "json", "copy", "manifest", "savez_via"])
def test_snapshot_writers_write_the_references_bytes(tmp_path, frozen_clock, writer):
    ours, theirs = tmp_path / "port", tmp_path / "ref"
    ours.mkdir()
    theirs.mkdir()
    doc = {"b": [1, 2.5, "x"], "a": {"nested": None}, "when": object.__name__}
    src = tmp_path / "src.bin"
    src.write_bytes(bytes(range(256)) * 5000)  # past one copy chunk
    for mod, d in ((snap, ours), (ref_snap, theirs)):
        path = str(d / "out")
        if writer == "bytes":
            mod.atomic_write_bytes(path, b"\x00payload\xff" * 3)
        elif writer == "json":
            mod.atomic_write_json(path, doc)
        elif writer == "copy":
            mod.atomic_copy(str(src), path, chunk=4096)
        elif writer == "manifest":
            (d / "a.npz").write_bytes(b"abc" * 100)
            (d / "a.txt").write_bytes(b"text")
            mod.write_manifest(str(d / "a"), [str(d / "a.npz"), str(d / "a.txt")],
                               meta={"iteration": 3}, optional=[str(d / "a.txt")])
            path = str(d / "a") + mod.MANIFEST_SUFFIX
        else:
            mod.atomic_write_via(lambda p: open(p, "w").write("via\n"), path)
        assert not [n for n in os.listdir(d) if ".tmp" in n]
    name = "a" + snap.MANIFEST_SUFFIX if writer == "manifest" else "out"
    assert (ours / name).read_bytes() == (theirs / name).read_bytes()
    if writer == "manifest":
        doc = json.loads((ours / name).read_text())
        assert snap.manifest_bytes(doc) == ref_snap.manifest_bytes(doc) == 304


def test_snapshot_helpers_are_the_references():
    assert snap._tmp_name("/x/y", ".npz") == ref_snap._tmp_name("/x/y", ".npz")
    assert snap._tmp_name("/x/y") == f"/x/y.tmp{os.getpid()}"
    assert (snap.SCHEMA, snap.MANIFEST_SUFFIX) == (ref_snap.SCHEMA, ref_snap.MANIFEST_SUFFIX)
    assert snap.manifest_path("p") == ref_snap.manifest_path("p")
    snap.fsync_dir("/nonexistent/dir")  # best effort, never raises


def test_atomic_replace_fsyncs_and_renames(tmp_path):
    tmp = tmp_path / "f.tmp"
    tmp.write_bytes(b"new")
    (tmp_path / "f").write_bytes(b"old")
    snap.atomic_replace(str(tmp), str(tmp_path / "f"))
    assert (tmp_path / "f").read_bytes() == b"new" and not tmp.exists()


def _save(export_dir, it, txt=True):
    vocab = Vocab([f"G{i}" for i in range(12)], np.arange(1, 13))
    from gene2vec_tpu_torch.sgns.model import SGNSParams

    import torch

    params = SGNSParams(torch.full((12, 4), float(it)), torch.zeros(12, 4))
    return ckpt.save_iteration(str(export_dir), 4, it, params, vocab, txt_output=txt)


def test_verify_cache_invalidates_on_change(tmp_path):
    _save(tmp_path, 1)
    prefix = ckpt.ckpt_prefix(str(tmp_path), 4, 1)
    assert snap.verify_manifest(prefix).ok
    time.sleep(0.01)  # a distinct mtime_ns on coarse filesystems
    chaos.truncate_file(prefix + ".npz")
    assert not snap.verify_manifest(prefix)


def test_verify_cache_serves_unchanged_files_without_a_crc(tmp_path, monkeypatch):
    _save(tmp_path, 1)
    prefix = ckpt.ckpt_prefix(str(tmp_path), 4, 1)
    snap.clear_verify_cache()
    first = snap.verify_manifest(prefix)
    calls = []
    monkeypatch.setattr(snap, "crc32_file", lambda p: calls.append(p) or 0)
    assert snap.verify_manifest(prefix) is first  # the cached verdict
    assert not calls
    assert not snap.verify_manifest(prefix, use_cache=False)  # the stub's CRC
    snap.clear_verify_cache()
    assert not snap.verify_manifest(prefix) and calls


@pytest.mark.parametrize("reason", ["missing-manifest", "torn-manifest", "missing",
                                    "size", "crc"])
def test_verify_reasons_are_the_references(tmp_path, reason):
    d = tmp_path / "e"
    _save(d, 1)
    prefix = ckpt.ckpt_prefix(str(d), 4, 1)
    mpath = prefix + snap.MANIFEST_SUFFIX
    if reason == "missing-manifest":
        os.unlink(mpath)
    elif reason == "torn-manifest":
        with open(mpath, "r+b") as f:
            f.truncate(10)
    elif reason == "missing":
        os.unlink(prefix + ".npz")
    elif reason == "size":
        chaos.truncate_file(prefix + ".npz", frac=0.5)
    else:
        chaos.flip_byte(prefix + ".npz", seed=1)
    snap.clear_verify_cache()
    ref_snap.clear_verify_cache()
    got, want = snap.verify_manifest(prefix), ref_snap.verify_manifest(prefix)
    assert not got and got.reason == want.reason and got.reason.startswith(reason)


# -- chaos helpers --------------------------------------------------------------


def _ref_save(export_dir, it):
    vocab = RefVocab([f"G{i}" for i in range(12)], np.arange(1, 13))
    params = RefParams(np.full((12, 4), float(it), np.float32), np.zeros((12, 4), np.float32))
    return ref_ckpt.save_iteration(str(export_dir), 4, it, params, vocab)


@pytest.mark.parametrize("injector", ["truncate", "flip", "corrupt_crc", "restamp"])
def test_chaos_injectors_do_what_the_references_do(tmp_path, injector):
    """Each injector, the port's and the reference's, on one iteration
    each package saved: the same return (where the files agree in size)
    and the same verification verdict after it."""
    ours, theirs = tmp_path / "port", tmp_path / "ref"
    _save(ours, 1)
    _ref_save(theirs, 1)
    returned, reasons = [], []
    for mod, d in ((chaos, ours), (ref_chaos, theirs)):
        prefix = ckpt.ckpt_prefix(str(d), 4, 1)
        if injector == "truncate":
            mod.truncate_file(prefix + ".npz", frac=0.25)
        elif injector == "flip":
            returned.append(mod.flip_byte(prefix + ".txt", seed=3))
        elif injector == "corrupt_crc":
            returned.append(mod.corrupt_manifest_crc(prefix))
        else:
            chaos.truncate_file(prefix + ".txt", keep_bytes=7)
            mod.restamp_manifest(prefix)
            doc = json.loads(open(prefix + snap.MANIFEST_SUFFIX).read())
            returned.append(doc["files"]["gene2vec_dim_4_iter_1.txt"]["bytes"])
            returned.append(doc["files"]["gene2vec_dim_4_iter_1.txt"]["optional"])
        snap.clear_verify_cache()
        reasons.append(snap.verify_manifest(prefix).reason)
    assert returned[: len(returned) // 2] == returned[len(returned) // 2:]
    assert reasons[0] == reasons[1] == {
        "truncate": "size:gene2vec_dim_4_iter_1.npz",
        "flip": "crc:gene2vec_dim_4_iter_1.txt",
        "corrupt_crc": "crc:gene2vec_dim_4_iter_1.npz",
        "restamp": "ok"}[injector]
    if injector == "restamp":
        assert returned == [7, True, 7, True]


def test_corruption_falls_back_to_the_newest_verifying_iteration(tmp_path):
    """The reference drill's corruption phase in the port's terms: a
    truncated newest npz, then a stale CRC, each make discovery fall back."""
    for it in (1, 2, 3):
        _save(tmp_path, it)
    chaos.truncate_file(os.path.join(str(tmp_path), "gene2vec_dim_4_iter_3.npz"))
    snap.clear_verify_cache()
    assert ckpt.latest_iteration(str(tmp_path), 4) == 2
    chaos.corrupt_manifest_crc(os.path.join(str(tmp_path), "gene2vec_dim_4_iter_2"))
    snap.clear_verify_cache()
    assert ckpt.latest_iteration(str(tmp_path), 4) == 1
    removed = chaos.delete_iteration(str(tmp_path), 4, 1)
    assert [os.path.basename(p) for p in removed] == [
        "gene2vec_dim_4_iter_1.npz", "gene2vec_dim_4_iter_1.txt",
        "gene2vec_dim_4_iter_1_w2v.txt", "gene2vec_dim_4_iter_1.MANIFEST.json"]
    assert np.array_equal(chaos.load_table(str(tmp_path), 4, 2), np.full((12, 4), 2.0))


def test_a_leftover_temp_file_is_ignored_and_overwritten(tmp_path):
    """A SIGKILL during a write leaves ``*.tmp<pid>`` behind: discovery
    skips it and the next save of that iteration lands cleanly."""
    _save(tmp_path, 1)
    stale = ckpt.ckpt_prefix(str(tmp_path), 4, 2) + ".npz.tmp12345"
    with open(stale, "wb") as f:
        f.write(b"torn")
    assert ckpt.latest_iteration(str(tmp_path), 4) == 1
    _save(tmp_path, 2)
    assert ckpt.latest_iteration(str(tmp_path), 4) == 2


def test_gene2vec_argv_and_child_env():
    argv = chaos.gene2vec_argv("d", "e", dim=8, device="cpu", no_txt_output=True,
                               async_checkpoint=False, seed=None)
    assert argv[1:] == ["-m", "gene2vec_tpu_torch.cli.gene2vec", "d", "e", "txt",
                        "--dim", "8", "--device", "cpu", "--no-txt-output"]
    env = chaos.child_env({"X": "1"})
    assert env["PYTHONUNBUFFERED"] == "1" and env["X"] == "1"
    assert env.get("JAX_PLATFORMS") == os.environ.get("JAX_PLATFORMS")


# -- the async writer -----------------------------------------------------------


def test_async_writer_runs_jobs_in_order_and_flushes():
    done = []
    w = AsyncCheckpointWriter(max_pending=1)
    for i in range(4):
        w.submit(lambda i=i: (time.sleep(0.01), done.append(i), 128)[-1])
    w.flush()
    assert done == [0, 1, 2, 3]
    w.close()
    w.close()  # idempotent
    with pytest.raises(CheckpointWriteError):
        w.submit(lambda: None)  # closed writers refuse work


def test_async_writer_double_buffer_bound():
    """At most max_pending writes outstanding: a second submit blocks until
    the in-flight write retires."""
    gate = threading.Event()
    w = AsyncCheckpointWriter(max_pending=1)
    t0 = time.perf_counter()
    w.submit(lambda: gate.wait(10))  # the writer is idle: returns at once
    assert time.perf_counter() - t0 < 1.0
    assert w.pending == 1
    threading.Thread(target=lambda: (time.sleep(0.2), gate.set()), daemon=True).start()
    t0 = time.perf_counter()
    w.submit(lambda: None)  # must wait for the first to retire
    assert time.perf_counter() - t0 > 0.1
    w.close()
    assert w.pending == 0


@pytest.mark.parametrize("surface", ["submit", "flush", "close"])
def test_async_writer_error_surfaces_on_the_next_call(surface):
    w = AsyncCheckpointWriter()
    w.submit(lambda: (_ for _ in ()).throw(IOError("disk full")))
    if surface == "submit":
        w._queue.join()  # the failed write has retired
    with pytest.raises(CheckpointWriteError, match="disk full") as info:
        getattr(w, surface)(*([lambda: None] if surface == "submit" else []))
    assert isinstance(info.value.__cause__, IOError)
    if surface != "close":
        w.close()  # the error was reported once


def test_async_writer_metrics_and_span_are_the_references(tmp_path):
    from gene2vec_tpu.obs.registry import MetricsRegistry as RefRegistry
    from gene2vec_tpu_torch.obs import trace

    got, want = MetricsRegistry(), RefRegistry()
    tracer = trace.Tracer(str(tmp_path / "events.jsonl"))
    trace.set_tracer(tracer)
    try:
        for cls, reg in ((AsyncCheckpointWriter, got), (RefWriter, want)):
            w = cls(metrics=reg)
            w.submit(lambda: 4096, iteration=3)
            w.submit(lambda: (_ for _ in ()).throw(IOError("x")))
            with pytest.raises(Exception):
                w.close()
    finally:
        trace.set_tracer(None)
        tracer.close()
    for m in got, want:
        assert m.counter("ckpt_writes_total").value == 1
        assert m.counter("ckpt_bytes_total").value == 4096
        assert m.counter("ckpt_errors_total").value == 1
        assert m.histogram("ckpt_write_seconds").count == 1
        assert m.gauge("ckpt_inflight").value == 0
    spans = [e for e in trace.read_events(str(tmp_path / "events.jsonl"))
             if e.get("name") == "ckpt_write" and e["type"] == "span_start"]
    assert spans and spans[0]["attrs"] == {"iteration": 3}


# -- the preemption handler -----------------------------------------------------


def test_preemption_handler_first_signal_wins():
    h = PreemptionHandler()
    assert not h.triggered and h.received is None and not h.wait(0.0)
    t0 = time.time()
    h.trigger(signal.SIGTERM)
    assert h.triggered and h.received == signal.SIGTERM and h.received_wall >= t0
    wall = h.received_wall
    h.trigger(signal.SIGINT)  # the first signal keeps the record
    assert h.received == signal.SIGTERM and h.received_wall == wall
    assert h.wait(0.01)
    assert EXIT_PREEMPTED == REF_EXIT_PREEMPTED == 113


def test_second_signal_restores_the_previous_disposition_and_reraises():
    seen = []
    prev = signal.signal(signal.SIGUSR1, lambda s, f: seen.append(s))
    try:
        with PreemptionHandler(signals=(signal.SIGUSR1,)) as h:
            os.kill(os.getpid(), signal.SIGUSR1)
            time.sleep(0.01)
            assert h.triggered and h.received == signal.SIGUSR1 and seen == []
            os.kill(os.getpid(), signal.SIGUSR1)  # the drain is too slow
            time.sleep(0.01)
            assert seen == [signal.SIGUSR1]  # re-raised to the old handler
            assert signal.getsignal(signal.SIGUSR1) != h._on_signal
    finally:
        signal.signal(signal.SIGUSR1, prev)


def test_uninstall_restores_the_dispositions():
    before = signal.getsignal(signal.SIGTERM)
    h = PreemptionHandler().install()
    assert signal.getsignal(signal.SIGTERM) == h._on_signal
    h.uninstall()
    assert signal.getsignal(signal.SIGTERM) == before


# -- the trainers' crash contract -----------------------------------------------


@pytest.mark.parametrize("name", list(CONFIGS))
def test_drain_then_resume_is_bitwise_the_uninterrupted_run(tmp_path, name):
    corpus = _corpus()
    ref_dir, drain_dir = tmp_path / "ref", tmp_path / "drain"
    _trainer(corpus, **CONFIGS[name]).run(str(ref_dir), log=_quiet)
    h = PreemptionHandler()
    _trainer(corpus, **CONFIGS[name]).run(str(drain_dir), log=_drain_at(h, 1), preempt=h)
    assert ckpt.latest_iteration(str(drain_dir), SMALL["dim"]) == 1
    manifest = _manifest(drain_dir)
    assert manifest["interrupted"] is True and manifest["completed_iteration"] == 1
    assert manifest["interrupted_reason"] == "signal"
    assert manifest["signal"] == signal.SIGTERM
    assert manifest["goodput"]["buckets_s"]["preempted"] > 0
    logs = []
    _trainer(corpus, **CONFIGS[name]).run(str(drain_dir), log=logs.append)
    assert "resuming from iteration 1" in logs
    assert "interrupted" not in _manifest(drain_dir)
    for it in (1, 2, 3):
        for a, b in zip(_tables(ref_dir, it), _tables(drain_dir, it)):
            assert np.array_equal(a, b)
            assert a.dtype == np.float32


def test_a_signal_between_iterations_trains_nothing(tmp_path):
    corpus = _corpus()
    _trainer(corpus, num_iters=1).run(str(tmp_path), log=_quiet)
    h = PreemptionHandler()
    h.trigger(signal.SIGINT)
    logs = []
    _trainer(corpus).run(str(tmp_path), log=logs.append, preempt=h)
    assert ckpt.latest_iteration(str(tmp_path), SMALL["dim"]) == 1
    assert not any("iteration 2" in m for m in logs)
    manifest = _manifest(tmp_path)
    assert manifest["interrupted"] is True and manifest["completed_iteration"] == 1


@pytest.mark.parametrize("txt", [False, True])
def test_async_checkpoint_is_bitwise_the_inline_save(tmp_path, txt):
    corpus = _corpus(seed=2)
    sync_dir, async_dir = tmp_path / "s", tmp_path / "a"
    _trainer(corpus, txt_output=txt).run(str(sync_dir), log=_quiet)
    _trainer(corpus, txt_output=txt, async_checkpoint=True).run(str(async_dir), log=_quiet)
    for it in (1, 2, 3):
        prefix = ckpt.ckpt_prefix(str(async_dir), SMALL["dim"], it)
        res = snap.verify_manifest(prefix)
        assert res.ok
        for a, b in zip(_tables(sync_dir, it), _tables(async_dir, it)):
            assert np.array_equal(a, b)
        if txt:
            for suffix in (".txt", "_w2v.txt"):
                sync_prefix = ckpt.ckpt_prefix(str(sync_dir), SMALL["dim"], it)
                with open(sync_prefix + suffix, "rb") as f, open(prefix + suffix, "rb") as g:
                    assert f.read() == g.read()
    # the writer's metrics and each checkpoint span's mode
    text = (async_dir / "metrics.prom").read_text()
    assert "ckpt_writes_total 3" in text and "ckpt_errors_total" not in text
    from gene2vec_tpu_torch.obs.trace import read_events

    modes = [e["attrs"]["mode"] for e in read_events(str(async_dir / "events.jsonl"))
             if e.get("name") == "checkpoint" and e["type"] == "span_start"]
    assert modes == ["async"] * 3
    modes = [e["attrs"]["mode"] for e in read_events(str(sync_dir / "events.jsonl"))
             if e.get("name") == "checkpoint" and e["type"] == "span_start"]
    assert modes == ["sync"] * 3


def test_the_staged_copy_is_a_copy(tmp_path, monkeypatch):
    """Iteration 1's write is held back until iteration 2's epoch has
    updated the live tables in place: its npz must still hold iteration
    1's tables, as the inline save wrote them."""
    from gene2vec_tpu_torch.sgns import train

    gate, order = threading.Event(), []

    class HeldBack(AsyncCheckpointWriter):
        def submit(self, write_fn, **attrs):
            def held():
                if attrs.get("iteration") == 1:
                    assert gate.wait(30)
                order.append(attrs.get("iteration"))
                return write_fn()
            super().submit(held, **attrs)

    monkeypatch.setattr(train, "AsyncCheckpointWriter", HeldBack)

    def log(msg):
        if "iteration 2 done" in msg:
            order.append("epoch 2")
            gate.set()

    corpus = _corpus(seed=4)
    sync_dir, async_dir = tmp_path / "s", tmp_path / "a"
    _trainer(corpus, num_iters=2).run(str(sync_dir), log=_quiet)
    _trainer(corpus, num_iters=2, async_checkpoint=True).run(str(async_dir), log=log)
    assert order == ["epoch 2", 1, 2]
    for it in (1, 2):
        for a, b in zip(_tables(sync_dir, it), _tables(async_dir, it)):
            assert np.array_equal(a, b)
    assert not np.array_equal(_tables(async_dir, 1)[0], _tables(async_dir, 2)[0])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_save_process_writes_what_the_inline_save_writes(tmp_path, dtype):
    """The helper's iteration equals ``save_iteration`` of the same tables
    inline: the arrays, the text exports' bytes, the width stamp; the slot
    it writes is the staged copy, not the live tables."""
    import torch

    from gene2vec_tpu_torch.sgns.model import SGNSParams

    corpus = _corpus()
    rng = np.random.RandomState(1)
    live = SGNSParams(*(torch.from_numpy(rng.randn(V, 8).astype(np.float32)).to(
        getattr(torch, dtype)) for _ in range(2)))
    inline, helper = str(tmp_path / "inline"), str(tmp_path / "helper")
    ckpt.save_iteration(inline, 8, 1, live, corpus.vocab, meta={"loss": 1.5})
    saver = ckpt.SaveProcess(helper, 8, V, corpus.vocab, txt_output=True)
    try:
        slot = saver.stage(live)
        want = live.emb.float().clone()
        live.emb.add_(1.0)  # the next epoch, in place
        nbytes = saver.save(slot, 1, {"loss": 1.5}, dtype)
    finally:
        saver.close()
    assert not saver._proc.is_alive()
    assert nbytes == snap.manifest_bytes(snap.verify_manifest(
        ckpt.ckpt_prefix(helper, 8, 1)).manifest)
    for a, b in zip(_tables(inline, 1), _tables(helper, 1)):
        assert np.array_equal(a, b)
    assert np.array_equal(_tables(helper, 1)[0], want.numpy())
    for suffix in (".txt", "_w2v.txt"):
        with open(ckpt.ckpt_prefix(inline, 8, 1) + suffix, "rb") as f, \
                open(ckpt.ckpt_prefix(helper, 8, 1) + suffix, "rb") as g:
            assert f.read() == g.read()
    _, _, meta = ckpt.load_iteration(helper, 8, 1)
    assert meta["table_dtype"] == dtype and meta["loss"] == 1.5


def test_save_process_reports_failures_and_a_dead_helper(tmp_path):
    corpus = _corpus()
    blocker = tmp_path / "not_a_dir"
    blocker.write_text("x")
    saver = ckpt.SaveProcess(str(blocker), 8, V, corpus.vocab)
    try:
        import torch

        from gene2vec_tpu_torch.sgns.model import SGNSParams

        slot = saver.stage(SGNSParams(torch.zeros(V, 8), torch.zeros(V, 8)))
        with pytest.raises(IOError, match="FileExistsError|NotADirectoryError"):
            saver.save(slot, 1, {}, "float32")
        saver._proc.kill()
        saver._proc.join(10)
        with pytest.raises(IOError, match="helper process gone"):
            saver.save(slot, 1, {}, "float32")
    finally:
        saver.close()


def test_save_process_dies_with_its_parent(tmp_path):
    """A parent killed with SIGKILL takes its helper along, so no orphan
    writes into an export dir a rerun is writing."""
    code = (
        "import sys, time\n"
        "sys.path.insert(0, %r)\n"
        "from gene2vec_tpu_torch.io.checkpoint import SaveProcess\n"
        "from gene2vec_tpu_torch.io.vocab import Vocab\n"
        "s = SaveProcess(%r, 4, 3, Vocab(['a', 'b', 'c'], [1, 1, 1]))\n"
        "print(s._proc.pid, flush=True)\n"
        "time.sleep(60)\n" % (ROOT, str(tmp_path / "e")))
    import subprocess

    proc = subprocess.Popen([sys.executable, "-c", code], stdout=subprocess.PIPE, text=True,
                            env=dict(os.environ, OMP_NUM_THREADS="1"))
    helper = int(proc.stdout.readline())
    proc.kill()
    proc.wait(30)

    def alive(pid):
        try:
            with open(f"/proc/{pid}/stat") as f:
                return f.read().rsplit(")", 1)[1].split()[0] not in ("Z", "X")
        except FileNotFoundError:
            return False

    deadline = time.monotonic() + 10
    while alive(helper) and time.monotonic() < deadline:
        time.sleep(0.05)
    assert not alive(helper)


def test_save_process_left_open_does_not_hold_the_exit(tmp_path):
    """A helper nobody closed (a run that died before its ``finally``)
    ignores SIGTERM, so the interpreter's exit must close it first."""
    import subprocess

    code = (
        "import sys\n"
        "sys.path.insert(0, %r)\n"
        "from gene2vec_tpu_torch.io.checkpoint import SaveProcess\n"
        "from gene2vec_tpu_torch.io.vocab import Vocab\n"
        "s = SaveProcess(%r, 4, 3, Vocab(['a', 'b', 'c'], [1, 1, 1]))\n"
        "print(s._proc.pid, flush=True)\n" % (ROOT, str(tmp_path / "e")))
    res = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=60, env=dict(os.environ, OMP_NUM_THREADS="1"))
    assert res.returncode == 0, res.stderr
    assert not os.path.exists(f"/proc/{int(res.stdout)}/stat") or open(
        f"/proc/{int(res.stdout)}/stat").read().rsplit(")", 1)[1].split()[0] in ("Z", "X")


def test_a_failed_background_write_fails_the_run(tmp_path, monkeypatch):
    from gene2vec_tpu_torch.sgns import train

    def broken(*a, **k):
        raise OSError("disk full")

    monkeypatch.setattr(train.ckpt, "save_iteration", broken)
    with pytest.raises(CheckpointWriteError, match="disk full"):
        _trainer(_corpus(), async_checkpoint=True).run(str(tmp_path), log=_quiet)
    assert ckpt.latest_iteration(str(tmp_path), SMALL["dim"]) == 0


def test_drained_and_resumed_run_stays_within_the_reference_bar(tmp_path, monkeypatch):
    """The reference's JAX trainer and the port's drained-then-resumed run
    on the reference's draws end within ``test_two_epochs_match_under_
    injected_draws``'s bar (loss rtol 1e-4, tables atol 1e-5)."""
    import jax

    from gene2vec_tpu.config import SGNSConfig as JConfig
    from gene2vec_tpu.data.pipeline import PairCorpus as JCorpus
    from gene2vec_tpu.io.vocab import Vocab as JVocab
    from gene2vec_tpu.sgns import step as jstep
    from gene2vec_tpu.sgns.model import init_params_numpy
    from gene2vec_tpu.sgns.train import SGNSTrainer as JTrainer
    from gene2vec_tpu_torch.sgns import train
    from gene2vec_tpu_torch.sgns.model import from_jax_params
    from test_torch_train import _jax_epoch_draws

    monkeypatch.setattr(jstep, "_DENSE_HEAD_PRECISION", jax.lax.Precision.HIGHEST)
    corpus = _corpus()
    kw = dict(SMALL, num_iters=2)
    kw.pop("txt_output")
    jt = JTrainer(JCorpus(JVocab(corpus.vocab.id_to_token, corpus.vocab.counts),
                          corpus.pairs), JConfig(**kw))
    jp = init_params_numpy(0, V, kw["dim"])
    # the reference's epoch donates its tables: keep the initial ones
    emb0, ctx0 = np.array(jp.emb), np.array(jp.ctx)
    draws, jlosses = {}, []
    for it in (1, 2):
        key = jax.random.fold_in(jax.random.PRNGKey(jt.config.seed), it)
        draws[it] = _jax_epoch_draws(jt, _trainer(corpus), key)
        jp, jloss = jt.train_epoch(jp, key)
        jlosses.append(float(jloss))

    # the port's run on the reference's draws and initial tables
    monkeypatch.setattr(train, "epoch_generator", lambda seed, it: it)

    def trainer():
        tt = _trainer(corpus, num_iters=2)
        tt.draw_epoch = draws.__getitem__
        tt.init = lambda seed=None: from_jax_params(emb0, ctx0)
        return tt

    h = PreemptionHandler()
    trainer().run(str(tmp_path), log=_drain_at(h, 1), preempt=h)
    assert ckpt.latest_iteration(str(tmp_path), SMALL["dim"]) == 1
    trainer().run(str(tmp_path), log=_quiet)
    with open(tmp_path / "training_log.csv") as f:
        losses = [float(r["loss"]) for r in csv.DictReader(f)]
    np.testing.assert_allclose(losses, jlosses, rtol=1e-4)
    emb, ctx = _tables(tmp_path, 2)
    np.testing.assert_allclose(emb, np.asarray(jp.emb), atol=1e-5)
    np.testing.assert_allclose(ctx, np.asarray(jp.ctx), atol=1e-5)


# -- the CLIs -------------------------------------------------------------------


@pytest.fixture(scope="module")
def pair_dir(tmp_path_factory):
    d = tmp_path_factory.mktemp("corpus")
    # 512 steps an epoch: an iteration (~0.2 s on one thread) outlasts the
    # signal's way from the parent's pattern match to the child
    corpus = _corpus(n=65536, seed=7)
    toks = corpus.vocab.id_to_token
    (d / "pairs.txt").write_text(
        "\n".join(f"{toks[a]} {toks[b]}" for a, b in corpus.pairs) + "\n")
    return str(d)


CLI_FLAGS = dict(dim=8, iters=3, batch_pairs=128, strat_head=16, strat_block=32,
                 strat_group=32, device="cpu", no_txt_output=True)
#: one intra-op thread a child: several test processes share the machine
CHILD_ENV = {"OMP_NUM_THREADS": "1"}


@pytest.fixture(scope="module")
def cli_reference(pair_dir, tmp_path_factory):
    out = str(tmp_path_factory.mktemp("cli_ref"))
    r = chaos.run_cli(chaos.gene2vec_argv(pair_dir, out, **CLI_FLAGS), timeout=300,
                      env=CHILD_ENV)
    assert r.returncode == 0, r.output[-2000:]
    return out


def test_cli_sigterm_drains_exits_113_and_resumes_bitwise(pair_dir, cli_reference, tmp_path):
    out = str(tmp_path / "term")
    argv = chaos.gene2vec_argv(pair_dir, out, async_checkpoint=True, **CLI_FLAGS)
    r = chaos.run_cli_kill_on(argv, r"iteration 1 done", sig=signal.SIGTERM,
                              timeout=300, env=CHILD_ENV)
    assert r.returncode == EXIT_PREEMPTED, r.output[-2000:]
    assert "rerun the same command to resume" in r.output
    # the drain lands at the first boundary the signal reaches: iteration
    # 1's end, or 2's if the child outran it
    drained = int(re.search(r"drained after iteration (\d+)", r.output).group(1))
    assert drained in (1, 2)
    manifest = _manifest(out)
    assert manifest["interrupted"] is True and manifest["completed_iteration"] == drained
    assert ckpt.latest_iteration(out, 8) == drained
    r = chaos.run_cli(argv, timeout=300, env=CHILD_ENV)
    assert r.returncode == 0, r.output[-2000:]
    assert f"resuming from iteration {drained}" in r.output
    for it in (1, 2, 3):
        for a, b in zip(_tables(cli_reference, it), _tables(out, it)):
            assert np.array_equal(a, b)


def test_cli_sigkill_then_rerun_is_bitwise_the_uninterrupted_run(pair_dir, cli_reference,
                                                                 tmp_path):
    out = str(tmp_path / "kill")
    argv = chaos.gene2vec_argv(pair_dir, out, **CLI_FLAGS)
    r = chaos.run_cli_kill_on(argv, r"iteration 2 done", sig=signal.SIGKILL,
                              timeout=300, env=CHILD_ENV)
    assert r.returncode == -signal.SIGKILL and r.signaled
    survivor = ckpt.latest_iteration(out, 8)
    assert survivor in (1, 2)  # at most the iteration whose line drew the kill
    r = chaos.run_cli(argv, timeout=300, env=CHILD_ENV)
    assert r.returncode == 0 and f"resuming from iteration {survivor}" in r.output
    for it in (1, 2, 3):
        for a, b in zip(_tables(cli_reference, it), _tables(out, it)):
            assert np.array_equal(a, b)


# -- GGIPNN -------------------------------------------------------------------------


def _prediction_data(root, v=40, d=8, seed=0):
    from gene2vec_tpu_torch.io import emb_io

    rng = np.random.RandomState(seed)
    tokens = [f"G{i}" for i in range(v)]
    os.makedirs(root, exist_ok=True)
    for split, n in (("train", 480), ("valid", 40), ("test", 60)):
        pairs = rng.randint(0, v, (n, 2))
        labels = (pairs[:, 0] % 2 == pairs[:, 1] % 2).astype(int)
        with open(os.path.join(root, f"{split}_text.txt"), "w") as f:
            f.write("\n".join(f"{tokens[a]} {tokens[b]}" for a, b in pairs) + "\n")
        with open(os.path.join(root, f"{split}_label.txt"), "w") as f:
            f.write("\n".join(map(str, labels)) + "\n")
    emb = rng.randn(v, d).astype(np.float32)
    w2v = os.path.join(root, "emb_w2v.txt")
    emb_io.write_word2vec_format(w2v, tokens, emb)
    return w2v


def _ggipnn_config(**kw):
    from gene2vec_tpu_torch.config import GGIPNNConfig

    return GGIPNNConfig(**dict(dict(embedding_dim=8, hidden_dims=(16, 16, 4), batch_size=16,
                                    num_epochs=3, evaluate_every=5, checkpoint_every=20,
                                    embed_train=True), **kw))


def test_ggipnn_drain_forces_its_off_cadence_checkpoint(tmp_path):
    from gene2vec_tpu_torch.models.ggipnn_train import run_classification

    data = str(tmp_path / "data")
    w2v = _prediction_data(data)
    h = PreemptionHandler()
    logs = []

    def log(msg):
        logs.append(msg)
        if msg.startswith("step 25:"):
            h.trigger(signal.SIGTERM)

    run_dir = tmp_path / "run"
    result = run_classification(data, w2v, _ggipnn_config(), log=log,
                                run_dir=str(run_dir), device="cpu", preempt=h)
    assert result == {"interrupted": True}
    assert "preemption requested; drained after step 25" in logs
    assert not any("AUC" in m or "test accuracy" in m for m in logs)
    assert sorted(os.listdir(run_dir / "checkpoints")) == ["model-20.npz", "model-25.npz"]
    manifest = _manifest(run_dir)
    assert manifest["interrupted"] is True and manifest["signal"] == signal.SIGTERM
    assert manifest["goodput"]["buckets_s"]["preempted"] > 0


def test_ggipnn_drain_on_the_cadence_writes_no_second_checkpoint(tmp_path):
    from gene2vec_tpu_torch.models.ggipnn_train import run_classification

    data = str(tmp_path / "data")
    w2v = _prediction_data(data)
    h = PreemptionHandler()

    def log(msg):
        if msg.startswith("step 20:"):
            h.trigger(signal.SIGTERM)

    run_dir = tmp_path / "run"
    assert run_classification(data, w2v, _ggipnn_config(), log=log, run_dir=str(run_dir),
                              device="cpu", preempt=h) == {"interrupted": True}
    assert sorted(os.listdir(run_dir / "checkpoints")) == ["model-20.npz"]


def test_ggipnn_scanned_fit_drains_at_an_epoch_boundary(tmp_path):
    from gene2vec_tpu_torch.models.ggipnn_train import run_classification

    data = str(tmp_path / "data")
    w2v = _prediction_data(data)
    h = PreemptionHandler()
    logs = []

    def log(msg):
        logs.append(msg)
        if msg.startswith("epoch 1:"):
            h.trigger(signal.SIGTERM)

    assert run_classification(data, w2v, _ggipnn_config(), log=log, device="cpu",
                              preempt=h) == {"interrupted": True}
    assert "preemption requested; drained after epoch 1" in logs
    assert not any(m.startswith("epoch 2:") for m in logs)


def test_ggipnn_cli_exits_113_under_sigterm(tmp_path):
    data = str(tmp_path / "data")
    w2v = _prediction_data(data)
    run_dir = str(tmp_path / "run")
    argv = [sys.executable, "-m", "gene2vec_tpu_torch.cli.ggipnn", "--data-dir", data,
            "--emb", w2v, "--embedding-dim", "8", "--batch-size", "16", "--num-epochs",
            "200", "--evaluate-every", "5", "--checkpoint-every", "1000", "--embed-train",
            "--run-dir", run_dir, "--device", "cpu"]
    r = chaos.run_cli_kill_on(argv, r"^step 10:", sig=signal.SIGTERM,
                              timeout=300, env=CHILD_ENV)
    assert r.returncode == EXIT_PREEMPTED, r.output[-2000:]
    assert "ggipnn has no resume path" in r.output and "AUC" not in r.output
    drained = int(r.output.split("drained after step ")[1].split()[0])
    assert drained >= 10
    assert os.listdir(os.path.join(run_dir, "checkpoints")) == [f"model-{drained}.npz"]
    assert _manifest(run_dir)["interrupted"] is True


# -- the budget and the scans -------------------------------------------------------


def test_async_overhead_budget_entry_is_honest():
    """The port's copy of the reference's ``resilience.async_ckpt`` budget:
    the GPU smoke run's overhead gate reads it."""
    from gene2vec_tpu.analysis.passes_hlo import load_budgets

    with open(os.path.join(ROOT, "gene2vec_tpu_torch", "obs", "budgets.json")) as f:
        entry = json.load(f)["resilience"]["async_ckpt"]
    assert entry == load_budgets()["resilience"]["async_ckpt"]
    assert entry["max_overhead_fraction"] <= 0.02
    assert entry["reference_overhead_fraction"] <= entry["max_overhead_fraction"]
    assert entry["txt_output"] is False


RESILIENCE_MODULES = {"gene2vec_tpu_torch.resilience." + m for m in (
    "snapshot", "preempt", "async_writer", "chaos", "faults")}


def test_sources_scan_covers_the_resilience_slice():
    from test_torch_isolation import _port_modules, _port_sources

    scanned = {os.path.relpath(p, ROOT) for p in _port_sources()}
    assert RESILIENCE_MODULES <= set(_port_modules())
    for mod in RESILIENCE_MODULES:
        assert mod.replace(".", "/") + ".py" in scanned
    assert "chip_smoke.py" in scanned
    import gene2vec_tpu.resilience as ref
    import gene2vec_tpu_torch.resilience as port

    for name in ("EXIT_PREEMPTED", "PreemptionHandler", "MANIFEST_SUFFIX", "VerifyResult",
                 "verify_manifest", "write_manifest"):
        assert hasattr(ref, name) and hasattr(port, name)
