"""The port's run-report tooling (``cli/obs.py``, ``obs/report.py``,
``obs/ledger.py``, ``obs/timeline.py``'s Chrome-trace export,
``obs/trace.py:read_events``) and its compile watcher, held against the
JAX package on the CPU.

All of it is host bookkeeping over files, so the bar is equality: the same
ledger records and regression evaluations over the repo root, byte-equal
JSONL and CSV, the same trace document (apart from the producer's name),
the same exit codes.  The run reports compare a tiny planted corpus trained
by both packages with ``kernel_profile``: the same keys, phases, span
counts and pairs, and the same report lines once the numbers are masked.
"""

import contextlib
import io
import json
import os
import re
import shutil
import types

import pytest
import torch

from gene2vec_tpu.analysis.passes_hlo import load_budgets
from gene2vec_tpu.cli import obs as ref_cli
from gene2vec_tpu.config import SGNSConfig as JConfig
from gene2vec_tpu.eval import planted as jplanted
from gene2vec_tpu.obs import ledger as ref_ledger
from gene2vec_tpu.obs import report as ref_report
from gene2vec_tpu.obs import timeline as ref_timeline
from gene2vec_tpu.obs import trace as ref_trace
from gene2vec_tpu.sgns.train import SGNSTrainer as JTrainer
from gene2vec_tpu_torch.cli import obs as port_cli
from gene2vec_tpu_torch.config import SGNSConfig
from gene2vec_tpu_torch.eval import planted
from gene2vec_tpu_torch.kernels import build
from gene2vec_tpu_torch.obs import ledger, probes, report, timeline, trace
from gene2vec_tpu_torch.obs.run import Run
from gene2vec_tpu_torch.sgns.train import SGNSTrainer

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PAIRS_PER = 200
SMALL = dict(dim=16, batch_pairs=128, strat_head=32, strat_block=64, strat_group=32,
             positive_head=8, positive_mid=24, num_iters=2, txt_output=False,
             kernel_profile=True)
PKGS = {"port": (ledger, port_cli.main), "reference": (ref_ledger, ref_cli.main)}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """{"port": run dir, "reference": run dir}: the same planted corpus
    trained by each package's SGNS trainer with ``kernel_profile``, each
    run dir the one entry of its parent."""
    base = tmp_path_factory.mktemp("runs")
    # spans that earlier tests in this process buffered outside any run
    # (servers, writers) would land in the next run's events: drop them
    for mod in (trace, ref_trace):
        with mod._pending_lock:
            mod._pending.clear()
    _, corpus = planted.planted_corpus(pairs_per=PAIRS_PER)
    _, jcorpus = jplanted.planted_corpus(pairs_per=PAIRS_PER)
    out = {"port": str(base / "port" / "run"), "reference": str(base / "reference" / "run")}
    SGNSTrainer(corpus, SGNSConfig(**SMALL), device="cpu").run(out["port"], log=lambda m: None)
    JTrainer(jcorpus, JConfig(**SMALL)).run(out["reference"], log=lambda m: None)
    return out


def _call(main, argv):
    """(exit code, stdout, stderr) of one CLI call in process."""
    out, err = io.StringIO(), io.StringIO()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
        rc = main(argv)
    return rc, out.getvalue(), err.getvalue()


def _unproduced(doc):
    """A trace document without its producer's name."""
    doc = json.loads(json.dumps(doc))
    doc["otherData"].pop("producer")
    return doc


# -- the ledger --------------------------------------------------------------------


def test_ingest_root_over_the_repo_equals_the_references():
    ours = ledger.ingest_root(REPO)
    assert ours == ref_ledger.ingest_root(REPO)
    matched = [n for n in os.listdir(REPO)
               if os.path.isfile(os.path.join(REPO, n)) and ledger.match_family(n)]
    assert len(ours) == len(matched) >= 31
    assert len({r["family"] for r in ours}) >= 19
    assert [r["source"] for r in ours if r.get("error")] == []
    assert ledger.SCHEMA == ref_ledger.SCHEMA
    assert ([(p.pattern, f) for p, f, _ in ledger.ADAPTERS]
            == [(p.pattern, f) for p, f, _ in ref_ledger.ADAPTERS])


def test_budgets_hold_the_references_regression_block_and_nothing_else():
    with open(ledger.BUDGETS_PATH) as f:
        doc = json.load(f)
    ref = load_budgets()
    assert doc == {"perf": {"regression": ref["perf"]["regression"]},
                   "resilience": {"async_ckpt": ref["resilience"]["async_ckpt"]}}
    assert ledger.regression_rules() == doc["perf"]["regression"]


def _planted_series(tmp_path, values, name="BENCH_r{:02d}.json"):
    for i, v in enumerate(values, start=1):
        (tmp_path / name.format(i)).write_text(json.dumps(_fake_bench(v)))
    return str(tmp_path)


@pytest.mark.parametrize("root", ["repo", "collapse", "healthy"])
def test_detect_regressions_under_each_packages_rules_are_equal(tmp_path, root):
    if root == "repo":
        path = REPO
    else:
        path = _planted_series(tmp_path, [4e6, 5e6, 6e6, 6.5e6]
                               + ([2e6] if root == "collapse" else [6.2e6]))
    ours = ledger.detect_regressions(ledger.ingest_root(path), ledger.regression_rules())
    theirs = ref_ledger.detect_regressions(ref_ledger.ingest_root(path),
                                           load_budgets()["perf"]["regression"])
    assert ours == theirs
    assert any(e["regressed"] for e in ours) == (root == "collapse")


def test_write_jsonl_and_csv_are_byte_identical(tmp_path):
    records = ledger.ingest_root(REPO)
    files = {}
    for pkg, (mod, _) in PKGS.items():
        mod.write_jsonl(records, str(tmp_path / f"{pkg}.jsonl"))
        mod.write_csv(records, str(tmp_path / f"{pkg}.csv"))
        files[pkg] = [(tmp_path / f"{pkg}.{ext}").read_bytes() for ext in ("jsonl", "csv")]
    assert files["port"] == files["reference"]
    assert len(files["port"][0].splitlines()) == len(records)


# the reference's planted cases (tests/test_perf_plane.py), run against each package


def _fake_bench(value, rc=0):
    return {
        "n": 1, "cmd": "python bench.py", "rc": rc, "tail": "",
        "parsed": {"metric": "sgns_pairs_per_sec", "value": value, "unit": "pairs/s"},
    }


_RULES = {
    "window": 4, "min_points": 3,
    "metrics": {"sgns_pairs_per_sec": {"direction": "higher", "max_regression_frac": 0.3}},
}


def _case_median_of_band(tmp_path, led, main):
    (ev,) = led.detect_regressions(
        led.ingest_root(_planted_series(tmp_path, [4e6, 5e6, 6e6, 6.5e6])), _RULES)
    assert not ev["regressed"]
    (ev,) = led.detect_regressions(
        led.ingest_root(_planted_series(tmp_path, [4e6, 5e6, 6e6, 6.5e6, 2e6])), _RULES)
    assert ev["regressed"] and ev["newest_source"] == "BENCH_r05.json"
    assert ev["band_median"] == pytest.approx(5.5e6)
    # one outlier round in the band cannot fake a regression
    (ev,) = led.detect_regressions(
        led.ingest_root(_planted_series(tmp_path, [4e6, 0.1e6, 6e6, 6.5e6, 6.2e6])), _RULES)
    assert not ev["regressed"]


def _case_short_series_skipped(tmp_path, led, main):
    (ev,) = led.detect_regressions(led.ingest_root(_planted_series(tmp_path, [4e6, 5e6])),
                                   _RULES)
    assert not ev["regressed"] and "skipped" in ev


def _case_lower_is_better(tmp_path, led, main):
    rules = {"window": 4, "min_points": 3, "metrics": {"serve_p50_ms_min_load": {
        "direction": "lower", "max_regression_frac": 0.5}}}
    for i, p50 in enumerate([20.0, 22.0, 21.0, 80.0], start=1):
        (tmp_path / f"BENCH_SERVE_r{i:02d}.json").write_text(json.dumps(
            {"bench": "serve_loadgen", "levels": [
                {"offered_rps": 50.0, "p50_ms": p50, "p99_ms": p50 * 3,
                 "rejection_rate": 0.0, "errors": 0}]}))
    (ev,) = led.detect_regressions(led.ingest_root(str(tmp_path)), rules)
    assert ev["regressed"]


def _case_unreadable_artifact(tmp_path, led, main):
    (tmp_path / "BENCH_r01.json").write_text("{not json")
    (rec,) = led.ingest_root(str(tmp_path))
    assert rec["error"] and rec["metrics"] == {}


def _case_jsonl_and_csv(tmp_path, led, main):
    for name in os.listdir(REPO):
        if led.match_family(name) and os.path.isfile(os.path.join(REPO, name)):
            shutil.copy(os.path.join(REPO, name), tmp_path / name)
    records = led.ingest_root(str(tmp_path))
    led.write_jsonl(records, str(tmp_path / "ledger.jsonl"))
    led.write_csv(records, str(tmp_path / "ledger.csv"))
    lines = (tmp_path / "ledger.jsonl").read_text().strip().splitlines()
    assert len(lines) == len(records)
    assert all(json.loads(ln)["schema"] == led.SCHEMA for ln in lines)
    header = (tmp_path / "ledger.csv").read_text().splitlines()[0].split(",")
    assert {"family", "source", "round", "headline_metric", "sgns_pairs_per_sec"} <= set(header)


def _case_cli_check(tmp_path, led, main):
    def stage(name, values):
        root = tmp_path / name
        root.mkdir()
        _planted_series(root, values)
        shutil.copy(os.path.join(REPO, "BENCH_PERF_r10.json"), root / "BENCH_PERF_r10.json")
        return str(root)

    out = tmp_path / "ledger.jsonl"
    rc, _, _ = _call(main, ["ledger", stage("clean", [4e6, 5e6, 6e6, 6.5e6]), "--check",
                            "--out", str(out)])
    assert rc == 0 and out.exists()
    rc, _, err = _call(main, ["ledger", stage("bad", [4e6, 5e6, 6e6, 6.5e6, 2e6]), "--check"])
    assert rc == 1 and "REGRESSION sgns_pairs_per_sec" in err


def _case_provenance_stamps(tmp_path, led, main):
    doc = led.provenance_stamp({"metric": "sgns_pairs_per_sec", "value": 1.0})
    assert doc["schema_version"] == 1 and "command" in doc and "created_unix" in doc
    (tmp_path / "BENCH_r01.json").write_text(json.dumps(
        {**_fake_bench(5e6), "schema_version": 1, "command": "python bench.py"}))
    (rec,) = led.ingest_root(str(tmp_path))
    assert rec["legacy_unstamped"] is False and rec["producer"] == "python bench.py"
    # a wrapper storing the bench's stdout document under "parsed" keeps its stamps
    (tmp_path / "BENCH_r02.json").write_text(json.dumps(
        {"n": 1, "cmd": "wrapper", "rc": 0, "tail": "",
         "parsed": {**_fake_bench(6e6)["parsed"], **led.provenance_stamp({})}}))
    rec2 = [r for r in led.ingest_root(str(tmp_path)) if r["source"] == "BENCH_r02.json"][0]
    assert rec2["legacy_unstamped"] is False and rec2["producer"]
    assert rec2["created_unix"] == pytest.approx(
        json.loads((tmp_path / "BENCH_r02.json").read_text())["parsed"]["created_unix"])


CASES = {
    "median_of_band": _case_median_of_band,
    "short_series_skipped": _case_short_series_skipped,
    "lower_is_better": _case_lower_is_better,
    "unreadable_artifact": _case_unreadable_artifact,
    "jsonl_and_csv": _case_jsonl_and_csv,
    "cli_check": _case_cli_check,
    "provenance_stamps": _case_provenance_stamps,
}


@pytest.mark.parametrize("pkg", sorted(PKGS))
@pytest.mark.parametrize("case", sorted(CASES))
def test_planted_ledger_cases(tmp_path, case, pkg):
    CASES[case](tmp_path, *PKGS[pkg])


# -- the trace export ----------------------------------------------------------------


def _synthetic():
    tl = timeline.PhaseTimeline()
    for step in range(3):
        for name in ("host_ingest", "dispatch", "compute"):
            tl.add(name, 0.01, step=step, wall=1000.0 + step)
    tl.add("ckpt_stage", -0.5, step=3, wall=1004.0, mode="sync")
    spans = [
        {"type": "span_start", "name": "iteration", "wall": 1002.0, "pid": 42, "tid": 7},
        {"type": "span_end", "name": "iteration", "wall": 1003.0, "dur": 1.0, "pid": 42,
         "tid": 7, "attrs": {"loss": 1.0}},
        {"type": "span_end", "name": "batch_item", "wall": 1003.5, "dur": 0.1, "pid": 43,
         "tid": 8, "hop": True, "trace": "ab" * 16},
        {"type": "event", "name": "probe", "wall": 1004.0, "pid": 42, "tid": 7,
         "attrs": {"rss": 1}},
        {"type": "stall", "name": "stall", "wall": 1004.5, "pid": 42, "tid": 7},
        {"type": "span_end", "name": "buffered", "wall": 999.0, "dur": None, "pid": 42,
         "tid": 9},
    ]
    return tl.records(), spans


def _records_of(run_dir):
    return (timeline.read_timeline(os.path.join(run_dir, timeline.TIMELINE_NAME)),
            trace.read_events(os.path.join(run_dir, "events.jsonl")))


@pytest.mark.parametrize("inputs", ["synthetic", "port_run", "reference_run", "empty"])
def test_chrome_trace_equals_the_references(runs, inputs):
    if inputs == "synthetic":
        recs, spans = _synthetic()
    elif inputs == "empty":
        recs, spans = [], []
    else:
        recs, spans = _records_of(runs[inputs[:-4]])
    names = {42: "sgns (pid 42)"}
    ours = timeline.chrome_trace(recs, spans, process_names=names)
    theirs = ref_timeline.chrome_trace(recs, spans, process_names=names)
    assert ours["otherData"]["producer"] == "gene2vec_tpu_torch.obs.timeline"
    assert _unproduced(ours) == _unproduced(theirs)
    for e in ours["traceEvents"]:
        assert e["ph"] != "X" or (e["ts"] >= 0 and e["dur"] >= 0)


@pytest.mark.parametrize("which", ["port", "reference", "parent"])
def test_collect_run_equals_the_references(runs, which):
    path = os.path.dirname(os.path.dirname(runs["port"])) if which == "parent" else runs[which]
    ours = timeline.collect_run(path)
    assert _unproduced(ours) == _unproduced(ref_timeline.collect_run(path))
    assert {"host_ingest", "dispatch", "compute", "ckpt_stage"} <= set(
        ours["otherData"]["phase_tracks"])
    labels = [e["args"]["name"] for e in ours["traceEvents"]
              if e["ph"] == "M" and e["name"] == "process_name"]
    assert any(v.startswith("sgns (pid ") for v in labels)


def test_read_events_equals_the_references(tmp_path):
    path = tmp_path / "events.jsonl"
    lines = [json.dumps({"type": "event", "name": n, "wall": w})
             for n, w in (("b", 2.0), ("a", 1.0), ("c", 3.0))]
    lines.insert(1, "")
    lines.append(json.dumps({"type": "event", "name": "nowall"}))
    path.write_text("\n".join(lines) + '\n{"type": "span_end", "na')
    ours = trace.read_events(str(path))
    assert ours == ref_trace.read_events(str(path))
    assert [e["name"] for e in ours] == ["nowall", "a", "b", "c"]


# -- the run report ----------------------------------------------------------------


def test_summarize_matches_the_references(runs):
    ours, theirs = (report.summarize(runs[k]) for k in ("port", "reference"))
    assert sorted(ours) == sorted(theirs)
    assert list(ours["phases"]) == list(theirs["phases"])
    assert ({n: p["count"] for n, p in ours["phases"].items()}
            == {n: p["count"] for n, p in theirs["phases"].items()})
    assert ours["pairs_total"] == theirs["pairs_total"] > 0
    assert ours["pairs_per_sec"] > 0 and theirs["pairs_per_sec"] > 0
    assert ours["n_processes"] == theirs["n_processes"] == 1
    assert ours["goodput"].keys() == theirs["goodput"].keys()
    assert ([t["name"] for t in ours["kernels"]["top"]]
            == [t["name"] for t in theirs["kernels"]["top"]] == ["sgns_train_step"])
    # on the CPU the port reads no device memory (the reference's CPU arrays
    # are its device's)
    assert set(ours["peak"]) == set(theirs["peak"]) - {"hbm_bytes"}
    assert ours["stalls"] == theirs["stalls"] == []
    assert report.load_run(runs["port"]).keys() == ref_report.load_run(runs["port"]).keys()
    assert report.find_runs(os.path.dirname(runs["port"])) == [runs["port"]]


_NUMBER = re.compile(r"\d[\d,.]*(\s?(min|ms|s|B|KiB|MiB|GiB|TiB)\b)?")


def _masked(text, run_dir):
    """The report's lines with the run dir and every number (with its unit)
    masked and runs of spaces folded; the backend line and device-memory peak
    dropped (torch's device facts, not jax's), the bound word masked (the
    two profilers count their work differently, by design)."""
    out = []
    for line in text.replace(run_dir, "<run>").splitlines():
        if line.startswith("backend:") or line.startswith("peak hbm_bytes"):
            continue
        line = re.sub(r"\[\w+-bound\]", "[?-bound]", line)
        line = re.sub(r"config hash: \w+", "config hash: <hash>", line)
        out.append(" ".join(_NUMBER.sub("#", line).split()))
    return sorted(out)


def test_format_report_prints_the_same_lines_up_to_the_numbers(runs):
    ours = report.format_report(runs["port"])
    theirs = ref_report.format_report(runs["reference"])
    assert _masked(ours, runs["port"]) == _masked(theirs, runs["reference"])
    for want in ("goodput: compute", "throughput:", "kernels: 1 attributed",
                 "sgns_train_step", "stalls: none", "peak jit_compiles"):
        assert want in ours


# -- the CLI -------------------------------------------------------------------------


def _inputs(runs, tmp_path):
    """Each input the exit codes are compared on, as a copy in tmp_path."""
    empty = tmp_path / "empty"
    empty.mkdir()
    parent = tmp_path / "parent"
    shutil.copytree(os.path.dirname(runs["port"]), parent)
    bare = tmp_path / "bare"
    shutil.copytree(runs["port"], bare)
    os.remove(bare / "kernels.jsonl")
    return {"empty": str(empty), "nested": str(parent), "run": str(parent / "run"),
            "no_kernels": str(bare), "absent": str(tmp_path / "absent")}


CLI_CASES = [
    ("report", "empty"), ("report", "nested"), ("report", "run"), ("report", "absent"),
    ("report", "no_kernels"), ("report --json", "nested"),
    ("list", "empty"), ("list", "nested"), ("list", "absent"),
    ("timeline", "empty"), ("timeline", "absent"), ("timeline", "no_kernels"),
    ("timeline --out -", "run"), ("timeline --out -", "empty"),
    ("kernels", "empty"), ("kernels", "nested"), ("kernels", "run"), ("kernels", "absent"),
    ("kernels", "no_kernels"), ("kernels --json", "run"),
    ("ledger", "empty"), ("ledger", "absent"), ("ledger --check", "nested"),
]


@pytest.mark.parametrize("command,where", CLI_CASES, ids=lambda v: v.replace(" ", "_"))
def test_exit_codes_equal_the_references(runs, tmp_path, command, where):
    sub, *flags = command.split()
    path = _inputs(runs, tmp_path)[where]
    got = {}
    for pkg, (_, main) in PKGS.items():
        got[pkg] = _call(main, [sub, path, *flags])
    assert got["port"][0] == got["reference"][0]
    if command == "timeline --out -" and got["port"][0] == 0:
        assert (_unproduced(json.loads(got["port"][1]))
                == _unproduced(json.loads(got["reference"][1])))
    if sub == "list":
        assert got["port"][1] == got["reference"][1]


def test_timeline_writes_the_phase_tracks(runs, tmp_path):
    out = tmp_path / "trace.json"
    rc, said, _ = _call(port_cli.main, ["timeline", runs["port"], "--out", str(out)])
    assert rc == 0
    doc = json.loads(out.read_text())
    assert json.loads(said) == {"out": str(out), "trace_events": len(doc["traceEvents"]),
                                "phase_tracks": doc["otherData"]["phase_tracks"]}
    phases = [e for e in doc["traceEvents"] if e.get("cat") == "phase"]
    assert len(phases) == len(timeline.read_timeline(
        os.path.join(runs["port"], timeline.TIMELINE_NAME)))


@pytest.mark.parametrize("sub,args", [("trace", ["d", "ab" * 16]), ("alerts", ["d"]),
                                      ("incident", ["d"])])
def test_unported_subcommands_exit_2_with_their_message(sub, args):
    """Over a path that is no directory, ``trace``, ``alerts`` and
    ``incident`` exit 2 with the reference's message; what they read of a
    fleet's run dirs is held in ``test_torch_alerts.py`` and
    ``test_torch_tracing.py``."""
    rc, out, err = _call(port_cli.main, [sub, *args, "--json"])
    assert rc == 2 and out == ""
    assert err == f"obs {sub}: d is not a directory\n"
    assert (rc, out, err) == _call(ref_cli.main, [sub, *args, "--json"])


def test_obs_cli_runs_on_the_host_without_a_device(runs, tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for argv in (["report", runs["port"]], ["kernels", runs["port"]],
                 ["timeline", runs["port"], "--out", str(tmp_path / "t.json")],
                 ["ledger", REPO, "--check"]):
        assert _call(port_cli.main, argv)[0] == 0, argv
    assert not torch.cuda.is_initialized()


# -- the compile watcher -------------------------------------------------------------


@pytest.fixture
def fresh_tallies(monkeypatch):
    """build.py's tallies and loaded libraries as at a process start."""
    monkeypatch.setattr(build, "_events", {"nvcc_build": 0, "library_load": 0})
    monkeypatch.setattr(build, "_libs", {})
    monkeypatch.setattr(build, "_built", [0.0])
    monkeypatch.setattr(probes.CompileWatcher, "_installed", None)


class _FakeLib:
    def __init__(self, path):
        self.path = path
        self.g2v_error_string = types.SimpleNamespace()


def test_compile_watcher_install_is_idempotent(fresh_tallies):
    w = probes.CompileWatcher.install()
    assert probes.CompileWatcher.install() is w and w.supported is True
    assert w.events == {"nvcc_build": 0, "library_load": 0} and w.count == 0


def test_library_load_counts_each_new_library_once(fresh_tallies, monkeypatch, tmp_path):
    monkeypatch.setattr(build, "lib_path", lambda name: str(tmp_path / f"{name}.so"))
    monkeypatch.setattr(build.ctypes, "CDLL", _FakeLib)
    for name in ("k_fake", "k_other"):
        (tmp_path / f"{name}.so").write_bytes(b"")
    # a watcher installed after a load still counts it
    assert build.load("k_fake").path == str(tmp_path / "k_fake.so")
    w = probes.CompileWatcher.install()
    assert w.events == {"nvcc_build": 0, "library_load": 1}
    build.load("k_fake")
    assert w.events["library_load"] == 1
    build.load("k_other")
    assert w.events == {"nvcc_build": 0, "library_load": 2} and w.count == 2


def test_nvcc_build_counts_each_compiler_run(fresh_tallies, monkeypatch, tmp_path):
    nvcc = tmp_path / "nvcc"
    nvcc.write_text('#!/bin/sh\nwhile [ $# -gt 0 ]; do\n'
                    '  if [ "$1" = "-o" ]; then : > "$2"; fi\n  shift\ndone\n')
    nvcc.chmod(0o755)
    monkeypatch.setattr(build, "nvcc_path", lambda: str(nvcc))
    monkeypatch.setattr(build, "BUILD_DIR", str(tmp_path / "_build"))
    w = probes.CompileWatcher.install()
    paths = build.build_all()
    assert all(os.path.exists(p) for p in paths.values())
    assert w.events == {"nvcc_build": len(build.SOURCES), "library_load": 0}
    build.build_all()  # every library there: no compiler runs
    assert w.count == len(build.SOURCES)


def test_run_makes_sample_report_the_watchers_count(fresh_tallies, tmp_path):
    assert probes.sample()["jit_compiles"] is None
    with Run(str(tmp_path / "quiet"), probe_devices=False):
        assert probes.CompileWatcher._installed is None
    build._events["library_load"] = 3
    with Run(str(tmp_path / "run"), name="t") as run:
        assert probes.CompileWatcher._installed is not None
        assert run.probe()["jit_compiles"] == 3
        assert probes.sample()["jit_compiles"] == probes.CompileWatcher.install().count
    events = trace.read_events(str(tmp_path / "run" / "events.jsonl"))
    (probe,) = [e for e in events if e["name"] == "probe"]
    assert probe["attrs"]["jit_compiles"] == 3 and "hbm_bytes" not in probe["attrs"]


def _compile_counter(app):
    lines = [ln for ln in app.metrics.prometheus_text().splitlines()
             if ln.startswith("jit_compile_events_total ")]
    return float(lines[0].split()[1]) if lines else None


def test_serve_app_publishes_compile_events_only_when_they_grew(fresh_tallies, tmp_path):
    from gene2vec_tpu.serve.registry import ModelRegistry as JaxRegistry
    from gene2vec_tpu.serve.server import ServeApp as JaxApp
    from gene2vec_tpu.serve.server import ServeConfig as JaxConfig
    from gene2vec_tpu_torch.serve.registry import ModelRegistry
    from gene2vec_tpu_torch.serve.server import ServeApp, ServeConfig

    ours = ServeApp(ModelRegistry(str(tmp_path / "none"), device="cpu"), ServeConfig())
    assert ours._compile_watcher is probes.CompileWatcher.install()
    ours.publish_engine_metrics()
    assert _compile_counter(ours) is None  # no build, no load: no series
    build._events["library_load"] += 2
    ours.publish_engine_metrics()
    ours.publish_engine_metrics()
    assert _compile_counter(ours) == 2.0
    # the same count sequence through the reference's app and the port's
    theirs = JaxApp(JaxRegistry(str(tmp_path / "none")), JaxConfig())
    ours = ServeApp(ModelRegistry(str(tmp_path / "none"), device="cpu"), ServeConfig())
    readings = {"port": [], "reference": []}
    for count in (0, 0, 3, 3, 5, 5):
        for pkg, app in (("port", ours), ("reference", theirs)):
            app._compile_watcher = types.SimpleNamespace(count=count)
            app.publish_engine_metrics()
            readings[pkg].append(_compile_counter(app))
    assert readings["port"] == readings["reference"] == [None, None, 3.0, 3.0, 5.0, 5.0]
