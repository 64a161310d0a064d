"""A real sharded ``cli.fleet --shard-by-rows 2 --jobs-dir`` over CPU
replicas of the port: a full-vocab ``knn_graph`` job submitted through
``/v1/jobs`` survives a SIGKILL of the front door and its replicas
mid-build, and the fleet restarted on the same jobs dir finishes it to
the bytes of an uninterrupted control built through the same scatter
path.  ``cli.batch`` submits, waits and fetches (the fetch checks the
manifest CRC), and the unchanged reference ``load_graph`` reads the
fetched artifact.  The fleets run pinned to one CPU core."""

import json
import os
import signal
import subprocess
import sys
import time
import urllib.request

import numpy as np
import torch

from gene2vec_tpu.batch.artifact import load_graph as ref_load_graph
from gene2vec_tpu_torch.cli import batch as batch_cli
from gene2vec_tpu_torch.io.checkpoint import save_iteration
from gene2vec_tpu_torch.io.vocab import Vocab
from gene2vec_tpu_torch.serve.fleet import read_contract_line
from gene2vec_tpu_torch.sgns.model import SGNSParams

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
V, D, K = 400, 8, 5


def _spawn(tmp_path, export, jobs, tag):
    env = dict(os.environ, OMP_NUM_THREADS="1", PYTHONPATH=REPO)
    err_path = tmp_path / f"fleet_{tag}.err"
    with open(err_path, "w") as err:
        proc = subprocess.Popen(
            [sys.executable, "-m", "gene2vec_tpu_torch.cli.fleet", "--export-dir",
             str(export), "--port", "0", "--run-dir", str(tmp_path / f"run_{tag}"),
             "--shard-by-rows", "2", "--jobs-dir", str(jobs), "--device", "cpu",
             "--alert-rules", "none", "--scrape-interval", "0.25",
             "--health-interval", "0.2", "--serve-arg=--device", "--serve-arg=cpu",
             "--serve-arg=--cache-size", "--serve-arg=0"],
            stdout=subprocess.PIPE, stderr=err, text=True, env=env, cwd=REPO,
            preexec_fn=lambda: os.sched_setaffinity(0, {max(os.sched_getaffinity(0))}))
    try:
        return proc, read_contract_line(proc, 240.0)
    except Exception:
        proc.kill()
        proc.wait(timeout=30)
        raise AssertionError(err_path.read_text()[-3000:])


def _status(url, job_id):
    with urllib.request.urlopen(f"{url}/v1/jobs/{job_id}", timeout=30) as r:
        return json.loads(r.read())


def _batch(capsys, *argv):
    rc = batch_cli.main(list(argv))
    return rc, json.loads(capsys.readouterr().out.strip().splitlines()[-1])


def test_sharded_jobs_fleet_killed_mid_graph_resumes_byte_identical(tmp_path, capsys):
    export, jobs = tmp_path / "export", tmp_path / "jobs"
    emb = np.random.RandomState(21).randn(V, D).astype(np.float32)
    save_iteration(str(export), D, 1, SGNSParams(torch.from_numpy(emb), torch.zeros(V, D)),
                   Vocab([f"G{i}" for i in range(V)], np.arange(V, 0, -1)),
                   txt_output=False)
    proc, info = _spawn(tmp_path, export, jobs, "first")
    try:
        assert info["jobs_dir"] == str(jobs) and info["shards"]["num_shards"] == 2
        rc, doc = _batch(capsys, "submit", "--url", info["url"], "--type", "knn_graph",
                         "--k", str(K), "--chunk-rows", "4", "--job-id", "graph")
        assert rc == 0 and doc["state"] in ("pending", "running")
        deadline = time.monotonic() + 60.0
        done = 0
        while time.monotonic() < deadline:
            done = _status(info["url"], "graph").get("records_done") or 0
            if done >= 40:
                break
            time.sleep(0.02)
        assert 40 <= done < V, f"the kill must land mid-build ({done} of {V} rows)"
    finally:
        # the front door and its replicas die at once, no drain
        proc.kill()
        proc.wait(timeout=30)
        for pid in info["replica_pids"]:
            try:
                os.kill(pid, signal.SIGKILL)
            except ProcessLookupError:
                pass
    journal = json.loads((jobs / "graph" / "JOB.json").read_text())
    assert journal["state"] == "running" and journal["records_done"] < V

    proc, info = _spawn(tmp_path, export, jobs, "second")
    url = info["url"]
    try:
        # the restarted front door resumes the job first; the control is
        # the same job uninterrupted, through the same scatter path
        rc, doc = _batch(capsys, "submit", "--url", url, "--type", "knn_graph", "--k",
                         str(K), "--chunk-rows", "4", "--job-id", "control", "--wait",
                         "--poll-s", "0.1", "--timeout-s", "90", "--out",
                         str(tmp_path / "control"))
        assert rc == 0 and doc["state"] == "done", doc
        assert doc["fetch"]["records"] == V
        rc, doc = _batch(capsys, "status", "--url", url, "--job-id", "graph")
        assert rc == 0 and doc["state"] == "done", doc
        assert 0 < doc["result"]["resumed_records"] < V
        rc, doc = _batch(capsys, "fetch", "--url", url, "--job-id", "graph", "--out",
                         str(tmp_path / "fetched"))
        assert rc == 0 and doc["records"] == V
        rc, doc = _batch(capsys, "list", "--url", url)
        assert rc == 0 and [j["job_id"] for j in doc["jobs"]] == ["graph", "control"]
        rc, doc = _batch(capsys, "cancel", "--url", url, "--job-id", "graph")
        assert rc == 1 and doc["state"] == "done"
    finally:
        proc.send_signal(signal.SIGTERM)
        try:
            proc.wait(timeout=60)
        except subprocess.TimeoutExpired:
            proc.kill()
            proc.wait(timeout=30)
    assert proc.returncode == 0
    for name in ("DATA.bin", "TOKENS.txt"):
        resumed = (jobs / "graph" / name).read_bytes()
        assert resumed == (jobs / "control" / name).read_bytes()
        assert resumed == (tmp_path / "fetched" / name).read_bytes()
        assert resumed == (tmp_path / "control" / name).read_bytes()
    tokens, ids, scores, meta = ref_load_graph(str(tmp_path / "fetched"))
    assert tokens == [f"G{i}" for i in range(V)] and ids.shape == (V, K)
    assert meta["type"] == "knn_graph" and meta["iteration"] == 1
    # every record is the exact graph: the ids' scores are the table's
    unit = emb.astype(np.float64)
    unit /= np.linalg.norm(unit, axis=1, keepdims=True)
    sims = unit @ unit.T
    np.fill_diagonal(sims, -np.inf)
    want = -np.sort(-sims, axis=1)[:, :K]
    np.testing.assert_allclose(np.take_along_axis(sims, ids.astype(np.int64), 1), want,
                               rtol=0, atol=2e-6)
