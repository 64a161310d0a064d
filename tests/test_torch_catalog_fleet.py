"""A real two-model ``cli.fleet --catalog`` over CPU replicas of the port.

One replica a pool, autoscale bounds 1-2, a 0.25 s scrape: the default
model is hot-swapped from iteration 1 to 2 under verified load on both
models, and a ramp on the second model alone scales its pool to 2 while
the first stays at 1.  Every answer is checked against the model that
gave it: its ``model.name``, and neighbour ids and scores of that model's
own table at the iteration it reports (no wrong, mixed or cross-model
answer).  The fleet and its replicas run pinned to one CPU core."""

import json
import os
import signal
import subprocess
import sys
import threading
import time
import urllib.error
import urllib.request

import numpy as np
import torch

from gene2vec_tpu_torch.io.checkpoint import save_iteration
from gene2vec_tpu_torch.io.vocab import Vocab
from gene2vec_tpu_torch.serve.fleet import read_contract_line
from gene2vec_tpu_torch.sgns.model import SGNSParams

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
V, K = 32, 4
DIMS = {"alpha": 8, "beta": 16}
#: a served score against a float64 oracle: float32 dots rounded to 6 decimals
SCORE_TOL = 2e-6


def _write(export_dir, dim, iteration, seed, oracles, model):
    """Save one iteration, its oracle registered before the checkpoint
    exists (a replica may serve it the moment it lands)."""
    emb = np.random.RandomState(seed).randn(V, dim).astype(np.float32)
    unit = emb.astype(np.float64)
    oracles[(model, iteration)] = unit / np.linalg.norm(unit, axis=1, keepdims=True)
    save_iteration(str(export_dir), dim, iteration,
                   SGNSParams(torch.from_numpy(emb), torch.zeros(V, dim)),
                   Vocab([f"G{i}" for i in range(V)], np.arange(V, 0, -1)),
                   txt_output=False)


def _post(url, body, timeout=30.0):
    req = urllib.request.Request(url, data=json.dumps(body).encode(),
                                 headers={"Content-Type": "application/json"})
    try:
        with urllib.request.urlopen(req, timeout=timeout) as r:
            return r.status, json.loads(r.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read() or b"{}")
    except OSError:
        return 0, {}


def _get(url, timeout=10.0):
    with urllib.request.urlopen(url, timeout=timeout) as r:
        return r.read().decode()


def _counter(text, name):
    for line in text.splitlines():
        if line.startswith(name + " "):
            return float(line.split()[1])
    return 0.0


class Checker:
    """Verifies every answer against the oracle of the model and the
    iteration it reports."""

    def __init__(self, oracles):
        self.oracles = oracles  # (model, iteration) -> unit rows
        self.lock = threading.Lock()
        self.ok = self.wrong = self.cross = self.shed = self.failed = 0
        self.iterations = {m: set() for m in DIMS}

    def check(self, model, gene, status, doc):
        with self.lock:
            if status in (429, 503):
                self.shed += 1
                return
            if status != 200:
                self.failed += 1
                return
            name, it = doc["model"].get("name"), doc["model"]["iteration"]
            if name != model or doc["model"]["dim"] != DIMS[model]:
                self.cross += 1
                return
            unit = self.oracles.get((model, it))
            row = int(gene[1:])
            s = unit @ unit[row]
            s[row] = -np.inf
            want = np.sort(s)[::-1][:K]
            got = doc["results"][0]["neighbors"]
            good = len(got) == K and all(
                abs(n["score"] - s[int(n["gene"][1:])]) <= SCORE_TOL
                and abs(n["score"] - w) <= SCORE_TOL for n, w in zip(got, want))
            if good:
                self.ok += 1
                self.iterations[model].add(it)
            else:
                self.wrong += 1


def _load(url, model, checker, stop, pause_s, seed):
    rng = np.random.RandomState(seed)
    while not stop.is_set():
        gene = f"G{rng.randint(V)}"
        status, doc = _post(f"{url}/v1/{model}/similar", {"genes": [gene], "k": K})
        checker.check(model, gene, status, doc)
        if pause_s:
            time.sleep(pause_s)


def test_catalog_fleet_swap_and_ramp(tmp_path):
    oracles = {}
    _write(tmp_path / "a", 8, 1, 1, oracles, "alpha")
    _write(tmp_path / "b", 16, 1, 2, oracles, "beta")
    spec = tmp_path / "catalog.json"
    spec.write_text(json.dumps({"default": "alpha", "models": {
        "alpha": {"export_dir": "a", "dim": 8},
        "beta": {"export_dir": "b", "dim": 16}}}))
    env = dict(os.environ, OMP_NUM_THREADS="1", PYTHONPATH=REPO)
    err_path = tmp_path / "fleet.err"
    with open(err_path, "w") as err:
        proc = subprocess.Popen(
            [sys.executable, "-m", "gene2vec_tpu_torch.cli.fleet", "--export-dir",
             str(tmp_path / "a"), "--catalog", str(spec), "--port", "0",
             "--run-dir", str(tmp_path / "run"), "--min-replicas", "1",
             "--max-replicas", "2", "--scrape-interval", "0.25", "--scale-up-after", "2",
             "--scale-up-queue", "4", "--scale-up-rejection", "0.02",
             "--scale-down-after", "1000", "--scale-cooldown", "1", "--alert-rules", "none",
             "--proxy-workers", "64", "--proxy-timeout-ms", "4000",
             "--health-interval", "0.2", "--serve-arg=--device", "--serve-arg=cpu",
             "--serve-arg=--cache-size", "--serve-arg=0", "--serve-arg=--max-delay-ms",
             "--serve-arg=100", "--serve-arg=--max-batch", "--serve-arg=4",
             "--serve-arg=--max-queue", "--serve-arg=8", "--serve-arg=--http-workers",
             "--serve-arg=32", "--serve-arg=--poll-interval", "--serve-arg=0.5"],
            stdout=subprocess.PIPE, stderr=err, text=True, env=env, cwd=REPO,
            preexec_fn=lambda: os.sched_setaffinity(0, {max(os.sched_getaffinity(0))}))
    stop = threading.Event()
    threads = []
    try:
        try:
            info = read_contract_line(proc, 240.0)
        except Exception:
            raise AssertionError(err_path.read_text()[-3000:])
        url = info["url"]
        assert info["catalog"]["default"] == "alpha"
        assert {m: v["replicas"] for m, v in info["catalog"]["models"].items()} == {
            "alpha": 1, "beta": 1}
        health = json.loads(_get(url + "/healthz"))
        assert health["default_model"] == "alpha" and health["models"]["beta"]["up"] == 1
        # an unknown model 404s at the door; unprefixed routes serve the default
        assert _post(url + "/v1/gamma/similar", {"genes": ["G1"], "k": K})[0] == 404
        status, doc = _post(url + "/v1/similar", {"genes": ["G1"], "k": K})
        assert status == 200 and doc["model"]["name"] == "alpha"

        checker = Checker(oracles)
        # two paced verified workers on each model through the swap
        for i, model in enumerate(("alpha", "alpha", "beta", "beta")):
            threads.append(threading.Thread(
                target=_load, args=(url, model, checker, stop, 0.02, i), daemon=True))
        for t in threads:
            t.start()
        time.sleep(1.0)
        _write(tmp_path / "a", 8, 2, 3, oracles, "alpha")
        deadline = time.monotonic() + 30.0
        while 2 not in checker.iterations["alpha"] and time.monotonic() < deadline:
            time.sleep(0.1)
        assert 2 in checker.iterations["alpha"], "the default model never swapped"

        # the ramp: 48 workers on the second model only
        ramp = threading.Event()
        for i in range(48):
            threads.append(threading.Thread(
                target=_load, args=(url, "beta", checker, ramp, 0.0, 100 + i), daemon=True))
            threads[-1].start()
        deadline = time.monotonic() + 60.0
        while time.monotonic() < deadline:
            health = json.loads(_get(url + "/healthz"))
            if health["models"]["beta"]["up"] == 2:
                break
            time.sleep(0.25)
        ramp.set()
        metrics = _get(url + "/metrics")
        assert _counter(metrics, "fleet_scale_up_total") >= 1
        assert health["models"]["beta"]["up"] == 2, health["models"]
        assert health["models"]["alpha"]["up"] == 1 and len(
            health["models"]["alpha"]["replicas"]) == 1
        time.sleep(0.5)
        stop.set()
        for t in threads:
            t.join(timeout=30)
        assert checker.wrong == 0 and checker.cross == 0 and checker.failed == 0, vars(checker)
        assert checker.ok > 100
        assert checker.iterations["beta"] == {1}
        assert 'fleet_proxy_seconds_count{model="beta",route="/v1/similar"}' in metrics
    finally:
        stop.set()
        proc.send_signal(signal.SIGTERM)
        try:
            proc.wait(timeout=60)
        except subprocess.TimeoutExpired:
            proc.kill()
            proc.wait(timeout=30)
    assert proc.returncode == 0
    assert "shutting down fleet" in err_path.read_text()
