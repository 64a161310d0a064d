"""A shutdown signal reaches ``cli.fleet`` whichever thread takes it.

The kernel may hand a process-directed SIGTERM or SIGINT to any thread
that does not block it.  CPython then runs the Python handler on the main
thread, but only once that thread is back in the interpreter: a main
thread parked in one long ``sleep`` never runs it, and the fleet serves
on until it is SIGKILLed.  Each test spawns the port's fleet over a CPU
replica, sends the signal to one of its helper threads with ``tgkill``
(``signal.pthread_kill`` reaches only the caller's own threads), and
holds the clean shutdown: exit 0 and "shutting down fleet" within the
drain timeout."""

import ctypes
import os
import platform
import signal
import subprocess
import sys
import time

import numpy as np
import pytest
import torch

from gene2vec_tpu_torch.io.checkpoint import save_iteration
from gene2vec_tpu_torch.io.vocab import Vocab
from gene2vec_tpu_torch.serve.fleet import read_contract_line
from gene2vec_tpu_torch.sgns.model import SGNSParams

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
#: the fleet's --drain-timeout: the whole shutdown must land inside it
DRAIN_TIMEOUT_S = 30.0
_SYS_TGKILL = {"x86_64": 234, "aarch64": 131}


def _tgkill(pid: int, tid: int, sig: int) -> None:
    libc = ctypes.CDLL(None, use_errno=True)
    if libc.syscall(_SYS_TGKILL[platform.machine()], pid, tid, int(sig)) != 0:
        raise OSError(ctypes.get_errno(), f"tgkill({pid}, {tid}, {sig})")


def _helper_threads(pid: int):
    return sorted(int(t) for t in os.listdir(f"/proc/{pid}/task") if int(t) != pid)


def _one_core():
    os.sched_setaffinity(0, {max(os.sched_getaffinity(0))})


@pytest.mark.skipif(platform.machine() not in _SYS_TGKILL or sys.platform != "linux",
                    reason="tgkill's syscall number is known for Linux x86_64 and aarch64")
@pytest.mark.parametrize("sig", [signal.SIGTERM, signal.SIGINT], ids=["SIGTERM", "SIGINT"])
def test_signal_to_a_helper_thread_shuts_the_fleet_down(tmp_path, sig):
    export = tmp_path / "export"
    rng = np.random.RandomState(7)
    save_iteration(str(export), 8, 1,
                   SGNSParams(torch.from_numpy(rng.randn(16, 8).astype(np.float32)),
                              torch.zeros(16, 8)),
                   Vocab([f"G{i}" for i in range(16)], np.arange(16, 0, -1)),
                   txt_output=False)
    err_path = tmp_path / "fleet.err"
    env = dict(os.environ, OMP_NUM_THREADS="1", PYTHONPATH=REPO)
    with open(err_path, "w") as err:
        proc = subprocess.Popen(
            [sys.executable, "-m", "gene2vec_tpu_torch.cli.fleet", "--export-dir",
             str(export), "--port", "0", "--replicas", "1", "--alert-rules", "none",
             "--scrape-interval", "0.2", "--drain-timeout", str(DRAIN_TIMEOUT_S),
             "--run-dir", str(tmp_path / "run"), "--serve-arg=--device",
             "--serve-arg=cpu"],
            stdout=subprocess.PIPE, stderr=err, text=True, env=env, cwd=REPO,
            preexec_fn=_one_core)
    try:
        info = read_contract_line(proc, 240.0)
        helpers = _helper_threads(proc.pid)
        assert helpers, "the fleet runs helper threads (proxy, monitor, aggregator)"
        # the newest helper: a handler-pool worker or the aggregator, never
        # the main thread
        _tgkill(proc.pid, helpers[-1], sig)
        try:
            rc = proc.wait(timeout=DRAIN_TIMEOUT_S)
        except subprocess.TimeoutExpired:
            rc = None
        assert rc == 0, f"fleet still up {DRAIN_TIMEOUT_S}s after {sig.name} to a helper"
        assert "shutting down fleet" in err_path.read_text()
        # the replica went down with it
        deadline = time.monotonic() + 10.0
        while time.monotonic() < deadline:
            try:
                os.kill(info["replica_pids"][0], 0)
            except ProcessLookupError:
                break
            time.sleep(0.1)
        else:
            pytest.fail("the replica outlived its fleet")
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait(timeout=30)
        for pid in info.get("replica_pids", []) if "info" in locals() else []:
            try:
                os.kill(pid, signal.SIGKILL)
            except ProcessLookupError:
                pass
