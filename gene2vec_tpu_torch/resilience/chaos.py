"""Fault injection for checkpoint/serve resilience drills — a copy of
``gene2vec_tpu/resilience/chaos.py``.

Two kinds of tools, both used by the resilience tests and the GPU smoke
run's resilience phase:

* **byte-level injectors** that manufacture the failures the snapshot
  manifests exist to catch — truncation, bit rot, a stale CRC, a
  checkpoint deleted out from under a watcher poll;
* **a child-process harness** that runs the *real* CLIs and kills them
  (SIGKILL/SIGTERM) when a log pattern appears, so "die mid-iteration
  N" is exercised against the actual process tree, not a mock.

Injectors operate on final (committed) files deliberately: rename
atomicity already makes in-progress writes invisible, so the interesting
corruption class is damage AFTER commit, which only the CRC manifest
detects.
"""

from __future__ import annotations

import dataclasses
import os
import re
import signal
import subprocess
import sys
import time
from typing import Dict, List, Optional, Sequence

import numpy as np

from gene2vec_tpu_torch.resilience import snapshot as snap

# -- byte-level injectors ----------------------------------------------------


def truncate_file(path: str, frac: float = 0.5,
                  keep_bytes: Optional[int] = None) -> int:
    """Truncate ``path`` to ``keep_bytes`` (or ``frac`` of its size);
    returns the new size.  Models a torn write / lost tail block."""
    size = os.path.getsize(path)
    keep = keep_bytes if keep_bytes is not None else max(1, int(size * frac))
    with open(path, "rb+") as f:
        f.truncate(keep)
    return keep


def flip_byte(path: str, offset: Optional[int] = None, seed: int = 0) -> int:
    """XOR one byte of ``path`` (bit rot); returns the offset hit."""
    size = os.path.getsize(path)
    if size == 0:
        raise ValueError(f"{path} is empty; nothing to corrupt")
    if offset is None:
        offset = int(np.random.RandomState(seed).randint(size))
    with open(path, "rb+") as f:
        f.seek(offset)
        b = f.read(1)
        f.seek(offset)
        f.write(bytes([b[0] ^ 0xFF]))
    return offset


def _load_manifest(prefix: str) -> dict:
    """Parse a manifest WITHOUT verifying it — injectors only need the
    JSON; CRC-sweeping the (much larger) artifacts to get it would read
    every byte twice per injection."""
    import json

    with open(snap.manifest_path(prefix), "r", encoding="utf-8") as f:
        return json.load(f)


def corrupt_manifest_crc(prefix: str, name: Optional[str] = None) -> str:
    """Rewrite one CRC entry in a checkpoint's manifest to a wrong value
    (valid JSON, stale stamp) — verification must fail ``crc:<name>``."""
    doc = _load_manifest(prefix)
    if name is None:
        name = sorted(doc["files"])[0]
    doc["files"][name]["crc32"] = (doc["files"][name]["crc32"] ^ 0xDEAD) & 0xFFFFFFFF
    snap.atomic_write_json(snap.manifest_path(prefix), doc)
    return name


def restamp_manifest(prefix: str) -> str:
    """Recompute the manifest's sizes/CRCs from the CURRENT bytes on
    disk — used after an injector to manufacture a checkpoint that
    *passes verification but fails to load* (exercises the registry's
    load-failure / quarantine path rather than its discovery filter)."""
    doc = _load_manifest(prefix)
    dirpath = os.path.dirname(os.path.abspath(prefix))
    for fname, entry in doc["files"].items():
        fpath = os.path.join(dirpath, fname)
        # update in place: flags like "optional" must survive the restamp
        entry["bytes"] = os.path.getsize(fpath)
        entry["crc32"] = snap.crc32_file(fpath)
    mpath = snap.manifest_path(prefix)
    snap.atomic_write_json(mpath, doc)
    return mpath


def delete_iteration(export_dir: str, dim: int, iteration: int) -> List[str]:
    """Remove every file of one iteration (npz first, manifest last —
    the order a hostile cleanup would race a watcher with)."""
    from gene2vec_tpu_torch.io.checkpoint import ckpt_prefix

    prefix = ckpt_prefix(export_dir, dim, iteration)
    removed = []
    for suffix in (".npz", ".txt", "_w2v.txt", snap.MANIFEST_SUFFIX):
        path = prefix + suffix
        if os.path.exists(path):
            os.unlink(path)
            removed.append(path)
    return removed


def load_table(export_dir: str, dim: int, iteration: int) -> np.ndarray:
    """The raw f32 ``emb`` table of one saved iteration — the
    bit-exactness comparand for resume-equivalence drills."""
    from gene2vec_tpu_torch.io.checkpoint import ckpt_prefix

    with np.load(ckpt_prefix(export_dir, dim, iteration) + ".npz") as z:
        return np.asarray(z["emb"], dtype=np.float32)


# -- child-process harness ---------------------------------------------------


@dataclasses.dataclass
class ChildResult:
    argv: List[str]
    returncode: Optional[int]
    output: str
    signaled: bool
    matched_line: Optional[str] = None

    @property
    def lines(self) -> List[str]:
        return self.output.splitlines()


def child_env(env: Optional[Dict[str, str]] = None) -> Dict[str, str]:
    """The caller's environment with ``PYTHONUNBUFFERED`` set: it makes
    the child's pipe-connected stdout line-buffered — without it,
    ``run_cli_kill_on``'s pattern matching only sees block-flushed
    output, i.e. usually at exit, and the kill lands on an
    already-finished process.  The device is the child's own flag
    (``--device``), never the environment's."""
    out = dict(os.environ)
    out["PYTHONUNBUFFERED"] = "1"
    out.update(env or {})
    return out


def run_cli(argv: Sequence[str], timeout: float = 600.0,
            env: Optional[Dict[str, str]] = None) -> ChildResult:
    """Run a CLI to completion, stdout+stderr merged."""
    proc = subprocess.run(
        list(argv), stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True, timeout=timeout, env=child_env(env),
    )
    return ChildResult(list(argv), proc.returncode, proc.stdout, False)


def run_cli_kill_on(
    argv: Sequence[str],
    pattern: str,
    occurrences: int = 1,
    sig: int = signal.SIGKILL,
    grace_s: float = 0.0,
    timeout: float = 600.0,
    env: Optional[Dict[str, str]] = None,
) -> ChildResult:
    """Spawn a CLI and deliver ``sig`` when ``pattern`` (regex, merged
    stdout+stderr, line-matched) has appeared ``occurrences`` times.

    ``grace_s`` sleeps between match and signal — 0 kills at the log
    line (mid-save for patterns emitted before the checkpoint span),
    larger values land the signal later in the iteration.  Returns once
    the child is gone; ``returncode`` is negative (-signum) for an
    uncaught signal, :data:`~gene2vec_tpu_torch.resilience.preempt.
    EXIT_PREEMPTED` for a drained SIGTERM.
    """
    import queue as _queue
    import threading

    rx = re.compile(pattern)
    proc = subprocess.Popen(
        list(argv), stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True, bufsize=1, env=child_env(env),
    )
    lines: List[str] = []
    matched: Optional[str] = None
    seen = 0
    deadline = time.monotonic() + timeout
    # the pipe is read on a helper thread so the deadline holds even
    # against a child that hangs SILENTLY (a blocking readline on the
    # main thread would never observe the timeout)
    q: "_queue.Queue" = _queue.Queue()

    def pump() -> None:
        assert proc.stdout is not None
        for line in proc.stdout:
            q.put(line)
        q.put(None)  # EOF sentinel

    reader = threading.Thread(target=pump, daemon=True)
    reader.start()
    try:
        while True:
            remaining = deadline - time.monotonic()
            if remaining <= 0:
                proc.kill()
                if matched is not None:
                    # the match + signal happened; the child just refused
                    # to die — report THAT, not a bogus no-match
                    raise TimeoutError(
                        f"{argv!r}: matched {pattern!r} and sent signal "
                        f"{sig}, but the child did not exit within "
                        f"{timeout}s; last output:\n{''.join(lines[-15:])}"
                    )
                raise TimeoutError(
                    f"{argv!r}: no match for {pattern!r} within {timeout}s"
                )
            try:
                line = q.get(timeout=min(remaining, 1.0))
            except _queue.Empty:
                continue
            if line is None:
                break  # child closed stdout (exited)
            lines.append(line)
            if matched is None and rx.search(line):
                seen += 1
                if seen >= occurrences:
                    matched = line.rstrip("\n")
                    if grace_s:
                        time.sleep(grace_s)
                    try:
                        proc.send_signal(sig)
                    except ProcessLookupError:
                        pass
                    # keep draining so a SIGTERM child can log its drain
        try:
            # stdout is closed but the process may linger (atexit, final
            # fsync); give it the remaining budget, floor 5s
            rc = proc.wait(timeout=max(deadline - time.monotonic(), 5.0))
        except subprocess.TimeoutExpired:
            proc.kill()
            raise TimeoutError(
                f"{argv!r}: child closed stdout but did not exit within "
                f"the deadline after signal {sig}"
            ) from None
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait(timeout=30)
    if matched is None:
        raise AssertionError(
            f"{argv!r} exited (rc={proc.returncode}) before matching "
            f"{pattern!r}; output:\n{''.join(lines[-30:])}"
        )
    return ChildResult(list(argv), rc, "".join(lines), True, matched)


def gene2vec_argv(data_dir: str, export_dir: str, **flags) -> List[str]:
    """argv for the port's training CLI (the drill's workload), with
    ``--flag value`` kwargs (underscores → dashes; True → bare flag);
    pass ``device="cpu"`` for a run off the card."""
    argv = [sys.executable, "-m", "gene2vec_tpu_torch.cli.gene2vec",
            data_dir, export_dir, "txt"]
    for k, v in flags.items():
        flag = "--" + k.replace("_", "-")
        if v is True:
            argv.append(flag)
        elif v is not False and v is not None:
            argv += [flag, str(v)]
    return argv
