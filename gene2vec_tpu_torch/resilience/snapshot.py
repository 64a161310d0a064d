"""Atomic snapshot writes + CRC-stamped manifests — a copy of
``gene2vec_tpu/resilience/snapshot.py``.

Failure model: a writer can die at any instruction (SIGKILL mid-``write``,
preemption between two files of one logical checkpoint, a disk that
bit-rots a block after the fact), and a concurrent reader (the serving
registry's watcher thread, a resuming trainer) must never act on a torn
snapshot as if it were complete.  Two mechanisms, layered:

1. **Atomic visibility** — every file is written to a temp name in the
   same directory, fsync'd, then ``os.replace``'d into place (and the
   directory entry fsync'd).  A reader sees the old file or the new
   file, never a prefix of the new one.
2. **Integrity stamping** — a checkpoint is several files (npz + text
   exports + vocab).  After all of them are in place, a
   ``<prefix>.MANIFEST.json`` listing each file's byte size and CRC32 is
   written (atomically, last).  Discovery treats the manifest as the
   commit record: no manifest → the checkpoint is still being written
   (or died mid-write) and is skipped; CRC/size mismatch → the bytes
   rotted or were truncated after commit, also skipped.

The schema string and layout are the reference's, so either package's
discovery verifies the other's exports, and the writers here produce the
reference's bytes.  Verification CRCs every covered file, so
:func:`verify_manifest` caches results keyed by the stat signature
(mtime_ns, size) of the manifest and every file it covers — the serving
watcher re-polling every few seconds pays the CRC cost once per change.
"""

from __future__ import annotations

import dataclasses
import json
import os
import threading
import time
import zlib
from typing import Dict, Iterable, Optional

SCHEMA = "gene2vec-tpu/snapshot-manifest/v1"
MANIFEST_SUFFIX = ".MANIFEST.json"

_CHUNK_BYTES = 1 << 20


def crc32_file(path: str) -> int:
    """Streaming CRC32 of a file (unsigned)."""
    crc = 0
    with open(path, "rb") as f:
        while True:
            chunk = f.read(_CHUNK_BYTES)
            if not chunk:
                break
            crc = zlib.crc32(chunk, crc)
    return crc & 0xFFFFFFFF


def fsync_dir(dirpath: str) -> None:
    """fsync a directory entry so a completed rename survives power loss
    (best-effort: some filesystems refuse O_RDONLY dir fsync)."""
    try:
        fd = os.open(dirpath, os.O_RDONLY)
    except OSError:
        return
    try:
        os.fsync(fd)
    except OSError:
        pass
    finally:
        os.close(fd)


def _tmp_name(path: str, suffix: str = "") -> str:
    # same directory as the target so os.replace stays a rename, never a
    # cross-device copy; pid-stamped so concurrent writers don't collide
    return f"{path}.tmp{os.getpid()}{suffix}"


def atomic_replace(tmp_path: str, path: str) -> None:
    """fsync ``tmp_path``, rename it onto ``path``, fsync the directory."""
    fd = os.open(tmp_path, os.O_RDONLY)
    try:
        os.fsync(fd)
    finally:
        os.close(fd)
    os.replace(tmp_path, path)
    fsync_dir(os.path.dirname(os.path.abspath(path)))


def atomic_write_bytes(path: str, data: bytes) -> None:
    tmp = _tmp_name(path)
    try:
        with open(tmp, "wb") as f:
            f.write(data)
        atomic_replace(tmp, path)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)


def atomic_write_json(path: str, doc: Dict) -> None:
    atomic_write_bytes(
        path, (json.dumps(doc, indent=1, default=str) + "\n").encode("utf-8")
    )


def atomic_savez(path: str, **arrays) -> None:
    """``np.savez`` with atomic visibility.  ``path`` must end in
    ``.npz``."""
    import numpy as np

    if not path.endswith(".npz"):
        raise ValueError(f"atomic_savez target must end in .npz: {path!r}")

    def _savez(tmp: str) -> None:
        # a file object keeps savez from appending a second ".npz"
        with open(tmp, "wb") as f:
            np.savez(f, **arrays)

    atomic_write_via(_savez, path)


def atomic_copy(src: str, path: str, chunk: int = 1 << 20) -> None:
    """Streaming file copy with atomic visibility — constant memory,
    so copying a production-size table never materializes the whole
    artifact as one bytes object."""
    def _copy(tmp: str) -> None:
        with open(src, "rb") as fin, open(tmp, "wb") as fout:
            while True:
                buf = fin.read(chunk)
                if not buf:
                    break
                fout.write(buf)
    atomic_write_via(_copy, path)


def atomic_write_via(write_fn, path: str) -> None:
    """Run a ``write_fn(path)``-style writer (e.g. the io/emb_io text
    exporters, ``Vocab.save``) against a temp path, then atomically
    rename the result into place."""
    tmp = _tmp_name(path)
    try:
        write_fn(tmp)
        atomic_replace(tmp, path)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)


# -- manifests ---------------------------------------------------------------


def manifest_path(prefix: str) -> str:
    """``<prefix>.MANIFEST.json`` — the commit record for one logical
    snapshot whose files all start with ``prefix`` or live beside it."""
    return prefix + MANIFEST_SUFFIX


def write_manifest(
    prefix: str, files: Iterable[str], meta: Optional[Dict] = None,
    optional: Iterable[str] = (),
) -> str:
    """Stamp a manifest over ``files`` (paths resolved exactly like any
    other open(); recorded under their basenames, so the whole snapshot
    directory can be moved — every file must live beside ``prefix``).
    Written last, atomically — its existence IS the snapshot's commit.

    Files also listed in ``optional`` are convenience artifacts (the
    per-iteration text exports): verification still catches their
    corruption while they exist, but DELETING one does not invalidate
    the snapshot — an operator reclaiming space from the ~100x-larger
    text twins must not silently un-commit every npz checkpoint."""
    opt_names = {os.path.basename(f) for f in optional}
    entries: Dict[str, Dict] = {}
    for f in files:
        path = os.path.abspath(f)
        name = os.path.basename(path)
        entries[name] = {
            "bytes": os.path.getsize(path),
            "crc32": crc32_file(path),
        }
        if name in opt_names:
            entries[name]["optional"] = True
    doc = {
        "schema": SCHEMA,
        "created_unix": time.time(),
        **(meta or {}),
        "files": entries,
    }
    mpath = manifest_path(prefix)
    atomic_write_json(mpath, doc)
    return mpath


@dataclasses.dataclass(frozen=True)
class VerifyResult:
    ok: bool
    reason: str
    path: str
    manifest: Optional[Dict] = None

    def __bool__(self) -> bool:
        return self.ok


_cache_lock = threading.Lock()
_verify_cache: Dict[str, tuple] = {}
_CACHE_MAX = 256


def stat_sig(path: str):
    """(mtime_ns, size) change signature, or None for a missing path —
    the shared "did these bytes change?" key for the verify cache and
    the registry's quarantine invalidation."""
    try:
        st = os.stat(path)
    except OSError:
        return None
    return (st.st_mtime_ns, st.st_size)


def clear_verify_cache() -> None:
    with _cache_lock:
        _verify_cache.clear()


def verify_manifest(prefix: str, use_cache: bool = True) -> VerifyResult:
    """Check one snapshot's manifest against its bytes on disk.

    ``prefix`` is the checkpoint prefix (or the manifest path itself).
    Returns a falsy :class:`VerifyResult` with a machine-parseable
    ``reason`` (``missing-manifest`` / ``torn-manifest`` /
    ``missing:<name>`` / ``size:<name>`` / ``crc:<name>``) — discovery
    *skips* failed snapshots, it never raises on them."""
    mpath = prefix if prefix.endswith(MANIFEST_SUFFIX) else manifest_path(prefix)
    dirpath = os.path.dirname(os.path.abspath(mpath))

    try:
        with open(mpath, "r", encoding="utf-8") as f:
            doc = json.load(f)
        entries = doc["files"]
    except FileNotFoundError:
        return VerifyResult(False, "missing-manifest", mpath)
    except (OSError, ValueError, KeyError, TypeError):
        return VerifyResult(False, "torn-manifest", mpath)
    if not isinstance(entries, dict) or not all(
        isinstance(e, dict) for e in entries.values()
    ):
        # valid JSON, wrong shape (hand-edited / corrupted): still a
        # falsy verdict — discovery never raises on a bad manifest
        return VerifyResult(False, "torn-manifest", mpath, doc)

    # stat signature over manifest + covered files: unchanged files keep
    # their cached verdict, so the watcher's poll loop CRCs each
    # checkpoint once per change, not once per poll
    sig = tuple(
        [stat_sig(mpath)]
        + [stat_sig(os.path.join(dirpath, name)) for name in sorted(entries)]
    )
    if use_cache:
        with _cache_lock:
            hit = _verify_cache.get(mpath)
        if hit is not None and hit[0] == sig:
            return hit[1]

    result = VerifyResult(True, "ok", mpath, doc)
    for name, entry in entries.items():
        fpath = os.path.join(dirpath, name)
        if not os.path.exists(fpath):
            if entry.get("optional"):
                continue  # deleted convenience artifact, not a torn commit
            result = VerifyResult(False, f"missing:{name}", mpath, doc)
            break
        if os.path.getsize(fpath) != entry.get("bytes"):
            result = VerifyResult(False, f"size:{name}", mpath, doc)
            break
        if crc32_file(fpath) != entry.get("crc32"):
            result = VerifyResult(False, f"crc:{name}", mpath, doc)
            break

    if use_cache:
        with _cache_lock:
            if len(_verify_cache) >= _CACHE_MAX:
                _verify_cache.pop(next(iter(_verify_cache)))
            _verify_cache[mpath] = (sig, result)
    return result


def manifest_bytes(doc: Dict) -> int:
    """Total payload bytes a manifest covers (the ``ckpt_bytes_total``
    feed for the async writer's metrics)."""
    return sum(int(e.get("bytes", 0)) for e in doc.get("files", {}).values())
