"""Atomic snapshot writes + CRC-stamped manifests — the part of
``gene2vec_tpu/resilience/snapshot.py`` the per-iteration export and the
serving registry need.

Every file is written to a temp name in the same directory, fsync'd and
renamed into place, so a reader sees the old file or the new one.  After
all files of one checkpoint are in place, ``<prefix>.MANIFEST.json``
(byte size + CRC32 of each file) is written last: it is the commit
record.  The schema string and layout are the reference's, so either
package's discovery verifies the other's exports.
"""

from __future__ import annotations

import dataclasses
import json
import os
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


def _fsync_dir(dirpath: str) -> None:
    """Best-effort fsync of a directory entry (some filesystems refuse)."""
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


def _tmp_name(path: str) -> str:
    return f"{path}.tmp{os.getpid()}"


def _atomic_replace(tmp_path: str, path: str) -> None:
    fd = os.open(tmp_path, os.O_RDONLY)
    try:
        os.fsync(fd)
    finally:
        os.close(fd)
    os.replace(tmp_path, path)
    _fsync_dir(os.path.dirname(os.path.abspath(path)))


def atomic_write_via(write_fn, path: str) -> None:
    """Run a ``write_fn(path)``-style writer against a temp path, then
    atomically rename the result into place."""
    tmp = _tmp_name(path)
    try:
        write_fn(tmp)
        _atomic_replace(tmp, path)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)


def atomic_savez(path: str, **arrays) -> None:
    """``np.savez`` with atomic visibility; ``path`` must end in ``.npz``."""
    import numpy as np

    if not path.endswith(".npz"):
        raise ValueError(f"atomic_savez target must end in .npz: {path!r}")
    atomic_write_via(lambda tmp: _savez_to(np, tmp, arrays), path)


def _savez_to(np, tmp: str, arrays) -> None:
    # a file object keeps savez from appending a second ".npz"
    with open(tmp, "wb") as f:
        np.savez(f, **arrays)


def manifest_path(prefix: str) -> str:
    return prefix + MANIFEST_SUFFIX


def write_manifest(
    prefix: str, files: Iterable[str], meta: Optional[Dict] = None,
    optional: Iterable[str] = (),
) -> str:
    """Stamp a manifest over ``files`` (recorded under their basenames;
    every file lives beside ``prefix``).  Written last — its existence is
    the snapshot's commit.  Files in ``optional`` may later be deleted
    without un-committing the snapshot."""
    opt_names = {os.path.basename(f) for f in optional}
    entries: Dict[str, Dict] = {}
    for f in files:
        path = os.path.abspath(f)
        name = os.path.basename(path)
        entries[name] = {"bytes": os.path.getsize(path), "crc32": crc32_file(path)}
        if name in opt_names:
            entries[name]["optional"] = True
    doc = {"schema": SCHEMA, "created_unix": time.time(), **(meta or {}),
           "files": entries}
    mpath = manifest_path(prefix)
    data = (json.dumps(doc, indent=1, default=str) + "\n").encode("utf-8")
    atomic_write_via(lambda tmp: _write_bytes(tmp, data), mpath)
    return mpath


def _write_bytes(path: str, data: bytes) -> None:
    with open(path, "wb") as f:
        f.write(data)


def stat_sig(path: str):
    """(mtime_ns, size) change signature, or None for a missing path —
    the registry's "did these bytes change?" key for its quarantine."""
    try:
        st = os.stat(path)
    except OSError:
        return None
    return (st.st_mtime_ns, st.st_size)


@dataclasses.dataclass(frozen=True)
class VerifyResult:
    ok: bool
    reason: str
    path: str
    manifest: Optional[Dict] = None

    def __bool__(self) -> bool:
        return self.ok


def verify_manifest(prefix: str) -> VerifyResult:
    """Check one snapshot's manifest against its bytes on disk; a falsy
    result carries ``missing-manifest`` / ``torn-manifest`` /
    ``missing:<name>`` / ``size:<name>`` / ``crc:<name>``."""
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
        return VerifyResult(False, "torn-manifest", mpath, doc)
    for name, entry in entries.items():
        fpath = os.path.join(dirpath, name)
        if not os.path.exists(fpath):
            if entry.get("optional"):
                continue
            return VerifyResult(False, f"missing:{name}", mpath, doc)
        if os.path.getsize(fpath) != entry.get("bytes"):
            return VerifyResult(False, f"size:{name}", mpath, doc)
        if crc32_file(fpath) != entry.get("crc32"):
            return VerifyResult(False, f"crc:{name}", mpath, doc)
    return VerifyResult(True, "ok", mpath, doc)
