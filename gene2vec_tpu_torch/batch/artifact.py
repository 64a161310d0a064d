"""Chunk-committed batch artifacts with a durable, CRC-stamped cursor —
the port of ``gene2vec_tpu/batch/artifact.py``, byte for byte on disk
(the reference's ``load_graph`` reads the port's artifacts).

A batch job's output grows as ONE append-only data file
(``<job_dir>/DATA.bin``) under a commit protocol in which the writer can
die at ANY instruction:

1. **Recover** — if ``DATA.bin`` is longer than the cursor's committed
   byte offset, the previous worker died mid-append: truncate back to
   the committed prefix (whose rolling CRC32 the cursor stamps, so
   post-commit rot is detected too, not just torn tails).
2. **Append** — one chunk's bytes are appended and fsync'd.
3. **Commit** — a new ``CURSOR.json`` (chunk count, byte offset,
   rolling CRC32 — self-CRC-stamped, previous cursor kept as
   ``CURSOR.prev.json``) is written atomically LAST.

Because every job type packs its output **per record** (per graph row,
per pair, per export line) the committed prefix is a pure function of
how many records are done — chunk boundaries never leak into the bytes,
so a SIGKILL'd-and-resumed build produces a final artifact bit-identical
to an uninterrupted control no matter where it was killed.

Completion is the atomic write of ``ARTIFACT.json`` (the manifest: full
data CRC + job metadata).  A reader trusts ``DATA.bin`` only through a
manifest that verifies.
"""

from __future__ import annotations

import json
import os
import zlib
from typing import Dict, List, Optional, Tuple

import numpy as np

from gene2vec_tpu_torch.resilience import snapshot as snap

CURSOR_SCHEMA = "gene2vec-tpu/batch-artifact-cursor/v1"
MANIFEST_SCHEMA = "gene2vec-tpu/batch-artifact/v1"
DATA_NAME = "DATA.bin"
CURSOR_NAME = "CURSOR.json"
CURSOR_PREV_NAME = "CURSOR.prev.json"
MANIFEST_NAME = "ARTIFACT.json"
TOKENS_NAME = "TOKENS.txt"


def _payload_crc(doc: Dict) -> int:
    body = {k: v for k, v in sorted(doc.items()) if k != "cursor_crc32"}
    return zlib.crc32(
        json.dumps(body, sort_keys=True).encode("utf-8")
    ) & 0xFFFFFFFF


class ChunkedArtifact:
    """The commit-protocol writer/reader for one job's output dir."""

    def __init__(self, job_dir: str):
        self.job_dir = job_dir
        os.makedirs(job_dir, exist_ok=True)
        self.data_path = os.path.join(job_dir, DATA_NAME)
        self._cursor = self._load_cursor()
        self._recover()

    # -- cursor ----------------------------------------------------------

    def _empty_cursor(self) -> Dict:
        return {
            "schema": CURSOR_SCHEMA,
            "chunks_done": 0,
            "records_done": 0,
            "data_bytes": 0,
            "data_crc32": 0,
        }

    def _load_cursor(self) -> Dict:
        for name in (CURSOR_NAME, CURSOR_PREV_NAME):
            path = os.path.join(self.job_dir, name)
            try:
                with open(path, "r", encoding="utf-8") as f:
                    doc = json.load(f)
            except (OSError, ValueError):
                continue
            if not isinstance(doc, dict):
                continue
            if doc.get("cursor_crc32") != _payload_crc(doc):
                continue
            return doc
        if (
            os.path.exists(self.data_path)
            and os.path.getsize(self.data_path) > 0
        ):
            raise IOError(
                f"{self.job_dir}: committed data present but no readable "
                "self-CRC-valid cursor (both CURSOR.json and "
                "CURSOR.prev.json lost/rotted) — refusing to truncate "
                "the whole artifact to a fresh cursor"
            )
        return self._empty_cursor()

    def _write_cursor(self, doc: Dict) -> None:
        doc = dict(doc)
        doc["cursor_crc32"] = _payload_crc(doc)
        cur = os.path.join(self.job_dir, CURSOR_NAME)
        if os.path.exists(cur):
            # keep the last good commit: a cursor torn by post-write rot
            # falls back one chunk instead of losing the whole offset
            with open(cur, "rb") as f:
                snap.atomic_write_bytes(
                    os.path.join(self.job_dir, CURSOR_PREV_NAME), f.read()
                )
        snap.atomic_write_json(cur, doc)
        self._cursor = doc

    def _recover(self) -> None:
        """Enforce the committed prefix: truncate a torn append, verify
        the prefix CRC (training-grade discipline — resuming on rotted
        bytes would silently corrupt the final artifact)."""
        committed = int(self._cursor.get("data_bytes", 0))
        size = (
            os.path.getsize(self.data_path)
            if os.path.exists(self.data_path) else 0
        )
        if size > committed:
            with open(self.data_path, "r+b") as f:
                f.truncate(committed)
                f.flush()
                os.fsync(f.fileno())
        elif size < committed:
            raise IOError(
                f"{self.data_path}: {size} bytes on disk but the cursor "
                f"committed {committed} — data truncated after commit"
            )
        if committed:
            crc = 0
            with open(self.data_path, "rb") as f:
                while True:
                    blob = f.read(1 << 20)
                    if not blob:
                        break
                    crc = zlib.crc32(blob, crc)
            if (crc & 0xFFFFFFFF) != int(self._cursor.get("data_crc32", 0)):
                raise IOError(
                    f"{self.data_path}: committed prefix CRC mismatch — "
                    "the artifact rotted after commit; restart the job "
                    "in a fresh dir"
                )

    # -- progress facts ---------------------------------------------------

    @property
    def chunks_done(self) -> int:
        return int(self._cursor.get("chunks_done", 0))

    @property
    def records_done(self) -> int:
        return int(self._cursor.get("records_done", 0))

    @property
    def data_bytes(self) -> int:
        return int(self._cursor.get("data_bytes", 0))

    # -- the commit protocol ----------------------------------------------

    def append_chunk(self, data: bytes, records: int) -> None:
        """Append one chunk's record bytes and commit the cursor LAST.
        A SIGKILL anywhere before the commit leaves the chunk torn; the
        next open truncates and the runner redoes it."""
        if os.path.exists(os.path.join(self.job_dir, MANIFEST_NAME)):
            raise IOError(f"{self.job_dir}: artifact already finalized")
        with open(self.data_path, "ab") as f:
            f.write(data)
            f.flush()
            os.fsync(f.fileno())
        snap.fsync_dir(self.job_dir)
        self._write_cursor({
            "schema": CURSOR_SCHEMA,
            "chunks_done": self.chunks_done + 1,
            "records_done": self.records_done + int(records),
            "data_bytes": self.data_bytes + len(data),
            "data_crc32": zlib.crc32(
                data, int(self._cursor.get("data_crc32", 0))
            ) & 0xFFFFFFFF,
        })

    def write_tokens(self, tokens) -> None:
        """The artifact's gene-name sidecar (one per line, vocab order)
        — written atomically before the first chunk so a standalone
        reader (eval/, Dash) can map packed row ids back to genes."""
        snap.atomic_write_bytes(
            os.path.join(self.job_dir, TOKENS_NAME),
            ("\n".join(str(t) for t in tokens) + "\n").encode("utf-8"),
        )

    def finalize(self, meta: Dict) -> str:
        """Atomically commit the completion manifest.  Idempotent — a
        resumed job that was killed between the last chunk and the
        manifest just rewrites the same document."""
        path = os.path.join(self.job_dir, MANIFEST_NAME)
        doc = {
            "schema": MANIFEST_SCHEMA,
            "chunks": self.chunks_done,
            "records": self.records_done,
            "data_bytes": self.data_bytes,
            "data_crc32": int(self._cursor.get("data_crc32", 0)),
            "meta": dict(meta),
        }
        snap.atomic_write_json(path, doc)
        return path

    # -- the reader side --------------------------------------------------

    def manifest(self) -> Optional[Dict]:
        path = os.path.join(self.job_dir, MANIFEST_NAME)
        try:
            with open(path, "r", encoding="utf-8") as f:
                doc = json.load(f)
        except (OSError, ValueError):
            return None
        return doc if isinstance(doc, dict) else None

    def verify(self) -> bool:
        """Finalized AND the data bytes still match the manifest CRC."""
        doc = self.manifest()
        if doc is None:
            return False
        try:
            if os.path.getsize(self.data_path) != int(doc["data_bytes"]):
                return False
            return snap.crc32_file(self.data_path) == int(doc["data_crc32"])
        except (OSError, KeyError, ValueError):
            return False


def write_fetched_artifact(
    job_dir: str,
    data: bytes,
    meta: Dict,
    chunks: int,
    records: int,
    data_crc32: int,
    tokens_bytes: Optional[bytes] = None,
) -> None:
    """Materialize an artifact dir from HTTP-fetched parts
    (``/v1/jobs/<id>/artifact``), byte-identical and fully loadable:
    the reassembled data must match the manifest CRC or this refuses
    to write anything."""
    got = zlib.crc32(data) & 0xFFFFFFFF
    if got != int(data_crc32):
        raise IOError(
            f"fetched data CRC {got} != manifest {data_crc32} "
            "(torn/reordered pages?)"
        )
    os.makedirs(job_dir, exist_ok=True)
    snap.atomic_write_bytes(os.path.join(job_dir, DATA_NAME), data)
    if tokens_bytes is not None:
        snap.atomic_write_bytes(
            os.path.join(job_dir, TOKENS_NAME), tokens_bytes
        )
    cursor = {
        "schema": CURSOR_SCHEMA,
        "chunks_done": int(chunks),
        "records_done": int(records),
        "data_bytes": len(data),
        "data_crc32": int(data_crc32),
    }
    cursor["cursor_crc32"] = _payload_crc(cursor)
    snap.atomic_write_json(os.path.join(job_dir, CURSOR_NAME), cursor)
    snap.atomic_write_json(os.path.join(job_dir, MANIFEST_NAME), {
        "schema": MANIFEST_SCHEMA,
        "chunks": int(chunks),
        "records": int(records),
        "data_bytes": len(data),
        "data_crc32": int(data_crc32),
        "meta": dict(meta),
    })


# -- kNN-graph record packing -------------------------------------------------
#
# One record per vocab row: k int32 global neighbor row ids then k
# float32 scores, little-endian, row-major.  Chunk boundaries never
# appear in the bytes, so resumed and uninterrupted builds are
# bit-identical by construction.


def pack_graph_rows(ids: np.ndarray, scores: np.ndarray) -> bytes:
    ids = np.ascontiguousarray(ids, dtype="<i4")
    scores = np.ascontiguousarray(scores, dtype="<f4")
    if ids.shape != scores.shape or ids.ndim != 2:
        raise ValueError(
            f"ids/scores must be matching (n, k) arrays, got "
            f"{ids.shape} vs {scores.shape}"
        )
    n, k = ids.shape
    out = np.empty((n, 2 * k), dtype="<i4")
    out[:, :k] = ids
    out[:, k:] = scores.view("<i4")
    return out.tobytes()


def unpack_graph(
    data: bytes, k: int
) -> Tuple[np.ndarray, np.ndarray]:
    rec = np.frombuffer(data, dtype="<i4").reshape(-1, 2 * k)
    ids = rec[:, :k].astype(np.int32)
    scores = rec[:, k:].copy().view("<f4").astype(np.float32)
    return ids, scores


def load_graph(
    job_dir: str,
) -> Tuple[List[str], np.ndarray, np.ndarray, Dict]:
    """(tokens, neighbor row ids [V, k], scores [V, k], meta) from a
    FINALIZED ``knn_graph`` artifact dir — the precomputed-graph input
    to the intrinsic eval and the Dash neighbor-view fallback."""
    art = ChunkedArtifact(job_dir)
    doc = art.manifest()
    if doc is None:
        raise IOError(
            f"{job_dir}: no ARTIFACT.json — the graph build has not "
            "completed (or this is not a batch artifact dir)"
        )
    if not art.verify():
        raise IOError(f"{job_dir}: artifact data fails manifest CRC")
    meta = doc.get("meta", {})
    if meta.get("type") != "knn_graph":
        raise IOError(
            f"{job_dir}: artifact type {meta.get('type')!r} is not a "
            "knn_graph"
        )
    k = int(meta["k"])
    with open(art.data_path, "rb") as f:
        ids, scores = unpack_graph(f.read(), k)
    tokens_path = os.path.join(job_dir, TOKENS_NAME)
    with open(tokens_path, "r", encoding="utf-8") as f:
        tokens = [ln.rstrip("\n") for ln in f if ln.rstrip("\n")]
    if len(tokens) != ids.shape[0]:
        raise IOError(
            f"{job_dir}: {len(tokens)} tokens but {ids.shape[0]} graph "
            "rows"
        )
    return tokens, ids, scores, meta
