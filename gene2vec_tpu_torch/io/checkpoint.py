"""Per-iteration checkpoint/resume in the reference's export format
(``gene2vec_tpu/io/checkpoint.py``), written by the port's own copy.

Layout in <export_dir>:
    vocab.tsv                               token \\t count, id order
    gene2vec_dim_<D>_iter_<N>.npz           emb, ctx, meta json
    gene2vec_dim_<D>_iter_<N>.txt           matrix-txt export
    gene2vec_dim_<D>_iter_<N>_w2v.txt       word2vec-format export
    gene2vec_dim_<D>_iter_<N>.vocab.tsv     per-iteration vocab sidecar
                                            (only for a tail-extended vocab)
    gene2vec_dim_<D>_iter_<N>.MANIFEST.json crc/size stamp (commit record)

The npz stores float32 tables (a lossless upcast of bfloat16 ones) and
stamps the tables' own width as ``table_dtype``, by its numpy name
("float32" or "bfloat16"), which the reference's loader parses with
``jnp.dtype``; a torch dtype name ("torch.bfloat16") would not.  Every
file lands atomically and the manifest, written last, commits the
iteration; discovery with ``verified_only`` skips iterations whose
manifest is missing or disagrees with the bytes on disk.

:class:`SaveProcess` runs ``save_iteration`` in a forked helper process
for the background checkpoint writer (``SGNSConfig(async_checkpoint=
True)``): the training loop stages the tables into one of two shared
host slots and the helper serializes, CRCs and fsyncs them under its own
interpreter lock.  The port's step loop is host Python that holds the
lock between its many small launches; a writer thread doing that work in
process contends with it for the lock (on an H100 host the full-width
step loop kept 38-46% of its pairs/s while such a thread wrote).
"""

from __future__ import annotations

import atexit
import ctypes
import json
import mmap
import multiprocessing
import os
import re
import signal
import warnings
import zipfile  # read_npz_rows; np.savez imports it too, loaded before the helper forks
from typing import Optional, Tuple

import numpy as np
import torch

from gene2vec_tpu_torch.io.emb_io import write_matrix_txt, write_word2vec_format
from gene2vec_tpu_torch.io.vocab import Vocab
from gene2vec_tpu_torch.resilience import snapshot as snap
from gene2vec_tpu_torch.sgns.model import SGNSParams, table_dtype as _torch_dtype

_CKPT_RE = re.compile(r"^gene2vec_dim_(\d+)_iter_(\d+)\.npz$")
_W2V_RE = re.compile(r"^gene2vec_dim_(\d+)_iter_(\d+)_w2v\.txt$")
_MANIFEST_RE = re.compile(
    r"^gene2vec_dim_(\d+)_iter_(\d+)" + re.escape(snap.MANIFEST_SUFFIX) + r"$"
)


def _scan(export_dir: str, text_fallback: bool):
    """One listing → (entries ``(dim, iteration, path, prefix)``, the set
    of (dim, iteration) keys that carry a manifest).  npz checkpoints
    shadow their word2vec-format twins."""
    names = sorted(os.listdir(export_dir))
    manifested = set()
    for name in names:
        m = _MANIFEST_RE.match(name)
        if m:
            manifested.add((int(m.group(1)), int(m.group(2))))
    entries, seen = [], set()
    for name in names:
        m = _CKPT_RE.match(name)
        if m:
            key = (int(m.group(1)), int(m.group(2)))
            seen.add(key)
            path = os.path.join(export_dir, name)
            entries.append((*key, path, path[: -len(".npz")]))
    if text_fallback:
        for name in names:
            m = _W2V_RE.match(name)
            if m:
                key = (int(m.group(1)), int(m.group(2)))
                if key not in seen:
                    path = os.path.join(export_dir, name)
                    entries.append((*key, path, path[: -len("_w2v.txt")]))
    return entries, manifested


def _verified_entries(entries, manifested, verified_only: bool):
    """With ``verified_only``: a manifested iteration must verify; an
    unmanifested one is accepted only if it is older than its dim's first
    manifested iteration (a legacy export), else it died mid-save."""
    if not verified_only:
        for dim, it, path, _ in entries:
            yield (dim, it, path)
        return
    first_manifested: dict = {}
    for d, i in manifested:
        if d not in first_manifested or i < first_manifested[d]:
            first_manifested[d] = i
    for dim, it, path, prefix in entries:
        if (dim, it) in manifested:
            if snap.verify_manifest(prefix):
                yield (dim, it, path)
        elif dim not in first_manifested or it < first_manifested[dim]:
            yield (dim, it, path)


def iter_checkpoints(
    export_dir: str, text_fallback: bool = False, verified_only: bool = False
):
    """Yield ``(dim, iteration, path)`` for every checkpoint in name order."""
    if not os.path.isdir(export_dir):
        return
    entries, manifested = _scan(export_dir, text_fallback)
    yield from _verified_entries(entries, manifested, verified_only)


def iter_checkpoints_newest_first(
    export_dir: str,
    text_fallback: bool = False,
    verified_only: bool = False,
    dim: Optional[int] = None,
):
    """Like :func:`iter_checkpoints`, newest first and verified lazily."""
    if not os.path.isdir(export_dir):
        return
    entries, manifested = _scan(export_dir, text_fallback)
    if dim is not None:
        entries = [e for e in entries if e[0] == dim]
    entries.sort(key=lambda e: (e[1], e[0]), reverse=True)
    yield from _verified_entries(entries, manifested, verified_only)


def ckpt_prefix(export_dir: str, dim: int, iteration: int) -> str:
    return os.path.join(export_dir, f"gene2vec_dim_{dim}_iter_{iteration}")


def vocab_path_for(ckpt_path: str) -> str:
    """The per-iteration ``<prefix>.vocab.tsv`` sidecar when present, else
    the export dir's shared ``vocab.tsv``.  Accepts an ``.npz`` path, a
    ``_w2v.txt`` path or a bare prefix."""
    if ckpt_path.endswith(".npz"):
        prefix = ckpt_path[: -len(".npz")]
    elif ckpt_path.endswith("_w2v.txt"):
        prefix = ckpt_path[: -len("_w2v.txt")]
    else:
        prefix = ckpt_path
    sidecar = prefix + ".vocab.tsv"
    if os.path.exists(sidecar):
        return sidecar
    return os.path.join(os.path.dirname(os.path.abspath(ckpt_path)), "vocab.tsv")


def _is_tail_extension(old_tokens, new_tokens) -> bool:
    return (
        len(new_tokens) >= len(old_tokens)
        and list(new_tokens[: len(old_tokens)]) == list(old_tokens)
    )


def _dtype_name(t) -> str:
    """A table's width as the reference stamps it: "float32" or "bfloat16"."""
    return "bfloat16" if str(t.dtype) in ("torch.bfloat16", "bfloat16") else "float32"


def _host_f32(t) -> np.ndarray:
    if isinstance(t, torch.Tensor):
        return t.detach().to("cpu", torch.float32).numpy()
    return np.asarray(t, dtype=np.float32)


def save_iteration(
    export_dir: str,
    dim: int,
    iteration: int,
    params: SGNSParams,
    vocab: Vocab,
    txt_output: bool = True,
    meta: Optional[dict] = None,
    table_dtype: Optional[str] = None,
) -> str:
    """Write iteration ``iteration`` and commit it with its manifest;
    returns the npz path.  ``table_dtype`` stamps the tables' width when
    ``params`` are float32 copies of narrower tables (default: their own
    dtype's name)."""
    os.makedirs(export_dir, exist_ok=True)
    prefix = ckpt_prefix(export_dir, dim, iteration)
    vocab_path = os.path.join(export_dir, "vocab.tsv")
    if os.path.exists(vocab_path):
        existing = Vocab.load(vocab_path)
        if existing.id_to_token != vocab.id_to_token:
            if _is_tail_extension(existing.id_to_token, vocab.id_to_token):
                vocab_path = prefix + ".vocab.tsv"
                snap.atomic_write_via(vocab.save, vocab_path)
            else:
                raise ValueError(
                    f"{vocab_path} was written for a different corpus "
                    f"({len(existing)} tokens vs {len(vocab)}, not a "
                    "tail extension); refusing to mix checkpoints with "
                    "mismatched vocabularies in one export dir"
                )
    else:
        snap.atomic_write_via(vocab.save, vocab_path)
    emb = _host_f32(params.emb)
    ctx = _host_f32(params.ctx)
    meta = dict(
        meta or {},
        dim=dim,
        iteration=iteration,
        vocab_size=len(vocab),
        table_dtype=table_dtype or _dtype_name(params.emb),
    )
    snap.atomic_savez(prefix + ".npz", emb=emb, ctx=ctx, meta=json.dumps(meta))
    files = [prefix + ".npz", vocab_path]
    optional = []
    if txt_output:
        snap.atomic_write_via(
            lambda p: write_matrix_txt(p, vocab.id_to_token, emb), prefix + ".txt"
        )
        snap.atomic_write_via(
            lambda p: write_word2vec_format(p, vocab.id_to_token, emb),
            prefix + "_w2v.txt",
        )
        optional = [prefix + ".txt", prefix + "_w2v.txt"]
        files += optional
    snap.write_manifest(prefix, files, meta=meta, optional=optional)
    return prefix + ".npz"


class SaveProcess:
    """``save_iteration`` of (rows, dim) float32 tables in a helper process
    forked at construction.  :meth:`stage` copies both tables into the
    next of two shared slots (for tables on the card, ``device``: an
    asynchronous copy into the slots, page-locked once the helper has
    forked, ordered before the next epoch's kernels on the same stream),
    so the caller's tables may change right after it; :meth:`save` waits for that copy, has the helper write,
    commit and verify the slot's iteration, and returns the manifest's
    payload bytes.  The slots alternate, so a slot is staged again only
    two saves later: callers keep at most one save outstanding (the
    background writer's double buffer, ``max_pending=1``).  At start the
    helper writes the export dir's ``vocab.tsv`` when it is absent, so the
    first save pays no more than the others.  It ignores SIGINT/SIGTERM
    (its parent drains, then closes it), dies with its parent, and touches
    numpy and files only, never torch or the card."""

    def __init__(self, export_dir: str, dim: int, rows: int, vocab: Vocab,
                 txt_output: bool = True, device=None):
        self._shape = (rows, dim)
        nbytes = max(rows * dim * 4, 1)
        self._slots = [(mmap.mmap(-1, nbytes), mmap.mmap(-1, nbytes)) for _ in range(2)]
        for pair in self._slots:
            for buf in pair:  # fault the pages in now, not in the first stagings
                buf.write(bytes(nbytes))
        self._next = 0
        ctx = multiprocessing.get_context("fork")
        self._conn, child = ctx.Pipe()
        self._proc = ctx.Process(
            target=_save_loop, name="ckpt-save", daemon=True,
            args=(child, self._conn, os.getpid(), self._slots, self._shape, export_dir,
                  dim, vocab, txt_output),
        )
        self._proc.start()
        child.close()
        self._views = [tuple(torch.frombuffer(buf, dtype=torch.float32).view(self._shape)
                             for buf in pair) for pair in self._slots]
        self._events = [None, None]
        self._pinned = []  # data pointers registered with the CUDA driver
        self._closed = False
        # before multiprocessing's own exit hook, which would wait on a
        # helper that ignores SIGTERM
        atexit.register(self.close)
        if torch.device(device or "cpu").type == "cuda":
            try:
                self._pin()
            except BaseException:
                self.close()
                raise

    def stage(self, params: SGNSParams) -> int:
        """Copy ``params`` (float32 or bfloat16, any device) into the next
        slot as float32; returns the slot."""
        slot, self._next = self._next, self._next ^ 1
        cuda = params.emb.is_cuda
        for dst, t in zip(self._views[slot], (params.emb, params.ctx)):
            dst.copy_(t.detach(), non_blocking=cuda)
        if cuda:
            event = torch.cuda.Event()
            event.record()
            self._events[slot] = event
        return slot

    def _pin(self) -> None:
        cudart = torch.cuda.cudart()
        for pair in self._views:
            for view in pair:
                rc = int(cudart.cudaHostRegister(view.data_ptr(), view.numel() * 4, 0))
                if rc != 0:
                    raise RuntimeError(f"cudaHostRegister of a checkpoint slot failed ({rc})")
                self._pinned.append(view.data_ptr())

    def save(self, slot: int, iteration: int, meta: dict, table_dtype: str) -> int:
        """Write and commit ``slot`` as ``iteration``; the manifest's payload
        bytes.  Raises IOError if the helper failed or is gone."""
        event, self._events[slot] = self._events[slot], None
        if event is not None:
            event.synchronize()  # the staging copy has landed in the slot
        try:
            self._conn.send((slot, iteration, meta, table_dtype))
            ok, value = self._conn.recv()
        except (EOFError, OSError) as e:
            raise IOError(f"checkpoint helper process gone: {e!r}") from e
        if not ok:
            raise IOError(value)
        return value

    def close(self) -> None:
        """Stop the helper (after the save in flight) and free the slots."""
        if self._closed:
            return
        self._closed = True
        atexit.unregister(self.close)
        try:
            self._conn.send(None)
        except OSError:
            pass
        self._proc.join(timeout=60)
        if self._proc.is_alive():
            self._proc.kill()
            self._proc.join()
        self._conn.close()
        for ptr in self._pinned:
            torch.cuda.cudart().cudaHostUnregister(ptr)
        self._pinned = []
        self._views = None  # the slots' buffers are exported to these tensors
        for pair in self._slots:
            for buf in pair:
                buf.close()


def _save_loop(conn, parent_conn, parent_pid: int, slots, shape, export_dir: str, dim: int,
               vocab: Vocab, txt_output: bool) -> None:
    """The helper process: one ``save_iteration`` and its verification a job."""
    parent_conn.close()  # so a dead parent reads as EOF here
    for sig in (signal.SIGINT, signal.SIGTERM):
        signal.signal(sig, signal.SIG_IGN)
    try:  # PR_SET_PDEATHSIG: SIGKILL this helper when its parent dies
        ctypes.CDLL(None).prctl(1, int(signal.SIGKILL))
    except (OSError, AttributeError):
        pass
    if os.getppid() != parent_pid:
        return
    startup_error = None
    try:
        os.makedirs(export_dir, exist_ok=True)
        vocab_path = os.path.join(export_dir, "vocab.tsv")
        if not os.path.exists(vocab_path):
            snap.atomic_write_via(vocab.save, vocab_path)
    except OSError as e:  # reported with the first save
        startup_error = f"{type(e).__name__}: {e}"
    while True:
        try:
            job = conn.recv()
        except EOFError:
            return
        if job is None:
            return
        slot, iteration, meta, table_dtype = job
        try:
            if startup_error is not None:
                raise IOError(startup_error)
            emb, ctx = (np.frombuffer(buf, dtype=np.float32).reshape(shape) for buf in slots[slot])
            path = save_iteration(export_dir, dim, iteration, SGNSParams(emb, ctx), vocab,
                                  txt_output=txt_output, meta=meta, table_dtype=table_dtype)
            res = snap.verify_manifest(path[: -len(".npz")])
            if not res:
                raise IOError(f"checkpoint iteration {iteration} failed post-write "
                              f"verification: {res.reason}")
            conn.send((True, snap.manifest_bytes(res.manifest)))
        except Exception as e:  # reported to the writer thread, which raises it
            conn.send((False, f"{type(e).__name__}: {e}"))


def load_iteration(
    export_dir: str, dim: int, iteration: int, device="cpu",
    table_dtype: Optional[str] = None,
) -> Tuple[SGNSParams, Vocab, dict]:
    """Load one iteration's tables onto ``device`` (+vocab, meta).

    ``table_dtype`` is the caller's configured width: on a mismatch with
    the recorded width the tables are cast to it, with the reference's
    warning; ``None`` restores the recorded width.  The file holds float32
    either way (a lossless upcast of bfloat16)."""
    prefix = ckpt_prefix(export_dir, dim, iteration)
    with np.load(prefix + ".npz") as z:
        meta = json.loads(str(z["meta"]))
        saved = meta.get("table_dtype", "float32")
        if table_dtype is not None and table_dtype != saved:
            warnings.warn(
                f"checkpoint iteration {iteration} was saved with "
                f"table_dtype={saved}; resuming at the configured "
                f"{table_dtype}",
                stacklevel=2,
            )
        dtype = _torch_dtype(table_dtype if table_dtype is not None else saved)
        emb = torch.from_numpy(np.array(z["emb"], dtype=np.float32)).to(device, dtype)
        ctx = torch.from_numpy(np.array(z["ctx"], dtype=np.float32)).to(device, dtype)
    vocab = Vocab.load(vocab_path_for(prefix + ".npz"))
    return SGNSParams(emb=emb, ctx=ctx), vocab, meta


def latest_iteration(export_dir: str, dim: int, verified_only: bool = True) -> int:
    """Highest saved (and, by default, verified) iteration for ``dim``, or 0."""
    for _, it, _ in iter_checkpoints_newest_first(
        export_dir, verified_only=verified_only, dim=dim
    ):
        return it
    return 0


def read_npz_rows(path: str, name: str, start: int,
                  end: int) -> Tuple[np.ndarray, int]:
    """Read rows ``[start, end)`` of array ``name`` from an
    **uncompressed** npz (``np.savez``, which ``atomic_savez`` uses)
    WITHOUT materializing the whole array: the zip member is STORED,
    so after parsing the npy header the row range is one seek + one
    read.  Returns ``(rows, total_rows)``.

    This is what lets a shard replica sized for ``rows/num_shards``
    actually load (and hot-stage) its slice of a table that does not
    fit the host — ``serve/registry.py`` routes sharded npz loads
    through here (a copy of the reference's
    ``io/checkpoint.py:read_npz_rows``).  Any structural surprise (compressed member, Fortran
    order, >2-D quirks) raises ``ValueError`` so the caller can fall
    back to the full load."""
    import struct

    member = name if name.endswith(".npy") else name + ".npy"
    # called from the registry's load path, which holds its refresh lock
    # (loads serialize; serve reads never take that lock)
    with open(path, "rb") as f:
        with zipfile.ZipFile(f) as zf:
            try:
                info = zf.getinfo(member)
            except KeyError:
                raise ValueError(
                    f"{path}: no member {member!r}"
                ) from None
            if info.compress_type != zipfile.ZIP_STORED:
                raise ValueError(
                    f"{path}:{member}: compressed member — cannot "
                    "seek a row range"
                )
        # the member's data offset: local file header (30 fixed bytes
        # + name + extra — the extra field can differ from the central
        # directory's, so it must be read from the LOCAL header)
        f.seek(info.header_offset)
        local = f.read(30)
        if len(local) != 30 or local[:4] != b"PK\x03\x04":
            raise ValueError(f"{path}:{member}: bad local zip header")
        name_len, extra_len = struct.unpack("<HH", local[26:30])
        f.seek(info.header_offset + 30 + name_len + extra_len)
        version = np.lib.format.read_magic(f)
        if version == (1, 0):
            shape, fortran, dtype = (
                np.lib.format.read_array_header_1_0(f)
            )
        elif version == (2, 0):
            shape, fortran, dtype = (
                np.lib.format.read_array_header_2_0(f)
            )
        else:
            raise ValueError(
                f"{path}:{member}: unsupported npy version {version}"
            )
        if fortran or len(shape) < 1:
            raise ValueError(
                f"{path}:{member}: need a C-ordered array"
            )
        total = int(shape[0])
        start = max(0, int(start))
        end = min(total, int(end))
        n = max(0, end - start)
        row_bytes = int(dtype.itemsize * int(np.prod(shape[1:], dtype=np.int64)))
        f.seek(start * row_bytes, 1)
        buf = f.read(n * row_bytes)
        if len(buf) != n * row_bytes:
            raise ValueError(
                f"{path}:{member}: short read ({len(buf)} of "
                f"{n * row_bytes} bytes)"
            )
        rows = np.frombuffer(buf, dtype=dtype).reshape(
            (n,) + tuple(int(s) for s in shape[1:])
        )
        return rows.copy(), total
