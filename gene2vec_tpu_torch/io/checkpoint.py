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
"""

from __future__ import annotations

import json
import os
import re
import warnings
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
) -> str:
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
        table_dtype=_dtype_name(params.emb),
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
