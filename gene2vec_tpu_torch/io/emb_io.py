"""Embedding matrix text formats — a copy of ``gene2vec_tpu/io/emb_io.py``.

* **matrix-txt** — ``gene\\tv1 v2 ... vD \\n`` per gene, trailing space
  before the newline;
* **word2vec-format** — a ``"<count> <dim>"`` header line then
  ``gene v1 ... vD`` rows.

Plus the GGIPNN harness's loader: an embedding file keyed by an external
vocab, with a U(−0.25, 0.25) random fallback for missing genes
(``src/GGIPNN_util.py:3-16``).
"""

from __future__ import annotations

from typing import Dict, List, Sequence, Tuple

import numpy as np


def write_matrix_txt(path: str, tokens: Sequence[str], matrix: np.ndarray) -> None:
    matrix = np.asarray(matrix)
    with open(path, "w", encoding="utf-8") as f:
        for tok, row in zip(tokens, matrix):
            f.write(str(tok) + "\t" + " ".join(repr(float(v)) for v in row) + " \n")


def read_matrix_txt(path: str) -> Tuple[List[str], np.ndarray]:
    tokens: List[str] = []
    rows: List[np.ndarray] = []
    with open(path, "r", encoding="utf-8") as f:
        for line in f:
            line = line.strip()
            if not line:
                continue
            tok, _, rest = line.partition("\t")
            if not rest:  # tolerate space-separated matrix files
                parts = line.split()
                tok, rest = parts[0], " ".join(parts[1:])
            tokens.append(tok)
            rows.append(np.asarray(rest.split(), dtype=np.float32))
    return tokens, np.vstack(rows) if rows else np.zeros((0, 0), np.float32)


def write_word2vec_format(path: str, tokens: Sequence[str], matrix: np.ndarray) -> None:
    matrix = np.asarray(matrix)
    with open(path, "w", encoding="utf-8") as f:
        f.write(f"{len(tokens)} {matrix.shape[1]}\n")
        for tok, row in zip(tokens, matrix):
            f.write(str(tok) + " " + " ".join(repr(float(v)) for v in row) + "\n")


def read_word2vec_format(path: str) -> Tuple[List[str], np.ndarray]:
    """Streaming reader: the header preallocates the (count, dim) matrix
    and rows parse straight into it."""
    tokens: List[str] = []
    with open(path, "r", encoding="utf-8") as f:
        header = f.readline().split()
        if len(header) != 2:
            raise ValueError(f"{path}: missing word2vec '<count> <dim>' header")
        count, dim = int(header[0]), int(header[1])
        matrix = np.empty((count, dim), dtype=np.float32)
        n = 0
        for line in f:
            parts = line.rstrip("\n").split(" ")
            if len(parts) < dim + 1:
                continue
            if n < count:
                matrix[n] = np.asarray(parts[1 : dim + 1], dtype=np.float32)
                tokens.append(parts[0])
            n += 1
    if n != count:
        raise ValueError(f"{path}: header says {count} rows, found {n}")
    return tokens, matrix if count else np.zeros((0, dim), np.float32)


def load_embedding_any(path: str) -> Tuple[List[str], np.ndarray]:
    """Auto-detect matrix-txt vs word2vec-format by the first line."""
    with open(path, "r", encoding="utf-8") as f:
        first = f.readline().split()
    if len(first) == 2 and all(p.isdigit() for p in first):
        return read_word2vec_format(path)
    return read_matrix_txt(path)


def load_embedding_for_vocab(
    vocabulary: Dict[str, int],
    path: str,
    vector_size: int,
    rng: np.random.RandomState | None = None,
) -> np.ndarray:
    """Embedding matrix aligned to an external vocab.  Missing genes keep a
    U(−0.25, 0.25) random init drawn from ``rng`` — the reference's
    deliberate fallback (SURVEY §2.2 #6)."""
    rng = rng or np.random.RandomState(0)
    out = rng.uniform(-0.25, 0.25, (len(vocabulary), vector_size)).astype(np.float32)
    tokens, matrix = load_embedding_any(path)
    for tok, row in zip(tokens, matrix):
        idx = vocabulary.get(tok)
        if idx is not None and row.shape[0] == vector_size:
            out[idx] = row
    return out
