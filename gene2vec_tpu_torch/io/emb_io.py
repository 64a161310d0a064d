"""Embedding matrix text formats — a copy of the writers and the reader the
export needs from ``gene2vec_tpu/io/emb_io.py``.

* **matrix-txt** — ``gene\\tv1 v2 ... vD \\n`` per gene, trailing space
  before the newline;
* **word2vec-format** — a ``"<count> <dim>"`` header line then
  ``gene v1 ... vD`` rows.
"""

from __future__ import annotations

from typing import List, Sequence, Tuple

import numpy as np


def write_matrix_txt(path: str, tokens: Sequence[str], matrix: np.ndarray) -> None:
    matrix = np.asarray(matrix)
    with open(path, "w", encoding="utf-8") as f:
        for tok, row in zip(tokens, matrix):
            f.write(str(tok) + "\t" + " ".join(repr(float(v)) for v in row) + " \n")


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
