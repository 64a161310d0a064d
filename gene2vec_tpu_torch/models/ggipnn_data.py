"""GGIPNN data utilities — a copy of ``gene2vec_tpu/models/ggipnn_data.py``
(array-identical outputs).

Behavioral equivalents of ``src/GGIPNN_util.py``:

* **transductive vocab** — fit over train+valid+test pair text together
  (``src/GGIPNN_Classification.py:61-62``, SURVEY §2.2 #5): the model indexes
  a fixed pretrained gene vocabulary, so every split's genes must be in it;
* ``batch_iter`` — epoch-shuffling batch iterator (``src/GGIPNN_util.py:18-35``);
* one-hot labels (``src/GGIPNN_util.py:37-50``).

Unlike the reference's ``myFit`` (which silently depends on 2-token lines —
quirk #7: ``j = 1`` instead of ``j += 1``, ``src/GGIPNN_util.py:82``), the
encoder here is explicit about the pair shape.
"""

from __future__ import annotations

from typing import Dict, Iterable, Iterator, List, Sequence, Tuple

import numpy as np


class PairTextVocab:
    """Token → contiguous id over 2-token pair lines, in first-seen order
    (matching the reference's dict-accumulation order semantics)."""

    __slots__ = ("token_to_id", "id_to_token")

    def __init__(self) -> None:
        self.token_to_id: Dict[str, int] = {}
        self.id_to_token: List[str] = []

    def __len__(self) -> int:
        return len(self.id_to_token)

    def fit(self, *line_sets: Iterable[str]) -> "PairTextVocab":
        """Fit over any number of line iterables (pass all splits at once
        for the reference's transductive behavior)."""
        for lines in line_sets:
            for line in lines:
                for tok in line.split():
                    if tok not in self.token_to_id:
                        self.token_to_id[tok] = len(self.id_to_token)
                        self.id_to_token.append(tok)
        return self

    def transform(self, lines: Iterable[str]) -> np.ndarray:
        """Pair lines → (N, 2) int32. Raises on out-of-vocab tokens (cannot
        happen when the vocab was fit transductively)."""
        out: List[Tuple[int, int]] = []
        for line in lines:
            toks = line.split()
            if len(toks) != 2:
                raise ValueError(f"expected 2 tokens per line, got {toks!r}")
            out.append((self.token_to_id[toks[0]], self.token_to_id[toks[1]]))
        return np.asarray(out, dtype=np.int32).reshape(-1, 2)


def one_hot_labels(labels: Sequence, num_classes: int = 2) -> np.ndarray:
    """Label sequence → (N, C) float32 one-hot; labels are ints or digit
    strings (the reference's label files hold '0'/'1' lines)."""
    idx = np.asarray([int(l) for l in labels], dtype=np.int64)
    if idx.size and (idx.min() < 0 or idx.max() >= num_classes):
        raise ValueError(f"label out of range [0, {num_classes})")
    out = np.zeros((len(idx), num_classes), dtype=np.float32)
    out[np.arange(len(idx)), idx] = 1.0
    return out


def batch_iter(
    data: np.ndarray,
    batch_size: int,
    num_epochs: int,
    shuffle: bool = True,
    seed: int = 10,
) -> Iterator[np.ndarray]:
    """Epoch-shuffling batch iterator over a stacked array — the behavior of
    ``src/GGIPNN_util.py:18-35`` (ragged final batch kept, reshuffle per
    epoch)."""
    data = np.asarray(data)
    n = data.shape[0]
    num_batches = (n - 1) // batch_size + 1 if n else 0
    rng = np.random.RandomState(seed)
    for _ in range(num_epochs):
        order = rng.permutation(n) if shuffle else np.arange(n)
        for b in range(num_batches):
            yield data[order[b * batch_size : min((b + 1) * batch_size, n)]]


def read_lines(path: str) -> List[str]:
    with open(path, "r", encoding="utf-8") as f:
        return [line.strip() for line in f if line.strip()]
