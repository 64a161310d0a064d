"""Vocabulary: gene symbol ↔ contiguous int id, with counts.

A copy of ``gene2vec_tpu/io/vocab.py`` (the port imports nothing of the
JAX package); the two must stay byte-compatible in ``vocab.tsv``.

Ordering follows the word2vec convention the reference inherits from gensim
(``src/gene2vec.py:70`` builds vocab inside ``gensim.models.Word2Vec``):
tokens sorted by corpus frequency, descending, ties broken by first
appearance (stable sort).  ``min_count`` drops rare tokens; the reference
always uses ``min_count=1`` so every gene is kept.
"""

from __future__ import annotations

from typing import Dict, Iterable, List, Sequence, Tuple

import numpy as np


class Vocab:
    """Frequency-sorted token vocabulary."""

    __slots__ = ("id_to_token", "token_to_id", "counts")

    def __init__(self, id_to_token: List[str], counts: np.ndarray):
        if len(id_to_token) != len(counts):
            raise ValueError("token list and counts length mismatch")
        self.id_to_token = list(id_to_token)
        self.counts = np.asarray(counts, dtype=np.int64)
        self.token_to_id: Dict[str, int] = {
            tok: i for i, tok in enumerate(self.id_to_token)
        }

    # -- construction ------------------------------------------------------

    @classmethod
    def from_pairs(cls, pairs: Iterable[Sequence[str]], min_count: int = 1) -> "Vocab":
        """Build from an iterable of token sequences (usually 2-token pairs)."""
        counts: Dict[str, int] = {}
        for toks in pairs:
            for tok in toks:
                counts[tok] = counts.get(tok, 0) + 1
        return cls.from_counts(counts, min_count=min_count)

    @classmethod
    def from_counts(cls, counts: Dict[str, int], min_count: int = 1) -> "Vocab":
        # dict preserves insertion order → stable sort ties break by first
        # appearance, matching gensim's sort_vocab behavior.
        items = [(tok, c) for tok, c in counts.items() if c >= min_count]
        items.sort(key=lambda kv: kv[1], reverse=True)
        toks = [kv[0] for kv in items]
        cnts = np.array([kv[1] for kv in items], dtype=np.int64)
        return cls(toks, cnts)

    # -- encoding ----------------------------------------------------------

    def __len__(self) -> int:
        return len(self.id_to_token)

    def __contains__(self, tok: str) -> bool:
        return tok in self.token_to_id

    def encode_pairs(self, pairs: Iterable[Sequence[str]]) -> np.ndarray:
        """Encode 2-token pairs to an (N, 2) int32 array, dropping pairs with
        out-of-vocab tokens (only possible when min_count > 1)."""
        t2i = self.token_to_id
        out: List[Tuple[int, int]] = []
        for toks in pairs:
            if len(toks) != 2:
                continue
            a = t2i.get(toks[0])
            b = t2i.get(toks[1])
            if a is not None and b is not None:
                out.append((a, b))
        return np.asarray(out, dtype=np.int32).reshape(-1, 2)

    # -- persistence -------------------------------------------------------

    def save(self, path: str) -> None:
        with open(path, "w", encoding="utf-8") as f:
            for tok, c in zip(self.id_to_token, self.counts):
                f.write(f"{tok}\t{int(c)}\n")

    @classmethod
    def load(cls, path: str) -> "Vocab":
        toks: List[str] = []
        cnts: List[int] = []
        with open(path, "r", encoding="utf-8") as f:
            for line in f:
                line = line.rstrip("\n")
                if not line:
                    continue
                tok, c = line.split("\t")
                toks.append(tok)
                cnts.append(int(c))
        return cls(toks, np.asarray(cnts, dtype=np.int64))
