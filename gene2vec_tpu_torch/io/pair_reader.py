"""Pair-corpus reading — a copy of ``gene2vec_tpu/io/pair_reader.py``
(pure-Python reader; the reference's optional native C++ fast path is not
carried over, and its output is behaviour-identical).

Every file in a directory whose name ends with the pattern is read with
windows-1252 decoding and split on whitespace, one pair per line.
"""

from __future__ import annotations

import os
from typing import Iterator, List, Tuple

import numpy as np

from gene2vec_tpu_torch.io.vocab import Vocab


def iter_pair_files(source_dir: str, ending_pattern: str = "txt") -> List[str]:
    """Files in ``source_dir`` whose names end with ``ending_pattern``,
    sorted for determinism."""
    names = sorted(n for n in os.listdir(source_dir) if n.endswith(ending_pattern))
    return [os.path.join(source_dir, n) for n in names]


def read_pair_lines(path: str, encoding: str = "windows-1252") -> Iterator[List[str]]:
    """Yield whitespace-split token lists, one per non-empty line."""
    with open(path, "r", encoding=encoding) as f:
        for line in f:
            toks = line.strip().split()
            if toks:
                yield toks


def read_pair_files(
    source_dir: str,
    ending_pattern: str = "txt",
    encoding: str = "windows-1252",
) -> List[List[str]]:
    """All pairs from all matching files, as token lists."""
    pairs: List[List[str]] = []
    for path in iter_pair_files(source_dir, ending_pattern):
        pairs.extend(read_pair_lines(path, encoding=encoding))
    return pairs


def load_corpus(
    source_dir: str,
    ending_pattern: str = "txt",
    min_count: int = 1,
    encoding: str = "windows-1252",
) -> Tuple[Vocab, np.ndarray]:
    """Read a pair corpus directory → (Vocab, (N,2) int32 encoded pairs)."""
    token_pairs = read_pair_files(source_dir, ending_pattern, encoding=encoding)
    vocab = Vocab.from_pairs(token_pairs, min_count=min_count)
    return vocab, vocab.encode_pairs(token_pairs)
