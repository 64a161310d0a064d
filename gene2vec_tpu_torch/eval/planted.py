"""The planted-cluster collapse check (a copy of
``gene2vec_tpu/eval/planted.py``), shared by the port's quality tooling
and ``chip_smoke.py``'s quality phase so both measure what the reference's
bench gate and ``tests/test_quality_regression.py`` measure.

A corpus of ``n_clusters`` disjoint gene cliques trained with the default
config must yield intra-cluster cosine > INTRA_MIN while inter-cluster
cosine stays < INTER_MAX (a design can pass any intra-only criterion while
the inter-cluster cosine drifts to ~1).  The constants are the
reference's, frozen.
"""

from __future__ import annotations

import itertools
from typing import Tuple

import numpy as np

N_CLUSTERS = 10
N_GENES = 20
PAIRS_PER_CLUSTER = 2000
INTRA_MIN = 0.95
INTER_MAX = 0.6


def planted_corpus(
    n_clusters: int = N_CLUSTERS,
    n_genes: int = N_GENES,
    pairs_per: int = PAIRS_PER_CLUSTER,
    seed: int = 0,
):
    """(vocab, PairCorpus) of ``n_clusters`` disjoint gene cliques."""
    from gene2vec_tpu_torch.data.pipeline import PairCorpus
    from gene2vec_tpu_torch.io.vocab import Vocab

    rng = np.random.RandomState(seed)
    lines = []
    for c in range(n_clusters):
        genes = [f"C{c}G{i}" for i in range(n_genes)]
        for _ in range(pairs_per):
            a, b = rng.choice(n_genes, 2, replace=False)
            lines.append((genes[a], genes[b]))
    vocab = Vocab.from_pairs(lines)
    return vocab, PairCorpus(vocab, vocab.encode_pairs(lines))


def cluster_cosines(
    vocab,
    emb: np.ndarray,
    n_clusters: int = N_CLUSTERS,
    n_genes: int = N_GENES,
) -> Tuple[float, float]:
    """(mean intra-cluster cosine, mean inter-cluster cosine)."""
    m = emb / (np.linalg.norm(emb, axis=1, keepdims=True) + 1e-9)
    idx = vocab.token_to_id
    rng = np.random.RandomState(1)
    intra, inter = [], []
    for c in range(n_clusters):
        rows = [idx[f"C{c}G{i}"] for i in range(8)]
        for a, b in itertools.combinations(rows, 2):
            intra.append(m[a] @ m[b])
    for _ in range(500):
        c1, c2 = rng.choice(n_clusters, 2, replace=False)
        inter.append(
            m[idx[f"C{c1}G{rng.randint(n_genes)}"]]
            @ m[idx[f"C{c2}G{rng.randint(n_genes)}"]]
        )
    return float(np.mean(intra)), float(np.mean(inter))
