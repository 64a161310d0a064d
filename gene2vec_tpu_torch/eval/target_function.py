"""Intrinsic evaluation, the "target function" — a numpy copy of
``gene2vec_tpu/eval/target_function.py``.

score = (mean intra-pathway cosine similarity) / (mean random-pair cosine
similarity) (``src/evaluation_target_function.py:16-60``), with the
reference's semantics:

* MSigDB ``.gmt`` pathways with more than 50 genes are skipped (lines of
  at most 52 tab fields: name, url, ≤50 genes);
* pathways contribute only genes present in the embedding, and pathways
  with fewer than 2 present genes are skipped;
* the denominator shuffles the embedding's gene list with
  ``random.seed(35)`` and averages all C(1000, 2) pair similarities.

Each pathway's mean pairwise cosine is one norm: with unit rows u_i,

    mean_{i<j} u_i·u_j = (‖Σ_i u_i‖² − n) / (n (n − 1)),

so the evaluation is a row normalization and a segment sum on the host;
there is no kernel.  ``graph_neighborhood_ratio`` (the kNN-graph variant)
waits for the batch plane's artifacts.
"""

from __future__ import annotations

import random
from typing import Dict, List, Sequence, Tuple

import numpy as np

from gene2vec_tpu_torch.io.emb_io import load_embedding_any

MAX_PATHWAY_GENES = 50
RANDOM_PAIR_GENES = 1000
RANDOM_SEED = 35


def load_gmt(path: str, max_genes: int = MAX_PATHWAY_GENES) -> Dict[str, List[str]]:
    """Pathway name → gene list from an MSigDB ``.gmt`` file (tab-separated:
    name, url, genes…), keeping pathways with at most ``max_genes`` genes."""
    pathways: Dict[str, List[str]] = {}
    with open(path, "r", encoding="utf-8") as f:
        for line in f:
            fields = line.rstrip("\n").split("\t")
            if len(fields) < 3 or len(fields) > max_genes + 2:
                continue
            pathways[fields[0]] = [g for g in fields[2:] if g]
    return pathways


def _unit_rows(matrix: np.ndarray) -> np.ndarray:
    norms = np.linalg.norm(matrix, axis=1, keepdims=True)
    return matrix / np.maximum(norms, 1e-12)


def mean_pairwise_cosine(unit: np.ndarray) -> float:
    """Mean over all C(n,2) pairwise cosine similarities of unit rows,
    via the sum-of-vectors identity (exact, no pair loop)."""
    n = unit.shape[0]
    if n < 2:
        raise ValueError("need at least 2 rows")
    s = unit.sum(axis=0)
    return float((s @ s - n) / (n * (n - 1)))


def target_function(
    emb_path: str,
    gmt_path: str,
    *,
    max_pathway_genes: int = MAX_PATHWAY_GENES,
    num_random_genes: int = RANDOM_PAIR_GENES,
    seed: int = RANDOM_SEED,
) -> float:
    """The reference's ``targetFunc`` on any supported embedding file."""
    tokens, matrix = load_embedding_any(emb_path)
    pathways = load_gmt(gmt_path, max_pathway_genes)
    return target_function_arrays(
        tokens, matrix, pathways, num_random_genes=num_random_genes, seed=seed,
    )


def target_function_arrays(
    tokens: Sequence[str],
    matrix: np.ndarray,
    pathways: Dict[str, List[str]],
    *,
    num_random_genes: int = RANDOM_PAIR_GENES,
    seed: int = RANDOM_SEED,
) -> float:
    numerator, _ = pathway_similarities(tokens, matrix, pathways)
    denominator = random_pair_similarity(
        tokens, matrix, num_genes=num_random_genes, seed=seed
    )
    return numerator / denominator


def pathway_similarities(
    tokens: Sequence[str],
    matrix: np.ndarray,
    pathways: Dict[str, List[str]],
) -> Tuple[float, Dict[str, float]]:
    """(mean over pathways, per-pathway mean intra-pathway cosine)."""
    token_to_id = {t: i for i, t in enumerate(tokens)}
    unit = _unit_rows(np.asarray(matrix, dtype=np.float64))
    per_pathway: Dict[str, float] = {}
    for name, genes in pathways.items():
        idx = [token_to_id[g] for g in genes if g in token_to_id]
        if len(idx) < 2:
            continue
        per_pathway[name] = mean_pairwise_cosine(unit[idx])
    if not per_pathway:
        raise ValueError("no pathway had ≥2 genes present in the embedding")
    return float(np.mean(list(per_pathway.values()))), per_pathway


def random_pair_similarity(
    tokens: Sequence[str],
    matrix: np.ndarray,
    *,
    num_genes: int = RANDOM_PAIR_GENES,
    seed: int = RANDOM_SEED,
) -> float:
    """Mean cosine over all pairs of ``num_genes`` randomly chosen genes,
    with the reference's RNG recipe: python ``random.seed(seed)`` +
    ``random.shuffle`` of the emb-file gene order, the first 1000
    (``src/evaluation_target_function.py:44-47``)."""
    gene_list = list(tokens)
    rng = random.Random()
    rng.seed(seed)
    rng.shuffle(gene_list)
    chosen = gene_list[:num_genes]
    if len(chosen) < 2:
        raise ValueError("embedding too small for random-pair denominator")
    token_to_id = {t: i for i, t in enumerate(tokens)}
    idx = [token_to_id[g] for g in chosen]
    unit = _unit_rows(np.asarray(matrix, dtype=np.float64))
    return mean_pairwise_cosine(unit[idx])
