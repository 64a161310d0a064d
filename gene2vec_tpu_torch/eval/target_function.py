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
there is no kernel.  :func:`graph_neighborhood_ratio` is the variant over
a precomputed kNN graph (a ``knn_graph`` batch artifact).
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



def graph_neighborhood_ratio(
    graph_dir: str,
    gmt_path: str,
    *,
    max_pathway_genes: int = MAX_PATHWAY_GENES,
    seed: int = RANDOM_SEED,
) -> Dict[str, float]:
    """Intrinsic eval over a PRECOMPUTED kNN graph (a finalized
    ``knn_graph`` batch artifact, :func:`gene2vec_tpu_torch.batch.artifact
    .load_graph`): the fraction of each gene's k nearest neighbors
    that share a pathway with it, against the same fraction for
    degree-matched random neighbor sets.

    The cosine-ratio :func:`target_function` needs the raw matrix;
    this one needs only the graph — the shape the serve fleet's batch
    plane exports — so the fleet's retrieval quality (including any
    ANN approximation) is measured exactly as served, not recomputed
    from the checkpoint.

    Returns ``{"neighbor_hit_rate", "random_hit_rate", "ratio",
    "genes_scored", "k"}``; raises ``ValueError`` when no graph gene
    appears in any pathway (wrong .gmt for this vocab)."""
    from gene2vec_tpu_torch.batch.artifact import load_graph

    tokens, ids, _scores, meta = load_graph(graph_dir)
    pathways = load_gmt(gmt_path, max_pathway_genes)
    member: Dict[str, set] = {}
    for name, genes in pathways.items():
        for g in genes:
            member.setdefault(g, set()).add(name)
    token_member = [member.get(t) for t in tokens]
    k = ids.shape[1]
    rng = random.Random(seed)
    v = len(tokens)
    hits = rand_hits = 0
    scored = 0
    for row, m in enumerate(token_member):
        if not m:
            continue
        scored += 1
        for j in range(k):
            other = token_member[int(ids[row, j])]
            if other and not m.isdisjoint(other):
                hits += 1
        for _ in range(k):
            other = token_member[rng.randrange(v)]
            if other and not m.isdisjoint(other):
                rand_hits += 1
    if scored == 0:
        raise ValueError(
            "no graph gene appears in any pathway (vocab/.gmt mismatch)"
        )
    neighbor_rate = hits / (scored * k)
    random_rate = rand_hits / (scored * k)
    return {
        "neighbor_hit_rate": neighbor_rate,
        "random_hit_rate": random_rate,
        "ratio": (
            neighbor_rate / random_rate if random_rate > 0
            else float("inf")
        ),
        "genes_scored": scored,
        "k": k,
        "iteration": int(meta.get("iteration", -1)),
    }


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
