"""The seen-gene holdout protocol (a copy of ``gene2vec_tpu/eval/holdout.py``):
the real-data quality measurement of the reference's bench gate, with the
same seed, split and embedding-corpus definition, so the port's numbers
and the reference's stay comparable.

The reference's train/valid/test splits are pairwise gene-disjoint, so a
test-split AUC says nothing about an embedding trained on in-repo data.
The measurable task is link prediction over *seen* genes: hold out a
fraction of the train split's pairs, train SGNS on the remaining
positives, rank the held-out pairs by cosine.  The protocol constants are
the reference's, frozen (its comments give each one's reason).
"""

from __future__ import annotations

from typing import List, NamedTuple, Tuple

import numpy as np

HOLDOUT_SEED = 7
HOLDOUT_FRACTION = 0.2
#: the reference's sequential CPU oracle under this protocol (in-vocab
#: cosine AUC, 50 epochs): the parity reference for the gate
ORACLE_COS_AUC = 0.878
#: the reference's no-embedding degree-product baseline on the same
#: holdout: the metric's co-occurrence floor
DEGREE_BASELINE_AUC = 0.859
#: the gate's lower threshold: above the degree floor, with slack under
#: the oracle for config and seed noise
GATE_MIN_AUC = 0.862
#: the gate's upper bound: the metric rewards raw co-occurrence, so an
#: AUC far above the oracle marks a degenerate estimator, not a better
#: embedding
GATE_MAX_AUC = 0.92


def auc_in_gate_band(auc: float) -> bool:
    """The two-sided gate decision on the holdout cosine AUC: at least
    GATE_MIN_AUC (it must beat the degree floor with oracle slack) and at
    most GATE_MAX_AUC (far above the oracle = co-occurrence degeneration:
    the "too good" runs are the broken ones).  NaN (diverged embedding)
    fails both sides."""
    return bool(GATE_MIN_AUC <= auc <= GATE_MAX_AUC)


def read_split(data_dir: str, split: str) -> Tuple[List[List[str]], np.ndarray]:
    """One reference-format split: pair lines + int labels."""
    with open(f"{data_dir}/{split}_text.txt") as f:
        lines = [ln.split() for ln in f if ln.strip()]
    with open(f"{data_dir}/{split}_label.txt") as f:
        labels = [int(ln) for ln in f if ln.strip()]
    if len(lines) != len(labels):
        raise ValueError(
            f"{split}: {len(lines)} pair lines vs {len(labels)} labels"
        )
    return lines, np.asarray(labels)


class HoldoutSplit(NamedTuple):
    fit_pairs: List[List[str]]    # classifier training pairs (all labels)
    fit_labels: np.ndarray
    hold_pairs: List[List[str]]   # evaluation pairs — never trained on
    hold_labels: np.ndarray
    fit_positives: List[List[str]]  # THE embedding corpus (fit positives)


def holdout_split(
    lines: List[List[str]],
    labels: np.ndarray,
    fraction: float = HOLDOUT_FRACTION,
    seed: int = HOLDOUT_SEED,
) -> HoldoutSplit:
    """The canonical pair-level split.  The embedding corpus is ALL fit
    positives — a monitoring dev slice, if a caller wants one, must be
    carved from ``fit_pairs`` *after* this split and must not shrink the
    embedding corpus."""
    rng = np.random.RandomState(seed)
    perm = rng.permutation(len(lines))
    n_hold = int(len(lines) * fraction)
    hold_idx, fit_idx = perm[:n_hold], perm[n_hold:]
    fit_pairs = [lines[i] for i in fit_idx]
    fit_labels = labels[fit_idx]
    return HoldoutSplit(
        fit_pairs=fit_pairs,
        fit_labels=fit_labels,
        hold_pairs=[lines[i] for i in hold_idx],
        hold_labels=labels[hold_idx],
        fit_positives=[p for p, y in zip(fit_pairs, fit_labels) if y == 1],
    )


def load_holdout(data_dir: str):
    """The one canonical construction of (embedding PairCorpus, split):
    read the reference train split, apply :func:`holdout_split`, and build
    the corpus from ALL fit positives.  Every caller goes through here, so
    the corpus definition cannot drift."""
    from gene2vec_tpu_torch.data.pipeline import PairCorpus
    from gene2vec_tpu_torch.io.vocab import Vocab

    lines, labels = read_split(data_dir, "train")
    split = holdout_split(lines, labels)
    vocab = Vocab.from_pairs(split.fit_positives)
    return PairCorpus(vocab, vocab.encode_pairs(split.fit_positives)), split


def cosine_scores(
    token_to_id, matrix: np.ndarray, pairs: List[List[str]]
) -> Tuple[np.ndarray, np.ndarray]:
    """(cosine score per pair, in-vocab mask).  Out-of-vocab pairs score
    0.0 — genes absent from every positive fit pair are themselves a
    negative signal, but gates should use the in-vocab subset, where the
    ranking comes entirely from learned geometry."""
    m = matrix / (np.linalg.norm(matrix, axis=1, keepdims=True) + 1e-9)
    scores = np.zeros(len(pairs))
    in_vocab = np.zeros(len(pairs), bool)
    for i, (a, b) in enumerate(pairs):
        ia, ib = token_to_id.get(a), token_to_id.get(b)
        if ia is not None and ib is not None:
            scores[i] = float(m[ia] @ m[ib])
            in_vocab[i] = True
    return scores, in_vocab


def holdout_cos_auc(
    vocab, emb: np.ndarray, split: HoldoutSplit, in_vocab_only: bool = True
) -> float:
    """In-vocab holdout cosine AUC — the gate metric (oracle: 0.878)."""
    from gene2vec_tpu_torch.eval.metrics import roc_auc_score

    scores, mask = cosine_scores(vocab.token_to_id, emb, split.hold_pairs)
    if in_vocab_only:
        return roc_auc_score(split.hold_labels[mask], scores[mask])
    return roc_auc_score(split.hold_labels, scores)
