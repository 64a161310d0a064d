"""Training configuration — the reference's ``SGNSConfig`` and
``GGIPNNConfig`` with the same fields and defaults
(``gene2vec_tpu/config.py:16-212, 216-240``).

Defaults mirror the reference Gene2vec parameter block (dim=200, sg=1,
window=1, min_count=1, 10 iterations) and gensim's SGNS defaults (5
negatives, alpha 0.025 → 1e-4, unigram^0.75 noise).  The per-field
rationale lives in the reference config's comments.

``CorpusConfig`` and ``TSNEConfig`` are the reference's corpus-builder
and t-SNE defaults (``gene2vec_tpu/config.py:254-285``).

This port trains every objective (sgns, cbow, sg_hs, cbow_hs) and every
noise estimator (stratified, shared, per_example) with float32 or
bfloat16 tables (``table_dtype``; bfloat16 write-backs round
stochastically unless ``bf16_stochastic_round`` is off).  The step always
computes in float32.  Fields whose non-default values select code this
port does not have are rejected at construction with a clear error (see
``_UNSUPPORTED``).
"""

from __future__ import annotations

import dataclasses
from typing import Tuple


@dataclasses.dataclass(frozen=True)
class SGNSConfig:
    dim: int = 200
    num_iters: int = 10
    objective: str = "sgns"
    window: int = 1
    min_count: int = 1
    negatives: int = 5
    ns_exponent: float = 0.75
    lr: float = 0.025
    min_lr: float = 1e-4
    batch_pairs: int = 4096
    seed: int = 1
    table_dtype: str = "float32"
    bf16_stochastic_round: bool = True
    compute_dtype: str = "float32"
    both_directions: bool = True
    combiner: str = "capped"       # "capped" | "mean" | "sum"
    negative_mode: str = "stratified"
    strat_head: int = 256
    strat_block: int = 512
    strat_group: int = 256
    positive_head: int = 512
    positive_mid: int = 2048
    pos_layout_shards: int = 0
    hs_dense_depth: int = 10
    shared_pool: int = 1024
    shared_pool_auto: bool = True
    shared_groups: int = 0
    shuffle_each_iter: bool = True
    shuffle_mode: str = "offset"   # "offset" | "full"
    txt_output: bool = True
    async_checkpoint: bool = False
    timeline: bool = True
    kernel_profile: bool = False

    data_axis: str = "data"
    model_axis: str = "model"
    vocab_sharded: bool = False
    donate: bool = True

    def __post_init__(self):
        for name, ok, why in _UNSUPPORTED:
            if not ok(getattr(self, name)):
                raise NotImplementedError(
                    f"SGNSConfig.{name}={getattr(self, name)!r} is not "
                    f"supported by gene2vec_tpu_torch: {why}"
                )
        if self.combiner not in ("capped", "mean", "sum"):
            raise ValueError(f"unknown combiner {self.combiner!r}")
        if self.objective not in OBJECTIVES:
            raise ValueError(f"unknown objective {self.objective!r}")
        if self.negative_mode not in NEGATIVE_MODES:
            raise ValueError(f"unknown negative_mode {self.negative_mode!r}")
        if self.table_dtype not in TABLE_DTYPES:
            raise ValueError(f"unknown table_dtype {self.table_dtype!r}")


OBJECTIVES = ("sgns", "cbow", "sg_hs", "cbow_hs")
NEGATIVE_MODES = ("stratified", "shared", "per_example")
TABLE_DTYPES = ("float32", "bfloat16")


# (field, accepted-value predicate, reason) — each names what the port lacks
_UNSUPPORTED = (
    ("compute_dtype", lambda v: v == "float32",
     "bf16 arithmetic inside the step is not ported"),
    ("vocab_sharded", lambda v: not v,
     "sharded tables need the multi-GPU path, which is not ported"),
    ("async_checkpoint", lambda v: not v,
     "the background checkpoint writer is not ported; exports are "
     "written inline"),
    ("pos_layout_shards", lambda v: v == 0,
     "a per-device batch layout needs the multi-GPU path, which is not "
     "ported"),
    ("data_axis", lambda v: v == "data",
     "device meshes are not ported"),
    ("model_axis", lambda v: v == "model",
     "device meshes are not ported"),
)


@dataclasses.dataclass(frozen=True)
class GGIPNNConfig:
    """Gene-gene-interaction MLP config — the reference's fields and
    defaults: batch 128, 1 epoch, Adam 1e-3, dropout keep 0.5, hidden
    widths (100, 100, 10), L2 λ = 0, frozen pretrained embedding."""

    embedding_dim: int = 200
    sequence_length: int = 2
    num_classes: int = 2
    hidden_dims: Tuple[int, int, int] = (100, 100, 10)
    dropout_keep_prob: float = 0.5
    l2_lambda: float = 0.0
    embed_train: bool = False
    use_pretrained: bool = True
    batch_size: int = 128
    num_epochs: int = 1
    learning_rate: float = 1e-3
    evaluate_every: int = 200
    checkpoint_every: int = 1000
    seed: int = 10
    scan_fit: bool = True          # whole-epoch fit with per-epoch dev eval;
                                   # False = the per-batch step loop with
                                   # every-N-steps evaluation


@dataclasses.dataclass(frozen=True)
class CorpusConfig:
    """Co-expression pair-corpus construction (reference
    ``src/generate_gene_pairs.py:12-42``)."""

    corr_threshold: float = 0.9
    min_study_samples: int = 20
    min_total_counts: float = 10.0
    parallel: bool = False
    ensembl: bool = False
    num_workers: int = 0           # 0 → os.cpu_count()


@dataclasses.dataclass(frozen=True)
class TSNEConfig:
    """t-SNE defaults from ``src/tsne_multi_core.py:31,42-52``.  The
    iteration computes in float32; ``compute_dtype="bfloat16"`` (the
    reference's bf16 (N, N) arrays) is refused until it is ported."""

    pca_dims: int = 50
    perplexity: float = 30.0
    learning_rate: float = 200.0
    n_iter: int = 1000
    early_exaggeration: float = 12.0
    exaggeration_iters: int = 250
    momentum_start: float = 0.5
    momentum_final: float = 0.8
    momentum_switch_iter: int = 250
    seed: int = 0
    compute_dtype: str = "float32"

    def __post_init__(self):
        if self.compute_dtype != "float32":
            raise NotImplementedError(
                f"TSNEConfig.compute_dtype={self.compute_dtype!r} is not "
                "supported by gene2vec_tpu_torch: the bfloat16 (N, N) "
                "iteration is not ported (K10 computes in float32)"
            )
