"""Training configuration — the reference's ``SGNSConfig`` with the same
fields and defaults (``gene2vec_tpu/config.py:16-212``).

Defaults mirror the reference Gene2vec parameter block (dim=200, sg=1,
window=1, min_count=1, 10 iterations) and gensim's SGNS defaults (5
negatives, alpha 0.025 → 1e-4, unigram^0.75 noise).  The per-field
rationale lives in the reference config's comments.

This port implements the default training path only.  Fields whose
non-default values select code this port does not have are rejected at
construction with a clear error (see ``_UNSUPPORTED``).
"""

from __future__ import annotations

import dataclasses


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


# (field, accepted-value predicate, reason) — each names what the port lacks
_UNSUPPORTED = (
    ("objective", lambda v: v == "sgns",
     "only skip-gram negative sampling is ported (CBOW and hierarchical "
     "softmax are not)"),
    ("negative_mode", lambda v: v == "stratified",
     "only the stratified noise estimator is ported (shared and "
     "per_example are not)"),
    ("table_dtype", lambda v: v == "float32",
     "tables are float32; bfloat16 tables with stochastic rounding are "
     "not ported"),
    ("compute_dtype", lambda v: v == "float32",
     "the step computes in float32 only"),
    ("vocab_sharded", lambda v: not v,
     "sharded tables need the multi-GPU path, which is not ported"),
    ("async_checkpoint", lambda v: not v,
     "the background checkpoint writer is not ported; exports are "
     "written inline"),
    ("kernel_profile", lambda v: not v,
     "kernel cost attribution is not ported"),
    ("timeline", lambda v: v,
     "the phase timeline is not ported (the default writes none)"),
    ("bf16_stochastic_round", lambda v: v,
     "it only selects the rounding of bfloat16 tables, which are not "
     "ported"),
    ("hs_dense_depth", lambda v: v == 10,
     "hierarchical softmax is not ported"),
    ("shared_pool", lambda v: v == 1024,
     "the shared noise mode is not ported"),
    ("shared_pool_auto", lambda v: v,
     "the shared noise mode is not ported"),
    ("pos_layout_shards", lambda v: v == 0,
     "a per-device batch layout needs the multi-GPU path, which is not "
     "ported"),
    ("data_axis", lambda v: v == "data",
     "device meshes are not ported"),
    ("model_axis", lambda v: v == "model",
     "device meshes are not ported"),
    ("donate", lambda v: v,
     "the step always updates the tables in place"),
)
