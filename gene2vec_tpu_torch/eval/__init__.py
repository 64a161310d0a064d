"""Evaluation: the intrinsic target function, extrinsic AUC, the planted
check and the seen-gene holdout protocol (``gene2vec_tpu/eval/``)."""

from gene2vec_tpu_torch.eval.holdout import (  # noqa: F401
    DEGREE_BASELINE_AUC,
    GATE_MIN_AUC,
    HOLDOUT_FRACTION,
    HOLDOUT_SEED,
    ORACLE_COS_AUC,
    HoldoutSplit,
    holdout_cos_auc,
    holdout_split,
    load_holdout,
    read_split,
)
from gene2vec_tpu_torch.eval.metrics import roc_auc_score  # noqa: F401
