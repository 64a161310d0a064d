"""Co-expression pair-corpus construction (layer L1); the device
threshold is K11 (``kernels/coexpr_mask.py``)."""

from gene2vec_tpu_torch.corpus.builder import (  # noqa: F401
    abs_correlation,
    abs_correlation_mask,
    build_pairs,
    clean_and_normalize,
    coexpression_pairs,
    gene_annotated_data,
    half_min,
)
