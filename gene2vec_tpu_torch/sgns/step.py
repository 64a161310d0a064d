"""The SGNS training step — stratified negatives, the default path of
``gene2vec_tpu/sgns/step.py`` (``_step_stratified`` 630-852 and
``sgns_step``'s stratified branch 855-947).

A batch of B corpus pairs becomes 2B examples (both directions of each
pair).  Gradients are closed form.  The noise term is the stratified
estimator: an exact expectation over the frequency head plus, per group
of examples, one random contiguous tail block.  Duplicate rows combine
through one (V, D+1) [gradient | example-unit weight] accumulator per
table and the ``combiner`` divisor, so a row's positive and negative
updates shrink together.

The four hot paths are the kernels of ``gene2vec_tpu_torch/kernels``:
K1 positive gather and logit, K2 exact noise head, K3 tail blocks, K4
accumulator scatter and finalize.  Given CPU tensors each runs its plain
PyTorch version; given CUDA tensors, its CUDA kernel.

Two departures from the reference, both value-preserving:

* the dense head/mid positive slabs (one-hot matmuls over
  ``table[lo:hi]``, ``step.py:522-595``) are a TPU device; here every
  example's rows are gathered, which computes the same values.  The
  class-segmented batch layout is kept exactly, since it decides which
  pairs share a step;
* the step updates ``params`` in place (the reference returns new
  arrays), saving two table copies per step.
"""

from __future__ import annotations

import warnings
from typing import Optional, Tuple

import torch

from gene2vec_tpu_torch.data.negative_sampling import StratifiedSpec
from gene2vec_tpu_torch.data.pipeline import pool_class_pairs
from gene2vec_tpu_torch.kernels.noise_head import noise_head
from gene2vec_tpu_torch.kernels.noise_tail import noise_tail
from gene2vec_tpu_torch.kernels.pos_logit import pos_logit
from gene2vec_tpu_torch.kernels.row_update import row_divisor as _row_divisor  # noqa: F401
from gene2vec_tpu_torch.kernels.row_update import row_update
from gene2vec_tpu_torch.sgns.model import SGNSParams


def _examples_from_pairs(
    pairs: torch.Tensor, both_directions: bool = True
) -> Tuple[torch.Tensor, torch.Tensor]:
    """(B, 2) pairs → (E,) centers, (E,) contexts with E = 2B (or B):
    [forward directions | reverse directions], so example i and i + B are
    the two directions of pair i."""
    if both_directions:
        centers = torch.cat([pairs[:, 0], pairs[:, 1]])
        contexts = torch.cat([pairs[:, 1], pairs[:, 0]])
        return centers, contexts
    return pairs[:, 0].contiguous(), pairs[:, 1].contiguous()


def num_tail_groups(e: int, group_size: int) -> int:
    """The number of tail-block groups for ``e`` examples: the divisor of
    ``e`` nearest below e/group_size (warns when it collapses)."""
    g = max(1, e // group_size)
    while e % g:
        g -= 1
    if e // g > 8 * group_size:
        warnings.warn(
            f"batch example count {e} has no divisor near e/{group_size}; "
            f"falling back to {g} tail-block group(s) of {e // g} examples, "
            "which raises stratified-estimator variance.  Use a batch_pairs "
            f"divisible by {group_size}.",
            stacklevel=3,
        )
    return g


def _step_stratified(
    params: SGNSParams,
    centers: torch.Tensor,
    contexts: torch.Tensor,
    spec: StratifiedSpec,
    blocks: torch.Tensor,
    k_negatives: int,
    lr: float,
    combiner: str,
) -> Tuple[SGNSParams, torch.Tensor]:
    emb, ctx = params
    v_size, d = ctx.shape
    e = centers.shape[0]
    # K1: v, u and the positive logit
    v, u, g_pos, loss_pos = pos_logit(emb, ctx, centers, contexts)
    acc_emb = torch.zeros((v_size, d + 1), dtype=torch.float32, device=emb.device)
    acc_ctx = torch.zeros_like(acc_emb)
    # K2: exact head — d_center = g_pos·u + g_head @ ctx[:H], head rows
    d_center, loss_head = noise_head(
        v, u, g_pos, contexts, ctx, spec.q, spec.head, k_negatives, acc_ctx
    )
    # K3: one random tail block per group of e/g examples
    loss_tail = noise_tail(
        v, contexts, ctx, spec.tail_w, blocks, spec.head, spec.block,
        e // blocks.shape[0], k_negatives, d_center, acc_ctx,
    )
    loss = torch.mean(loss_pos + loss_head + loss_tail)
    # K4: positive scatters into both accumulators, then both finalizes
    row_update(emb, ctx, acc_emb, acc_ctx, centers, contexts, d_center, v,
               g_pos, lr, combiner)
    return params, loss


def sgns_step(
    params: SGNSParams,
    pairs: torch.Tensor,  # (B, 2) int32
    lr: float,
    *,
    stratified: StratifiedSpec,
    blocks: Optional[torch.Tensor] = None,
    generator: Optional[torch.Generator] = None,
    negatives: int = 5,
    both_directions: bool = True,
    combiner: str = "capped",
    strat_group: int = 32,
    shared_groups: int = 0,
    positive_head: int = 0,
    positive_mid: int = 0,
    pos_quotas=None,
) -> Tuple[SGNSParams, torch.Tensor]:
    """One fused SGD step over a batch of corpus pairs; updates ``params``
    in place and returns (params, mean loss as a 0-d tensor).

    ``blocks`` (G,) int32 are the groups' tail-block draws in [0, nb) (the
    reference's ``randint(key, (G,), 0, nb)``, step.py:753; the caller
    keeps them in range — the trainer checks its draws on the host);
    without them they are drawn from ``generator``.  ``positive_head``/``positive_mid``
    with ``pos_quotas`` declare a class-segmented batch, validated as the
    reference does; the rows are gathered either way, so it does not
    change the arithmetic."""
    dense_pos = positive_head > 0 and pos_quotas is not None
    if dense_pos:
        if not both_directions:
            raise ValueError(
                "positive_head requires both_directions=True (the class-"
                "segmented batch layout emits both directions of each pair)"
            )
        b = int(pairs.shape[0])
        n_classes = 3 if positive_mid > 0 else 2
        n_pools = len(pool_class_pairs(n_classes))
        if len(pos_quotas) != n_pools:
            raise ValueError(
                f"pos_quotas {pos_quotas} must have {n_pools} entries (one "
                f"per {n_classes}-class pool of segment_corpus_by_head)"
            )
        if any(q < 0 for q in pos_quotas) or sum(pos_quotas) != b:
            raise ValueError(
                f"pos_quotas {pos_quotas} inconsistent with batch {b}: "
                "need every quota >= 0 and sum(pos_quotas) == batch_pairs"
            )
    centers, contexts = _examples_from_pairs(pairs, both_directions)
    e = int(centers.shape[0])
    if shared_groups > 0 and (shared_groups > e or e % shared_groups):
        raise ValueError(
            f"shared_groups={shared_groups} does not divide the example "
            f"count {e} (= {'2x' if both_directions else ''}batch_pairs)"
        )
    group_size = e // shared_groups if shared_groups > 0 else strat_group
    g = num_tail_groups(e, group_size)
    if blocks is None:
        blocks = torch.randint(0, stratified.nb, (g,), generator=generator,
                               dtype=torch.int32).to(pairs.device)
    if tuple(blocks.shape) != (g,):
        raise ValueError(f"blocks must have shape ({g},), got {tuple(blocks.shape)}")
    return _step_stratified(
        params, centers, contexts, stratified, blocks, negatives, lr, combiner
    )
