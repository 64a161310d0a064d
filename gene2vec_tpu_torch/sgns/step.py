"""The SGNS training step (``gene2vec_tpu/sgns/step.py``): stratified
negatives, the default path (``_step_stratified`` 630-852 and
``sgns_step``'s stratified branch 855-947), and the shared-pool and
per-example noise modes (``_step_shared`` 337-442, ``_step_per_example``
289-334, ``sgns_step`` 948-1039).

A batch of B corpus pairs becomes 2B examples (both directions of each
pair).  Gradients are closed form.  The noise term is the stratified
estimator: an exact expectation over the frequency head plus, per group
of examples, one random contiguous tail block.  Duplicate rows combine
through one (V, D+1) [gradient | example-unit weight] accumulator per
table and the ``combiner`` divisor, so a row's positive and negative
updates shrink together.

The hot paths are the kernels of ``gene2vec_tpu_torch/kernels``: K1
positive gather and logit, K2 exact noise head, K3 tail blocks, K4
accumulator scatter and finalize; in the other modes K5a (per-example
draws) or K5b (the shared grouped pool) in place of K2/K3, with K4's
generic scatter and finalize.  Given CPU tensors each runs its plain
PyTorch version; given CUDA tensors, its CUDA kernel.

Noise draws: the shared and per-example modes take their alias draws as
``negs=`` ((P,) or (E, K) int32, the reference's ``sample_negatives``
shapes), or draw them from ``generator`` (on the tables' device) with
the ``noise`` table.

bfloat16 tables: every row is upcast to float32 on load and the
accumulators stay float32; K4 writes each table back by stochastic
rounding (``stochastic_round``, the default) with the step's salt words —
``sr_salts``, a (2, 2) table of uint32 words, emb's row then ctx's, as
``jax.random.bits(fold_in(key, 0x51EB | 0x51EC), (2,), uint32)`` gives
them (step.py:884-887, 207) — or drawn from ``generator``; with
``stochastic_round`` off, by round-to-nearest-even.

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

import math
import warnings
from typing import Optional, Tuple

import numpy as np
import torch

from gene2vec_tpu_torch.config import NEGATIVE_MODES
from gene2vec_tpu_torch.data.negative_sampling import (
    NoiseTable,
    StratifiedSpec,
    sample_negatives,
)
from gene2vec_tpu_torch.data.pipeline import pool_class_pairs
from gene2vec_tpu_torch.kernels.noise_head import noise_head
from gene2vec_tpu_torch.kernels.noise_tail import noise_tail
from gene2vec_tpu_torch.kernels.per_example import per_example
from gene2vec_tpu_torch.kernels.pos_logit import pos_logit
from gene2vec_tpu_torch.kernels.row_update import (
    Touched,
    finalize_rows,
    row_update,
    scatter_rows,
)
from gene2vec_tpu_torch.kernels.row_update import row_divisor as _row_divisor  # noqa: F401
from gene2vec_tpu_torch.kernels.shared_pool import shared_pool as shared_pool_kernel
from gene2vec_tpu_torch.sgns.model import SGNSParams

#: shared mode draws this fraction of per-example mode's E·K noise draws
#: per step (P = fraction·E·K; the reference's measured parity point)
_SHARED_DRAW_FRACTION = 0.8


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
    salts=None,
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
    # K4: positive scatters into both accumulators, then both finalizes over
    # the touched rows: the centers; the contexts, K2's head and K3's blocks
    ctx_rows = Touched(prefix=spec.head, blocks=blocks, block=spec.block,
                       limit=spec.tail_w.shape[0])
    row_update(emb, ctx, acc_emb, acc_ctx, centers, contexts, d_center, v,
               g_pos, lr, combiner, salts, (Touched(), ctx_rows))
    return params, loss


def _step_sampled(params, centers, contexts, lr, combiner, noise_rows, noise_ids,
                  salts=None, adds_contexts=False):
    """The shared and per-example steps: K1 for v, u and the positive
    logit; ``noise_rows(v, u, g_pos, acc_ctx)`` (K5a or K5b) for the noise
    term, its rows (``noise_ids``) scattered into ``acc_ctx``; then K4's
    generic path: [d_center | 1] by center, [g_pos·v | 1] by context
    (unless ``adds_contexts``: K5a adds them with its draws, the
    reference's one fused scatter), both finalizes over the scattered
    rows and the noise rows (``salts``: see :func:`sr_salts_for`)."""
    emb, ctx = params
    v, u, g_pos, loss_pos = pos_logit(emb, ctx, centers, contexts)
    acc_emb = torch.zeros((emb.shape[0], emb.shape[1] + 1), dtype=torch.float32,
                          device=emb.device)
    acc_ctx = torch.zeros_like(acc_emb)
    d_center, loss_neg = noise_rows(v, u, g_pos, acc_ctx)
    loss = torch.mean(loss_pos + loss_neg)
    ones = torch.ones_like(g_pos)
    scatter_rows(acc_emb, centers, d_center, ones)
    if not adds_contexts:
        scatter_rows(acc_ctx, contexts, g_pos[:, None] * v, ones)
    salt_e, salt_c = (None, None) if salts is None else salts
    finalize_rows(emb, acc_emb, lr, combiner, salt_e, Touched(ids=centers))
    finalize_rows(ctx, acc_ctx, lr, combiner, salt_c, Touched(ids=(contexts, noise_ids)))
    return params, loss


def shared_pool_layout(e: int, negatives: int, shared_pool: int = 1024,
                       shared_pool_auto: bool = True, shared_groups: int = 0,
                       both_directions: bool = True) -> Tuple[int, int]:
    """(groups G, draws per group P/G) of the shared pool for ``e``
    examples — the reference's sizing (step.py:948-1026): groups of ~32
    examples (or ``shared_groups``); with ``shared_pool_auto`` each slice
    holds ceil(0.8·(E/G)·K) draws rounded up to 8 (``shared_pool`` is a
    floor); an explicit pool is honoured from above, rounded down to 8,
    with a warning when it had to move, and refused below G·K."""
    if shared_groups > 0:
        g = shared_groups
        if e % g:
            raise ValueError(
                f"shared_groups={g} does not divide the example count "
                f"{e} (= {'2x' if both_directions else ''}batch_pairs)"
            )
        if not shared_pool_auto and shared_pool < g * negatives:
            raise ValueError(
                f"shared_pool={shared_pool} cannot be split across "
                f"shared_groups={g} groups of at least {negatives} "
                "draws each; lower shared_groups or raise shared_pool"
            )
    else:
        g = max(1, e // 32)
        if not shared_pool_auto:
            slice_min = 8 * -(-negatives // 8)
            g = max(1, min(g, shared_pool // slice_min))
        while e % g:
            g -= 1
        if shared_pool_auto and e // g > 256 and e > 256:
            warnings.warn(
                f"batch example count {e} has no divisor near e/32; "
                f"falling back to {g} pool group(s) of {e // g} "
                "examples, which degrades embedding quality (see "
                "sgns/step.py invariant 3).  Use a batch_pairs "
                "divisible by 32.",
                stacklevel=3,
            )
    per_group = max(negatives, -(-max(shared_pool, 1) // g))
    if shared_pool_auto:
        per_group = max(
            per_group, math.ceil(_SHARED_DRAW_FRACTION * (e // g) * negatives)
        )
        per_group = 8 * -(-per_group // 8)
    else:
        per_group = max(8 * -(-negatives // 8), 8 * (per_group // 8))
        if g * per_group != shared_pool:
            warnings.warn(
                f"explicit shared_pool={shared_pool} adjusted to "
                f"{g * per_group} ({g} groups x {per_group}-draw "
                "slices; slices are sublane-rounded and at least "
                "`negatives` wide) — record the adjusted size when "
                "labeling experiments",
                stacklevel=3,
            )
    return g, per_group


def _draws(negs, noise, generator, shape, device):
    """The step's alias draws: ``negs`` checked against ``shape``, or drawn
    from ``noise`` with ``generator``."""
    if negs is None:
        if noise is None:
            raise ValueError("this noise mode needs negs= or a noise table")
        return sample_negatives(noise, generator, shape)
    if tuple(negs.shape) != tuple(shape):
        raise ValueError(f"negs must have shape {tuple(shape)}, got {tuple(negs.shape)}")
    return negs.to(device=device, dtype=torch.int32)


def sr_salts_for(params: SGNSParams, sr_salts, stochastic_round: bool,
                 generator: Optional[torch.Generator]):
    """The step's stochastic-rounding salts as host ints [[s0, s1] of emb,
    [s0, s1] of ctx (or of the HS node table)], or None when the tables
    are float32 or ``stochastic_round`` is off (nearest-even write-back).
    Without ``sr_salts`` the four words are drawn from ``generator``."""
    if params.emb.dtype != torch.bfloat16 or not stochastic_round:
        return None
    if sr_salts is None:
        dev = generator.device if generator is not None else torch.device("cpu")
        sr_salts = torch.randint(0, 1 << 32, (2, 2), generator=generator,
                                 dtype=torch.int64, device=dev)
    words = np.asarray(
        sr_salts.cpu() if isinstance(sr_salts, torch.Tensor) else sr_salts, dtype=np.int64)
    if words.shape != (2, 2) or words.min() < 0 or words.max() >= 1 << 32:
        raise ValueError(f"sr_salts must be (2, 2) uint32 words, got {words.tolist()}")
    return words.tolist()


def sgns_step(
    params: SGNSParams,
    pairs: torch.Tensor,  # (B, 2) int32
    lr: float,
    *,
    negative_mode: str = "stratified",
    stratified: Optional[StratifiedSpec] = None,
    noise: Optional[NoiseTable] = None,
    blocks: Optional[torch.Tensor] = None,
    negs: Optional[torch.Tensor] = None,
    generator: Optional[torch.Generator] = None,
    negatives: int = 5,
    both_directions: bool = True,
    combiner: str = "capped",
    strat_group: int = 32,
    shared_pool: int = 1024,
    shared_pool_auto: bool = True,
    shared_groups: int = 0,
    positive_head: int = 0,
    positive_mid: int = 0,
    pos_quotas=None,
    sr_salts=None,
    stochastic_round: bool = True,
) -> Tuple[SGNSParams, torch.Tensor]:
    """One fused SGD step over a batch of corpus pairs; updates ``params``
    in place and returns (params, mean loss as a 0-d tensor).

    ``stratified``: ``blocks`` (G,) int32 are the groups' tail-block draws
    in [0, nb) (the reference's ``randint(key, (G,), 0, nb)``,
    step.py:753; the caller keeps them in range — the trainer checks its
    draws on the host); without them they are drawn from ``generator``
    (a CPU generator).  ``shared`` / ``per_example``: ``negs`` are the
    alias draws, (G·P/G,) or (E, K); without them they are drawn from
    ``noise`` with ``generator`` (on the tables' device).
    ``positive_head``/``positive_mid`` with ``pos_quotas`` declare a
    class-segmented batch, validated as the reference does; the rows are
    gathered either way, so it does not change the arithmetic.
    ``sr_salts`` / ``stochastic_round``: the write-back of bfloat16 tables
    (:func:`sr_salts_for`); float32 tables ignore both."""
    if negative_mode not in NEGATIVE_MODES:
        raise ValueError(f"unknown negative_mode {negative_mode!r}")
    dense_pos = positive_head > 0 and pos_quotas is not None
    if dense_pos:
        if negative_mode != "stratified":
            raise ValueError(
                "positive_head (dense-head positives) is implemented for "
                "negative_mode='stratified' only"
            )
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
    if negative_mode == "shared":
        g, per_group = shared_pool_layout(e, negatives, shared_pool, shared_pool_auto,
                                          shared_groups, both_directions)
        negs = _draws(negs, noise, generator, (g * per_group,), pairs.device)
        salts = sr_salts_for(params, sr_salts, stochastic_round, generator)
        # K5b: each group of E/G examples against its own P/G pool slice; a
        # slot's weight is scale·Σ mask, in example units (step.py:398-441)
        return _step_sampled(params, centers, contexts, lr, combiner,
                             lambda v, u, g_pos, acc: shared_pool_kernel(
                                 v, u, g_pos, contexts, negs, params.ctx, negatives, g, acc),
                             negs, salts)
    if negative_mode == "per_example":
        negs = _draws(negs, noise, generator, (e, negatives), pairs.device)
        salts = sr_salts_for(params, sr_salts, stochastic_round, generator)
        # K5a: K draws per example, their rows scattered with weight = mask,
        # and the positive contexts' rows with weight 1 (step.py:320-332)
        return _step_sampled(params, centers, contexts, lr, combiner,
                             lambda v, u, g_pos, acc: per_example(
                                 v, u, g_pos, contexts, negs, params.ctx, acc),
                             negs, salts, adds_contexts=True)
    if stratified is None:
        raise ValueError("negative_mode='stratified' needs a StratifiedSpec")
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
    salts = sr_salts_for(params, sr_salts, stochastic_round, generator)
    return _step_stratified(
        params, centers, contexts, stratified, blocks, negatives, lr, combiner, salts
    )


def sgns_step_work(
    pairs: torch.Tensor,
    d: int,
    n_rows: int,
    table_bytes: int = 4,
    *,
    negative_mode: str = "stratified",
    stratified: Optional[StratifiedSpec] = None,
    noise: Optional[NoiseTable] = None,
    blocks: Optional[torch.Tensor] = None,
    negs: Optional[torch.Tensor] = None,
    generator: Optional[torch.Generator] = None,
    negatives: int = 5,
    both_directions: bool = True,
    strat_group: int = 32,
    shared_pool: int = 1024,
    shared_pool_auto: bool = True,
    shared_groups: int = 0,
    salts: bool = False,
) -> dict:
    """The work (``kernels/_work.py``) of the kernels one :func:`sgns_step`
    launches on ``pairs`` with these noise keywords, summed: K1-K4
    (stratified), K1, K5a and K4's generic scatter and finalizes
    (per_example), K1, K5b and those (shared), at tables of ``n_rows`` ×
    ``d`` with ``table_bytes`` an element (``salts``: stochastic
    rounding).  Draws that ``negs`` does not give come from ``generator``
    as the step draws them, so a fresh generator of the step's seed gives
    the step's ids."""
    from gene2vec_tpu_torch.kernels import (
        noise_head,
        noise_tail,
        per_example,
        pos_logit,
        row_update,
        shared_pool as shared_pool_kernels,
    )
    from gene2vec_tpu_torch.obs.profiler import add_work

    centers, contexts = _examples_from_pairs(pairs, both_directions)
    e = int(centers.shape[0])
    total = dict(pos_logit.work(centers, contexts, d, table_bytes))
    if negative_mode == "stratified":
        if stratified is None or blocks is None:
            raise ValueError("the stratified step's work needs its spec and blocks")
        add_work(total, noise_head.work(e, stratified.head, d, table_bytes))
        v_noise = stratified.tail_w.shape[0]
        add_work(total, noise_tail.work(blocks, e, stratified.head, stratified.block,
                                        v_noise, d, table_bytes))
        ctx_rows = Touched(prefix=stratified.head, blocks=blocks, block=stratified.block,
                           limit=v_noise)
        return add_work(total, row_update.work(centers, contexts, d, n_rows, table_bytes,
                                               (Touched(), ctx_rows), salts))
    if negative_mode == "shared":
        g, per_group = shared_pool_layout(e, negatives, shared_pool, shared_pool_auto,
                                          shared_groups, both_directions)
        negs = _draws(negs, noise, generator, (g * per_group,), pairs.device)
        add_work(total, shared_pool_kernels.work(e, negs, g, d, table_bytes))
        scattered = (centers, contexts)
    else:
        negs = _draws(negs, noise, generator, (e, negatives), pairs.device)
        add_work(total, per_example.work(contexts, negs, d, table_bytes))
        scattered = (centers,)
    for ids in scattered:
        add_work(total, row_update.scatter_work(ids, d))
    add_work(total, row_update.finalize_work(Touched(ids=centers), n_rows, d, table_bytes,
                                             salts))
    return add_work(total, row_update.finalize_work(Touched(ids=(contexts, negs)), n_rows,
                                                    d, table_bytes, salts))
