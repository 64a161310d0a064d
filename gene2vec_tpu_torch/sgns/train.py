"""SGNS trainer: a Python loop over steps and the reference-shaped
iteration loop (``gene2vec_tpu/sgns/train.py``).

Load corpus → shuffle → N iterations of (reshuffle, one epoch, checkpoint,
text export), resuming from the newest verified iteration.  The corpus,
the stratified noise weights and both tables live on the device; each
step assembles its batch with index operations there and runs the four
step kernels.  The learning rate decays linearly from ``lr`` to
``min_lr`` across each epoch, in float32 as the reference computes it.

Randomness: an epoch's draws — the per-pool shuffles and every step's
tail-block ids, or (shared and per-example noise) every step's alias
draws — are one :class:`EpochDraws`.  ``train_epoch`` takes them
explicitly (the parity tests hand in the reference's draws) or makes them
from a CPU ``torch.Generator``; the alias draws then come per step from
a generator on the device, seeded from that CPU generator.  With
bfloat16 tables and stochastic rounding, every step's salt words are an
epoch draw too (``EpochDraws.salts``, drawn last so the other draws keep
their stream).  ``run`` seeds one per iteration from (seed, iteration),
so a resumed run replays the stream an uninterrupted one would.

``run`` writes what the reference's ``run`` writes into the export dir
(:func:`observed_run`): ``manifest.json`` with the config hash and, at
the end, the goodput block (``obs/goodput.py``), ``events.jsonl`` (one
``iteration`` step span an iteration), ``metrics.prom``,
``training_log.csv`` through the registry's CSV sink, and the phase
timeline (``timeline.jsonl``) unless ``SGNSConfig(timeline=False)``; each
checkpoint's meta carries ``config_hash``.  With
``SGNSConfig(kernel_profile=True)`` it also attributes the epoch step
(``obs/profiler.py``, :func:`epoch_work`): ``kernels.jsonl``, the
``kernel_*`` gauges and goodput's per-kernel breakdown; ``run(profile_dir=)``
traces the first epoch it trains with ``torch.profiler``.  With
``SGNSConfig(donate=False)`` an epoch leaves the tables it is given
untouched and returns updated copies (the reference's jit without buffer
donation); the default updates them in place.

:func:`train_epochs` is the quality tooling's loop (fresh init, one epoch
an iteration), :func:`make_train_epoch` the epoch function a trainer runs.

Left out (see ROADMAP.md): the background checkpoint writer, preemption
handling and the multi-device paths.
"""

from __future__ import annotations

import contextlib
import dataclasses
import os
import time
import warnings
from typing import Callable, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

from gene2vec_tpu_torch.config import SGNSConfig
from gene2vec_tpu_torch.data.negative_sampling import (
    build_alias_table,
    build_stratified_spec,
    noise_distribution,
)
from gene2vec_tpu_torch.data.pipeline import (
    PairCorpus,
    ShuffleDraw,
    draw_shuffle,
    epoch_shuffle,
    host_preshuffle,
    segment_corpus_by_head,
    segmented_batch,
    segmented_epoch_shuffle,
)
from gene2vec_tpu_torch.device import resolve_device
from gene2vec_tpu_torch.io import checkpoint as ckpt
from gene2vec_tpu_torch.obs import goodput
from gene2vec_tpu_torch.obs.profiler import add_work
from gene2vec_tpu_torch.obs.run import Run
from gene2vec_tpu_torch.obs.timeline import TIMELINE_NAME, PhaseTimeline
from gene2vec_tpu_torch.sgns.model import SGNSParams, init_params
from gene2vec_tpu_torch.sgns.step import (
    num_tail_groups,
    sgns_step,
    sgns_step_work,
    shared_pool_layout,
)
from gene2vec_tpu_torch.utils.profiling import StepTimer, trace_context


class EpochDraws(NamedTuple):
    """Every random draw of one epoch.

    ``shuffles``: one :class:`ShuffleDraw` per class pool (``None`` for a
    zero-quota pool), or a 1-tuple for an unsegmented corpus; ``None``
    entries throughout when ``shuffle_each_iter`` is off.  ``blocks``
    (stratified noise): (num_batches, G) tail-block ids in [0, nb).
    ``negs`` (shared / per-example noise): (num_batches, P) or
    (num_batches, E, K) alias draws; without them, each step draws its
    own on the device from a generator seeded with ``neg_seed``.
    ``salts`` (bfloat16 tables with stochastic rounding): (num_batches,
    2, 2) uint32 words, each step's input-table row then its output-table
    row (see ``sgns_step``)."""

    shuffles: Tuple[Optional[ShuffleDraw], ...]
    blocks: Optional[np.ndarray] = None
    negs: Optional[np.ndarray] = None
    neg_seed: Optional[int] = None
    salts: Optional[np.ndarray] = None


class NoiseSetup(NamedTuple):
    """A trainer's noise for its ``negative_mode``: the stratified spec and
    its group count, or the alias table and one step's draw shape."""

    stratified: object
    num_groups: int
    table: object
    draw_shape: Optional[Tuple[int, ...]]


def noise_setup(config: SGNSConfig, counts, examples: int, device) -> NoiseSetup:
    if config.negative_mode == "stratified":
        spec = build_stratified_spec(counts, config.strat_head, config.strat_block,
                                     config.ns_exponent, device=device)
        group_size = (examples // config.shared_groups if config.shared_groups > 0
                      else config.strat_group)
        return NoiseSetup(spec, num_tail_groups(examples, group_size), None, None)
    table = build_alias_table(noise_distribution(counts, config.ns_exponent), device=device)
    if config.negative_mode == "shared":
        g, per_group = shared_pool_layout(
            examples, config.negatives, config.shared_pool, config.shared_pool_auto,
            config.shared_groups, config.both_directions,
        )
        return NoiseSetup(None, 0, table, (g * per_group,))
    return NoiseSetup(None, 0, table, (examples, config.negatives))


def draw_noise(noise: NoiseSetup, num_batches: int, generator: torch.Generator) -> dict:
    """An epoch's noise draws from the CPU ``generator``: the tail blocks,
    or the seed of the device generator that draws each step's negatives."""
    if noise.stratified is not None:
        blocks = torch.randint(0, noise.stratified.nb, (num_batches, noise.num_groups),
                               generator=generator, dtype=torch.int32)
        return {"blocks": blocks.numpy()}
    return {"neg_seed": int(torch.randint(0, 1 << 62, (1,), generator=generator))}


def epoch_noise(noise: NoiseSetup, config: SGNSConfig, draws: EpochDraws,
                num_batches: int, vocab_size: int, device) -> Callable[[int], dict]:
    """Checks an epoch's noise draws; returns step → the noise keywords of
    that step's ``sgns_step``."""
    if noise.stratified is not None:
        blocks = np.asarray(draws.blocks, dtype=np.int32)
        if blocks.shape != (num_batches, noise.num_groups):
            raise ValueError(
                f"draws.blocks must be ({num_batches}, {noise.num_groups}), got {blocks.shape}"
            )
        if blocks.min() < 0 or blocks.max() >= noise.stratified.nb:
            raise ValueError(f"draws.blocks outside [0, {noise.stratified.nb})")
        blocks = torch.from_numpy(blocks).to(device)
        return lambda step: {"negative_mode": "stratified",
                             "stratified": noise.stratified, "blocks": blocks[step]}
    pool = {"negative_mode": config.negative_mode, "shared_pool": config.shared_pool,
            "shared_pool_auto": config.shared_pool_auto}
    if draws.negs is not None:
        negs = np.asarray(draws.negs, dtype=np.int32)
        if negs.shape != (num_batches, *noise.draw_shape):
            raise ValueError(f"draws.negs must be ({num_batches}, "
                             f"{', '.join(map(str, noise.draw_shape))}), got {negs.shape}")
        if negs.size and (negs.min() < 0 or negs.max() >= vocab_size):
            raise ValueError(f"draws.negs outside [0, {vocab_size})")
        negs = torch.from_numpy(negs).to(device)
        return lambda step: dict(pool, negs=negs[step])
    if draws.neg_seed is None:
        raise ValueError("draws carry neither negs nor neg_seed")
    gen = torch.Generator(device=device).manual_seed(draws.neg_seed)
    return lambda step: dict(pool, noise=noise.table, generator=gen)


def uses_salts(config: SGNSConfig) -> bool:
    """True when each step needs stochastic-rounding salts."""
    return config.table_dtype == "bfloat16" and config.bf16_stochastic_round


def draw_salts(config: SGNSConfig, num_batches: int, generator: torch.Generator):
    """An epoch's salt words from the CPU ``generator``, or None."""
    if not uses_salts(config):
        return None
    return torch.randint(0, 1 << 32, (num_batches, 2, 2), generator=generator,
                         dtype=torch.int64).numpy()


def epoch_salts(config: SGNSConfig, draws: EpochDraws,
                num_batches: int) -> Callable[[int], dict]:
    """Checks an epoch's salts; returns step → the write-back keywords of
    that step's ``sgns_step`` / ``hs_step``."""
    if not uses_salts(config):
        return lambda step: {"stochastic_round": config.bf16_stochastic_round}
    if draws.salts is None:
        raise ValueError("bfloat16 tables with stochastic rounding need draws.salts")
    salts = np.asarray(draws.salts, dtype=np.int64)
    if salts.shape != (num_batches, 2, 2):
        raise ValueError(f"draws.salts must be ({num_batches}, 2, 2), got {salts.shape}")
    if salts.min() < 0 or salts.max() >= 1 << 32:
        raise ValueError("draws.salts are not uint32 words")
    return lambda step: {"sr_salts": salts[step], "stochastic_round": True}


def learning_rate(config: SGNSConfig, step: int, num_batches: int) -> float:
    """lr0·(1 − step/nb) + min_lr·step/nb, in float32."""
    f32 = np.float32
    frac = f32(step) / f32(max(num_batches, 1))
    return float(f32(config.lr) * (f32(1.0) - frac) + f32(config.min_lr) * frac)


def _positive_boundaries(config: SGNSConfig):
    if config.positive_mid > 0:
        return (config.positive_head, config.positive_head + config.positive_mid)
    return config.positive_head


def epoch_generator(seed: int, iteration: int) -> torch.Generator:
    """The CPU generator behind iteration ``iteration``'s draws."""
    state = np.random.SeedSequence([seed, iteration]).generate_state(2)
    return torch.Generator().manual_seed(int(state[0]) << 32 | int(state[1]))


class SGNSTrainer:
    """End-to-end trainer over an encoded :class:`PairCorpus`, on ``device``
    (CUDA unless ``device="cpu"`` is passed)."""

    def __init__(self, corpus: PairCorpus, config: SGNSConfig = SGNSConfig(),
                 device=None):
        self.device = resolve_device(device)
        if config.objective != "sgns":
            raise NotImplementedError(
                f"objective={config.objective!r}: use CBOWHSTrainer from "
                "gene2vec_tpu_torch.sgns.cbow_hs for the cbow/hierarchical-softmax "
                "variants"
            )
        if corpus.num_pairs == 0 or corpus.vocab_size == 0:
            raise ValueError(
                "corpus is empty — no pair lines matched the source "
                "directory/pattern (or min_count filtered every token)"
            )
        if corpus.pairs.min() < 0 or corpus.pairs.max() >= corpus.vocab_size:
            # the kernels index the tables with these ids unchecked
            raise ValueError("pair ids outside [0, vocab_size)")
        if corpus.num_pairs < config.batch_pairs:
            # shrink the batch rather than failing on tiny corpora
            config = dataclasses.replace(config, batch_pairs=max(1, corpus.num_pairs))
        if config.shuffle_mode not in ("offset", "full"):
            raise ValueError(f"unknown shuffle_mode {config.shuffle_mode!r}")
        config = self._resolve_positive_head(config, corpus)
        if config.shuffle_mode == "offset":
            corpus = host_preshuffle(corpus, config.seed)
        self.config = config
        self.corpus = corpus
        self.num_batches = corpus.num_pairs // config.batch_pairs
        self.global_num_pairs = corpus.num_pairs
        self.pos_quotas = None
        if config.positive_head > 0:
            pools, self.pos_quotas = segment_corpus_by_head(
                corpus.pairs, _positive_boundaries(config), config.batch_pairs
            )
            self.pairs = tuple(torch.from_numpy(p).to(self.device) for p in pools)
        else:
            self.pairs = corpus.device_pairs(self.device)
        e = config.batch_pairs * (2 if config.both_directions else 1)
        self.noise = noise_setup(config, corpus.vocab.counts, e, self.device)
        self.stratified, self.num_groups = self.noise.stratified, self.noise.num_groups
        # draws for train_epoch calls that pass neither draws nor a generator
        self.generator = torch.Generator().manual_seed(config.seed)
        self.timer = StepTimer()
        self._epoch_fn = make_train_epoch(self)

    @staticmethod
    def _resolve_positive_head(config, corpus):
        """The reference's gate for the class-segmented batch layout
        (train.py:333-460, one device): returns the config with
        ``positive_head``/``positive_mid`` clamped to the vocab, or set to
        0 (with a warning) when the layout cannot apply."""
        def disabled(msg):
            warnings.warn(
                f"positive_head (dense-head positives) disabled: {msg}",
                stacklevel=3,
            )
            return dataclasses.replace(config, positive_head=0, positive_mid=0)

        if config.positive_head <= 0:
            if 0 < config.positive_mid != type(config)().positive_mid:
                warnings.warn(
                    "positive_mid > 0 has no effect without positive_head "
                    "> 0 (the mid slab extends the dense-head batch "
                    "layout); running the plain-gather path",
                    stacklevel=3,
                )
            return dataclasses.replace(config, positive_mid=0)
        if config.negative_mode != "stratified" or not config.both_directions:
            # silent: these configs never supported the dense path
            return dataclasses.replace(config, positive_head=0, positive_mid=0)
        head = min(config.positive_head, corpus.vocab_size)
        mid = min(max(config.positive_mid, 0), corpus.vocab_size - head)
        seg_pairs = corpus.pairs

        def pools_present(bounds):
            n_classes = len(bounds) + 1
            limit = n_classes * (n_classes + 1) // 2
            present = set()
            for lo in range(0, len(seg_pairs), 1 << 20):
                c = np.searchsorted(bounds, seg_pairs[lo : lo + (1 << 20)], side="right")
                present.update(
                    np.unique(c.min(axis=1) * n_classes + c.max(axis=1)).tolist()
                )
                if len(present) == limit:
                    break
            return len(present)

        if mid > 0:
            n_pools = pools_present(np.asarray((head, head + mid), dtype=np.int64))
            if config.batch_pairs < n_pools:
                warnings.warn(
                    f"positive_mid disabled: batch_pairs={config.batch_pairs} "
                    f"cannot cover the corpus's {n_pools} head/mid/tail pools; "
                    "falling back to the 2-class head-only layout",
                    stacklevel=3,
                )
                mid = 0
        if mid == 0:
            n_pools = pools_present(np.asarray((head,), dtype=np.int64))
            if config.batch_pairs < n_pools:
                return disabled(
                    f"batch_pairs={config.batch_pairs} cannot form a "
                    "class-segmented batch over the corpus's "
                    f"{n_pools} class pools (needs at least {n_pools})"
                )
        return dataclasses.replace(config, positive_head=head, positive_mid=mid)

    # -- params ------------------------------------------------------------

    def init(self, seed: Optional[int] = None) -> SGNSParams:
        gen = torch.Generator().manual_seed(self.config.seed if seed is None else seed)
        return init_params(gen, self.corpus.vocab_size, self.config.dim, self.device,
                           dtype=self.config.table_dtype)

    # -- training ----------------------------------------------------------

    def draw_epoch(self, generator: torch.Generator) -> EpochDraws:
        """An epoch's draws, of the reference's shapes and distributions."""
        cfg = self.config
        shuffles: Tuple[Optional[ShuffleDraw], ...]
        if self.pos_quotas is not None:
            shuffles = tuple(
                draw_shuffle(int(p.shape[0]), self.num_batches, q, cfg.shuffle_mode,
                             generator)
                if q and cfg.shuffle_each_iter else None
                for p, q in zip(self.pairs, self.pos_quotas)
            )
        else:
            shuffles = ((
                draw_shuffle(self.global_num_pairs, self.num_batches,
                             cfg.batch_pairs, cfg.shuffle_mode, generator)
                if cfg.shuffle_each_iter else None
            ),)
        return EpochDraws(shuffles, **draw_noise(self.noise, self.num_batches, generator),
                          salts=draw_salts(cfg, self.num_batches, generator))

    def learning_rate(self, step: int) -> float:
        return learning_rate(self.config, step, self.num_batches)

    def train_epoch(
        self, params: SGNSParams, draws: Optional[EpochDraws] = None,
        generator: Optional[torch.Generator] = None,
    ) -> Tuple[SGNSParams, torch.Tensor]:
        """One epoch; updates ``params`` in place (``config.donate``, the
        default) or, with ``donate=False``, updates copies and leaves
        ``params`` untouched.  Returns (params, the mean step loss as a 0-d
        tensor on the device).  The draws are ``draws`` if given, else made
        from ``generator``, else from the trainer's own generator (seeded by
        ``config.seed``)."""
        if draws is None:
            draws = self.draw_epoch(generator if generator is not None
                                    else self.generator)
        return self._epoch_fn(params, draws)

    def epoch_work(self, draws: EpochDraws) -> dict:
        """:func:`epoch_work` of this trainer."""
        return epoch_work(self, draws)

    def profile_kernel(self, profiler, params: Optional[SGNSParams] = None,
                       name: str = "sgns_train_step"):
        """Attribution of the epoch step under ``name`` (:func:`profile_epoch`)."""
        return profile_epoch(self, profiler, params, name)

    def run(
        self,
        export_dir: str,
        start_iter: Optional[int] = None,
        log: Callable[[str], None] = print,
        profile_dir: Optional[str] = None,
    ) -> SGNSParams:
        """The reference iteration loop (:func:`observed_run`): resume from
        the newest verified iteration if present, else init fresh; each
        iteration reshuffles, trains one epoch, logs its row and exports.
        ``profile_dir`` traces the first epoch trained (``torch.profiler``,
        a Chrome trace in that directory)."""
        return observed_run(
            self, export_dir, start_iter, log, name="sgns", log_start=True,
            kernel="sgns_train_step", profile_dir=profile_dir,
            manifest_extra={
                "num_pairs": self.global_num_pairs,
                "vocab_size": self.corpus.vocab_size,
                "num_batches": self.num_batches,
                "pos_quotas": list(self.pos_quotas) if self.pos_quotas else None,
            },
        )


def make_train_epoch(trainer: SGNSTrainer) -> Callable:
    """The epoch function of ``trainer``: (params, draws) -> (params, the
    mean step loss as a 0-d tensor on the device), one epoch under the
    :class:`EpochDraws` ``draws`` — the reference's jitted epoch
    (train.py:56-157) as a loop over the port's steps, K1-K4 on the card
    at the default config.  It reads the trainer's corpus, noise and
    config when called."""

    def train_epoch(params: SGNSParams, draws: EpochDraws
                    ) -> Tuple[SGNSParams, torch.Tensor]:
        cfg = trainer.config
        params = own_tables(params, cfg)
        nb, bp = trainer.num_batches, cfg.batch_pairs
        step_noise = epoch_noise(trainer.noise, cfg, draws, nb, trainer.corpus.vocab_size,
                                 trainer.device)
        step_salts = epoch_salts(cfg, draws, nb)
        quotas = trainer.pos_quotas
        if quotas is not None:
            pools = segmented_epoch_shuffle(
                trainer.pairs, quotas, nb, cfg.shuffle_mode,
                draws=draws.shuffles, enabled=cfg.shuffle_each_iter,
            )
        else:
            shuffled = epoch_shuffle(
                trainer.pairs, trainer.global_num_pairs, nb, bp, cfg.shuffle_mode,
                draw=draws.shuffles[0], enabled=cfg.shuffle_each_iter,
            )
        losses = torch.empty((nb,), dtype=torch.float32, device=trainer.device)
        for step in range(nb):
            if quotas is not None:
                batch = segmented_batch(pools, quotas, step)
            else:
                batch = shuffled[step * bp : (step + 1) * bp]
            params, loss = sgns_step(
                params, batch, trainer.learning_rate(step),
                **step_noise(step),
                negatives=cfg.negatives,
                both_directions=cfg.both_directions,
                combiner=cfg.combiner,
                strat_group=cfg.strat_group,
                shared_groups=cfg.shared_groups,
                positive_head=cfg.positive_head if quotas else 0,
                positive_mid=cfg.positive_mid if quotas else 0,
                pos_quotas=quotas,
                **step_salts(step),
            )
            losses[step] = loss
        return params, torch.mean(losses)

    return train_epoch


def epoch_work(trainer: SGNSTrainer, draws: EpochDraws) -> dict:
    """The work (``kernels/_work.py``) of the kernels that one epoch of
    ``trainer`` under ``draws`` launches: each step's
    :func:`~gene2vec_tpu_torch.sgns.step.sgns_step_work` at that step's
    batch and noise ids, summed — the count behind ``sgns_train_step``.  It
    walks the epoch's ids as :func:`make_train_epoch` does (the shuffle,
    each step's batch and draws, the alias draws from their own generator)
    and launches no kernel: a host pass of distinct-row counts
    (``torch.unique`` and a read of its size) a step, at warm time."""
    cfg = trainer.config
    nb, bp = trainer.num_batches, cfg.batch_pairs
    step_noise = epoch_noise(trainer.noise, cfg, draws, nb, trainer.corpus.vocab_size,
                             trainer.device)
    quotas = trainer.pos_quotas
    if quotas is not None:
        pools = segmented_epoch_shuffle(
            trainer.pairs, quotas, nb, cfg.shuffle_mode,
            draws=draws.shuffles, enabled=cfg.shuffle_each_iter,
        )
    else:
        shuffled = epoch_shuffle(
            trainer.pairs, trainer.global_num_pairs, nb, bp, cfg.shuffle_mode,
            draw=draws.shuffles[0], enabled=cfg.shuffle_each_iter,
        )
    tb = 2 if cfg.table_dtype == "bfloat16" else 4
    total: dict = {}
    for step in range(nb):
        if quotas is not None:
            batch = segmented_batch(pools, quotas, step)
        else:
            batch = shuffled[step * bp : (step + 1) * bp]
        add_work(total, sgns_step_work(
            batch, cfg.dim, trainer.corpus.vocab_size, tb, **step_noise(step),
            negatives=cfg.negatives, both_directions=cfg.both_directions,
            strat_group=cfg.strat_group, shared_groups=cfg.shared_groups,
            salts=uses_salts(cfg),
        ))
    return total


def profile_epoch(trainer, profiler, params: Optional[SGNSParams], name: str) -> dict:
    """``profiler.attribute`` of one epoch of ``trainer`` (``SGNSTrainer`` or
    ``CBOWHSTrainer``) under ``name``: the epoch runs once on copies of
    ``params`` (a fresh init when None) under the draws of iteration 0,
    which no training iteration uses, with ``trainer.epoch_work`` of those
    draws as its count — so the kernels are built, and ``compile_s``
    paid, before the first timed iteration, and the caller's tables and
    generators are untouched.  Returns the attributed record."""
    if params is None:
        params = trainer.init()
    draws = trainer.draw_epoch(epoch_generator(trainer.config.seed, 0))
    tables = SGNSParams(params.emb.clone(), params.ctx.clone())
    return profiler.attribute(name, trainer.train_epoch, (tables, draws),
                              work=trainer.epoch_work(draws))


def train_epochs(corpus: PairCorpus, config: SGNSConfig, epochs: int,
                 draws: Optional[Sequence[EpochDraws]] = None, device=None):
    """The quality tooling's loop (the reference's ``train_epochs``, shared
    by its bench gate and quality tests so they all train identically):
    fresh init, then iteration ``it`` (1-based) under ``draws[it - 1]`` or
    the draws of ``epoch_generator(config.seed, it)``, as ``run`` makes
    them.  Returns (emb[:V] as a float32 numpy array, per-epoch losses)."""
    trainer = SGNSTrainer(corpus, config, device=device)
    if draws is not None and len(draws) < epochs:
        raise ValueError(f"{len(draws)} epochs of draws for {epochs} epochs")
    params = trainer.init()
    losses = []
    for it in range(1, epochs + 1):
        d = (draws[it - 1] if draws is not None
             else trainer.draw_epoch(epoch_generator(config.seed, it)))
        params, loss = trainer.train_epoch(params, d)
        losses.append(float(loss))
    return params.emb[: corpus.vocab_size].float().cpu().numpy(), losses


def observed_run(trainer, export_dir: str, start_iter: Optional[int],
                 log: Callable[[str], None], *, name: str, manifest_extra: dict,
                 log_start: bool = False, label: str = "", meta_extra=None,
                 check_resume: Optional[Callable[[dict], None]] = None,
                 kernel: str = "sgns_train_step",
                 profile_dir: Optional[str] = None) -> SGNSParams:
    """The reference's ``run`` loop for either trainer, observed as the
    reference observes it (sgns/train.py:605-773, cbow_hs.py:442-580): a
    :class:`Run` in the export dir (``manifest.json``, ``events.jsonl``,
    ``metrics.prom``), ``training_log.csv`` through the registry's CSV
    sink, one ``iteration`` step span an iteration, ``pairs_total``, the
    phase timeline, and the goodput block stamped at the end.  Resumes
    from the newest verified iteration (``check_resume`` sees its meta),
    else inits fresh; each checkpoint's meta carries ``config_hash``, the
    device, the draws' lineage and ``meta_extra``.  Only the timeline
    flush and the goodput stamp are guarded, so that they never mask the
    loop's own exception.

    With ``kernel_profile`` set (the reference's train.py:633-644, 669-675,
    698-699, 762-771): a :class:`~gene2vec_tpu_torch.obs.profiler.KernelProfiler` in
    the export dir, one ``kernel_attribution`` span that attributes the
    epoch step under ``kernel`` (``trainer.profile_kernel``), each
    iteration's wall observed under that name, ``kernels.jsonl`` and the
    ``kernel_*`` gauges flushed at the end and the attributed seconds as
    goodput's per-kernel breakdown.  ``profile_dir`` traces the first
    iteration trained (``utils/profiling.py:trace_context``)."""
    cfg = trainer.config
    run = Run(export_dir, name=name, config=cfg, manifest_extra=manifest_extra)
    run.registry.attach_csv(os.path.join(export_dir, "training_log.csv"))
    tl = PhaseTimeline(enabled=cfg.timeline)
    kp = None
    if cfg.kernel_profile:
        from gene2vec_tpu_torch.obs.profiler import KernelProfiler

        kp = KernelProfiler(run_dir=export_dir, registry=run.registry, device=trainer.device)
    wall_t0 = time.perf_counter()
    pairs_done = 0.0
    best_rate = 0.0
    # everything after the Run's construction runs under its finally, so a
    # failed resume still closes the run
    try:
        if start_iter is None:
            start_iter = ckpt.latest_iteration(export_dir, cfg.dim) + 1
        if start_iter > 1:
            with run.span("resume", iteration=start_iter - 1):
                params, _, saved = ckpt.load_iteration(
                    export_dir, cfg.dim, start_iter - 1, device=trainer.device,
                    table_dtype=cfg.table_dtype,
                )
                if check_resume is not None:
                    check_resume(saved)
            log(f"resuming from iteration {start_iter - 1}")
        else:
            with run.span("init_params"):
                params = trainer.init()
            start_iter = 1
        if kp is not None:
            with run.span("kernel_attribution", kernel=kernel):
                trainer.profile_kernel(kp, params=params, name=kernel)
        pairs_per_epoch = trainer.num_batches * cfg.batch_pairs
        pairs_counter = run.registry.counter("pairs_total")
        for it in range(start_iter, cfg.num_iters + 1):
            if log_start:
                log(f"gene2vec {label}dimension {cfg.dim} iteration {it} start")
            t0 = time.perf_counter()
            with trace_context(profile_dir if it == start_iter else None):
                with run.step("iteration", iteration=it, pairs=pairs_per_epoch) as span_out:
                    params, loss = timed_epoch(trainer, tl, it, params)
                    span_out["loss"] = loss
            dt = time.perf_counter() - t0
            rate = pairs_per_epoch / dt if dt > 0 else float("inf")
            if kp is not None:
                kp.observe(kernel, dt)
            trainer.timer.record(pairs_per_epoch, dt)
            pairs_counter.inc(pairs_per_epoch)
            pairs_done += pairs_per_epoch
            if dt > 0 and it != start_iter:
                # the peak leaves out the first iteration (the kernels' build)
                best_rate = max(best_rate, rate)
            log(
                f"gene2vec {label}dimension {cfg.dim} iteration {it} done: "
                f"loss={loss:.4f} {rate:,.0f} pairs/s ({dt:.2f}s)"
            )
            run.log_row(it, {"loss": loss, "pairs_per_sec": rate, "seconds": dt})
            run.probe()
            with run.span("checkpoint", iteration=it, mode="sync"):
                with tl.phase("ckpt_stage", step=it):
                    ckpt.save_iteration(
                        export_dir, cfg.dim, it, params, trainer.corpus.vocab,
                        txt_output=cfg.txt_output,
                        meta={
                            "loss": loss,
                            "pairs_per_sec": rate,
                            "config_hash": run.manifest.get("config_hash"),
                            **(meta_extra or {}),
                            "device": str(trainer.device),
                            "rng": {"seed": cfg.seed, "epoch_generator":
                                    f"SeedSequence([{cfg.seed}, iteration])"},
                        },
                    )
    finally:
        # the timeline and goodput are observability residue: they never
        # mask the loop's own exception
        with contextlib.suppress(Exception):
            wall_s = time.perf_counter() - wall_t0
            tl.flush(os.path.join(run.run_dir, TIMELINE_NAME))
            if kp is not None:
                kp.flush()
            goodput.stamp(run, goodput.summarize(
                tl.records(), wall_s, pairs_total=pairs_done,
                peak_pairs_per_sec=best_rate or None,
                kernel_seconds=kp.attributed_seconds() if kp is not None else None,
            ))
        run.close()
    return params


def own_tables(params: SGNSParams, config: SGNSConfig) -> SGNSParams:
    """The tables an epoch updates: ``params`` itself when the config
    donates them (the default), else copies, so the caller's stay as
    they were."""
    if config.donate:
        return params
    return SGNSParams(params.emb.clone(), params.ctx.clone())


def timed_epoch(trainer, tl: PhaseTimeline, it: int, params: SGNSParams):
    """Iteration ``it`` of ``run`` in the reference's phases: the epoch's
    draws (``host_ingest``), its step loop (``dispatch``: it returns once
    the kernels are queued) and the wait for its loss (``compute``).
    Returns (params, loss as a float)."""
    with tl.phase("host_ingest", step=it):
        draws = trainer.draw_epoch(epoch_generator(trainer.config.seed, it))
    with tl.phase("dispatch", step=it):
        params, loss = trainer.train_epoch(params, draws)
    with tl.phase("compute", step=it):
        loss = float(loss)  # waits for the epoch to finish
    return params, loss
