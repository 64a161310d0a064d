"""SGNS trainer: a Python loop over steps and the reference-shaped
iteration loop (``gene2vec_tpu/sgns/train.py``).

Load corpus → shuffle → N iterations of (reshuffle, one epoch, checkpoint,
text export), resuming from the newest verified iteration.  The corpus,
the stratified noise weights and both tables live on the device; each
step assembles its batch with index operations there and runs the four
step kernels.  The learning rate decays linearly from ``lr`` to
``min_lr`` across each epoch, in float32 as the reference computes it.

Randomness: an epoch's draws — the per-pool shuffles and every step's
tail-block ids — are one :class:`EpochDraws`.  ``train_epoch`` takes them
explicitly (the parity tests hand in the reference's draws) or makes them
from a CPU ``torch.Generator``; ``run`` seeds one per iteration from
(seed, iteration), so a resumed run replays the stream an uninterrupted
one would.

Left out of this slice (see ROADMAP.md): the observability hooks of the
reference ``run`` (run manifest and events, phase timeline, goodput,
kernel profiler), the background checkpoint writer, preemption handling
and the multi-device paths.
"""

from __future__ import annotations

import csv
import dataclasses
import os
import time
import warnings
from typing import Callable, NamedTuple, Optional, Tuple

import numpy as np
import torch

from gene2vec_tpu_torch.config import SGNSConfig
from gene2vec_tpu_torch.data.negative_sampling import build_stratified_spec
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
from gene2vec_tpu_torch.sgns.model import SGNSParams, init_params
from gene2vec_tpu_torch.sgns.step import num_tail_groups, sgns_step
from gene2vec_tpu_torch.utils.profiling import StepTimer


class EpochDraws(NamedTuple):
    """Every random draw of one epoch.

    ``shuffles``: one :class:`ShuffleDraw` per class pool (``None`` for a
    zero-quota pool), or a 1-tuple for an unsegmented corpus; ``None``
    entries throughout when ``shuffle_each_iter`` is off.  ``blocks``:
    (num_batches, G) tail-block ids in [0, nb)."""

    shuffles: Tuple[Optional[ShuffleDraw], ...]
    blocks: np.ndarray


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
        self.stratified = build_stratified_spec(
            corpus.vocab.counts, config.strat_head, config.strat_block,
            config.ns_exponent, device=self.device,
        )
        e = config.batch_pairs * (2 if config.both_directions else 1)
        group_size = (
            e // config.shared_groups if config.shared_groups > 0
            else config.strat_group
        )
        self.num_groups = num_tail_groups(e, group_size)
        # draws for train_epoch calls that pass neither draws nor a generator
        self.generator = torch.Generator().manual_seed(config.seed)
        self.timer = StepTimer()

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
        if not config.both_directions:
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
        return init_params(gen, self.corpus.vocab_size, self.config.dim, self.device)

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
        blocks = torch.randint(
            0, self.stratified.nb, (self.num_batches, self.num_groups),
            generator=generator, dtype=torch.int32,
        )
        return EpochDraws(shuffles, blocks.numpy())

    def learning_rate(self, step: int) -> float:
        """lr0·(1 − step/nb) + min_lr·step/nb, in float32."""
        f32 = np.float32
        frac = f32(step) / f32(max(self.num_batches, 1))
        return float(f32(self.config.lr) * (f32(1.0) - frac)
                     + f32(self.config.min_lr) * frac)

    def train_epoch(
        self, params: SGNSParams, draws: Optional[EpochDraws] = None,
        generator: Optional[torch.Generator] = None,
    ) -> Tuple[SGNSParams, torch.Tensor]:
        """One epoch; updates ``params`` in place.  Returns (params, the
        mean step loss as a 0-d tensor on the device).  The draws are
        ``draws`` if given, else made from ``generator``, else from the
        trainer's own generator (seeded by ``config.seed``)."""
        cfg = self.config
        if draws is None:
            draws = self.draw_epoch(generator if generator is not None
                                    else self.generator)
        nb, bp = self.num_batches, cfg.batch_pairs
        blocks = np.asarray(draws.blocks, dtype=np.int32)
        if blocks.shape != (nb, self.num_groups):
            raise ValueError(
                f"draws.blocks must be ({nb}, {self.num_groups}), got {blocks.shape}"
            )
        if blocks.min() < 0 or blocks.max() >= self.stratified.nb:
            raise ValueError(f"draws.blocks outside [0, {self.stratified.nb})")
        blocks = torch.from_numpy(blocks).to(self.device)
        if self.pos_quotas is not None:
            pools = segmented_epoch_shuffle(
                self.pairs, self.pos_quotas, nb, cfg.shuffle_mode,
                draws=draws.shuffles, enabled=cfg.shuffle_each_iter,
            )
        else:
            shuffled = epoch_shuffle(
                self.pairs, self.global_num_pairs, nb, bp, cfg.shuffle_mode,
                draw=draws.shuffles[0], enabled=cfg.shuffle_each_iter,
            )
        losses = torch.empty((nb,), dtype=torch.float32, device=self.device)
        for step in range(nb):
            if self.pos_quotas is not None:
                batch = segmented_batch(pools, self.pos_quotas, step)
            else:
                batch = shuffled[step * bp : (step + 1) * bp]
            params, loss = sgns_step(
                params, batch, self.learning_rate(step),
                stratified=self.stratified,
                blocks=blocks[step],
                negatives=cfg.negatives,
                both_directions=cfg.both_directions,
                combiner=cfg.combiner,
                strat_group=cfg.strat_group,
                shared_groups=cfg.shared_groups,
                positive_head=cfg.positive_head if self.pos_quotas else 0,
                positive_mid=cfg.positive_mid if self.pos_quotas else 0,
                pos_quotas=self.pos_quotas,
            )
            losses[step] = loss
        return params, torch.mean(losses)

    def run(
        self,
        export_dir: str,
        start_iter: Optional[int] = None,
        log: Callable[[str], None] = print,
    ) -> SGNSParams:
        """The reference iteration loop: resume from the newest verified
        iteration if present, else init fresh; each iteration reshuffles,
        trains one epoch, appends to ``training_log.csv`` and exports."""
        cfg = self.config
        os.makedirs(export_dir, exist_ok=True)
        if start_iter is None:
            start_iter = ckpt.latest_iteration(export_dir, cfg.dim) + 1
        if start_iter > 1:
            params, _, _ = ckpt.load_iteration(
                export_dir, cfg.dim, start_iter - 1, device=self.device
            )
            log(f"resuming from iteration {start_iter - 1}")
        else:
            params = self.init()
            start_iter = 1
        pairs_per_epoch = self.num_batches * cfg.batch_pairs
        csv_path = os.path.join(export_dir, "training_log.csv")
        for it in range(start_iter, cfg.num_iters + 1):
            log(f"gene2vec dimension {cfg.dim} iteration {it} start")
            t0 = time.perf_counter()
            params, loss = self.train_epoch(
                params, generator=epoch_generator(cfg.seed, it)
            )
            loss = float(loss)  # waits for the epoch to finish
            dt = time.perf_counter() - t0
            rate = pairs_per_epoch / dt if dt > 0 else float("inf")
            self.timer.record(pairs_per_epoch, dt)
            log(
                f"gene2vec dimension {cfg.dim} iteration {it} done: "
                f"loss={loss:.4f} {rate:,.0f} pairs/s ({dt:.2f}s)"
            )
            _append_csv(csv_path, {"step": it, "time": time.time(), "loss": loss,
                                   "pairs_per_sec": rate, "seconds": dt})
            ckpt.save_iteration(
                export_dir, cfg.dim, it, params, self.corpus.vocab,
                txt_output=cfg.txt_output,
                meta={
                    "loss": loss,
                    "pairs_per_sec": rate,
                    "device": str(self.device),
                    "rng": {"seed": cfg.seed,
                            "epoch_generator": f"SeedSequence([{cfg.seed}, iteration])"},
                },
            )
        return params


def _append_csv(path: str, row: dict) -> None:
    """One row of ``training_log.csv`` (the reference's columns, sorted)."""
    fields = sorted(row)
    new = not os.path.exists(path)
    with open(path, "a", encoding="utf-8", newline="") as f:
        w = csv.DictWriter(f, fields)
        if new:
            w.writeheader()
        w.writerow(row)
