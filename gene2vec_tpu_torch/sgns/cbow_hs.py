"""CBOW and hierarchical-softmax objectives (``gene2vec_tpu/sgns/cbow_hs.py``).

With the reference's corpus shape (2-token "sentences", window 1) CBOW
degenerates to single-context prediction, so the objectives differ only
in which token is the input and which is the target:

* ``cbow``     — input = the context token's emb row, negative sampling
  against the center: the SGNS step on the swapped pair (any noise mode);
* ``sg_hs``    — input = the center's emb row, a sigmoid per Huffman-path
  node of the context token;
* ``cbow_hs``  — input = the context row, the path of the center.

Hierarchical softmax runs through K6 (``kernels/hs.py``): with
``hs_dense_depth > 0`` the first tree levels live in a contiguous
node-table prefix (``huffman.split_shallow``), which the reference scores
densely; the port visits each target's shallow path as a short list
(``huffman.shallow_paths``, built once by the trainer) beside the deep
remainders of rare tokens' paths.  The node table has
V − 1 rows; its accumulator and the input table's finalize through K4's
generic entry points with the SGNS step's combiner.  bfloat16 tables write
back as in the SGNS step, with the salts of the input table and of the
node table (the reference's ``split(sr_key)``, cbow_hs.py:339-343).

:class:`CBOWHSTrainer` mirrors the port's ``SGNSTrainer`` (init /
draw_epoch / train_epoch / run, explicit draws, CUDA unless
``device="cpu"``).  As in ``SGNSTrainer``: ``run`` writes the reference
run's records (manifest with goodput, events, metrics, training log,
timeline) and ``donate=False`` leaves the caller's tables untouched;
``kernel_profile`` attributes the epoch step as ``cbow_hs_step`` (the
reference's name for every objective here; :meth:`CBOWHSTrainer.profile_kernel`,
its count :meth:`CBOWHSTrainer.epoch_work`).  ``run(preempt=)`` drains at
the next iteration boundary and stamps the manifest ``interrupted`` as the
SGNS trainer's does; its saves stay inline whatever ``async_checkpoint``
says, as the reference's do.  Left out are the multi-device paths.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional, Tuple

import torch

from gene2vec_tpu_torch.config import OBJECTIVES as _ALL_OBJECTIVES
from gene2vec_tpu_torch.config import SGNSConfig
from gene2vec_tpu_torch.data.pipeline import (
    PairCorpus,
    draw_shuffle,
    epoch_shuffle,
    host_preshuffle,
)
from gene2vec_tpu_torch.device import resolve_device
from gene2vec_tpu_torch.kernels import hs as hs_kernels
from gene2vec_tpu_torch.kernels import row_update
from gene2vec_tpu_torch.kernels.hs import hs
from gene2vec_tpu_torch.kernels.row_update import Touched, finalize_rows, scatter_rows
from gene2vec_tpu_torch.obs.profiler import add_work
from gene2vec_tpu_torch.sgns.huffman import (
    ShallowPaths,
    build_huffman_tree,
    shallow_paths,
    split_shallow,
)
from gene2vec_tpu_torch.sgns.model import SGNSParams, init_params
from gene2vec_tpu_torch.sgns.step import (
    _examples_from_pairs,
    sgns_step,
    sgns_step_work,
    sr_salts_for,
)
from gene2vec_tpu_torch.sgns.train import (
    EpochDraws,
    SGNSTrainer,
    draw_noise,
    draw_salts,
    epoch_noise,
    epoch_salts,
    learning_rate,
    noise_setup,
    observed_run,
    own_tables,
    profile_epoch,
    uses_salts,
)
from gene2vec_tpu_torch.utils.profiling import StepTimer

OBJECTIVES = tuple(o for o in _ALL_OBJECTIVES if o != "sgns")


def shallow_on(split, device) -> ShallowPaths:
    """:func:`shallow_paths` of ``split`` as tensors on ``device``: K6's
    shallow levels, built once per tree."""
    paths = shallow_paths(split)
    return ShallowPaths(torch.from_numpy(paths.ids).to(device),
                        torch.from_numpy(paths.signs).to(device), paths.n_shallow)


def hs_step(
    params: SGNSParams,   # emb = input table, ctx = (V-1, D) node table
    pairs: torch.Tensor,
    tree_points: torch.Tensor,
    tree_codes: torch.Tensor,
    tree_lengths: torch.Tensor,
    lr: float,
    *,
    cbow: bool,
    both_directions: bool = True,
    combiner: str = "capped",
    shallow: Optional[ShallowPaths] = None,  # of tensors, split layout
    sr_salts=None,
    stochastic_round: bool = True,
) -> Tuple[SGNSParams, torch.Tensor]:
    """One hierarchical-softmax SGD step over a batch of corpus pairs;
    updates ``params`` in place and returns (params, loss).  With
    ``shallow`` (:func:`shallow_on` of the :func:`split_shallow` layout;
    ``tree_*`` are then the deep remainders) the first levels are those of
    ``node[:n_shallow]`` — the reference's ``shallow_sign`` rows as short
    paths.  bfloat16 tables: ``sr_salts``
    is (2, 2) uint32 words, the input table's row then the node table's
    (``bits(split(sr_key))``, cbow_hs.py:339-343), or drawn from the
    default generator; ``stochastic_round`` off rounds to nearest-even."""
    salts = sr_salts_for(params, sr_salts, stochastic_round, None)
    salt_e, salt_n = (None, None) if salts is None else salts
    centers, contexts = _examples_from_pairs(pairs, both_directions)
    inputs, targets = (contexts, centers) if cbow else (centers, contexts)
    emb, node = params
    d = emb.shape[1]
    acc_emb = torch.zeros((emb.shape[0], d + 1), dtype=torch.float32, device=emb.device)
    acc_node = torch.zeros((node.shape[0], d + 1), dtype=torch.float32, device=emb.device)
    # K6: every path entry, shallow and deep, gathered
    d_input, loss_deep, loss_shallow = hs(emb, node, inputs, targets, tree_points,
                                          tree_codes, tree_lengths, shallow, acc_node)
    loss = torch.mean(loss_deep)
    if loss_shallow is not None:
        loss = loss + torch.mean(loss_shallow)
    # K4: input rows, then both finalizes (one divisor per node over its
    # shallow and deep load together) over the touched rows: the inputs;
    # the shallow prefix and the targets' deep path nodes
    scatter_rows(acc_emb, inputs, d_input, torch.ones_like(loss_deep))
    finalize_rows(emb, acc_emb, lr, combiner, salt_e, Touched(ids=inputs))
    node_rows = Touched(prefix=shallow.n_shallow if shallow is not None else 0,
                        paths=(tree_points, tree_lengths, targets))
    finalize_rows(node, acc_node, lr, combiner, salt_n, node_rows)
    return params, loss


def hs_step_work(pairs, tree_points, tree_lengths, d: int, n_rows: int, n_nodes: int,
                 table_bytes: int = 4, *, cbow: bool, both_directions: bool = True,
                 shallow: Optional[ShallowPaths] = None, salts: bool = False) -> dict:
    """The work (``kernels/_work.py``) of the kernels one :func:`hs_step`
    launches on ``pairs``, summed: K6 over every path entry, K4's scatter
    of the input rows and the finalizes of the input table (``n_rows``
    rows) and the node table (``n_nodes``) over the rows the step names."""
    centers, contexts = _examples_from_pairs(pairs, both_directions)
    inputs, targets = (contexts, centers) if cbow else (centers, contexts)
    total = dict(hs_kernels.work(inputs, targets, tree_points, tree_lengths, shallow, d,
                                 table_bytes))
    add_work(total, row_update.scatter_work(inputs, d))
    add_work(total, row_update.finalize_work(Touched(ids=inputs), n_rows, d, table_bytes,
                                             salts))
    node_rows = Touched(prefix=shallow.n_shallow if shallow is not None else 0,
                        paths=(tree_points, tree_lengths, targets))
    return add_work(total, row_update.finalize_work(node_rows, n_nodes, d, table_bytes, salts))


class CBOWHSTrainer:
    """Trainer for the cbow / sg_hs / cbow_hs objectives over an encoded
    :class:`PairCorpus`, on ``device`` (CUDA unless ``device="cpu"``)."""

    def __init__(self, corpus: PairCorpus, config: SGNSConfig, device=None):
        self.device = resolve_device(device)
        if config.objective not in OBJECTIVES:
            raise ValueError(
                f"objective={config.objective!r} not in {OBJECTIVES}; plain "
                "'sgns' uses SGNSTrainer"
            )
        if corpus.num_pairs == 0 or corpus.vocab_size == 0:
            raise ValueError("corpus is empty")
        if corpus.pairs.min() < 0 or corpus.pairs.max() >= corpus.vocab_size:
            raise ValueError("pair ids outside [0, vocab_size)")
        if corpus.num_pairs < config.batch_pairs:
            config = dataclasses.replace(config, batch_pairs=max(1, corpus.num_pairs))
        if config.shuffle_mode not in ("offset", "full"):
            raise ValueError(f"unknown shuffle_mode {config.shuffle_mode!r}")
        if config.shuffle_mode == "offset":
            corpus = host_preshuffle(corpus, config.seed)
        self.config = config
        self.corpus = corpus
        self.num_batches = corpus.num_batches(config.batch_pairs)
        self.timer = StepTimer()
        self.hs = config.objective.endswith("_hs")
        self.split = None
        self.tree = None
        self.noise = None
        if self.hs:
            self.tree = build_huffman_tree(corpus.vocab.counts)
            self._shallow = None
            if config.hs_dense_depth > 0 and self.tree.num_nodes > 1:
                self.split = split_shallow(self.tree, config.hs_dense_depth)
                arrays = (self.split.points_deep, self.split.codes_deep,
                          self.split.lengths_deep)
                self._shallow = shallow_on(self.split, self.device)
            else:
                arrays = (self.tree.points, self.tree.codes, self.tree.lengths)
            self._points, self._codes, self._lengths = (
                torch.from_numpy(a).to(self.device) for a in arrays
            )
        else:
            e = config.batch_pairs * (2 if config.both_directions else 1)
            self.noise = noise_setup(config, corpus.vocab.counts, e, self.device)
        self.pairs = corpus.device_pairs(self.device)
        # draws for train_epoch calls that pass neither draws nor a generator
        self.generator = torch.Generator().manual_seed(config.seed)

    # -- params ------------------------------------------------------------

    def init(self, seed: Optional[int] = None) -> SGNSParams:
        """U(−0.5/D, 0.5/D) emb; a zero output table of V − 1 node rows
        (hierarchical softmax) or V rows (cbow); both at ``table_dtype``."""
        cfg = self.config
        gen = torch.Generator().manual_seed(cfg.seed if seed is None else seed)
        v = self.corpus.vocab_size
        out_rows = max(self.tree.num_nodes, 1) if self.hs else v
        return init_params(gen, v, cfg.dim, self.device, out_rows=out_rows,
                           dtype=cfg.table_dtype)

    # -- training ----------------------------------------------------------

    def draw_epoch(self, generator: torch.Generator) -> EpochDraws:
        cfg = self.config
        shuffles = ((
            draw_shuffle(self.corpus.num_pairs, self.num_batches, cfg.batch_pairs,
                         cfg.shuffle_mode, generator)
            if cfg.shuffle_each_iter else None
        ),)
        noise = {} if self.hs else draw_noise(self.noise, self.num_batches, generator)
        return EpochDraws(shuffles, **noise,
                          salts=draw_salts(cfg, self.num_batches, generator))

    def learning_rate(self, step: int) -> float:
        return learning_rate(self.config, step, self.num_batches)

    def train_epoch(
        self, params: SGNSParams, draws: Optional[EpochDraws] = None,
        generator: Optional[torch.Generator] = None,
    ) -> Tuple[SGNSParams, torch.Tensor]:
        """One epoch; updates ``params`` in place, or copies of them with
        ``donate=False`` (as ``SGNSTrainer.train_epoch``).  Returns (params,
        the mean step loss as a 0-d tensor on the device)."""
        cfg = self.config
        params = own_tables(params, cfg)
        if draws is None:
            draws = self.draw_epoch(generator if generator is not None
                                    else self.generator)
        nb, bp = self.num_batches, cfg.batch_pairs
        shuffled = epoch_shuffle(
            self.pairs, self.corpus.num_pairs, nb, bp, cfg.shuffle_mode,
            draw=draws.shuffles[0], enabled=cfg.shuffle_each_iter,
        )
        step_noise = None
        if not self.hs:
            step_noise = epoch_noise(self.noise, cfg, draws, nb, self.corpus.vocab_size,
                                     self.device)
        step_salts = epoch_salts(cfg, draws, nb)
        cbow = cfg.objective.startswith("cbow")
        losses = torch.empty((nb,), dtype=torch.float32, device=self.device)
        for step in range(nb):
            batch = shuffled[step * bp : (step + 1) * bp]
            lr = self.learning_rate(step)
            if self.hs:
                params, loss = hs_step(
                    params, batch, self._points, self._codes, self._lengths, lr,
                    cbow=cbow, both_directions=cfg.both_directions,
                    combiner=cfg.combiner, shallow=self._shallow, **step_salts(step),
                )
            else:
                # cbow + negative sampling: the swapped pair, so the input
                # table hosts the context vector (gensim's cbow layout)
                params, loss = sgns_step(
                    params, batch.flip(1), lr, **step_noise(step),
                    negatives=cfg.negatives, both_directions=cfg.both_directions,
                    combiner=cfg.combiner, strat_group=cfg.strat_group,
                    shared_groups=cfg.shared_groups, **step_salts(step),
                )
            losses[step] = loss
        return params, torch.mean(losses)

    def epoch_work(self, draws: EpochDraws) -> dict:
        """The work (``kernels/_work.py``) of the kernels one epoch under
        ``draws`` launches: each step's :func:`hs_step_work` (sg_hs,
        cbow_hs) or :func:`~gene2vec_tpu_torch.sgns.step.sgns_step_work` of
        the swapped pairs (cbow) at that step's ids, summed; a host pass
        of distinct-row counts a step that launches no kernel, as
        ``train.epoch_work``."""
        cfg = self.config
        nb, bp = self.num_batches, cfg.batch_pairs
        shuffled = epoch_shuffle(
            self.pairs, self.corpus.num_pairs, nb, bp, cfg.shuffle_mode,
            draw=draws.shuffles[0], enabled=cfg.shuffle_each_iter,
        )
        step_noise = None
        if not self.hs:
            step_noise = epoch_noise(self.noise, cfg, draws, nb, self.corpus.vocab_size,
                                     self.device)
        tb = 2 if cfg.table_dtype == "bfloat16" else 4
        v = self.corpus.vocab_size
        total: dict = {}
        for step in range(nb):
            batch = shuffled[step * bp : (step + 1) * bp]
            if self.hs:
                add_work(total, hs_step_work(
                    batch, self._points, self._lengths, cfg.dim, v,
                    max(self.tree.num_nodes, 1), tb, cbow=cfg.objective.startswith("cbow"),
                    both_directions=cfg.both_directions, shallow=self._shallow,
                    salts=uses_salts(cfg)))
            else:
                add_work(total, sgns_step_work(
                    batch.flip(1), cfg.dim, v, tb, **step_noise(step),
                    negatives=cfg.negatives, both_directions=cfg.both_directions,
                    strat_group=cfg.strat_group, shared_groups=cfg.shared_groups,
                    salts=uses_salts(cfg)))
        return total

    def profile_kernel(self, profiler, params: Optional[SGNSParams] = None,
                       name: str = "cbow_hs_step"):
        """Attribution of the epoch step under ``name``
        (``train.profile_epoch``: one epoch on copies of ``params``, a fresh
        init when None, counted by :meth:`epoch_work`)."""
        return profile_epoch(self, profiler, params, name)

    def run(
        self,
        export_dir: str,
        start_iter: Optional[int] = None,
        log: Callable[[str], None] = print,
        profile_dir: Optional[str] = None,
        preempt=None,
    ) -> SGNSParams:
        """The reference iteration loop with its records
        (``train.observed_run``): resume from the newest verified iteration
        (refusing a checkpoint of another ``hs_dense_depth``: node-table
        row ids depend on the split), else init fresh; each iteration
        trains one epoch, logs its row and exports inline with the
        ``objective`` and ``hs_dense_depth`` meta.  ``profile_dir`` traces
        the first epoch trained; ``preempt`` (a ``PreemptionHandler``)
        drains the loop at the next iteration boundary."""
        cfg = self.config

        def check_resume(meta):
            saved_depth = int(meta.get("hs_dense_depth", 0))
            if self.hs and saved_depth != cfg.hs_dense_depth:
                raise ValueError(
                    f"checkpoint in {export_dir} was saved with "
                    f"hs_dense_depth={saved_depth}, config has "
                    f"{cfg.hs_dense_depth}: node-table layouts differ "
                    "— resume with the saved depth or start a fresh "
                    "export dir"
                )

        return observed_run(
            self, export_dir, start_iter, log, name=cfg.objective,
            label=f"[{cfg.objective}] ", check_resume=check_resume,
            kernel="cbow_hs_step", profile_dir=profile_dir, preempt=preempt,
            manifest_extra={
                "num_pairs": self.corpus.num_pairs,
                "vocab_size": self.corpus.vocab_size,
                "num_batches": self.num_batches,
                "hs_shallow_nodes": self.split.n_shallow if self.split else 0,
            },
            # node-table layout tag: resume refuses a mismatch
            meta_extra={"objective": cfg.objective,
                        "hs_dense_depth": cfg.hs_dense_depth if self.hs else 0},
        )


def make_trainer(corpus: PairCorpus, config: SGNSConfig, device=None):
    """Objective-dispatching factory: 'sgns' → SGNSTrainer, else CBOWHSTrainer."""
    if config.objective == "sgns":
        return SGNSTrainer(corpus, config, device=device)
    return CBOWHSTrainer(corpus, config, device=device)
