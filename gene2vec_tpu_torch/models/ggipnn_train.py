"""GGIPNN train/eval harness — the port of
``gene2vec_tpu/models/ggipnn_train.py:44-501``.

Transductive vocab over all splits, one-hot labels, Adam(1e-3), a train
loop with dev evaluation, then one test pass producing softmax scores;
ROC-AUC from the positive-class column (``scores[:, 1]``).

* ``embed_train=False`` freezes the table: it takes no gradient and gets
  no optimizer state (the reference's ``set_to_zero`` transform).
* ``fit`` runs the reference's per-batch step loop (``batch_iter`` order,
  evaluation every ``evaluate_every`` steps, checkpoints under a run
  dir) when ``scan_fit`` is off or a run is observed, and otherwise the
  scanned fit's equivalent: the host ``RandomState`` permutation once,
  ``np.resize`` wrap-padded to a batch multiple, a random batch order
  per epoch and per-epoch dev evaluation.
* :meth:`GGIPNNTrainer.fit_epoch` is one epoch of the scanned fit over
  pre-encoded tensors: a random batch order and per-step dropout masks.
* Every draw is injectable (:class:`FitDraws`): each step's dropout
  masks and each epoch's batch order.  Without them the masks come from
  a generator on the device seeded with ``seed + 1`` and the orders from
  a CPU generator with the same seed.
* ``predict`` pads the ragged last batch by repeating the last row, and
  its per-batch losses include the padded rows (a reference quirk that
  evaluation's loss shows).

``run_classification(run_dir=)`` records the observed step loop's phase
timeline (``timeline.jsonl``) and stamps the goodput block into the run's
manifest.  :meth:`GGIPNNTrainer.profile_kernel` attributes one step as
``ggipnn_step`` (``obs/profiler.py``; its count :func:`step_work`).  Not
ported: preemption (A6b).
"""

from __future__ import annotations

import contextlib
import copy
import os
import time
from typing import Callable, Dict, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

from gene2vec_tpu_torch.config import GGIPNNConfig
from gene2vec_tpu_torch.device import resolve_device
from gene2vec_tpu_torch.eval.metrics import roc_auc_score
from gene2vec_tpu_torch.io.emb_io import load_embedding_for_vocab
from gene2vec_tpu_torch.kernels import rescore
from gene2vec_tpu_torch.models.ggipnn import GGIPNN, loss_fn
from gene2vec_tpu_torch.models.ggipnn_data import (
    PairTextVocab,
    batch_iter,
    one_hot_labels,
    read_lines,
)
from gene2vec_tpu_torch.models.ggipnn_obs import GGIPNNRun, _flatten_params
from gene2vec_tpu_torch.obs import goodput
from gene2vec_tpu_torch.obs.timeline import TIMELINE_NAME, PhaseTimeline


#: float32 operations of one Adam update of an element (both moments, the
#: bias corrections folded into the step size, the square root, the
#: division and the update)
ADAM_OPS = 12


def step_work(model: GGIPNN, batch_ids, embed_train: bool) -> dict:
    """What one Adam step of ``model`` on the (B, 2) ids ``batch_ids`` needs
    (``kernels/_work.py``): the row gather of the 2B lookups
    (``rescore.gather_work``); each ``nn.Linear``'s GEMMs of 2·B·in·out
    operations, the forward, the weight gradient and the input gradient
    (none for the first layer over a frozen table), each reading its
    operands and writing its result once; and Adam's pass over every
    trained parameter (the parameter, its gradient and both moments read,
    the parameter and the moments written; :data:`ADAM_OPS` an element),
    with a trained table's dense gradient (zeroed, the lookups' rows
    added).  The elementwise epilogues (bias, ReLU, dropout, the loss) are
    left out."""
    b = int(batch_ids.shape[0])
    v, d = model.embedding.shape
    total = dict(rescore.gather_work(batch_ids.reshape(-1), d * model.embedding.element_size()))
    trained = 0
    for i, layer in enumerate([*model.hidden_layers(), model.output]):
        n_out, n_in = layer.weight.shape
        gemms = 2 if i == 0 and not embed_train else 3
        total["flops"] += gemms * 2 * b * n_in * n_out
        total["bytes"] += gemms * 4 * (b * n_in + n_in * n_out + b * n_out)
        trained += n_out * n_in + n_out
    if embed_train:
        total["flops"] += 2 * b * d
        total["bytes"] += 4 * (v * d + 2 * 2 * b * d)
        trained += v * d
    total["flops"] += ADAM_OPS * trained
    total["bytes"] += 4 * 7 * trained
    return total


class FitDraws(NamedTuple):
    """The random draws of one ``fit``.

    ``masks``: indexed by the fit's step (0-based, across epochs), that
    step's dropout masks — one (b, h) bool array per hidden layer.
    ``orders`` (scanned fit only): (num_epochs, num_batches), each
    epoch's batch order.  For one :meth:`GGIPNNTrainer.fit_epoch` the
    steps and epochs are that epoch's own (``orders`` (1, num_batches))."""

    masks: Optional[Sequence] = None
    orders: Optional[np.ndarray] = None


class GGIPNNTrainer:
    """Trains a :class:`GGIPNN` on encoded (N, 2) id pairs + one-hot labels,
    on ``device`` (CUDA unless ``device="cpu"`` is passed)."""

    def __init__(self, config: GGIPNNConfig, vocab: PairTextVocab, device=None):
        self.config = config
        self.vocab = vocab
        self.device = resolve_device(device)
        self.model = GGIPNN.from_config(config, vocab_size=len(vocab)).to(self.device)
        self.optimizer: Optional[torch.optim.Optimizer] = None
        self._step = 0

    # -- setup -------------------------------------------------------------

    def init_state(self, pretrained_emb_path: Optional[str] = None,
                   params: Optional[dict] = None) -> GGIPNN:
        """Fresh parameters — ``params`` (the reference's nested or flat
        layout, e.g. ``init_params_numpy``'s) or the port's own init from
        ``torch.Generator().manual_seed(seed)`` — then the pretrained
        table when a path is given and ``use_pretrained`` is set; then a
        fresh Adam over every parameter but a frozen table."""
        cfg = self.config
        model = self.model
        if params is not None:
            model.load_flat(_flatten_params(params))
        else:
            model.reset_parameters(torch.Generator().manual_seed(cfg.seed))
        if pretrained_emb_path is not None and cfg.use_pretrained:
            table = load_embedding_for_vocab(
                self.vocab.token_to_id, pretrained_emb_path, cfg.embedding_dim,
                rng=np.random.RandomState(cfg.seed),
            )
            with torch.no_grad():
                model.embedding.copy_(torch.from_numpy(table))
        model.embedding.requires_grad_(cfg.embed_train)
        trained = [p for p in model.parameters() if p.requires_grad]
        self.optimizer = torch.optim.Adam(trained, lr=cfg.learning_rate)
        self._step = 0
        return model

    def _tensors(self, x: np.ndarray, y: np.ndarray):
        return (torch.from_numpy(np.ascontiguousarray(x, dtype=np.int32)).to(self.device),
                torch.from_numpy(np.ascontiguousarray(y, dtype=np.float32)).to(self.device))

    def _masks(self, draws: Optional[FitDraws], step: int, batch: int,
               generator: torch.Generator):
        if draws is not None and draws.masks is not None:
            return tuple(torch.from_numpy(np.asarray(m, dtype=bool)).to(self.device)
                         for m in draws.masks[step])
        return self.model.draw_masks(batch, generator)

    # -- steps -------------------------------------------------------------

    def _forward_backward(self, bx, by, masks):
        model = self.model
        model.train()
        self.optimizer.zero_grad(set_to_none=True)
        logits = model(bx, masks=masks)
        loss, acc = loss_fn(logits, by, model, self.config.l2_lambda)
        loss.backward()
        return loss.detach(), acc

    def train_step(self, bx: torch.Tensor, by: torch.Tensor, masks=None,
                   generator: Optional[torch.Generator] = None):
        """One Adam step on a (b, 2) int32 id batch and its (b, C) one-hot
        labels with ``masks`` (or masks from ``generator``); returns
        (loss, accuracy) as device scalars."""
        if masks is None:
            masks = self.model.draw_masks(bx.shape[0], generator)
        loss, acc = self._forward_backward(bx, by, masks)
        self.optimizer.step()
        return loss, acc

    def train_step_grads(self, bx: torch.Tensor, by: torch.Tensor, masks=None,
                         generator: Optional[torch.Generator] = None):
        """:meth:`train_step` that also returns every variable's gradient
        in the reference's flat names and layouts — the frozen table's
        too, which the reference computes and then zeroes (the run
        summaries' gradient sparsity)."""
        table = self.model.embedding
        frozen = not table.requires_grad
        if masks is None:
            masks = self.model.draw_masks(bx.shape[0], generator)
        if frozen:
            table.requires_grad_(True)
        try:
            loss, acc = self._forward_backward(bx, by, masks)
            grads = {"embedding": table.grad}
        finally:
            if frozen:
                table.requires_grad_(False)
                table.grad = None
        for name in self.model._layer_names():
            layer = getattr(self.model, name)
            grads[f"{name}/bias"] = layer.bias.grad.detach().clone()
            grads[f"{name}/kernel"] = layer.weight.grad.detach().T.clone()
        self.optimizer.step()
        return loss, acc, grads

    def profile_kernel(self, profiler, params=None, opt_state=None, batch_x=None,
                       batch_y=None, name: str = "ggipnn_step"):
        """Attribution of one training step (``obs/profiler.py``) under
        ``name``: :meth:`train_step` once on the (B, 2) ids ``batch_x`` and
        one-hot labels ``batch_y``, run on copies of the model — its
        parameters, or ``params`` in the reference's layout — and of the
        optimizer's state (or ``opt_state``, a state dict), with dropout
        masks from a fresh generator, so the trainer's own state is
        untouched; counted by :func:`step_work`.  Returns the record."""
        cfg = self.config
        shadow = GGIPNNTrainer(cfg, self.vocab, device=self.device)
        shadow.model.load_state_dict(self.model.state_dict())
        if params is not None:
            shadow.model.load_flat(_flatten_params(params))
        shadow.model.embedding.requires_grad_(cfg.embed_train)
        shadow.optimizer = torch.optim.Adam(
            [p for p in shadow.model.parameters() if p.requires_grad], lr=cfg.learning_rate)
        if opt_state is None and self.optimizer is not None:
            opt_state = self.optimizer.state_dict()
        if opt_state is not None:
            shadow.optimizer.load_state_dict(copy.deepcopy(opt_state))
        bx, by = ((batch_x, batch_y) if isinstance(batch_x, torch.Tensor)
                  else self._tensors(batch_x, batch_y))
        gen = torch.Generator(device=self.device).manual_seed(cfg.seed + 1)
        masks = shadow.model.draw_masks(bx.shape[0], gen)
        return profiler.attribute(name, shadow.train_step, (bx, by, masks),
                                  work=step_work(shadow.model, bx, cfg.embed_train))

    # -- loops -------------------------------------------------------------

    def fit(self, x_train: np.ndarray, y_train: np.ndarray,
            x_valid: Optional[np.ndarray] = None, y_valid: Optional[np.ndarray] = None,
            log: Callable[[str], None] = print, run=None,
            draws: Optional[FitDraws] = None,
            timeline: Optional[PhaseTimeline] = None) -> GGIPNN:
        """Train.  With ``run`` (a :class:`~gene2vec_tpu_torch.models.
        ggipnn_obs.GGIPNNRun`) the reference's observed step loop runs
        whatever ``scan_fit`` says: per-step train summaries with gradient
        sparsity, dev summaries every ``evaluate_every`` steps,
        checkpoints every ``checkpoint_every`` steps keeping 5.
        ``timeline`` records each step of the step loop in the phases
        host_ingest / dispatch / compute; the caller flushes it."""
        tl = timeline if timeline is not None else PhaseTimeline(enabled=False)
        cfg = self.config
        if self.optimizer is None:
            self.init_state()
        if cfg.scan_fit and run is None:
            return self._fit_scanned(x_train, y_train, x_valid, y_valid, log, draws)
        gen = torch.Generator(device=self.device).manual_seed(cfg.seed + 1)
        stacked = np.concatenate([x_train, y_train], axis=1)
        nx = x_train.shape[1]
        for i, batch in enumerate(batch_iter(stacked, cfg.batch_size, cfg.num_epochs,
                                             seed=cfg.seed)):
            t0 = time.perf_counter()
            step_no = self._step + 1
            with tl.phase("host_ingest", step=step_no):
                bx, by = self._tensors(batch[:, :nx], batch[:, nx:])
                masks = self._masks(draws, i, len(batch), gen)
            with tl.phase("dispatch", step=step_no):
                if run is not None:
                    loss, acc, grads = self.train_step_grads(bx, by, masks)
                else:
                    loss, acc = self.train_step(bx, by, masks)
            self._step += 1
            if run is not None:
                with tl.phase("compute", step=step_no):
                    loss_f, acc_f = float(loss), float(acc)  # waits for the step
                run.obs.record_step("train_step", time.perf_counter() - t0, step=self._step)
                run.log_train(self._step, loss_f, acc_f, grads)
            if self._step % cfg.evaluate_every == 0:
                msg = f"step {self._step}: loss {float(loss):.4f} acc {float(acc):.4f}"
                if x_valid is not None and y_valid is not None:
                    dev = self.evaluate(x_valid, y_valid)
                    msg += f" | dev loss {dev['loss']:.4f} acc {dev['accuracy']:.4f}"
                    if run is not None:
                        run.log_dev(self._step, dev["loss"], dev["accuracy"])
                log(msg)
            if run is not None and self._step % cfg.checkpoint_every == 0:
                run.checkpoint(self._step, self.model)
        return self.model

    def fit_epoch(self, x, y, draws: Optional[FitDraws] = None,
                  order_generator: Optional[torch.Generator] = None,
                  mask_generator: Optional[torch.Generator] = None):
        """One training epoch of the scanned fit (the reference's public
        ``fit_epoch``) over pre-encoded (N, 2) ids and (N, C) one-hot
        labels, tensors on the trainer's device or arrays: N // batch_size
        batches in a random order (``draws.orders[0]``, else a permutation
        from ``order_generator``, a CPU generator seeded with ``seed + 1``
        by default), each step's dropout masks ``draws.masks[step]`` or
        drawn from ``mask_generator`` (on the device).  On the card the
        lookup runs ``row_gather``.  Returns (model, optimizer, mean loss,
        mean accuracy), the means as 0-d device tensors."""
        cfg = self.config
        bs = cfg.batch_size
        num_batches = int(x.shape[0]) // bs
        if num_batches == 0:
            # zero batches would return a NaN loss with the model untouched
            raise ValueError(f"{x.shape[0]} examples is fewer than one batch "
                             f"(batch_size={bs})")
        if self.optimizer is None:
            self.init_state()
        if not isinstance(x, torch.Tensor):
            x, y = self._tensors(x, y)
        if draws is not None and draws.orders is not None:
            perm = np.asarray(draws.orders[0], dtype=np.int64)
            if sorted(perm.tolist()) != list(range(num_batches)):
                raise ValueError(f"the batch order is not a permutation of "
                                 f"{num_batches} batches")
        else:
            if order_generator is None:
                order_generator = torch.Generator().manual_seed(cfg.seed + 1)
            perm = torch.randperm(num_batches, generator=order_generator).numpy()
        if mask_generator is None:
            mask_generator = torch.Generator(device=self.device).manual_seed(cfg.seed + 1)
        losses, accs = [], []
        for step in range(num_batches):
            s = int(perm[step]) * bs
            masks = self._masks(draws, step, bs, mask_generator)
            loss, acc = self.train_step(x[s:s + bs], y[s:s + bs], masks)
            losses.append(loss)
            accs.append(acc)
        self._step += num_batches
        return (self.model, self.optimizer, torch.stack(losses).mean(),
                torch.stack(accs).mean())

    def _fit_scanned(self, x_train, y_train, x_valid, y_valid, log,
                     draws: Optional[FitDraws]) -> GGIPNN:
        """The reference's scanned-epoch path, one :meth:`fit_epoch` an
        epoch: per-epoch dev evaluation instead of the
        every-``evaluate_every`` cadence."""
        cfg = self.config
        n = x_train.shape[0]
        bs = cfg.batch_size
        # host shuffle once; wrap-pad to a batch multiple (the reference's
        # scan needs static shapes; the ragged tail becomes repeated rows)
        order = np.random.RandomState(cfg.seed).permutation(n)
        idx = np.resize(order, ((n + bs - 1) // bs) * bs)
        x, y = self._tensors(x_train[idx], y_train[idx])
        num_batches = x.shape[0] // bs
        order_gen = torch.Generator().manual_seed(cfg.seed + 1)
        mask_gen = torch.Generator(device=self.device).manual_seed(cfg.seed + 1)
        for epoch in range(cfg.num_epochs):
            epoch_draws = None
            if draws is not None:
                masks, orders = draws
                epoch_draws = FitDraws(
                    masks=(None if masks is None
                           else masks[epoch * num_batches:(epoch + 1) * num_batches]),
                    orders=None if orders is None else orders[epoch:epoch + 1])
            _, _, loss, acc = self.fit_epoch(x, y, epoch_draws, order_gen, mask_gen)
            msg = f"epoch {epoch + 1}: loss {float(loss):.4f} acc {float(acc):.4f}"
            if x_valid is not None and y_valid is not None:
                dev = self.evaluate(x_valid, y_valid)
                msg += f" | dev loss {dev['loss']:.4f} acc {dev['accuracy']:.4f}"
            log(msg)
        return self.model

    def evaluate(self, x: np.ndarray, y_onehot: np.ndarray) -> Dict[str, float]:
        """Full-split evaluation in batch-size batches: loss, accuracy and
        (both classes present) ROC-AUC from ``scores[:, 1]``."""
        scores, preds, losses = self.predict(x, y_onehot)
        labels = np.argmax(y_onehot, axis=1)
        out = {"loss": float(np.mean(losses)), "accuracy": float((preds == labels).mean())}
        if len(np.unique(labels)) == 2:
            out["auc"] = roc_auc_score(labels, scores[:, 1])
        return out

    @torch.no_grad()
    def predict(self, x: np.ndarray, y_onehot: Optional[np.ndarray] = None
                ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
        """(softmax scores, argmax predictions, per-batch losses) over a
        split, the last batch padded by repeating the last row."""
        cfg = self.config
        n = x.shape[0]
        if y_onehot is None:
            y_onehot = np.zeros((n, cfg.num_classes), np.float32)
        bs = cfg.batch_size
        pad = (-n) % bs
        xp = np.concatenate([x, np.repeat(x[-1:], pad, 0)], 0) if pad else x
        yp = np.concatenate([y_onehot, np.repeat(y_onehot[-1:], pad, 0)], 0) if pad else y_onehot
        xt, yt = self._tensors(xp, yp)
        model = self.model
        model.eval()
        scores, preds, losses = [], [], []
        for s in range(0, xt.shape[0], bs):
            logits = model(xt[s:s + bs])
            loss, _ = loss_fn(logits, yt[s:s + bs], model, cfg.l2_lambda)
            scores.append(torch.softmax(logits, dim=-1))
            preds.append(torch.argmax(logits, dim=-1))
            losses.append(loss)
        return (torch.cat(scores).cpu().numpy()[:n], torch.cat(preds).cpu().numpy()[:n],
                torch.stack(losses).cpu().numpy())


def run_classification(data_dir: str, emb_path: Optional[str],
                       config: GGIPNNConfig = GGIPNNConfig(),
                       log: Callable[[str], None] = print, run_dir: Optional[str] = None,
                       device=None) -> Dict[str, float]:
    """End-to-end over a ``predictionData/``-shaped directory (train/valid/
    test ``_text.txt`` + ``_label.txt``): the reference's main flow.  With
    ``run_dir`` the run is observed at the reference cadence — the step
    loop, ``summaries/{train,dev}`` and ``checkpoints/model-<step>.npz``
    keeping 5."""
    splits = {}
    for split in ("train", "valid", "test"):
        splits[split] = (read_lines(f"{data_dir}/{split}_text.txt"),
                         read_lines(f"{data_dir}/{split}_label.txt"))
    vocab = PairTextVocab().fit(*(text for text, _ in splits.values()))
    log(f"vocab size: {len(vocab)}")
    enc = {s: (vocab.transform(text), one_hot_labels(labels, config.num_classes))
           for s, (text, labels) in splits.items()}
    trainer = GGIPNNTrainer(config, vocab, device=device)
    trainer.init_state(pretrained_emb_path=emb_path)
    if run_dir is None:
        trainer.fit(*enc["train"], *enc["valid"], log=log)
        result = trainer.evaluate(*enc["test"])
    else:
        run = GGIPNNRun(run_dir, config=config)
        tl = PhaseTimeline()
        log(f"Writing to {run.out_dir}")
        wall_t0 = time.perf_counter()
        try:
            with run.obs.span("fit", train_examples=len(enc["train"][0])):
                trainer.fit(*enc["train"], *enc["valid"], log=log, run=run, timeline=tl)
            with run.obs.span("test_eval"):
                result = trainer.evaluate(*enc["test"])
            run.obs.event("test_result", **result)
            run.obs.probe()
        finally:
            # the timeline and goodput are observability residue: they never
            # mask the run's own exception
            with contextlib.suppress(Exception):
                wall_s = time.perf_counter() - wall_t0
                tl.flush(os.path.join(run.out_dir, TIMELINE_NAME))
                goodput.stamp(run.obs, goodput.summarize(
                    tl.records(), wall_s, pairs_total=trainer._step * config.batch_size))
            run.close()
    log(f"test accuracy: {result['accuracy']:.4f}")
    if "auc" in result:
        log(f"The AUC score is {result['auc']:.6f}")
    return result
