"""GGIPNN run-directory observability — the port of
``gene2vec_tpu/models/ggipnn_obs.py:33-125`` (``runs/<timestamp>/`` parity).

Per run, as the reference writes it:

* ``summaries/train``: loss + accuracy and, for every variable with a
  gradient, a gradient-sparsity (zero-fraction) scalar — and a gradient
  histogram when tensorboardX is installed — per training step;
* ``summaries/dev``: loss + accuracy at the evaluation cadence;
* ``checkpoints/model-<step>.npz`` every ``checkpoint_every`` steps,
  keeping the 5 most recent, in the reference's flat names and layouts,
  so the JAX package's ``load_checkpoint`` + ``unflatten_params`` read a
  port checkpoint and :func:`load_checkpoint` here reads a JAX one;
* ``manifest.json`` / ``events.jsonl`` / ``metrics.prom`` (``obs/run.py``).
"""

from __future__ import annotations

import os
import re
import time
from typing import Dict, Optional

import numpy as np
import torch

from gene2vec_tpu_torch.obs.run import Run
from gene2vec_tpu_torch.utils.metrics import MetricsLogger


def _flatten_params(params, prefix: str = "") -> Dict[str, np.ndarray]:
    """Nested reference-layout params → ``{'hidden1/kernel': ...}``."""
    out = {}
    for k, v in params.items():
        path = f"{prefix}{k}"
        if isinstance(v, dict):
            out.update(_flatten_params(v, path + "/"))
        else:
            out[path] = np.asarray(v)
    return out


def load_checkpoint(path: str) -> Dict[str, np.ndarray]:
    """Flat ``{'hidden1/kernel': array, ...}`` dict from a run checkpoint."""
    with np.load(path) as z:
        return {k: z[k] for k in z.files}


class GGIPNNRun:
    """One training run's artifact directory (reference ``runs/<ts>/``);
    ``max_to_keep`` is the reference's ``num_checkpoints`` (default 5)."""

    def __init__(self, out_dir: Optional[str] = None, max_to_keep: int = 5,
                 base_dir: str = "runs", config=None):
        if out_dir is None:
            out_dir = os.path.join(base_dir, str(int(time.time())))
        self.out_dir = os.path.abspath(out_dir)
        self.checkpoint_dir = os.path.join(self.out_dir, "checkpoints")
        os.makedirs(self.checkpoint_dir, exist_ok=True)
        train_dir = os.path.join(self.out_dir, "summaries", "train")
        dev_dir = os.path.join(self.out_dir, "summaries", "dev")
        self._train = MetricsLogger(os.path.join(train_dir, "metrics.csv"),
                                    tensorboard_dir=train_dir)
        self._dev = MetricsLogger(os.path.join(dev_dir, "metrics.csv"),
                                  tensorboard_dir=dev_dir)
        self.max_to_keep = max_to_keep
        self.obs = Run(self.out_dir, name="ggipnn", config=config)

    # -- summaries ---------------------------------------------------------

    def log_train(self, step: int, loss: float, accuracy: float,
                  grads: Optional[Dict[str, torch.Tensor]] = None) -> None:
        """Train-writer scalars; with ``grads`` (flat reference names →
        gradient tensors) also each variable's gradient sparsity (and
        histogram under tensorboardX)."""
        metrics = {"loss": float(loss), "accuracy": float(accuracy)}
        for name, g in (grads or {}).items():
            metrics[f"{name}/grad/sparsity"] = float((g == 0).float().mean())
            if self._train._tb is not None:
                self._train._tb.add_histogram(f"{name}/grad/hist", g.float().cpu().numpy(),
                                              step)
        self._train.log(step, metrics)
        self.obs.registry.counter("train_steps_total").inc()
        self.obs.registry.gauge("train_loss").set(float(loss))
        self.obs.registry.gauge("train_accuracy").set(float(accuracy))

    def log_dev(self, step: int, loss: float, accuracy: float) -> None:
        self._dev.log(step, {"loss": float(loss), "accuracy": float(accuracy)})
        self.obs.event("dev_eval", step=step, loss=float(loss), accuracy=float(accuracy))

    # -- checkpoints -------------------------------------------------------

    def checkpoint(self, step: int, model) -> str:
        """``checkpoints/model-<step>.npz`` of ``model`` (a ``GGIPNN``) in
        the reference's flat layout, pruned to ``max_to_keep``."""
        path = os.path.join(self.checkpoint_dir, f"model-{step}.npz")
        with self.obs.span("checkpoint", step=step):
            np.savez(path, **model.to_flat())
        kept = sorted(
            (int(m.group(1)), f)
            for f in os.listdir(self.checkpoint_dir)
            if (m := re.fullmatch(r"model-(\d+)\.npz", f))
        )
        for _, f in kept[: max(0, len(kept) - self.max_to_keep)]:
            os.remove(os.path.join(self.checkpoint_dir, f))
        return path

    def close(self) -> None:
        self._train.close()
        self._dev.close()
        self.obs.close()
