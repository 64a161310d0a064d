"""GGIPNN interaction scoring over served embeddings — the port of
``gene2vec_tpu/serve/interaction.py``.

``/v1/interaction`` scores gene pairs with the
:class:`~gene2vec_tpu_torch.models.ggipnn_train.GGIPNNTrainer` predict
path, whose table lookup is the row-gather kernel.

* :class:`InteractionScorer` binds to one
  :class:`~gene2vec_tpu_torch.serve.registry.LoadedModel` snapshot (the
  server checks the version and rebuilds it on hot swap); its table is
  the served model's raw table, row-aligned to the served vocab and
  placed on the registry's device — never the checkpoint's own table,
  which is row-ordered by its training vocab.
* :class:`CrossShardScorer` is the front-door scorer of a row-sharded
  fleet (``serve/shardgroup.py:ShardGroup.interaction``): no process
  holds the whole table, so the front door resolves each gene's vector
  from its owner shard and scores the pairs over a fixed-shape scratch
  table of ``2 * max_pairs`` rows.

Either scorer's MLP head loads from a GGIPNN run checkpoint
(``checkpoints/model-<step>.npz``, either package's) when one is given;
without one the head keeps the port's own random init and ``trained`` is
false, which the server echoes in every response so untrained scores
cannot pass for predictions.
"""

from __future__ import annotations

import threading
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from gene2vec_tpu_torch.config import GGIPNNConfig
from gene2vec_tpu_torch.models.ggipnn_data import PairTextVocab
from gene2vec_tpu_torch.models.ggipnn_obs import load_checkpoint
from gene2vec_tpu_torch.models.ggipnn_train import GGIPNNTrainer


def unflatten_params(flat: Dict[str, np.ndarray]) -> dict:
    """``{'hidden1/kernel': a, ...}`` (the checkpoint layout) back to the
    nested param dict."""
    out: dict = {}
    for path, value in flat.items():
        node = out
        parts = path.split("/")
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = value
    return out


class InteractionScorer:
    """GGIPNN softmax scores for (gene, gene) pairs from one model
    snapshot, on ``device``.  One pair batch is scored at a time: the
    kernels' launch counters and the device's stream are shared by the
    server's handler threads."""

    def __init__(self, model, checkpoint_path: Optional[str] = None,
                 batch_size: int = 64, device=None):
        self.version = model.version
        vocab = PairTextVocab()
        vocab.token_to_id = dict(model.index)
        vocab.id_to_token = list(model.tokens)
        config = GGIPNNConfig(embedding_dim=model.dim, batch_size=batch_size)
        self.trainer = GGIPNNTrainer(config, vocab, device=device)
        net = self.trainer.init_state()
        with torch.no_grad():
            net.embedding.copy_(torch.from_numpy(np.asarray(model.emb, np.float32)))
        self.trained = False
        if checkpoint_path is not None:
            flat = load_checkpoint(checkpoint_path)
            emb = flat.get("embedding")
            if emb is not None and tuple(emb.shape) != tuple(net.embedding.shape):
                raise ValueError(
                    f"{checkpoint_path}: embedding {tuple(emb.shape)} does not match "
                    f"the served model {tuple(net.embedding.shape)} — the checkpoint "
                    "was trained against a different vocab/dim")
            # head weights only: the served table stays
            net.load_flat(flat, head_only=True)
            self.trained = True
        self._lock = threading.Lock()

    def encode(self, pairs: Sequence[Tuple[str, str]]) -> np.ndarray:
        """(N, 2) int32 ids; raises KeyError naming the first unknown gene
        (the server maps it to HTTP 400)."""
        index = self.trainer.vocab.token_to_id
        out = []
        for a, b in pairs:
            if a not in index:
                raise KeyError(a)
            if b not in index:
                raise KeyError(b)
            out.append((index[a], index[b]))
        return np.asarray(out, dtype=np.int32).reshape(-1, 2)

    def score(self, pairs: Sequence[Tuple[str, str]]) -> List[float]:
        """Positive-class softmax score per pair (``scores[:, 1]``, the
        column the reference's ROC-AUC reads)."""
        if not pairs:
            return []
        ids = self.encode(pairs)
        with self._lock:
            scores, _, _ = self.trainer.predict(ids)
        return [float(s) for s in scores[:, 1]]


class CrossShardScorer:
    """GGIPNN pair scores from raw VECTORS: the sharded fleet's
    front-door scorer.

    The math is :class:`InteractionScorer`'s: the same predict path runs
    over a fixed-shape scratch table (``2 * max_pairs`` rows) whose rows
    are filled with the resolved vectors on each call, pair *i* looking up
    rows ``(2i, 2i + 1)`` through the row-gather kernel.  The table lives
    on ``device`` (``cuda`` unless ``"cpu"`` is asked for); one call
    scores at a time.  ``checkpoint_path`` loads the head (a checkpoint
    trained at another dim raises ``ValueError``); without it ``trained``
    is false."""

    def __init__(self, dim: int, checkpoint_path: Optional[str] = None,
                 max_pairs: int = 64, batch_size: int = 64, device=None):
        self.dim = int(dim)
        self.max_pairs = int(max_pairs)
        rows = 2 * self.max_pairs
        vocab = PairTextVocab()
        vocab.token_to_id = {f"_slot{i}": i for i in range(rows)}
        vocab.id_to_token = [f"_slot{i}" for i in range(rows)]
        config = GGIPNNConfig(embedding_dim=self.dim, batch_size=batch_size)
        self.trainer = GGIPNNTrainer(config, vocab, device=device)
        self.net = self.trainer.init_state()
        self.trained = False
        if checkpoint_path is not None:
            flat = load_checkpoint(checkpoint_path)
            emb = flat.get("embedding")
            if emb is not None and emb.shape[1] != self.dim:
                raise ValueError(
                    f"{checkpoint_path}: head trained at dim {emb.shape[1]}, the served "
                    f"table is dim {self.dim}")
            # head weights only: the scratch rows are filled per call (the
            # checkpoint's own table is ordered by its training vocab)
            self.net.load_flat(flat, head_only=True)
            self.trained = True
        self._lock = threading.Lock()

    def score_vectors(self, vec_pairs: Sequence[Tuple[np.ndarray, np.ndarray]]) -> List[float]:
        """Positive-class softmax score per (vector, vector) pair."""
        if not vec_pairs:
            return []
        if len(vec_pairs) > self.max_pairs:
            raise ValueError(f"at most {self.max_pairs} pairs per call")
        table = np.zeros(tuple(self.net.embedding.shape), np.float32)
        for i, (a, b) in enumerate(vec_pairs):
            table[2 * i] = np.asarray(a, np.float32)
            table[2 * i + 1] = np.asarray(b, np.float32)
        ids = np.arange(2 * len(vec_pairs), dtype=np.int32).reshape(-1, 2)
        with self._lock:
            with torch.no_grad():
                self.net.embedding.copy_(torch.from_numpy(table))
            scores, _, _ = self.trainer.predict(ids)
        return [float(s) for s in scores[:, 1]]
