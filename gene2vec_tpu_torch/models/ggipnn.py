"""GGIPNN — the gene-gene-interaction prediction MLP as a torch module,
the port of ``gene2vec_tpu/models/ggipnn.py:34-94``.

Embedding lookup of a (B, 2) gene-id batch → flatten to (B, 2·D) →
Linear(100)+ReLU → dropout → Linear(100)+ReLU → dropout → Linear(10)+ReLU
→ dropout → Linear(num_classes).  As in the reference, dropout also
follows the last hidden layer, and L2 (default λ = 0) covers the dense
kernels only.

The table lookup is K9r's row gather (``kernels.rescore.row_gather``)
inside :class:`RowLookup`, whose backward sums duplicate ids' row
gradients into a dense (V, D) gradient, as the reference's gather
transpose does.  The dense layers stay ``torch.nn.Linear``: the reference
leaves them to XLA outside any kernel.

Dropout is ``where(mask, x / keep, 0)`` with flax's keep probability
(``1 − rate``, ``rate = 1 − dropout_keep_prob``).  Masks are either an
explicit argument (the parity tests hand in the reference's) or drawn
from a ``torch.Generator``.

Parameters cross between the packages in the reference's flat names and
layouts (``embedding``, ``hidden{1,2,3}/{kernel,bias}``,
``output/{kernel,bias}``): a flax ``kernel`` is (in, out), a torch
``weight`` (out, in).
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch
from torch import nn

from gene2vec_tpu_torch.config import GGIPNNConfig
from gene2vec_tpu_torch.kernels import rescore
from gene2vec_tpu_torch.models.ggipnn_obs import _flatten_params


class RowLookup(torch.autograd.Function):
    """``table[ids]`` through the row-gather kernel; the backward is the
    gather's transpose, a dense (V, D) gradient with duplicate ids'
    rows summed."""

    @staticmethod
    def forward(ctx, table: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
        ctx.save_for_backward(ids)
        ctx.rows = table.shape[0]
        return rescore.row_gather(table, ids)

    @staticmethod
    def backward(ctx, grad: torch.Tensor):
        if not ctx.needs_input_grad[0]:
            return None, None
        (ids,) = ctx.saved_tensors
        dense = grad.new_zeros((ctx.rows, grad.shape[1]))
        return dense.index_add_(0, ids.long(), grad), None


class GGIPNN(nn.Module):
    """MLP over concatenated pair embeddings."""

    def __init__(self, vocab_size: int, embedding_dim: int = 200,
                 hidden_dims: Sequence[int] = (100, 100, 10), num_classes: int = 2,
                 dropout_keep_prob: float = 0.5):
        super().__init__()
        self.embedding = nn.Parameter(torch.empty((vocab_size, embedding_dim)))
        widths = [2 * embedding_dim, *hidden_dims]
        for i, (n_in, n_out) in enumerate(zip(widths, widths[1:])):
            setattr(self, f"hidden{i + 1}", nn.Linear(n_in, n_out))
        self.output = nn.Linear(widths[-1], num_classes)
        self.hidden_dims = tuple(hidden_dims)
        # flax's Dropout(rate=1 - keep) keeps with probability 1 - rate
        self.rate = 1.0 - dropout_keep_prob
        self.keep = 1.0 - self.rate

    @classmethod
    def from_config(cls, cfg: GGIPNNConfig, vocab_size: int) -> "GGIPNN":
        return cls(vocab_size, cfg.embedding_dim, tuple(cfg.hidden_dims),
                   cfg.num_classes, cfg.dropout_keep_prob)

    def hidden_layers(self):
        return [getattr(self, f"hidden{i + 1}") for i in range(len(self.hidden_dims))]

    def draw_masks(self, batch: int, generator: Optional[torch.Generator] = None):
        """One step's dropout masks, (batch, h) bool each, kept with
        probability ``keep``."""
        dev = self.embedding.device
        return tuple(torch.rand((batch, h), generator=generator, device=dev) < self.keep
                     for h in self.hidden_dims)

    def forward(self, gene_ids: torch.Tensor, masks=None,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """(B, 2) int32 ids → (B, num_classes) logits.  In training mode
        dropout applies ``masks`` (one bool (B, h) mask per hidden layer)
        or masks drawn from ``generator``; in eval mode none."""
        b = gene_ids.shape[0]
        x = RowLookup.apply(self.embedding, gene_ids.reshape(-1))
        x = x.reshape(b, -1)
        dropout = self.training and self.rate > 0.0
        if dropout and masks is None:
            masks = self.draw_masks(b, generator)
        for i, layer in enumerate(self.hidden_layers()):
            x = torch.relu(layer(x))
            if dropout:
                x = torch.where(masks[i], x / self.keep, torch.zeros_like(x))
        return self.output(x)

    # -- parameters in the reference's names and layouts --------------------

    def kernels(self):
        """The dense kernels (torch weights) in the reference's order."""
        return [getattr(self, name).weight for name in self._layer_names()]

    def to_flat(self) -> Dict[str, np.ndarray]:
        """``{'embedding': (V, D), 'hidden1/kernel': (in, out), ...}`` as
        float32 numpy arrays — the reference's checkpoint names and
        layouts."""
        out = {"embedding": self.embedding.detach().float().cpu().numpy()}
        for name in self._layer_names():
            layer = getattr(self, name)
            out[f"{name}/kernel"] = layer.weight.detach().T.float().cpu().numpy()
            out[f"{name}/bias"] = layer.bias.detach().float().cpu().numpy()
        return out

    def load_flat(self, flat: Dict[str, np.ndarray], head_only: bool = False) -> None:
        """Copy a flat reference-layout dict into the parameters
        (``head_only`` skips the table); raises on a missing or
        mis-shaped entry."""
        names = [] if head_only else ["embedding"]
        names += [f"{n}/{p}" for n in self._layer_names() for p in ("kernel", "bias")]
        with torch.no_grad():
            for key in names:
                if key not in flat:
                    raise KeyError(f"parameter {key!r} missing")
                value = torch.from_numpy(np.array(flat[key], dtype=np.float32, copy=True))
                if key == "embedding":
                    target = self.embedding
                else:
                    name, part = key.split("/")
                    layer = getattr(self, name)
                    target = layer.weight if part == "kernel" else layer.bias
                    if part == "kernel":
                        value = value.T
                if tuple(value.shape) != tuple(target.shape):
                    raise ValueError(f"{key}: shape {tuple(value.shape)}, the model has "
                                     f"{tuple(target.shape)}")
                target.copy_(value)

    def _layer_names(self) -> Tuple[str, ...]:
        return tuple(f"hidden{i + 1}" for i in range(len(self.hidden_dims))) + ("output",)

    def reset_parameters(self, generator: torch.Generator) -> None:
        """The port's own init from ``generator`` (a CPU generator): the
        table U(−1, 1) as in the reference, kernels truncated-normal
        lecun (flax's default Dense init, variance 1/fan_in), biases 0.
        The draws are not the reference's ``PRNGKey`` stream."""
        with torch.no_grad():
            emb = torch.rand(self.embedding.shape, generator=generator) * 2.0 - 1.0
            self.embedding.copy_(emb)
            for name in self._layer_names():
                layer = getattr(self, name)
                fan_in = layer.weight.shape[1]
                # std of a unit normal truncated at ±2 is 0.8796...
                std = (1.0 / fan_in) ** 0.5 / 0.87962566103423978
                w = torch.empty(layer.weight.shape)
                nn.init.trunc_normal_(w, 0.0, std, -2 * std, 2 * std, generator=generator)
                layer.weight.copy_(w)
                layer.bias.zero_()


def init_params_numpy(seed: int, vocab_size: int, cfg: GGIPNNConfig = GGIPNNConfig()) -> dict:
    """Host-side params in the reference's nested layout (``{'embedding':
    (V, D), 'hidden1': {'kernel': (in, out), 'bias': (out,)}, ...}``,
    float32), from ``RandomState(seed)``: table U(−1, 1), kernels
    U(±√(3/fan_in)) (variance 1/fan_in), biases 0.  Both packages can
    start from them (``from_jax_params`` here; ``jnp.asarray`` leaves
    there)."""
    rng = np.random.RandomState(seed)
    params = {"embedding": rng.uniform(-1.0, 1.0, (vocab_size, cfg.embedding_dim))
              .astype(np.float32)}
    widths = [2 * cfg.embedding_dim, *cfg.hidden_dims, cfg.num_classes]
    names = [f"hidden{i + 1}" for i in range(len(cfg.hidden_dims))] + ["output"]
    for name, n_in, n_out in zip(names, widths, widths[1:]):
        lim = (3.0 / n_in) ** 0.5
        params[name] = {"kernel": rng.uniform(-lim, lim, (n_in, n_out)).astype(np.float32),
                        "bias": np.zeros(n_out, np.float32)}
    return params


def from_jax_params(params, cfg: GGIPNNConfig = GGIPNNConfig(), device="cpu") -> GGIPNN:
    """A :class:`GGIPNN` on ``device`` holding ``params`` — the reference's
    nested param pytree (numpy or JAX arrays) or its flat checkpoint dict."""
    flat = _flatten_params(params)
    model = GGIPNN.from_config(cfg, vocab_size=flat["embedding"].shape[0])
    model.load_flat(flat)
    return model.to(device)


def loss_fn(logits: torch.Tensor, labels_onehot: torch.Tensor, model: GGIPNN,
            l2_lambda: float = 0.0) -> Tuple[torch.Tensor, torch.Tensor]:
    """Softmax cross-entropy (+ kernel L2 when ``l2_lambda``) and accuracy
    — the reference's loss/accuracy pair."""
    logp = torch.log_softmax(logits, dim=-1)
    xent = -torch.mean(torch.sum(labels_onehot * logp, dim=-1))
    if l2_lambda:
        l2 = sum(torch.sum(torch.square(w)) for w in model.kernels())
        xent = xent + l2_lambda * l2
    acc = torch.mean((torch.argmax(logits, -1) == torch.argmax(labels_onehot, -1)).float())
    return xent, acc
