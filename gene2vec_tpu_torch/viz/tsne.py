"""Exact t-SNE on the GPU — the port of ``gene2vec_tpu/viz/tsne.py``.

The reference projects the ~24k-gene embedding with exact O(N²) t-SNE
(van der Maaten & Hinton 2008) and snapshots the layout at every requested
iteration count in one run.  Here:

* ``pca_reduce`` is the reference's numpy PCA, bit for bit;
* ``_squared_distances`` is one float32 ``torch.matmul`` (the plain
  library GEMM the reference leaves to XLA), in the reference's order
  ``sq_i − 2·x·xᵀ + sq_j``, clamped at 0;
* the perplexity calibration (``_calibrate_points``) is K10c
  (``kernels/tsne_calibrate.py``): P is the one resident (N, N) array, on
  the card a view of rows padded to a multiple of 32 floats;
* each iteration of ``_segment`` is K10 (``kernels/tsne_step.py``, one
  cooperative launch that streams P once and never stores num or g), a
  Python loop over launches with y, vel and gains resident on the device
  and one host copy per snapshot.

On CPU tensors (``device="cpu"``) the kernels' plain versions run.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from gene2vec_tpu_torch.config import TSNEConfig


def pca_reduce(x: np.ndarray, dims: int = 50) -> np.ndarray:
    """Top-``dims`` principal components (the reference's PCA-50 pre-step,
    ``src/tsne_multi_core.py:31-33``).  Covariance is d x d (d = emb dim),
    so eigh is trivial."""
    x = np.asarray(x, np.float64)
    x = x - x.mean(axis=0)
    cov = x.T @ x / max(x.shape[0] - 1, 1)
    vals, vecs = np.linalg.eigh(cov)
    top = vecs[:, np.argsort(vals)[::-1][: min(dims, x.shape[1])]]
    return (x @ top).astype(np.float32)


def _squared_distances(x: torch.Tensor) -> torch.Tensor:
    sq = torch.sum(x * x, dim=1)
    d = sq[:, None] - 2.0 * torch.matmul(x, x.T) + sq[None, :]
    return torch.clamp_min(d, 0.0)


def _calibrate_points(x: torch.Tensor, perplexity: float) -> torch.Tensor:
    """Distances, then K10c's calibration: the symmetrized, normalized P
    (on the card an (N, N) view of padded rows, the layout K10 reads).
    The distances are freed once the conditionals are written."""
    from gene2vec_tpu_torch.kernels import tsne_calibrate

    d2 = _squared_distances(x)
    p_cond = tsne_calibrate.conditional(d2, perplexity)
    del d2
    return tsne_calibrate.symmetrize_(p_cond)


@dataclasses.dataclass
class TSNE:
    """Exact t-SNE with snapshot support.

    ``fit(x, snapshot_iters=[...])`` returns {n_iter: (N, 2) layout} — the
    multi-iteration sweep of ``src/tsne_multi_core.py`` in one run.
    ``device``: ``"cuda"`` (the default; raises without a GPU) or
    ``"cpu"``.  On the card the layout has 2 components (K10's).
    """

    config: TSNEConfig = dataclasses.field(default_factory=TSNEConfig)
    n_components: int = 2
    device: Optional[str] = None

    def fit(
        self,
        x: np.ndarray,
        snapshot_iters: Optional[Sequence[int]] = None,
        log=print,
    ) -> Dict[int, np.ndarray]:
        from gene2vec_tpu_torch.device import resolve_device

        dev = resolve_device(self.device)
        if dev.type == "cuda" and self.n_components != 2:
            raise NotImplementedError(
                f"t-SNE at n_components={self.n_components} does not run on the card: "
                "K10 iterates 2-D layouts (ROADMAP.md, Queue B); pass device='cpu'"
            )
        cfg = self.config
        snapshots = sorted(set(snapshot_iters or [cfg.n_iter]))
        x = np.asarray(x, np.float32)
        if cfg.pca_dims and x.shape[1] > cfg.pca_dims:
            x = pca_reduce(x, cfg.pca_dims)

        p = _calibrate_points(torch.from_numpy(x).to(dev), cfg.perplexity)

        n = x.shape[0]
        rng = np.random.RandomState(cfg.seed)
        y = torch.from_numpy(
            (rng.randn(n, self.n_components) * 1e-4).astype(np.float32)).to(dev)
        vel = torch.zeros_like(y)
        gains = torch.ones_like(y)

        out: Dict[int, np.ndarray] = {}
        done = 0
        for snap in snapshots:
            if snap > done:
                _segment(cfg, p, y, vel, gains, done, snap - done)
                done = snap
            out[snap] = y.to("cpu", copy=True).numpy()  # y moves on in place
            log(f"t-SNE: {done} iterations done (snapshot)")
        return out


def _segment(cfg: TSNEConfig, p, y, vel, gains, start: int, steps: int) -> None:
    """``steps`` iterations from global iteration ``start``, updating y,
    vel and gains in place: one K10 call (one launch) an iteration.
    Exaggeration and momentum switch on the global iteration number."""
    from gene2vec_tpu_torch.kernels import tsne_step

    ws = None if y.device.type == "cpu" else tsne_step.workspace(y.shape[0], y.device)
    for i in range(steps):
        it = start + i
        exaggeration = cfg.early_exaggeration if it < cfg.exaggeration_iters else 1.0
        momentum = cfg.momentum_start if it < cfg.momentum_switch_iter else cfg.momentum_final
        tsne_step.step_(p, y, vel, gains, exaggeration, momentum, cfg.learning_rate, ws)


def run_tsne_sweep(
    emb_path: str,
    out_dir: str,
    iters: Sequence[int] = (100, 5000, 10000, 20000, 50000, 100000),
    config: TSNEConfig = TSNEConfig(),
    shuffle_seed: Optional[int] = 0,
    log=print,
    device: Optional[str] = None,
) -> List[str]:
    """File-level parity with ``src/tsne_multi_core.py``: reads an embedding
    txt, writes ``labels.txt`` plus one 2-D coordinate file per requested
    iteration count."""
    import os

    from gene2vec_tpu_torch.io.emb_io import load_embedding_any

    tokens, matrix = load_embedding_any(emb_path)
    if shuffle_seed is not None:  # the reference shuffles rows (:23-24)
        order = np.random.RandomState(shuffle_seed).permutation(len(tokens))
        tokens = [tokens[i] for i in order]
        matrix = matrix[order]

    os.makedirs(out_dir, exist_ok=True)
    label_path = os.path.join(out_dir, "labels.txt")
    with open(label_path, "w", encoding="utf-8") as f:
        f.write("\n".join(tokens) + "\n")

    layouts = TSNE(config=config, device=device).fit(matrix, snapshot_iters=iters, log=log)
    written = [label_path]
    for it, coords in layouts.items():
        path = os.path.join(out_dir, f"tsne_iter_{it}.txt")
        np.savetxt(path, coords)
        written.append(path)
    return written
