"""GTEx tissue-specificity figures — the port of ``gene2vec_tpu/viz/gtex.py``
(``src/GTExFigure.py`` parity).  Host-side matplotlib over a saved layout.

For each ``*specific_genes.txt`` file (gene + z-score per line), scatter all
genes at their t-SNE coordinates in silver and color that tissue's genes by
z clipped to [-1, 4] on a midpoint-shifted coolwarm colormap
(``src/GTExFigure.py:86-89``, ``shiftedColorMap`` ``:7-56``).
"""

from __future__ import annotations

import glob
import os
from typing import Dict, List, Optional, Tuple

import numpy as np

Z_CLIP = (-1.0, 4.0)


def shifted_colormap(midpoint: float, name: str = "coolwarm"):
    """Colormap with its center moved to ``midpoint`` in [0, 1] — the
    reference's shiftedColorMap recipe."""
    import matplotlib
    import matplotlib.pyplot as plt
    from matplotlib.colors import LinearSegmentedColormap

    base = plt.get_cmap(name)
    reg = np.linspace(0.0, 1.0, 257)
    shift = np.hstack(
        [
            np.linspace(0.0, midpoint, 128, endpoint=False),
            np.linspace(midpoint, 1.0, 129),
        ]
    )
    colors = base(reg)
    cdict = {"red": [], "green": [], "blue": [], "alpha": []}
    for si, ri in zip(shift, reg):
        r, g, b, a = colors[int(ri * 256)]
        cdict["red"].append((si, r, r))
        cdict["green"].append((si, g, g))
        cdict["blue"].append((si, b, b))
        cdict["alpha"].append((si, a, a))
    cmap = LinearSegmentedColormap("shifted_" + name, cdict)
    try:
        matplotlib.colormaps.register(cmap, force=True)
    except Exception:
        pass
    return cmap


def load_tsne_layout(
    label_path: str, coord_path: str
) -> Tuple[List[str], np.ndarray]:
    with open(label_path, "r", encoding="utf-8") as f:
        labels = [line.strip() for line in f if line.strip()]
    coords = np.loadtxt(coord_path)
    if coords.shape[0] != len(labels):
        raise ValueError(
            f"{coord_path}: {coords.shape[0]} rows vs {len(labels)} labels"
        )
    return labels, coords


def load_tissue_zscores(path: str) -> Dict[str, float]:
    """gene → z from a ``*specific_genes.txt`` file (whitespace-separated)."""
    out: Dict[str, float] = {}
    with open(path, "r", encoding="utf-8") as f:
        for line in f:
            parts = line.split()
            if len(parts) >= 2:
                try:
                    out[parts[0]] = float(parts[1])
                except ValueError:
                    continue  # header line
    return out


def gtex_figure(
    labels: List[str],
    coords: np.ndarray,
    zscores: Dict[str, float],
    out_path: str,
    title: Optional[str] = None,
) -> str:
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    z_lo, z_hi = Z_CLIP
    idx = [i for i, g in enumerate(labels) if g in zscores]
    z = np.clip([zscores[labels[i]] for i in idx], z_lo, z_hi)
    midpoint = (0.0 - z_lo) / (z_hi - z_lo)  # z=0 at the colormap center
    cmap = shifted_colormap(midpoint)

    fig, ax = plt.subplots(figsize=(12, 12))
    ax.scatter(coords[:, 0], coords[:, 1], s=1, c="silver", linewidths=0)
    if idx:
        sc = ax.scatter(
            coords[idx, 0], coords[idx, 1], s=3, c=z,
            cmap=cmap, vmin=z_lo, vmax=z_hi, linewidths=0,
        )
        fig.colorbar(sc, ax=ax, shrink=0.7)
    if title:
        ax.set_title(title)
    ax.set_xticks([])
    ax.set_yticks([])
    fig.savefig(out_path, dpi=200, bbox_inches="tight")
    plt.close(fig)
    return out_path


def run_gtex_figures(
    label_path: str,
    coord_path: str,
    tissue_glob: str,
    out_dir: str,
    log=print,
) -> List[str]:
    """One figure per tissue file, named after the tissue."""
    labels, coords = load_tsne_layout(label_path, coord_path)
    os.makedirs(out_dir, exist_ok=True)
    written = []
    for path in sorted(glob.glob(tissue_glob)):
        tissue = os.path.basename(path).replace("specific_genes.txt", "").strip(
            "_. "
        ) or os.path.basename(path)
        out = os.path.join(out_dir, f"{tissue}.png")
        gtex_figure(labels, coords, load_tissue_zscores(path), out, title=tissue)
        log(f"wrote {out}")
        written.append(out)
    return written
