"""Visualization (layer L5): exact t-SNE (K10c, K10) and UMAP (K15, K16)
on the GPU; the plot exports, the GTEx figures and the GeneView dashboard
on the host (matplotlib in the image; plotly, umap-learn, dash, mygene
and goatools import-gated with actionable errors)."""

from gene2vec_tpu_torch.viz.tsne import TSNE, pca_reduce, run_tsne_sweep  # noqa: F401
