"""Visualization (layer L5): exact t-SNE on the GPU, K10c and K10.  The
figure and dashboard modules of the reference (UMAP, GTEx figures, plots,
the dash app) are not ported yet."""

from gene2vec_tpu_torch.viz.tsne import TSNE, pca_reduce, run_tsne_sweep  # noqa: F401
