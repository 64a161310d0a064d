"""gene2vec_tpu_torch — the PyTorch/CUDA port of ``gene2vec_tpu`` for one
NVIDIA H100.

The JAX package is the reference; this package mirrors its module paths
(``gene2vec_tpu_torch/sgns/step.py`` ↔ ``gene2vec_tpu/sgns/step.py``) and
imports nothing of it, nor ``jax``.  Host-side helpers it needs are kept
as copies here.

This slice covers the training main path: pair corpus → vocab → SGNS
training with the default stratified configuration → per-iteration export
in the reference's checkpoint format.  The step's four hot paths run as
hand-written CUDA kernels (``kernels/``); every kernel has a plain PyTorch
twin that CPU tensors take.

Matmul precision: the reference computes and compares in float32, so the
port turns TF32 off for both cuBLAS matmuls and cuDNN at import.
"""

import torch

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

__version__ = "0.1.0"
