"""The SGNS step's hand-written CUDA kernels (sm_90a), one wrapper module
each, with the plain PyTorch version beside it in the same module:

====  ===============  =============================  =========================
K     wrapper          source                         replaces (sgns/step.py)
====  ===============  =============================  =========================
K1    ``pos_logit``    ``csrc/k1_pos_logit.cu``       705-734
K2    ``noise_head``   ``csrc/k2_noise_head.cu``      736-746, 782-786, 828-831
K3    ``noise_tail``   ``csrc/k3_noise_tail.cu``      748-777, 785, 833-847
K4    ``row_update``   ``csrc/k4_row_update.cu``      143-172, 229-263
====  ===============  =============================  =========================

A wrapper given CPU tensors runs the plain version; given CUDA tensors it
launches the kernel (building the libraries at first use, see
``build.py``) or raises.  There is no switch between the two.  Each
wrapper counts its kernel launches in its module's ``launches``.
"""

from __future__ import annotations

from gene2vec_tpu_torch.kernels import noise_head, noise_tail, pos_logit, row_update

#: name → wrapper module, in step order
MODULES = {
    "pos_logit": pos_logit,
    "noise_head": noise_head,
    "noise_tail": noise_tail,
    "row_update": row_update,
}


def launch_counts() -> dict:
    return {name: mod.launches for name, mod in MODULES.items()}


def reset_launch_counts() -> None:
    for mod in MODULES.values():
        mod.launches = 0
