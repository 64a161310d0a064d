"""The port's hand-written CUDA kernels (sm_90a), one wrapper module
each, with the plain PyTorch version beside it in the same module:

====  ===============  =============================  ==============================
K     wrapper          source                         replaces
====  ===============  =============================  ==============================
K1    ``pos_logit``    ``csrc/k1_pos_logit.cu``       sgns/step.py:705-734
K2    ``noise_head``   ``csrc/k2_noise_head.cu``      sgns/step.py:736-746, 782-786
K3    ``noise_tail``   ``csrc/k3_noise_tail.cu``      sgns/step.py:748-777, 833-847
K4    ``row_update``   ``csrc/k4_row_update.cu``      sgns/step.py:143-172, 229-263
K7    ``topk_exact``   ``csrc/k7_topk_exact.cu``      serve/engine.py:43-59
K8    ``quant_scan``   ``csrc/k8_quant_scan.cu``      serve/ann.py:397-426, 476-497
K9    ``ivf_scan``     ``csrc/k9_ivf_scan.cu``        serve/ann.py:429-449, 550-571
K9r   ``rescore``      ``csrc/k9r_rescore.cu``        serve/ann.py:452-467
====  ===============  =============================  ==============================

``rescore.row_gather`` is K9r's gather loop on its own, the counterpart
of the Pallas row-gather probes in ``experiments/``.

A wrapper given CPU tensors runs the plain version; given CUDA tensors it
launches the kernel (building the libraries at first use, see
``build.py``) or raises.  There is no switch between the two.  Each
wrapper counts its kernel launches in its module's ``launches``.
"""

from __future__ import annotations

from gene2vec_tpu_torch.kernels import (
    ivf_scan,
    noise_head,
    noise_tail,
    pos_logit,
    quant_scan,
    rescore,
    row_update,
    topk_exact,
)

#: name → wrapper module: the step's kernels in step order, then serving's
MODULES = {
    "pos_logit": pos_logit,
    "noise_head": noise_head,
    "noise_tail": noise_tail,
    "row_update": row_update,
    "topk_exact": topk_exact,
    "quant_scan": quant_scan,
    "ivf_scan": ivf_scan,
    "rescore": rescore,
}


def launch_counts() -> dict:
    """Launches per kernel, and ``row_gather``'s (K9r's gather alone)."""
    out = {name: mod.launches for name, mod in MODULES.items()}
    out["row_gather"] = rescore.gather_launches
    return out


def reset_launch_counts() -> None:
    for mod in MODULES.values():
        mod.launches = 0
    rescore.gather_launches = 0
