"""The port's hand-written CUDA kernels (sm_90a), one wrapper module
each, with the plain PyTorch version beside it in the same module:

====  ==================  ===============================  ======================================
K     wrapper             source                           replaces
====  ==================  ===============================  ======================================
K1    ``pos_logit``       ``csrc/k1_pos_logit.cu``         sgns/step.py:705-734
K2    ``noise_head``      ``csrc/k2_noise_head.cu``        sgns/step.py:736-746, 782-786
K3    ``noise_tail``      ``csrc/k3_noise_tail.cu``        sgns/step.py:748-777, 833-847
K4    ``row_update``      ``csrc/k4_row_update.cu``        sgns/step.py:143-172, 179-263
K5a   ``per_example``     ``csrc/k5_per_example.cu``       sgns/step.py:97-130, 289-334
K5b   ``shared_pool``     ``csrc/k5_shared.cu``            sgns/step.py:337-442
K6    ``hs``              ``csrc/k6_hs.cu``                sgns/cbow_hs.py:65-101, 149-209
K7    ``topk_exact``      ``csrc/k7_topk_exact.cu``        serve/engine.py:43-59
K8    ``quant_scan``      ``csrc/k8_quant_scan.cu``        serve/ann.py:397-426, 476-497
K9    ``ivf_scan``        ``csrc/k9_ivf_scan.cu``          serve/ann.py:429-449, 550-571
K9r   ``rescore``         ``csrc/k9r_rescore.cu``          serve/ann.py:452-467
K10c  ``tsne_calibrate``  ``csrc/k10c_tsne_calibrate.cu``  viz/tsne.py:52-85
K10   ``tsne_step``       ``csrc/k10_tsne_step.cu``        viz/tsne.py:143-219
K11   ``coexpr_mask``     ``csrc/k11_coexpr_mask.cu``      corpus/builder.py:125-171
K12   ``stream_scale``    ``csrc/k12_stream_scale.cu``     experiments/test_bw.py:39,
                                                           test_lane_gather.py:100
K13   ``lane``            ``csrc/k13_lane.cu``             experiments/test_lane_gather.py:57, 82
K14   ``staged_copy``     ``csrc/k14_staged_copy.cu``      experiments/test_dma2.py:83,
                                                           test_vmem_dma.py:24,
                                                           test_feature_matrix.py:35-132
K15   ``umap_graph``      ``csrc/k15_umap_graph.cu``       viz/umap.py:114-157
K16   ``umap_step``       ``csrc/k16_umap_step.cu``        viz/umap.py:188-225
====  ==================  ===============================  ======================================

K1-K6 take float32 or bfloat16 tables (``SGNSConfig.table_dtype``); K4
writes a bfloat16 table back by stochastic rounding (with the step's salt
words) or round-to-nearest-even.  K12-K14 are the counterparts of Pallas
probes on no path the package runs.  K10c/K10 (t-SNE's calibration and
iteration), K15/K16 (UMAP's graph and iteration) and K11 (the
co-expression mask) carry the pipeline's visualization and corpus stages.

``rescore.row_gather`` is K9r's gather loop on its own, the counterpart
of the Pallas row-gather probes in ``experiments/``; it also carries the
GGIPNN table lookup (``models/ggipnn.py``), in training and behind
``/v1/interaction``.
``row_update.scatter_rows`` and ``row_update.finalize_rows`` are K4's
generic entry points (one accumulator scatter; one table's finalize),
which the per-example, shared and hierarchical-softmax steps use.

A wrapper given CPU tensors runs the plain version; given CUDA tensors it
launches the kernel (building the libraries at first use, see
``build.py``) or raises.  There is no switch between the two.  Each
wrapper counts its kernel launches in its module's ``launches``, keyed
by (entry point, variant); the variant "" is a float32 table or none.
"""

from __future__ import annotations

from gene2vec_tpu_torch.kernels import (
    coexpr_mask,
    hs,
    ivf_scan,
    lane,
    noise_head,
    noise_tail,
    per_example,
    pos_logit,
    quant_scan,
    rescore,
    row_update,
    shared_pool,
    staged_copy,
    stream_scale,
    topk_exact,
    tsne_calibrate,
    tsne_step,
    umap_graph,
    umap_step,
)

#: name → wrapper module: the step's kernels in step order, serving's, the
#: pipeline's t-SNE, UMAP and corpus kernels, then the probes' counterparts
MODULES = {
    "pos_logit": pos_logit,
    "noise_head": noise_head,
    "noise_tail": noise_tail,
    "row_update": row_update,
    "per_example": per_example,
    "shared_pool": shared_pool,
    "hs": hs,
    "topk_exact": topk_exact,
    "quant_scan": quant_scan,
    "ivf_scan": ivf_scan,
    "rescore": rescore,
    "tsne_calibrate": tsne_calibrate,
    "tsne_step": tsne_step,
    "umap_graph": umap_graph,
    "umap_step": umap_step,
    "coexpr_mask": coexpr_mask,
    "stream_scale": stream_scale,
    "lane": lane,
    "staged_copy": staged_copy,
}


def launch_counts() -> dict:
    """Launches per entry point — each wrapper, K4's generic
    ``row_scatter`` / ``row_finalize`` and ``row_gather`` (K9r's gather
    alone) — and beside each total its launches per variant: ``<name>_bf16``
    on bfloat16 tables (K12 and K13 too), K4's ``_bf16_sr`` (stochastic rounding) and
    ``_bf16_rn`` (nearest-even) write-backs."""
    out = {}
    for mod in MODULES.values():
        for (entry, variant), n in mod.launches.items():
            out[entry] = out.get(entry, 0) + n
            if variant:
                out[f"{entry}_{variant}"] = n
    return out


def reset_launch_counts() -> None:
    for mod in MODULES.values():
        mod.launches.update(dict.fromkeys(mod.launches, 0))


def publish_launches(registry) -> None:
    """This process's launches as ``kernel_launches_total{kernel=}``
    counters of ``registry`` (a training run's ``metrics.prom``; the
    server's ``/metrics`` uses the same name).  An entry point that
    launched nothing — every one on the CPU — adds no line."""
    for name, count in launch_counts().items():
        if count:
            registry.counter("kernel_launches_total", "CUDA kernel launches by this process",
                             labels={"kernel": name}).inc(count)
