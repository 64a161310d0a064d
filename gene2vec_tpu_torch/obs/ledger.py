"""Unified bench ledger: every root bench artifact, one record schema — a
copy of ``gene2vec_tpu/obs/ledger.py``.

The repo root accumulates one JSON artifact per benchmark family per
round — ``BENCH_r*`` (SGNS headline), ``MULTICHIP_r*``,
``BENCH_SERVE/FLEET/OBS/RESILIENCE/VIZ_CORPUS/BATCH_*``,
``MESH_SANITY_*``,
``INTRINSIC_*``, ``REAL_AUC``, ``BENCH_PERF_*`` — each with its own
shape and no index.  The ledger ingests all of them through per-family
*adapters* into one versioned record schema, renders the longitudinal
trajectory (``ledger.jsonl`` + CSV), and runs trailing-window
regression detection over the metric series:

* a **record** is ``{schema, family, source, round, created_unix,
  schema_version, legacy_unstamped, producer, headline_metric,
  metrics}`` — ``metrics`` a flat name→number map, ``round`` parsed
  from the ``_rNN`` filename suffix;
* artifacts without a ``schema_version`` / ``command`` stamp are
  ingested all the same and marked ``legacy_unstamped``, so provenance
  gaps are visible, not silent (:func:`provenance_stamp` writes the
  stamp);
* **regression detection** compares the newest point of a configured
  metric series against the **median of the trailing window** of
  prior points (median-of-band: one outlier round cannot fake or mask
  a regression); the per-metric threshold and direction are the
  ``perf.regression`` block of this package's ``budgets.json``
  (:func:`regression_rules`).

The ledger reads artifact files and nothing else; what it prints is a
tool's output.  CLI: ``python -m gene2vec_tpu_torch.cli.obs ledger``
(``--check`` exits 1 on a detected regression).
"""

from __future__ import annotations

import csv
import json
import os
import re
import sys
import time
from typing import Callable, Dict, List, Optional, Sequence, Tuple

SCHEMA = "gene2vec-tpu/ledger-record/v1"

_ROUND_RE = re.compile(r"_r(\d+)\.json$")


def _num(v) -> Optional[float]:
    if isinstance(v, bool):
        return 1.0 if v else 0.0
    if isinstance(v, (int, float)):
        return float(v)
    return None


def _put(metrics: Dict[str, float], name: str, value) -> None:
    n = _num(value)
    if n is not None:
        metrics[name] = n


def _parse_tail_json(tail: str, key: str = "metric") -> Optional[Dict]:
    """A wrapped ``BENCH_r*`` file holds the bench's one stdout JSON line
    inside a captured ``tail``; find it (newest last)."""
    found = None
    for line in tail.splitlines():
        line = line.strip()
        if not (line.startswith("{") and f'"{key}"' in line):
            continue
        try:
            found = json.loads(line)
        except json.JSONDecodeError:
            continue
    return found


# -- per-family adapters -----------------------------------------------------
# Each takes the parsed source document and returns (metrics, headline).
# Adapters are defensive by contract: every field access is guarded, so
# a shape drift in one family degrades to a sparser record, never an
# ingest crash.


def _adapt_bench_sgns(doc: Dict) -> Tuple[Dict[str, float], str]:
    parsed = doc.get("parsed")
    if not isinstance(parsed, dict):
        parsed = _parse_tail_json(doc.get("tail", "")) or {}
    m: Dict[str, float] = {}
    _put(m, "sgns_pairs_per_sec", parsed.get("value"))
    _put(m, "vs_baseline", parsed.get("vs_baseline"))
    _put(m, "vs_32thread_equiv", parsed.get("vs_32thread_equiv"))
    _put(m, "baseline_1core", parsed.get("baseline_1core"))
    quality = parsed.get("quality")
    if isinstance(quality, dict):
        _put(m, "quality_passed", quality.get("passed"))
        _put(m, "holdout_cos_auc", quality.get("holdout_cos_auc"))
    secondary = parsed.get("secondary")
    if isinstance(secondary, dict):
        for k in (
            "cbow_hs_pairs_per_sec",
            "dim512_sharded_pairs_per_sec",
            "ggipnn_pairs_per_sec",
            "shared_mode_pairs_per_sec",
            "table_bf16_pairs_per_sec",
        ):
            _put(m, k, secondary.get(k))
    _put(m, "rc", doc.get("rc"))
    return m, "sgns_pairs_per_sec"


def _adapt_multichip(doc: Dict) -> Tuple[Dict[str, float], str]:
    m: Dict[str, float] = {}
    _put(m, "multichip_ok", doc.get("ok"))
    _put(m, "multichip_skipped", doc.get("skipped"))
    _put(m, "n_devices", doc.get("n_devices"))
    _put(m, "rc", doc.get("rc"))
    return m, "multichip_ok"


def _adapt_serve(doc: Dict) -> Tuple[Dict[str, float], str]:
    m: Dict[str, float] = {}
    levels = doc.get("levels")
    if isinstance(levels, list) and levels:
        by_rate = sorted(
            (lv for lv in levels if isinstance(lv, dict)),
            key=lambda lv: _num(lv.get("offered_rps")) or 0.0,
        )
        if by_rate:
            low = by_rate[0]
            _put(m, "serve_p50_ms_min_load", low.get("p50_ms"))
            _put(m, "serve_p99_ms_min_load", low.get("p99_ms"))
            _put(m, "serve_min_load_rps", low.get("offered_rps"))
            # highest offered load that shed nothing: the measured knee
            clean = [
                lv for lv in by_rate
                if (_num(lv.get("rejection_rate")) or 0.0) == 0.0
                and (_num(lv.get("errors")) or 0.0) == 0.0
            ]
            if clean:
                _put(m, "serve_clean_capacity_rps",
                     clean[-1].get("offered_rps"))
    # capacity sections (schema_version >= 2; serve_loadgen --method/
    # --fleet era).  Older records (BENCH_SERVE_r06) predate the
    # capacity verdict entirely — they simply contribute no point to
    # the serve_capacity_rps series ("pre-capacity legacy"), which the
    # trajectory rules treat as a shorter series, never an error.
    capacity = doc.get("capacity")
    if isinstance(capacity, dict):
        _put(m, "serve_capacity_rps", capacity.get("sustained_rps"))
        _put(m, "serve_capacity_p99_ms", capacity.get("p99_ms"))
    else:
        _put(m, "serve_pre_capacity_legacy", True)
    fleet_capacity = doc.get("fleet_capacity")
    if isinstance(fleet_capacity, dict):
        _put(m, "serve_fleet_capacity_rps",
             fleet_capacity.get("sustained_rps"))
        _put(m, "serve_fleet_capacity_p99_ms",
             fleet_capacity.get("p99_ms"))
    return m, "serve_p50_ms_min_load"


def _adapt_fleet(doc: Dict) -> Tuple[Dict[str, float], str]:
    m: Dict[str, float] = {}
    fleet = doc.get("fleet")
    if isinstance(fleet, dict):
        _put(m, "fleet_availability", fleet.get("availability"))
        _put(m, "fleet_retry_amplification", fleet.get("retry_amplification"))
        _put(m, "fleet_wrong_answers", fleet.get("wrong_answers"))
        _put(m, "fleet_mixed_iteration_answers",
             fleet.get("mixed_iteration_answers"))
        _put(m, "fleet_requests", fleet.get("requests"))
    _put(m, "passed", doc.get("passed"))
    return m, "fleet_availability"


def _adapt_obs_trace(doc: Dict) -> Tuple[Dict[str, float], str]:
    m: Dict[str, float] = {}
    ov = doc.get("trace_overhead")
    if isinstance(ov, dict):
        _put(m, "trace_p50_regression_frac", ov.get("regression_frac"))
        _put(m, "trace_p50_untraced_ms", ov.get("p50_untraced_ms"))
        _put(m, "trace_p50_traced_ms", ov.get("p50_traced_ms"))
    return m, "trace_p50_regression_frac"


def _adapt_resilience(doc: Dict) -> Tuple[Dict[str, float], str]:
    m: Dict[str, float] = {}
    _put(m, "chaos_passed", doc.get("passed"))
    _put(m, "chaos_wall_seconds", doc.get("wall_seconds"))
    phases = doc.get("phases")
    if isinstance(phases, dict):
        async_ov = phases.get("async_overhead")
        if isinstance(async_ov, dict):
            _put(m, "async_ckpt_overhead_fraction",
                 async_ov.get("async_overhead_fraction"))
            _put(m, "sync_ckpt_overhead_fraction",
                 async_ov.get("sync_overhead_fraction"))
    return m, "chaos_passed"


def _adapt_mesh_sanity(doc: Dict) -> Tuple[Dict[str, float], str]:
    m: Dict[str, float] = {}
    rows = doc.get("rows")
    if isinstance(rows, list) and rows:
        rows = [r for r in rows if isinstance(r, dict)]
        parity = [r.get("loss_parity") for r in rows if "loss_parity" in r]
        if parity:
            _put(m, "mesh_loss_parity", all(bool(p) for p in parity))
        top = max(rows, key=lambda r: _num(r.get("devices")) or 0.0)
        _put(m, "mesh_max_devices", top.get("devices"))
        _put(m, "mesh_pairs_per_sec_max_devices", top.get("pairs_per_sec"))
        _put(m, "mesh_overhead_factor_max_devices",
             top.get("overhead_factor"))
    return m, "mesh_loss_parity"


def _adapt_intrinsic(doc: Dict) -> Tuple[Dict[str, float], str]:
    m: Dict[str, float] = {}
    _put(m, "intrinsic_target_func_ratio",
         doc.get("trained_target_func_ratio"))
    trained = doc.get("trained")
    if isinstance(trained, dict):
        _put(m, "intrinsic_intra_set_cos",
             trained.get("intra_set_cos_real_sets"))
    return m, "intrinsic_target_func_ratio"


def _adapt_real_auc(doc: Dict) -> Tuple[Dict[str, float], str]:
    m: Dict[str, float] = {}
    holdout = doc.get("holdout")
    if isinstance(holdout, dict):
        cos = holdout.get("cosine_auc")
        if isinstance(cos, dict):
            _put(m, "holdout_cos_auc_in_vocab", cos.get("in_vocab_pairs"))
            _put(m, "holdout_cos_auc_all_pairs", cos.get("all_pairs"))
        _put(m, "ggipnn_auc", holdout.get("ggipnn_auc"))
        _put(m, "ggipnn_accuracy", holdout.get("ggipnn_accuracy"))
    return m, "holdout_cos_auc_in_vocab"


def _adapt_viz_corpus(doc: Dict) -> Tuple[Dict[str, float], str]:
    m: Dict[str, float] = {}
    tsne = doc.get("tsne_24k")
    if isinstance(tsne, dict):
        _put(m, "tsne_tpu_iters_per_sec", tsne.get("tpu_iters_per_sec"))
    umap = doc.get("umap_24k")
    if isinstance(umap, dict):
        _put(m, "umap_iters_per_sec", umap.get("iters_per_sec"))
    corr = doc.get("corpus_corr")
    if isinstance(corr, dict):
        _put(m, "corpus_corr_tpu_vs_pandas", corr.get("tpu_vs_pandas"))
    return m, "tsne_tpu_iters_per_sec"


def _adapt_perf(doc: Dict) -> Tuple[Dict[str, float], str]:
    m: Dict[str, float] = {}
    _put(m, "timeline_regression_frac", doc.get("regression_frac"))
    _put(m, "rate_timeline_on", doc.get("rate_timeline_on"))
    _put(m, "rate_timeline_off", doc.get("rate_timeline_off"))
    return m, "timeline_regression_frac"


def _adapt_alerts(doc: Dict) -> Tuple[Dict[str, float], str]:
    """BENCH_ALERTS_* (chaos_drill.py --only alerts --alerts-out): the
    detection loop's headline is how fast the right rule fired after
    the injected fault; the ``perf.regression`` rules watch it so
    detection latency cannot silently erode."""
    m: Dict[str, float] = {}
    section = doc.get("alerts")
    section = section if isinstance(section, dict) else {}
    _put(m, "alert_detection_latency_s",
         section.get("detection_latency_s"))
    _put(m, "alert_warmup_false_positives",
         section.get("warmup_false_positives"))
    _put(m, "alert_bundle_verified", section.get("bundle_verified"))
    _put(m, "alert_bundle_trace_through_faulty_replica",
         section.get("bundle_trace_through_faulty_replica"))
    _put(m, "alert_bundle_traces", section.get("bundle_traces"))
    _put(m, "passed", doc.get("passed"))
    return m, "alert_detection_latency_s"


def _adapt_autoscale(doc: Dict) -> Tuple[Dict[str, float], str]:
    """BENCH_AUTOSCALE_* (chaos_drill.py --only autoscale
    --autoscale-out): the elastic fleet's headline is how fast the
    scaler noticed a load ramp (in scrape ticks) plus whether tenant
    isolation held; the ``perf.regression`` rules watch both so
    elasticity wins cannot silently erode."""
    m: Dict[str, float] = {}
    section = doc.get("autoscale")
    section = section if isinstance(section, dict) else {}
    for key in (
        "scale_up_detection_ticks",
        "victim_tenant_availability",
        "dropped_answers",
        "wrong_answers",
        "mixed_iteration_answers",
        "steady_state_scale_actions",
        "scale_up_completed_s",
        "scale_down_s",
        "drain_timeouts",
    ):
        _put(m, key, section.get(key))
    _put(m, "passed", doc.get("passed"))
    return m, "scale_up_detection_ticks"


def _adapt_ann(doc: Dict) -> Tuple[Dict[str, float], str]:
    """BENCH_ANN_* (bench.py --ann): per-index-mode recall@10 vs the
    exact numpy oracle, p50/p99 at the 1M-row synthetic geometry, and
    the IVF-vs-exact gain factors the ``ann.recall`` budget gates."""
    m: Dict[str, float] = {}
    modes = doc.get("modes")
    modes = modes if isinstance(modes, dict) else {}
    for mode in ("exact", "quant", "ivf"):
        section = modes.get(mode)
        if not isinstance(section, dict):
            continue
        _put(m, f"ann_{mode}_recall_at_10", section.get("recall_at_10"))
        _put(m, f"ann_{mode}_p50_ms", section.get("p50_ms"))
        _put(m, f"ann_{mode}_p99_ms", section.get("p99_ms"))
        _put(m, f"ann_{mode}_bytes_per_query",
             section.get("bytes_per_query"))
    ivf = modes.get("ivf")
    if isinstance(ivf, dict):
        # the two headline series the perf.regression rules watch
        _put(m, "ann_recall_at_10", ivf.get("recall_at_10"))
        _put(m, "ann_p99_ms_1m", ivf.get("p99_ms"))
        _put(m, "ann_p99_speedup_vs_exact",
             ivf.get("p99_speedup_vs_exact"))
        _put(m, "ann_bytes_reduction_vs_exact",
             ivf.get("bytes_reduction_vs_exact"))
    real = doc.get("real_table")
    if isinstance(real, dict):
        _put(m, "ann_real_recall_at_10_ivf", real.get("recall_at_10_ivf"))
        _put(m, "ann_real_recall_at_10_quant",
             real.get("recall_at_10_quant"))
    return m, "ann_recall_at_10"


def _adapt_shard(doc: Dict) -> Tuple[Dict[str, float], str]:
    """BENCH_SHARD_* (chaos_drill.py --only shard --shard-out): the
    fleet-sharded index story in two halves — the 10M-row scatter-merge
    bench (recall@10 vs the exact oracle with all shards up, degraded
    recall with one shard removed, merge p99) and the HTTP chaos drill
    (availability + answer integrity under a SIGKILLed shard and a
    swap-under-load).  The ``perf.regression`` rules watch the recall
    and p99 headline series."""
    m: Dict[str, float] = {}
    section = doc.get("shard")
    section = section if isinstance(section, dict) else {}
    bench = section.get("bench")
    if isinstance(bench, dict):
        _put(m, "shard_recall_at_10", bench.get("recall_at_10"))
        _put(m, "shard_degraded_recall_at_10",
             bench.get("degraded_recall_at_10"))
        _put(m, "shard_dead_row_fraction",
             bench.get("dead_shard_row_fraction"))
        _put(m, "shard_p50_ms", bench.get("p50_ms"))
        _put(m, "shard_p99_ms_10m", bench.get("p99_ms"))
        _put(m, "shard_rows", bench.get("rows"))
        _put(m, "shard_count", bench.get("shards"))
    drill = section.get("drill")
    if isinstance(drill, dict):
        _put(m, "shard_availability", drill.get("availability"))
        _put(m, "shard_wrong_answers", drill.get("wrong_answers"))
        _put(m, "shard_mixed_iteration_answers",
             drill.get("mixed_iteration_answers"))
        _put(m, "shard_server_5xx", drill.get("server_5xx"))
        _put(m, "shard_retry_amplification",
             drill.get("retry_amplification"))
        # replicated-shard failover scenario: a dead sibling
        # must cost zero degraded answers and bounded latency
        fo = drill.get("failover")
        if isinstance(fo, dict):
            _put(m, "failover_degraded_responses",
                 fo.get("degraded_responses"))
            _put(m, "failover_p99_ms", fo.get("p99_ms"))
            _put(m, "failover_availability", fo.get("availability"))
    _put(m, "passed", doc.get("passed"))
    return m, "shard_recall_at_10"


def _adapt_loop(doc: Dict) -> Tuple[Dict[str, float], str]:
    """BENCH_LOOP_* (chaos_drill.py --only loop --loop-out): the
    continuous-learning cycle end to end — ingest→promoted wall time,
    shadow answer churn / p99 delta between the live and candidate
    arms, promotion decision latency, and the zero-wrong/zero-mixed
    answer integrity held through a SIGKILL in every loop state.  The
    ``perf.regression`` rules watch churn and cycle wall time."""
    m: Dict[str, float] = {}
    section = doc.get("loop")
    section = section if isinstance(section, dict) else {}
    for key in (
        "answer_churn",
        "shadow_p99_delta_ms",
        "ingest_to_promoted_s",
        "promotion_decision_s",
        "wrong_answers",
        "mixed_iteration_answers",
        "resume_bit_exact",
        "promoted",
        "states_killed",
        "shadow_scored",
        "quality_auc",
        "new_genes",
    ):
        _put(m, f"loop_{key}", section.get(key))
    _put(m, "passed", doc.get("passed"))
    return m, "loop_answer_churn"


def _adapt_kernels(doc: Dict) -> Tuple[Dict[str, float], str]:
    """BENCH_KERNELS_* (bench.py --kernel-profile): per-kernel roofline
    records — static XLA flops/bytes plus best observed wall and
    achieved-vs-peak utilization at the pinned recipe — flattened to
    ``kernel_<name>_*`` series, plus the profiling-overhead headline
    the ``perf.regression`` rules watch (``kernels.profile`` budget)."""
    m: Dict[str, float] = {}
    kernels = doc.get("kernels")
    kernels = kernels if isinstance(kernels, dict) else {}
    for name, rec in kernels.items():
        if not isinstance(rec, dict):
            continue
        for key in ("flops", "bytes_accessed", "wall_s", "utilization",
                    "compile_s"):
            _put(m, f"kernel_{name}_{key}", rec.get(key))
    sgns = kernels.get("sgns_train_step")
    if isinstance(sgns, dict):
        _put(m, "kernel_sgns_utilization", sgns.get("utilization"))
    overhead = doc.get("overhead")
    overhead = overhead if isinstance(overhead, dict) else {}
    _put(m, "kernel_profile_overhead_frac", overhead.get("regression_frac"))
    return m, "kernel_profile_overhead_frac"


def _adapt_batch(doc: Dict) -> Tuple[Dict[str, float], str]:
    """BENCH_BATCH_* (chaos_drill.py --only batch --batch-out): the
    offline analytics plane end to end — full-vocab kNN graph build
    through the live fleet's background lane (throughput at the paper's
    24k vocab, recall@10 vs the brute-force oracle, SIGKILL-resume
    bit-identity), sampled-query throughput against a 1M-row index,
    and the mixed-workload interactive p99 delta.  The
    ``perf.regression`` rules watch graph throughput (higher) and the
    p99-under-batch delta (lower)."""
    m: Dict[str, float] = {}
    section = doc.get("batch")
    section = section if isinstance(section, dict) else {}
    g = section.get("graph_24k")
    if isinstance(g, dict):
        _put(m, "batch_graph_rows_per_sec", g.get("rows_per_sec"))
        _put(m, "batch_graph_recall_at_10", g.get("recall_at_10"))
        _put(m, "batch_graph_rows", g.get("rows"))
        _put(m, "batch_graph_wall_s", g.get("wall_s"))
        _put(m, "batch_resume_bit_exact", g.get("resume_bit_exact"))
        _put(m, "batch_resumed_records", g.get("resumed_records"))
    g1m = section.get("graph_1m")
    if isinstance(g1m, dict):
        _put(m, "batch_graph_1m_rows_per_sec", g1m.get("rows_per_sec"))
        _put(m, "batch_graph_1m_recall_at_10", g1m.get("recall_at_10"))
        _put(m, "batch_graph_1m_rows", g1m.get("rows"))
    mixed = section.get("mixed")
    if isinstance(mixed, dict):
        _put(m, "batch_interactive_p99_baseline_ms",
             mixed.get("interactive_p99_baseline_ms"))
        _put(m, "batch_interactive_p99_under_batch_ms",
             mixed.get("interactive_p99_under_batch_ms"))
        _put(m, "batch_p99_delta_ms", mixed.get("p99_delta_ms"))
        _put(m, "batch_p99_delta_frac", mixed.get("p99_delta_frac"))
        _put(m, "batch_goodput_rows_per_sec",
             mixed.get("batch_goodput_rows_per_sec"))
    _put(m, "passed", doc.get("passed"))
    return m, "batch_graph_rows_per_sec"


def _adapt_catalog(doc: Dict) -> Tuple[Dict[str, float], str]:
    """BENCH_CATALOG_* (chaos_drill.py --only catalog --catalog-out):
    the multi-model serving plane's isolation drill — a two-model
    catalog fleet hot-swaps its default model under verified load on
    both models, then ramps the second model and proves only that
    model's pool scales.  The ``perf.regression`` rules watch verified
    availability (higher) and the per-model scale-up detection latency
    in scrape ticks (lower)."""
    m: Dict[str, float] = {}
    section = doc.get("catalog")
    section = section if isinstance(section, dict) else {}
    verified = section.get("verified")
    if isinstance(verified, dict):
        _put(m, "catalog_availability", verified.get("availability"))
        _put(m, "catalog_verified_requests", verified.get("requests"))
        _put(m, "catalog_wrong_answers", verified.get("wrong"))
        _put(m, "catalog_mixed_answers", verified.get("mixed"))
        _put(m, "catalog_cross_model_answers", verified.get("cross_model"))
    swap = section.get("swap")
    if isinstance(swap, dict):
        _put(m, "catalog_swap_visible_s", swap.get("visible_s"))
    scale = section.get("scale_up")
    if isinstance(scale, dict):
        _put(m, "catalog_scale_up_detection_ticks",
             scale.get("detection_ticks"))
        _put(m, "catalog_scale_up_completed_s", scale.get("completed_s"))
        _put(m, "catalog_cold_pool_final", scale.get("cold_pool_final"))
    _put(m, "passed", doc.get("passed"))
    return m, "catalog_availability"


#: ingest order: (compiled filename pattern, family, adapter).
#: First match wins — BENCH_PERF/SERVE/FLEET/... must precede the bare
#: BENCH_r catch-all.
ADAPTERS: Sequence[Tuple[re.Pattern, str, Callable]] = (
    (re.compile(r"^BENCH_CATALOG_\w*\.json$"), "catalog", _adapt_catalog),
    (re.compile(r"^BENCH_BATCH_\w*\.json$"), "batch", _adapt_batch),
    (re.compile(r"^BENCH_LOOP_\w*\.json$"), "loop", _adapt_loop),
    (re.compile(r"^BENCH_SHARD_\w*\.json$"), "shard", _adapt_shard),
    (re.compile(r"^BENCH_PERF_r?\d*\.json$"), "perf_timeline", _adapt_perf),
    (re.compile(r"^BENCH_ALERTS_\w*\.json$"), "alerts", _adapt_alerts),
    (re.compile(r"^BENCH_AUTOSCALE_\w*\.json$"), "autoscale",
     _adapt_autoscale),
    (re.compile(r"^BENCH_KERNELS_\w*\.json$"), "kernels", _adapt_kernels),
    (re.compile(r"^BENCH_ANN_\w*\.json$"), "ann", _adapt_ann),
    (re.compile(r"^BENCH_SERVE_\w*\.json$"), "serve_loadgen", _adapt_serve),
    (re.compile(r"^BENCH_FLEET_\w*\.json$"), "fleet_chaos", _adapt_fleet),
    (re.compile(r"^BENCH_OBS_\w*\.json$"), "obs_trace", _adapt_obs_trace),
    (re.compile(r"^BENCH_RESILIENCE_\w*\.json$"), "chaos_drill",
     _adapt_resilience),
    (re.compile(r"^BENCH_VIZ_CORPUS_\w*\.json$"), "viz_corpus",
     _adapt_viz_corpus),
    (re.compile(r"^BENCH_r\d+\.json$"), "bench_sgns", _adapt_bench_sgns),
    (re.compile(r"^MULTICHIP_r\d+\.json$"), "multichip", _adapt_multichip),
    (re.compile(r"^MESH_SANITY_\w*\.json$"), "mesh_sanity",
     _adapt_mesh_sanity),
    (re.compile(r"^INTRINSIC_\w*\.json$"), "intrinsic", _adapt_intrinsic),
    (re.compile(r"^REAL_AUC\.json$"), "real_auc", _adapt_real_auc),
)


def provenance_stamp(doc: Dict) -> Dict:
    """Stamp ``schema_version`` / ``command`` / ``created_unix`` into a
    bench or quality-eval JSON product so :func:`adapt_file` ingests it
    with provenance instead of marking it ``legacy_unstamped``."""
    doc.setdefault("schema_version", 1)
    doc.setdefault("command", " ".join([sys.executable, *sys.argv]))
    doc.setdefault("created_unix", time.time())
    return doc


#: this package's regression rules: the ``perf.regression`` block
BUDGETS_PATH = os.path.join(os.path.dirname(os.path.abspath(__file__)), "budgets.json")


def regression_rules() -> Dict:
    """The ``perf.regression`` block of ``budgets.json``, the rules
    :func:`detect_regressions` takes."""
    with open(BUDGETS_PATH, "r", encoding="utf-8") as f:
        return json.load(f).get("perf", {}).get("regression", {})


def match_family(filename: str) -> Optional[Tuple[str, Callable]]:
    for pattern, family, adapter in ADAPTERS:
        if pattern.match(filename):
            return family, adapter
    return None


def parse_round(filename: str) -> Optional[int]:
    m = _ROUND_RE.search(filename)
    return int(m.group(1)) if m else None


def adapt_file(path: str) -> Optional[Dict]:
    """One artifact → one ledger record, or None when the filename
    matches no family.  Unreadable/unparseable files yield a record
    with an ``error`` field (the trajectory shows the hole) instead of
    crashing the ingest."""
    name = os.path.basename(path)
    matched = match_family(name)
    if matched is None:
        return None
    family, adapter = matched
    record: Dict = {
        "schema": SCHEMA,
        "family": family,
        "source": name,
        "round": parse_round(name),
    }
    try:
        with open(path, "r", encoding="utf-8") as f:
            doc = json.load(f)
        if not isinstance(doc, dict):
            raise ValueError(f"top-level JSON is {type(doc).__name__}")
    except (OSError, ValueError) as e:
        record.update({
            "error": str(e), "metrics": {}, "headline_metric": None,
            "legacy_unstamped": True,
        })
        return record
    try:
        metrics, headline = adapter(doc)
    except Exception as e:  # adapter bug ≠ ingest crash
        record.update({
            "error": f"adapter failed: {e}", "metrics": {},
            "headline_metric": None,
        })
        metrics, headline = {}, None
    # provenance stamps live at the top level of directly-written
    # artifacts; the BENCH_r* wrapper stores the bench's own
    # stdout document under "parsed", so fall back one level — the
    # stamp must survive the wrapping or every future headline round
    # would still read as legacy
    stamp_docs = [doc]
    if isinstance(doc.get("parsed"), dict):
        stamp_docs.append(doc["parsed"])

    def stamped(key, want):
        for d in stamp_docs:
            v = d.get(key)
            if isinstance(v, want):
                return v
        return None

    sv = stamped("schema_version", int)
    created = next(
        (v for d in stamp_docs
         if (v := _num(d.get("created_unix"))) is not None),
        None,
    )
    if created is None:
        try:
            created = os.path.getmtime(path)
        except OSError:
            created = None
    record.update({
        "created_unix": created,
        "schema_version": sv,
        "source_schema": stamped("schema", str),
        # artifacts produced before the provenance stamps: visible, not
        # silent
        "legacy_unstamped": sv is None,
        "producer": stamped("command", str),
        "headline_metric": headline,
        "metrics": metrics,
    })
    return record


def ingest_root(root: str) -> List[Dict]:
    """Adapt every matching artifact directly under ``root`` (the repo
    root by convention), ordered by (round, created) so the series read
    oldest → newest."""
    records: List[Dict] = []
    try:
        names = sorted(os.listdir(root))
    except OSError:
        return records
    for name in names:
        path = os.path.join(root, name)
        if not os.path.isfile(path):
            continue
        rec = adapt_file(path)
        if rec is not None:
            records.append(rec)
    records.sort(key=lambda r: (
        r["family"],
        r["round"] if r["round"] is not None else -1,
        r.get("created_unix") or 0.0,
        r["source"],
    ))
    return records


# -- persistence -------------------------------------------------------------


def write_jsonl(records: List[Dict], path: str) -> None:
    with open(path, "w", encoding="utf-8") as f:
        for rec in records:
            f.write(json.dumps(rec, separators=(",", ":"), default=str)
                    + "\n")


def write_csv(records: List[Dict], path: str) -> None:
    """Flat CSV: fixed identity columns + the union of metric names."""
    metric_names = sorted({
        name for rec in records for name in rec.get("metrics", {})
    })
    head = [
        "family", "source", "round", "created_unix", "schema_version",
        "legacy_unstamped", "headline_metric", "headline_value", "error",
    ]
    with open(path, "w", encoding="utf-8", newline="") as f:
        w = csv.writer(f)
        w.writerow(head + metric_names)
        for rec in records:
            metrics = rec.get("metrics", {})
            headline = rec.get("headline_metric")
            row = [
                rec.get("family"), rec.get("source"), rec.get("round"),
                rec.get("created_unix"), rec.get("schema_version"),
                rec.get("legacy_unstamped"), headline,
                metrics.get(headline) if headline else None,
                rec.get("error", ""),
            ]
            w.writerow(row + [metrics.get(n, "") for n in metric_names])


# -- regression detection ----------------------------------------------------


def series(records: List[Dict], metric: str) -> List[Tuple[str, float]]:
    """(source, value) points for one metric, in ledger (oldest→newest)
    order."""
    out = []
    for rec in records:
        v = rec.get("metrics", {}).get(metric)
        if v is not None:
            out.append((rec["source"], float(v)))
    return out


def _median(values: Sequence[float]) -> float:
    ordered = sorted(values)
    n = len(ordered)
    mid = n // 2
    if n % 2:
        return ordered[mid]
    return 0.5 * (ordered[mid - 1] + ordered[mid])


def detect_regressions(records: List[Dict], rules: Dict) -> List[Dict]:
    """Trailing-window regression check per configured metric.

    ``rules`` is the ``perf.regression`` budgets section
    (:func:`regression_rules`)::

        {"window": 4, "min_points": 3,
         "metrics": {"sgns_pairs_per_sec":
                     {"direction": "higher", "max_regression_frac": 0.3}}}

    For each metric: the newest point is compared against the MEDIAN of
    the up-to-``window`` points before it (median-of-band: one outlier
    round cannot fake or mask a regression).  ``direction`` names which
    way is good ("higher" for throughput, "lower" for latency); a
    newest point worse than the band median by more than
    ``max_regression_frac`` regresses.  Series shorter than
    ``min_points`` (newest included) are reported ``skipped`` — gating
    them would make every new benchmark family fail until it has
    history.

    Returns one evaluation dict per configured metric with a
    ``regressed`` bool; callers (``cli.obs ledger --check``) decide
    severity.
    """
    window = int(rules.get("window", 4))
    min_points = int(rules.get("min_points", 3))
    out: List[Dict] = []
    for metric, rule in (rules.get("metrics") or {}).items():
        if metric.startswith("_") or not isinstance(rule, dict):
            continue
        pts = series(records, metric)
        threshold = float(rule.get("max_regression_frac", 0.2))
        direction = str(rule.get("direction", "higher"))
        ev: Dict = {
            "metric": metric,
            "direction": direction,
            "max_regression_frac": threshold,
            "n_points": len(pts),
            "regressed": False,
        }
        if len(pts) < min_points:
            ev["skipped"] = f"needs >= {min_points} points, has {len(pts)}"
            out.append(ev)
            continue
        newest_src, newest = pts[-1]
        band = [v for _, v in pts[-1 - window:-1]]
        med = _median(band)
        ev.update({
            "newest_source": newest_src,
            "newest_value": newest,
            "band_median": med,
            "band_values": band,
        })
        if med != 0:
            delta = (
                (med - newest) / abs(med)
                if direction == "higher"
                else (newest - med) / abs(med)
            )
            ev["regression_frac"] = round(delta, 4)
            ev["regressed"] = delta > threshold
        out.append(ev)
    return out
