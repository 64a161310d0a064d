"""Goodput accounting — a copy of ``gene2vec_tpu/obs/goodput.py``: how
much of a run's wall time was real training?

Classify the run's wall time into buckets and report achieved-vs-peak
throughput, so "the run took 40 minutes" decomposes into compute,
checkpointing, input stalls and time drained after preemption.  The
classification consumes the :mod:`~gene2vec_tpu_torch.obs.timeline`
phase records — each canonical phase maps to one bucket — and the
invariant is exact: the reported buckets **sum to the wall time**
(``other`` absorbs unattributed host time; when instrumented phases
overlap and exceed the wall clock, the known buckets are scaled down
proportionally rather than reporting a sum that disagrees with the
clock).

Buckets:

* ``compute``     — dispatch + device compute + collective wait (the
  time the card was doing, or directly feeding, real work);
* ``input_stall`` — host-side input work the device waited on
  (``host_ingest`` / ``h2d_stage`` phases);
* ``checkpoint``  — checkpoint staging/commit time on the loop thread;
* ``preempted``   — wall time between the preemption signal landing
  and the drain completing (work the scheduler reclaimed);
* ``other``       — everything unattributed (logging, probes, python).

The summary is stamped into the run manifest (``manifest.json`` key
``goodput``) and exported as gauges into ``metrics.prom``
(:func:`stamp`).  The port's trainers pass ``kernel_seconds=None``: no
kernel profiler feeds the per-kernel breakdown yet.
"""

from __future__ import annotations

from typing import Dict, Iterable, Optional

BUCKETS = ("compute", "input_stall", "checkpoint", "preempted", "other")

#: canonical timeline phase name → goodput bucket
PHASE_BUCKET = {
    "dispatch": "compute",
    "compute": "compute",
    "compute_wait": "compute",
    "collective_wait": "compute",
    "host_ingest": "input_stall",
    "h2d_stage": "input_stall",
    "ckpt_stage": "checkpoint",
    "checkpoint": "checkpoint",
}


def classify(
    timeline_records: Iterable[Dict],
    wall_s: float,
    preempted_s: float = 0.0,
) -> Dict[str, float]:
    """Bucket a run's wall time.  Returns ``{bucket: seconds}`` over
    exactly :data:`BUCKETS`, summing to ``wall_s`` (to float
    precision).  Unknown phase names fall into ``other`` implicitly
    (they are simply not attributed)."""
    wall_s = max(float(wall_s), 0.0)
    buckets = {b: 0.0 for b in BUCKETS}
    for rec in timeline_records:
        bucket = PHASE_BUCKET.get(str(rec.get("name", "")))
        if bucket is None:
            continue
        buckets[bucket] += max(float(rec.get("dur", 0.0)), 0.0)
    buckets["preempted"] = max(float(preempted_s), 0.0)
    known = sum(buckets.values())
    if known > wall_s and known > 0.0:
        # overlapping/duplicated instrumentation cannot make the report
        # exceed the clock: scale attributed time down to fit
        scale = wall_s / known
        for b in buckets:
            buckets[b] *= scale
        known = wall_s
    buckets["other"] = wall_s - known
    return buckets


def summarize(
    timeline_records: Iterable[Dict],
    wall_s: float,
    pairs_total: float = 0.0,
    peak_pairs_per_sec: Optional[float] = None,
    preempted_s: float = 0.0,
    kernel_seconds: Optional[Dict[str, float]] = None,
) -> Dict:
    """The full goodput summary stamped into run manifests.

    * ``buckets_s`` / ``fractions`` — the wall-time classification;
    * ``achieved_pairs_per_sec`` — pairs over the whole wall clock
      (what a user of the run actually got);
    * ``peak_pairs_per_sec`` — the best sustained rate observed (the
      caller passes the max per-iteration rate; falls back to pairs
      over compute-bucket seconds when not given);
    * ``utilization`` — achieved/peak: the fraction of the machine's
      demonstrated capability the run delivered end to end;
    * ``compute_kernels`` / ``compute_kernels_s`` (only with
      ``kernel_seconds``, the profiler's attributed wall per kernel) —
      per-kernel breakdown OF the compute bucket, same discipline as
      the buckets themselves: over-attribution scales down to fit the
      bucket, under-attribution leaves an explicit ``_unattributed``
      residual, so the kernel seconds sum to the compute bucket
      exactly (and the wall fractions to the compute fraction).
    """
    records = list(timeline_records)
    buckets = classify(records, wall_s, preempted_s=preempted_s)
    wall_s = max(float(wall_s), 0.0)
    fractions = {
        b: (buckets[b] / wall_s if wall_s > 0 else 0.0) for b in BUCKETS
    }
    achieved = pairs_total / wall_s if wall_s > 0 else 0.0
    peak = peak_pairs_per_sec
    if peak is None and buckets["compute"] > 0:
        peak = pairs_total / buckets["compute"]
    kernels_s: Optional[Dict[str, float]] = None
    if kernel_seconds is not None:
        compute_s = buckets["compute"]
        kernels_s = {
            str(k): max(float(v), 0.0)
            for k, v in kernel_seconds.items()
            if float(v) > 0.0
        }
        attributed = sum(kernels_s.values())
        if attributed > compute_s and attributed > 0.0:
            scale = compute_s / attributed
            kernels_s = {k: v * scale for k, v in kernels_s.items()}
        else:
            kernels_s["_unattributed"] = compute_s - attributed
    return {
        "wall_s": round(wall_s, 6),
        "buckets_s": {b: round(v, 6) for b, v in buckets.items()},
        "fractions": {b: round(v, 6) for b, v in fractions.items()},
        "pairs_total": float(pairs_total),
        "achieved_pairs_per_sec": round(achieved, 1),
        "peak_pairs_per_sec": (
            round(float(peak), 1) if peak is not None else None
        ),
        "utilization": (
            round(achieved / peak, 4) if peak else None
        ),
        **(
            {
                "compute_kernels_s": {
                    k: round(v, 6) for k, v in kernels_s.items()
                },
                "compute_kernels": {
                    k: (round(v / wall_s, 6) if wall_s > 0 else 0.0)
                    for k, v in kernels_s.items()
                },
            }
            if kernels_s is not None else {}
        ),
    }


def stamp(run, summary: Dict) -> None:
    """Persist a goodput summary: merge into the run's on-disk manifest
    (key ``goodput``) and set the ``goodput_*_fraction`` /
    ``achieved_pairs_per_sec`` / ``peak_pairs_per_sec`` gauges so the
    run-close ``metrics.prom`` snapshot carries them."""
    run.annotate(goodput=summary)
    for b in BUCKETS:
        run.registry.gauge(f"goodput_{b}_fraction").set(
            summary["fractions"][b]
        )
    run.registry.gauge("achieved_pairs_per_sec").set(
        summary["achieved_pairs_per_sec"]
    )
    if summary.get("peak_pairs_per_sec") is not None:
        run.registry.gauge("peak_pairs_per_sec").set(
            summary["peak_pairs_per_sec"]
        )
    if summary.get("utilization") is not None:
        run.registry.gauge("goodput_utilization").set(summary["utilization"])
    for kernel, frac in (summary.get("compute_kernels") or {}).items():
        run.registry.gauge(
            "goodput_kernel_fraction", labels={"kernel": kernel}
        ).set(frac)
