"""Unified observability layer: spans, metrics, probes, run manifests —
the port of ``gene2vec_tpu/obs``.

* :mod:`gene2vec_tpu_torch.obs.trace` — append-only JSON-lines span/event
  tracer (``events.jsonl``); nested spans, wall + monotonic timestamps,
  process/thread ids, so concurrent writers land in one merged timeline;
* :mod:`gene2vec_tpu_torch.obs.registry` — named counters/gauges/histograms
  with a Prometheus-style text export and a CSV sink
  (:class:`~gene2vec_tpu_torch.utils.metrics.MetricsLogger`);
* :mod:`gene2vec_tpu_torch.obs.probes` — runtime samplers: CUDA memory
  held in tensors, host RSS, compile events (kernel builds and library
  loads, :class:`~gene2vec_tpu_torch.obs.probes.CompileWatcher`);
* :mod:`gene2vec_tpu_torch.obs.run` — the per-run orchestrator: writes
  ``manifest.json`` (config hash, git sha, devices, versions, argv) at
  run start and flags steps exceeding a rolling p99×3 budget as
  ``stall`` events;
* :mod:`gene2vec_tpu_torch.obs.timeline` — per-step phase timeline
  (host_ingest / dispatch / compute / ckpt_stage) into a bounded ring,
  flushed to ``timeline.jsonl`` and exported as Perfetto-loadable
  Chrome trace JSON via ``cli.obs timeline``;
* :mod:`gene2vec_tpu_torch.obs.goodput` — goodput accounting: run wall
  time classified into compute / input-stall / checkpoint / preempted
  buckets (summing exactly to wall), achieved-vs-peak pairs/s, stamped
  into the run manifest and ``metrics.prom``;
* :mod:`gene2vec_tpu_torch.obs.profiler` — kernel cost attribution: each
  hot path's work counted from its shapes, its best wall and utilization
  against the card's data-sheet peaks (``kernels.jsonl``);
* :mod:`gene2vec_tpu_torch.obs.report` — the run summary behind
  ``cli.obs report``;
* :mod:`gene2vec_tpu_torch.obs.ledger` — the unified bench ledger: every
  root bench artifact adapted into one record schema, trailing-window
  regression detection (``cli.obs ledger``).
* :mod:`gene2vec_tpu_torch.obs.tracecontext` — W3C-style ``traceparent``
  contexts, a head sampler and the thread's current context, which the
  tracer stamps onto every record (``trace``/``tsid``/``tpid``);
* :mod:`gene2vec_tpu_torch.obs.flight` — the always-on ring of recent
  requests with their hops, dumped on a 5xx burst or SIGQUIT, and the
  cross-process trace reassembly behind ``cli.obs trace``;
* :mod:`gene2vec_tpu_torch.obs.aggregate` — the fleet's scrape of every
  replica's ``/metrics`` merged into ``/metrics/fleet``;
* :mod:`gene2vec_tpu_torch.obs.alerts` — SLO rules (thresholds, burn
  rates) evaluated on each scrape tick into ``alerts.jsonl``, and the
  rate limiter every forensic write shares;
* :mod:`gene2vec_tpu_torch.obs.incident` — CRC-manifested incident
  bundles assembled when a rule fires (``cli.obs incident``).

Every trainer's ``run(export_dir)`` writes ``manifest.json`` +
``events.jsonl`` into its export/run directory;
``python -m gene2vec_tpu_torch.cli.obs report <run_dir>`` summarizes any
of them.
"""

from gene2vec_tpu_torch.obs.registry import MetricsRegistry  # noqa: F401
from gene2vec_tpu_torch.obs.run import Run, StallWatchdog, config_hash  # noqa: F401
from gene2vec_tpu_torch.obs.trace import Tracer, ambient_span, get_tracer  # noqa: F401
