"""Serve CLI: the similarity query server over an export dir, on the GPU.

    python -m gene2vec_tpu_torch.cli.serve --export-dir out/ --port 8000 \\
        [--index exact|quant|ivf] [--ggipnn-checkpoint model-<step>.npz] \\
        [--kernel-profile] [--faults JSON] [--trace-sample P] \\
        [--run-dir DIR] [--device cuda|cpu] \\
        [--shard-index I --num-shards N] \\
        [--tenant-quota RATE [--tenant-burst B] [--tenant-override ID:R[:B[:W]]]] \
        [--model-name NAME | --catalog SPEC.json] \
        [--jobs-dir DIR [--batch-weight W] [--batch-duty D] [--batch-guard-max G]]

Loads the newest verified iteration of an export that either package
wrote, places the unit matrix (and the quant/IVF index) on the card, and
answers ``/v1/similar``, ``/v1/embedding``, ``/v1/interaction``,
``/v1/genes``, ``/healthz``, ``/livez``, ``/debug/flight`` and
``/metrics`` through the event loop and
micro-batcher; the top-k work and the interaction scorer's table lookup
run on the port's CUDA kernels.  ``--device`` defaults to
``cuda`` and the server refuses to start without a GPU unless
``--device cpu`` is given.

Prints exactly ONE JSON line on stdout once the server is listening —
``{"url": ..., "dim": ..., "iteration": ..., "run_dir": ..., "index":
..., "device": ...}`` — so a harness can parse the bound address;
human-readable status goes to stderr.  SIGTERM or Ctrl-C shuts it down.

Every session stamps an obs run dir (``--run-dir``, default
``<export-dir>/serve_runs/<unix-ts>``): its ``events.jsonl`` holds the
request spans (trace-stamped under a sampled ``traceparent`` or
``--trace-sample``), and it is the flight recorder's dump dir — a 5xx
burst (``--burst-threshold`` within ``--burst-window``) dumps the ring
there, and so does ``kill -QUIT <pid>``.

``--shard-index I --num-shards N`` serves one contiguous row shard of the
table (only its rows and index reach the card) with the ``/v1/shard/*``
plane and no self-swap watcher: the fleet's coordinator stages and flips
every shard together (``cli.fleet --shard-by-rows`` sets them).
``--tenant-quota`` turns per-tenant admission on (``X-Tenant``; 429s
labelled by tenant; ``serve/tenancy.py``).

``--catalog SPEC.json`` serves a multi-model catalog
(``serve/catalog.py``): one registry, engine and watcher per named model
at ``/v1/<model>/*``, unprefixed ``/v1/*`` serving the spec's default;
``--export-dir`` then only anchors the run dir.  ``--model-name`` serves
one export under a catalog name (what ``cli.fleet --catalog`` gives each
pool's replicas).  ``--jobs-dir`` mounts ``/v1/jobs`` (``batch/jobs.py``):
jobs query this server's own batcher on the low-weight ``batch`` tenant
lane and resume from their committed cursor after a restart.

``--faults`` (else ``$GENE2VEC_TPU_FAULTS``) takes a
``resilience/faults.py`` ``FaultSpec`` as JSON and injects deterministic
HTTP faults (latency, error, reset, blackhole) into the matching routes;
the server then says ``FAULT INJECTION ACTIVE: ...`` on stderr.
"""

from __future__ import annotations

import argparse
import json
import os
import signal
import sys
import threading
import time
from typing import List, Optional


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="serve",
        description="Batched embedding similarity server over a checkpoint export dir.",
    )
    p.add_argument("--export-dir", required=True,
                   help="checkpoint export dir (npz + vocab.tsv; *_w2v.txt text "
                        "exports work as a fallback)")
    p.add_argument("--dim", type=int, default=None,
                   help="serve only this table width (default: newest of any dim)")
    p.add_argument("--model-name", default="default",
                   help="catalog name this replica serves under (serve/catalog.py): "
                        "/v1/<name>/* aliases the unprefixed routes, metrics gain a "
                        "model= label and /healthz names it; 'default' keeps every "
                        "label set and response as a single-model server's")
    p.add_argument("--catalog", default=None, metavar="SPEC.json",
                   help="serve a multi-model catalog spec instead of one export "
                        "dir: one registry + engine + watcher per named model at "
                        "/v1/<model>/* (unprefixed /v1/* serves the spec's "
                        "default).  --export-dir still anchors the run dir.  "
                        "Never combines with row sharding")
    p.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    p.add_argument("--host", default="127.0.0.1")
    p.add_argument("--port", type=int, default=8000,
                   help="0 picks an ephemeral port (printed in the JSON status line)")
    p.add_argument("--max-batch", type=int, default=64)
    p.add_argument("--max-delay-ms", type=float, default=5.0,
                   help="micro-batch admission window")
    p.add_argument("--max-queue", type=int, default=256,
                   help="bounded queue depth; beyond it requests get 429")
    p.add_argument("--cache-size", type=int, default=4096,
                   help="LRU entries keyed by (model version, gene, k); 0 disables")
    p.add_argument("--timeout-ms", type=float, default=2000.0,
                   help="default per-request deadline")
    p.add_argument("--read-timeout", type=float, default=10.0,
                   help="per-request read deadline in seconds (slow clients get "
                        "408 + close)")
    p.add_argument("--idle-timeout", type=float, default=30.0,
                   help="keep-alive connections idle longer than this are closed")
    p.add_argument("--max-conn-requests", type=int, default=0,
                   help="requests served per keep-alive connection before it is "
                        "closed (0 = unbounded)")
    p.add_argument("--acceptors", type=int, default=1,
                   help="acceptor event loops; > 1 binds SO_REUSEPORT listening "
                        "sockets")
    p.add_argument("--http-workers", type=int, default=8,
                   help="bounded worker pool for the full-dispatch path (POSTs); "
                        "saturation answers 429")
    p.add_argument("--burst-threshold", type=int, default=10,
                   help="5xx responses within --burst-window that dump the "
                        "flight-recorder ring to the run dir (rate-limited)")
    p.add_argument("--burst-window", type=float, default=5.0,
                   help="the 5xx-burst detection window in seconds")
    p.add_argument("--trace-sample", type=float, default=0.0,
                   help="root-trace sampling rate for requests without a "
                        "traceparent header (0..1; propagated sampled contexts "
                        "are always honored)")
    p.add_argument("--index", choices=("exact", "quant", "ivf"), default="exact",
                   help="retrieval index: exact = float32 brute force (K7); quant = "
                        "int8 full-table scan (K8) + exact rescore (K9r); ivf = "
                        "centroid probe -> --nprobe lists -> int8 candidates (K9) + "
                        "exact rescore (K9r); centroids cached under "
                        "<export-dir>/ann_cache keyed by table CRC")
    p.add_argument("--nprobe", type=int, default=8,
                   help="IVF lists probed per query (ignored unless --index ivf)")
    p.add_argument("--rescore-mult", type=int, default=4,
                   help="exact-rescore tail size as a multiple of k (quant/ivf)")
    p.add_argument("--ann-clusters", type=int, default=None,
                   help="IVF centroid count (default ~4*sqrt(vocab))")
    p.add_argument("--kernel-profile", action="store_true",
                   help="count each engine batch bucket's kernel work at startup and "
                        "publish per-bucket kernel cost gauges (kernel_flops, "
                        "kernel_bytes_accessed) on /metrics; launches no kernel")
    p.add_argument("--faults", default=None, metavar="JSON",
                   help="resilience/faults.py FaultSpec as JSON — deterministic HTTP "
                        "fault injection for drills (default: $GENE2VEC_TPU_FAULTS "
                        "when set, else no injection)")
    p.add_argument("--poll-interval", type=float, default=5.0,
                   help="seconds between export-dir rescans (hot swap)")
    p.add_argument("--run-dir", default=None,
                   help="obs run dir: span log and flight dumps (default: "
                        "<export-dir>/serve_runs/<unix-ts>)")
    p.add_argument("--ggipnn-checkpoint", default=None,
                   help="GGIPNN run checkpoint npz (checkpoints/model-<step>.npz) "
                        "backing /v1/interaction (without it the MLP head is "
                        "untrained and responses say so)")
    p.add_argument("--shard-rows", action="store_true",
                   help="row-shard the table over every visible device; on one "
                        "card the whole table stays on it (more cards need ROADMAP "
                        "A13, multi-GPU)")
    p.add_argument("--shard-index", type=int, default=None,
                   help="serve ONE contiguous row shard of the table: this replica's "
                        "shard index in [0, --num-shards).  Loads only the shard's "
                        "rows and index, exposes /v1/shard/*, and disables the "
                        "self-swap watcher (the fleet's coordinator stages and flips; "
                        "normally set by cli.fleet --shard-by-rows)")
    p.add_argument("--num-shards", type=int, default=None,
                   help="total shard count for --shard-index")
    p.add_argument("--tenant-quota", type=float, default=0.0, metavar="RATE",
                   help="per-tenant token-bucket quota in requests/s (X-Tenant "
                        "header; untagged traffic is the 'default' tenant); 0 "
                        "disables tenant admission.  Quotas are per replica")
    p.add_argument("--tenant-burst", type=float, default=0.0,
                   help="tenant bucket burst headroom (0 = 2 x --tenant-quota)")
    p.add_argument("--tenant-override", action="append", default=[],
                   metavar="ID:RATE[:BURST[:WEIGHT]]",
                   help="explicit quota for one tenant (repeatable); WEIGHT is its "
                        "weighted-fair share of a contended batch (default 1)")
    p.add_argument("--jobs-dir", default=None, metavar="DIR",
                   help="batch-job store root: mounts /v1/jobs (batch/jobs.py); "
                        "jobs query this server's batcher on the low-weight "
                        "'batch' tenant lane and resume from their committed "
                        "cursor across restarts")
    p.add_argument("--batch-weight", type=float, default=0.05,
                   help="the batch lane's weighted-fair share against "
                        "interactive lanes when the queue is contended")
    p.add_argument("--batch-duty", type=float, default=1.0,
                   help="share of wall time a batch job may take (1.0 = no "
                        "idle gap between chunks)")
    p.add_argument("--batch-guard-max", type=float, default=0.5,
                   help="queue fullness above which batch chunks yield until "
                        "the pressure drops")
    return p


def main(argv: Optional[List[str]] = None) -> int:
    args = build_parser().parse_args(argv)

    from gene2vec_tpu_torch.obs.run import Run
    from gene2vec_tpu_torch.resilience.faults import FaultInjector, FaultSpec
    from gene2vec_tpu_torch.serve.registry import ModelRegistry
    from gene2vec_tpu_torch.serve.server import ServeApp, ServeConfig, make_server
    from gene2vec_tpu_torch.serve.tenancy import TenantPolicy

    # a typo'd quota or shard flag fails in milliseconds, before the load
    try:
        TenantPolicy.from_args(args.tenant_quota, args.tenant_burst or None,
                               args.tenant_override)
    except ValueError as e:
        print(f"error: bad tenant quota flags: {e}", file=sys.stderr)
        return 2
    shard = None
    if (args.shard_index is None) != (args.num_shards is None):
        print("error: --shard-index and --num-shards go together", file=sys.stderr)
        return 2
    if args.catalog and (args.shard_rows or args.shard_index is not None):
        # a catalog partitions replicas by model, row sharding by row
        # range; one replica cannot sit in both grids
        print("error: --catalog cannot combine with --shard-rows/--shard-index "
              "(model pools and row shards are different fleet partitions)",
              file=sys.stderr)
        return 2
    if args.shard_index is not None:
        if not 0 <= args.shard_index < args.num_shards:
            print(f"error: --shard-index {args.shard_index} outside "
                  f"[0, {args.num_shards})", file=sys.stderr)
            return 2
        shard = (args.shard_index, args.num_shards)
    if args.shard_rows and args.device == "cuda":
        import torch

        if torch.cuda.device_count() > 1:
            print("error: --shard-rows over more than one card needs ROADMAP A13 "
                  "(multi-GPU), which gene2vec_tpu_torch does not port yet",
                  file=sys.stderr)
            return 2
    if args.faults is not None:
        fault_injector = FaultInjector(FaultSpec.from_json(args.faults))
    else:
        fault_injector = FaultInjector.from_env()
    if fault_injector is not None:
        print(f"FAULT INJECTION ACTIVE: {fault_injector.spec.to_json()}", file=sys.stderr)
    spec = None
    if args.catalog:
        from gene2vec_tpu_torch.serve.catalog import ModelCatalog, load_catalog_spec

        try:
            spec = load_catalog_spec(args.catalog)
        except (ValueError, OSError) as e:
            print(f"error: bad catalog spec {args.catalog!r}: {e}", file=sys.stderr)
            return 2
    from gene2vec_tpu_torch.device import resolve_device

    # raises without a GPU unless --device cpu
    device = resolve_device(args.device)
    run_dir = args.run_dir or os.path.join(
        args.export_dir, "serve_runs", str(int(time.time())))
    # the manifest names the card only when the server runs on one
    run = Run(run_dir, name="serve", config=vars(args),
              probe_devices=device.type == "cuda")
    metrics = run.registry
    registry = None
    if spec is None:
        registry = ModelRegistry(
            args.export_dir, dim=args.dim, index_mode=args.index,
            ann_clusters=args.ann_clusters, device=args.device, shard=shard,
            name=args.model_name,
        )
        registry.metrics = metrics
        if not registry.refresh():
            print(
                f"error: no checkpoint found in {args.export_dir!r} "
                "(expected gene2vec_dim_<D>_iter_<N>.npz or *_w2v.txt)",
                file=sys.stderr,
            )
            run.close()
            return 2
    if device.type == "cuda":
        from gene2vec_tpu_torch.kernels import build

        # build (or find) the kernel libraries now, not inside the first
        # request's deadline
        build.build_all()
    if shard is None:
        if registry is not None:  # a catalog starts one watcher per model below
            registry.start_watcher(args.poll_interval)
    else:
        # a shard swapping on its own poll would be the mixed-iteration
        # merge the coordinator's epoch protocol exists to prevent
        print(f"shard {shard[0]}/{shard[1]}: self-swap watcher disabled "
              "(coordinator-driven stage/flip)", file=sys.stderr)
    config = ServeConfig(
        max_batch=args.max_batch,
        max_delay_ms=args.max_delay_ms,
        max_queue=args.max_queue,
        cache_size=args.cache_size,
        timeout_ms=args.timeout_ms,
        read_timeout_s=args.read_timeout,
        trace_sample=args.trace_sample,
        idle_timeout_s=args.idle_timeout,
        max_conn_requests=args.max_conn_requests,
        acceptors=args.acceptors,
        http_workers=args.http_workers,
        index=args.index,
        nprobe=args.nprobe,
        rescore_mult=args.rescore_mult,
        kernel_profile=args.kernel_profile,
        burst_threshold=args.burst_threshold,
        burst_window_s=args.burst_window,
        tenant_rate=args.tenant_quota,
        tenant_burst=args.tenant_burst,
        tenant_overrides=tuple(args.tenant_override),
        jobs_dir=args.jobs_dir,
        batch_weight=args.batch_weight,
        batch_duty=args.batch_duty,
        batch_guard_max=args.batch_guard_max,
    )
    catalog = None
    if spec is not None:
        try:
            catalog = ModelCatalog(spec, config=config, metrics=metrics, device=device,
                                   fault_injector=fault_injector).build()
        except RuntimeError as e:
            print(f"error: {e}", file=sys.stderr)
            run.close()
            return 2
        catalog.start(watch_interval_s=args.poll_interval)
        app = catalog.default_app
        registry = app.registry
        print(f"catalog {args.catalog}: serving {', '.join(catalog.names)} "
              f"(default {spec.default})", file=sys.stderr)
    else:
        app = ServeApp(registry, config=config, metrics=metrics,
                       ggipnn_checkpoint=args.ggipnn_checkpoint,
                       fault_injector=fault_injector,
                       model_name=args.model_name).start()
    # 5xx bursts dump the flight ring into the run dir; SIGQUIT on demand
    app.flight_dir = run.run_dir
    if args.kernel_profile:
        profiled = app.profile_kernels()
        print(f"kernel profile: {len(profiled)} engine buckets attributed ({args.index})",
              file=sys.stderr)
    server = make_server(app, args.host, args.port)
    host, port = server.server_address[:2]
    url = f"http://{host}:{port}"
    model = registry.model

    def _on_term(signum, frame):
        # shutdown() joins the loops, so it must not run on the loop's
        # own (main) thread
        threading.Thread(target=server.shutdown, daemon=True).start()

    def _on_sigquit(signum, frame):
        try:
            path = app.flight.dump(run.run_dir, "sigquit")
            print(f"flight recorder dumped to {path}", file=sys.stderr)
        except Exception as e:
            print(f"flight dump failed: {e!r}", file=sys.stderr)

    try:
        signal.signal(signal.SIGTERM, _on_term)
        signal.signal(signal.SIGQUIT, _on_sigquit)
    except (ValueError, OSError):
        pass  # not the main thread
    run.annotate(serve_url=url)
    run.event("serve_start", url=url, iteration=model.iteration)
    contract = {
        "url": url, "dim": model.dim, "iteration": model.iteration,
        "run_dir": run.run_dir, "index": args.index, "device": str(registry.device),
    }
    if shard is not None:
        contract["shard"] = {
            "index": shard[0], "num_shards": shard[1],
            "rows": [model.row_base, model.row_base + len(model)],
            "total_rows": model.total_rows, "epoch": model.epoch,
        }
    if args.model_name != "default":
        contract["model_name"] = args.model_name
    if catalog is not None:
        contract["catalog"] = {"default": spec.default, "models": list(catalog.names)}
    print(json.dumps(contract), flush=True)
    print(
        f"serving {args.export_dir} (dim {model.dim}, iteration {model.iteration}, "
        f"vocab {len(model)}, index {args.index}) on {url}, device {registry.device}; "
        f"run dir {run.run_dir}",
        file=sys.stderr,
    )
    try:
        server.serve_forever()
    except KeyboardInterrupt:
        print("shutting down", file=sys.stderr)
    finally:
        server.shutdown()
        server.server_close()
        if catalog is not None:
            catalog.stop()  # every model's app and watcher
        else:
            app.stop()
        run.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
