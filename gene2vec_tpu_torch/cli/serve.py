"""Serve CLI: the similarity query server over an export dir, on the GPU.

    python -m gene2vec_tpu_torch.cli.serve --export-dir out/ --port 8000 \\
        [--index exact|quant|ivf] [--ggipnn-checkpoint model-<step>.npz] \\
        [--kernel-profile] [--faults JSON] [--trace-sample P] \\
        [--run-dir DIR] [--device cuda|cpu]

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
    return p


def main(argv: Optional[List[str]] = None) -> int:
    args = build_parser().parse_args(argv)

    from gene2vec_tpu_torch.obs.run import Run
    from gene2vec_tpu_torch.resilience.faults import FaultInjector, FaultSpec
    from gene2vec_tpu_torch.serve.registry import ModelRegistry
    from gene2vec_tpu_torch.serve.server import ServeApp, ServeConfig, make_server

    if args.faults is not None:
        fault_injector = FaultInjector(FaultSpec.from_json(args.faults))
    else:
        fault_injector = FaultInjector.from_env()
    if fault_injector is not None:
        print(f"FAULT INJECTION ACTIVE: {fault_injector.spec.to_json()}", file=sys.stderr)
    # raises without a GPU unless --device cpu
    registry = ModelRegistry(
        args.export_dir, dim=args.dim, index_mode=args.index,
        ann_clusters=args.ann_clusters, device=args.device,
    )
    run_dir = args.run_dir or os.path.join(
        args.export_dir, "serve_runs", str(int(time.time())))
    # the manifest names the card only when the server runs on one
    run = Run(run_dir, name="serve", config=vars(args),
              probe_devices=registry.device.type == "cuda")
    metrics = registry.metrics = run.registry
    if not registry.refresh():
        print(
            f"error: no checkpoint found in {args.export_dir!r} "
            "(expected gene2vec_dim_<D>_iter_<N>.npz or *_w2v.txt)",
            file=sys.stderr,
        )
        run.close()
        return 2
    if registry.device.type == "cuda":
        from gene2vec_tpu_torch.kernels import build

        # build (or find) the kernel libraries now, not inside the first
        # request's deadline
        build.build_all()
    registry.start_watcher(args.poll_interval)
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
    )
    app = ServeApp(registry, config=config, metrics=metrics,
                   ggipnn_checkpoint=args.ggipnn_checkpoint,
                   fault_injector=fault_injector).start()
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
    print(json.dumps({
        "url": url, "dim": model.dim, "iteration": model.iteration,
        "run_dir": run.run_dir, "index": args.index, "device": str(registry.device),
    }), flush=True)
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
        app.stop()
        run.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
