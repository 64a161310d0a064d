"""Fleet CLI: N supervised serve replicas behind one front-door proxy —
the port of ``gene2vec_tpu/cli/fleet.py``.

::

    python -m gene2vec_tpu_torch.cli.fleet --export-dir exports/ --replicas 3

Spawns ``--replicas`` ``gene2vec_tpu_torch.cli.serve`` children over the
same export dir (each on the card; the tests pass
``--serve-arg=--device --serve-arg=cpu``), health-checks and restarts
them (``serve/fleet.py``), and serves the round-robin ``/v1/*`` proxy on
``--port``.  Emits exactly ONE JSON line on stdout once the front door is
listening::

    {"url": ..., "replicas": 3, "replica_urls": [...],
     "replica_pids": [...], "run_dir": ...}

Human chatter goes to stderr; every fleet session stamps an obs ``Run``
manifest (default run dir ``<export_dir>/fleet_runs/<unix-ts>``) whose
registry backs the front door's ``/metrics``, and which holds
``alerts.jsonl``, the proxy's flight dumps and ``incidents/``.

A replica that cannot start (no GPU and no ``--device cpu``) exits at
once; the restart-storm cap then gives up on its slot and the fleet
exits non-zero: it never serves on the CPU unless asked to.

The reference's autoscaling (ROADMAP A19 item 3), row shards (item 4),
multi-model catalog (item 5), shadow canary and shard swap (A12) and
batch jobs (A20) are not ported: their flags parse and are refused with
exit 2.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time
from typing import List, Optional

#: flags whose feature the port lacks -> the ROADMAP item that brings it;
#: given a value other than its default, a flag is refused with exit 2
REFUSED = {
    **{name: "A19 item 3 (autoscaling)" for name in (
        "min_replicas", "max_replicas", "scale_up_queue", "scale_up_rejection",
        "scale_up_after", "scale_down_queue", "scale_down_after", "scale_cooldown")},
    **{name: "A12 (the shadow canary and the shard swap coordinator)"
       for name in ("enable_shadow", "swap_interval")},
    **{name: "A19 item 4 (row shards)" for name in (
        "shard_by_rows", "replicas_per_shard", "shard_deadline_ms")},
    "catalog": "A19 item 5 (the multi-model catalog)",
    "jobs_dir": "A20 (batch jobs)",
}


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="fleet",
        description="Supervised multi-replica serving fleet with a "
        "resilient front-door proxy.",
    )
    p.add_argument("--export-dir", required=True,
                   help="io/checkpoint.py export dir every replica serves")
    p.add_argument("--replicas", type=int, default=3,
                   help="initial replica count")
    p.add_argument("--min-replicas", type=int, default=0,
                   help="autoscaling floor (0 = --replicas); not ported: "
                        "refused (ROADMAP A19 item 3)")
    p.add_argument("--max-replicas", type=int, default=0,
                   help="autoscaling ceiling; > 0 turns the SLO-driven "
                        "scaler ON (serve/autoscale.py: scale-up on "
                        "queue/rejection/availability breach, slow "
                        "hysteresis scale-down with a zero-drop drain; "
                        "docs/SERVING.md#elastic-fleet); not ported: "
                        "refused (ROADMAP A19 item 3), as are the "
                        "--scale-* flags below")
    p.add_argument("--scale-up-queue", type=float, default=8.0,
                   help="scale-up breach threshold: fleet queue depth "
                        "PER replica")
    p.add_argument("--scale-up-rejection", type=float, default=0.02,
                   help="scale-up breach threshold: windowed rejection "
                        "rate (delta per tick, not lifetime)")
    p.add_argument("--scale-up-after", type=int, default=2,
                   help="consecutive breach ticks before scaling up")
    p.add_argument("--scale-down-queue", type=float, default=1.0,
                   help="scale-down clear threshold: fleet queue depth "
                        "per replica must sit at or below this for the "
                        "whole clear window (the hysteresis band is the "
                        "gap up to --scale-up-queue)")
    p.add_argument("--scale-down-after", type=int, default=30,
                   help="consecutive CLEAR ticks before scaling down "
                        "(asymmetric on purpose: ramps are emergencies, "
                        "idle capacity is not)")
    p.add_argument("--scale-cooldown", type=float, default=10.0,
                   help="seconds after an action completes before the "
                        "next may fire (anti-flap)")
    p.add_argument("--drain-timeout", type=float, default=30.0,
                   help="max seconds the shutdown waits for the front "
                        "door's in-flight forwards to settle before the "
                        "replicas are terminated anyway")
    p.add_argument("--host", default="127.0.0.1")
    p.add_argument("--port", type=int, default=8100,
                   help="front-door port; 0 picks an ephemeral one "
                        "(printed in the JSON status line)")
    p.add_argument("--health-interval", type=float, default=0.5,
                   help="seconds between replica readiness probes")
    p.add_argument("--unhealthy-after", type=int, default=3,
                   help="consecutive probe failures before ejection")
    p.add_argument("--readmit-after", type=int, default=2,
                   help="consecutive probe passes before re-admission")
    p.add_argument("--backoff-base", type=float, default=0.5,
                   help="restart backoff base (doubles per attempt, "
                        "jittered)")
    p.add_argument("--storm-max-restarts", type=int, default=5,
                   help="restarts within --storm-window before a slot "
                        "is abandoned")
    p.add_argument("--storm-window", type=float, default=60.0)
    p.add_argument("--proxy-attempts", type=int, default=3,
                   help="front-door max attempts per request "
                        "(failover across replicas)")
    p.add_argument("--proxy-timeout-ms", type=float, default=5000.0,
                   help="front-door default per-request deadline")
    p.add_argument("--proxy-workers", type=int, default=16,
                   help="front-door forwarding worker pool size "
                        "(each forward blocks on a replica round "
                        "trip); saturation answers 429")
    p.add_argument("--proxy-acceptors", type=int, default=1,
                   help="front-door acceptor event loops (> 1 uses "
                        "SO_REUSEPORT)")
    p.add_argument("--hedge", action="store_true",
                   help="enable p95 hedging on the front-door client")
    p.add_argument("--trace-sample", type=float, default=0.0,
                   help="proxy-originated root-trace sampling rate for "
                        "requests without a traceparent header (0..1; "
                        "sampled client contexts always propagate)")
    p.add_argument("--scrape-interval", type=float, default=2.0,
                   help="seconds between replica /metrics scrapes for "
                        "the merged /metrics/fleet view (0 disables "
                        "aggregation)")
    p.add_argument("--alert-rules", default="default", metavar="PATH",
                   help="SLO alert rules evaluated on every scrape tick "
                        "(obs/alerts.py): an alerts.json path, "
                        "'default' for the built-in availability/"
                        "p99/rejection/queue rules, 'none' to disable; "
                        "firings append to <run-dir>/alerts.jsonl and "
                        "assemble incident bundles under "
                        "<run-dir>/incidents/ "
                        "(docs/OBSERVABILITY.md#alerting)")
    p.add_argument("--seed", type=int, default=None,
                   help="restart-jitter seed (reproducible drills)")
    p.add_argument("--run-dir", default=None,
                   help="obs run dir (default: "
                        "<export-dir>/fleet_runs/<unix-ts>)")
    p.add_argument("--serve-arg", action="append", default=[],
                   help="extra flag passed to EVERY replica's cli.serve "
                        "(repeatable)")
    p.add_argument("--replica-arg", action="append", default=[],
                   metavar="IDX:FLAG",
                   help="extra flag for ONE replica, as <index>:<flag> "
                        "(repeatable; the drill injects faults into a "
                        "single replica this way)")
    p.add_argument("--enable-shadow", action="store_true",
                   help="enable the continuous-learning shadow canary "
                        "(loop/shadow.py): the front door exposes "
                        "/v1/shadow/start|stop|report and, while a "
                        "canary is active, duplicates a sampled "
                        "fraction of live /v1/similar traffic to the "
                        "candidate replica off the caller's latency "
                        "path; not ported: refused (ROADMAP A12)")
    p.add_argument("--shard-by-rows", type=int, default=0, metavar="N",
                   help="fleet-sharded index serving: run N row shards "
                        "each owning a CONTIGUOUS row range of the "
                        "table (+ its inverted lists), with the front "
                        "door scatter-gathering /v1/similar across all "
                        "shards and merging shard-local top-k "
                        "(serve/shardgroup.py; docs/SERVING.md"
                        "#sharded-index-serving).  Overrides "
                        "--replicas (total = N x --replicas-per-shard)."
                        "  With --max-replicas the bounds apply PER "
                        "SHARD POOL (shard-aware autoscaling).  Hot "
                        "swap becomes shard-ATOMIC: every (shard, "
                        "replica) cell stages the new iteration, then "
                        "all flip under one epoch token; not ported: "
                        "refused (ROADMAP A19 item 4)")
    p.add_argument("--replicas-per-shard", type=int, default=1,
                   metavar="R",
                   help="replica GROUP size per row shard (sharded "
                        "mode only): the front door scatters each "
                        "shard leg to any live sibling and fails over "
                        "within the leg's deadline, so a single "
                        "replica death costs zero degraded answers "
                        "(sharded mode only; refused with it)")
    p.add_argument("--ggipnn-checkpoint", default=None,
                   help="GGIPNN checkpoint npz (checkpoints/model-<step>.npz) "
                        "backing every replica's /v1/interaction (passed "
                        "to each replica's cli.serve; without it the MLP "
                        "head is untrained and responses say so)")
    p.add_argument("--shard-deadline-ms", type=float, default=2000.0,
                   help="per-shard scatter-leg deadline; a dead or "
                        "slow shard costs at most this before the "
                        "merge proceeds without it (the answer is "
                        "flagged degraded, never a 5xx; sharded mode "
                        "only, refused with it)")
    p.add_argument("--swap-interval", type=float, default=2.0,
                   help="seconds between the shard swap coordinator's "
                        "export-dir polls (sharded mode only); not "
                        "ported: refused (ROADMAP A12)")
    p.add_argument("--catalog", default=None, metavar="SPEC.json",
                   help="serve a multi-model catalog (serve/catalog.py "
                        "spec): replicas partition into one pool PER "
                        "MODEL (each pool sized by the entry's "
                        "'replicas'), the front door routes "
                        "/v1/<model>/* to the owning pool and "
                        "unprefixed /v1/* to the spec's default, "
                        "per-model token buckets 429 a hot model "
                        "before it starves a cold one, and with "
                        "--max-replicas the autoscaler runs one "
                        "policy per (model) pool — hottest signal "
                        "wins, one action per tick.  Overrides "
                        "--replicas; excludes --shard-by-rows "
                        "(docs/SERVING.md#multi-model-catalog); not "
                        "ported: refused (ROADMAP A19 item 5)")
    p.add_argument("--jobs-dir", default=None, metavar="DIR",
                   help="batch-job store root: mounts the /v1/jobs "
                        "lifecycle surface on the front door "
                        "(docs/BATCH.md); jobs query the fleet at "
                        "background priority — scatter-gather when "
                        "sharded, the resilient client otherwise — "
                        "and resume from their committed cursor "
                        "across fleet restarts; not ported: refused "
                        "(ROADMAP A20)")
    return p


def parse_replica_args(pairs: List[str]) -> dict:
    out: dict = {}
    for pair in pairs:
        idx, sep, flag = pair.partition(":")
        if not sep:
            raise ValueError(
                f"--replica-arg must be <index>:<flag>, got {pair!r}"
            )
        out.setdefault(int(idx), []).append(flag)
    return out


def parse_replica_args(pairs: List[str]) -> dict:
    out: dict = {}
    for pair in pairs:
        idx, sep, flag = pair.partition(":")
        if not sep:
            raise ValueError(
                f"--replica-arg must be <index>:<flag>, got {pair!r}"
            )
        out.setdefault(int(idx), []).append(flag)
    return out


def refused_flags(parser: argparse.ArgumentParser, args) -> List[str]:
    """One message for each flag given whose feature is not ported."""
    return [
        f"error: --{name.replace('_', '-')} needs ROADMAP {item}, which "
        "gene2vec_tpu_torch does not port yet"
        for name, item in REFUSED.items()
        if getattr(args, name) != parser.get_default(name)
    ]


def main(argv: Optional[List[str]] = None) -> int:
    parser = build_parser()
    args = parser.parse_args(argv)
    refused = refused_flags(parser, args)
    if refused:
        print("\n".join(refused), file=sys.stderr)
        return 2

    import random
    import signal

    from gene2vec_tpu_torch.obs.run import Run
    from gene2vec_tpu_torch.serve.client import RetryPolicy
    from gene2vec_tpu_torch.serve.fleet import (
        FleetConfig,
        FleetProxy,
        FleetSupervisor,
    )

    if args.replicas < 1:
        print("error: --replicas must be >= 1", file=sys.stderr)
        return 2
    serve_args = list(args.serve_arg)
    if args.ggipnn_checkpoint:
        if not os.path.isfile(args.ggipnn_checkpoint):
            print(
                f"error: --ggipnn-checkpoint {args.ggipnn_checkpoint!r} "
                "does not exist",
                file=sys.stderr,
            )
            return 2
        serve_args += ["--ggipnn-checkpoint", args.ggipnn_checkpoint]
    # validate the alert rules BEFORE paying N replica spawns — a typo'd
    # alerts.json must fail in milliseconds
    alert_rules = None
    if args.alert_rules and args.alert_rules != "none":
        from gene2vec_tpu_torch.obs import alerts as alerts_mod

        try:
            alert_rules = (
                alerts_mod.default_rules()
                if args.alert_rules == "default"
                else alerts_mod.load_rules(args.alert_rules)
            )
        except (OSError, ValueError) as e:
            print(f"error: bad --alert-rules: {e}", file=sys.stderr)
            return 2
        if args.scrape_interval <= 0:
            print(
                "warning: --alert-rules given but --scrape-interval 0 "
                "disables the aggregator tick; alerting is off",
                file=sys.stderr,
            )

    run_dir = args.run_dir or os.path.join(
        args.export_dir, "fleet_runs", str(int(time.time()))
    )
    # the front door touches no device: no device facts in its manifest
    run = Run(run_dir, name="fleet", config=vars(args), probe_devices=False)

    # installed BEFORE any replica exists: a SIGTERM during the (long)
    # start window must still tear the replicas down — dying silently
    # would orphan N serving processes
    def _on_term(signum, frame):
        raise KeyboardInterrupt

    signal.signal(signal.SIGTERM, _on_term)
    supervisor = FleetSupervisor(
        args.export_dir,
        config=FleetConfig(
            replicas=args.replicas,
            health_interval_s=args.health_interval,
            unhealthy_after=args.unhealthy_after,
            readmit_after=args.readmit_after,
            backoff_base_s=args.backoff_base,
            storm_max_restarts=args.storm_max_restarts,
            storm_window_s=args.storm_window,
        ),
        serve_args=serve_args,
        replica_args=parse_replica_args(args.replica_arg),
        metrics=run.registry,
        rng=random.Random(args.seed),
    )
    try:
        supervisor.start()
    except BaseException as e:
        # start() already tears down its own replicas on failure; the
        # extra stop() here is an idempotent belt for interrupt timing
        supervisor.stop()
        print(f"error: fleet failed to start: {e!r}", file=sys.stderr)
        run.close()
        return 2
    proxy = FleetProxy(
        supervisor,
        metrics=run.registry,
        policy=RetryPolicy(
            max_attempts=args.proxy_attempts,
            default_timeout_s=args.proxy_timeout_ms / 1000.0,
            hedge=args.hedge,
        ),
        trace_sample=args.trace_sample,
        scrape_interval_s=args.scrape_interval,
        telemetry_csv=os.path.join(run.run_dir, "fleet_telemetry.csv"),
        flight_dir=run.run_dir,
        proxy_workers=args.proxy_workers,
        acceptors=args.proxy_acceptors,
        alert_rules=alert_rules,
    )
    url = proxy.serve(args.host, args.port)
    run.annotate(fleet_url=url)
    run.event(
        "fleet_start", url=url, replicas=args.replicas,
        replica_urls=[r.url for r in supervisor.replicas],
    )
    print(
        json.dumps({
            "url": url,
            "replicas": args.replicas,
            "replica_urls": [r.url for r in supervisor.replicas],
            "replica_pids": [r.pid for r in supervisor.replicas],
            "run_dir": run.run_dir,
        }),
        flush=True,
    )
    print(
        f"fleet of {args.replicas} replicas over {args.export_dir} "
        f"fronted at {url}; run dir {run.run_dir}",
        file=sys.stderr,
    )
    try:
        while True:
            time.sleep(3600.0)
    except KeyboardInterrupt:
        print("shutting down fleet", file=sys.stderr)
    finally:
        # graceful, zero-drop shutdown ordering: stop accepting (front
        # door down), DRAIN the forwards the proxy already dispatched,
        # and only then SIGTERM the replicas
        proxy.stop()
        proxy.drain(timeout_s=args.drain_timeout)
        supervisor.stop()
        run.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
