"""Fleet CLI: N supervised serve replicas behind one front-door proxy —
the port of ``gene2vec_tpu/cli/fleet.py``.

::

    python -m gene2vec_tpu_torch.cli.fleet --export-dir exports/ --replicas 3
    python -m gene2vec_tpu_torch.cli.fleet --export-dir exports/ --replicas 1 \\
        --min-replicas 1 --max-replicas 2
    python -m gene2vec_tpu_torch.cli.fleet --export-dir exports/ \\
        --shard-by-rows 2 --replicas-per-shard 2 [--ggipnn-checkpoint CKPT] \\
        [--jobs-dir DIR]
    python -m gene2vec_tpu_torch.cli.fleet --export-dir exports/ \\
        --catalog catalog.json [--max-replicas 2]

Spawns ``gene2vec_tpu_torch.cli.serve`` children over the same export dir
(each on the card; the tests pass ``--serve-arg=--device
--serve-arg=cpu``), health-checks and restarts them (``serve/fleet.py``),
and serves the front door on ``--port``.  Emits exactly ONE JSON line on
stdout once the front door is listening::

    {"url": ..., "replicas": 3, "replica_urls": [...],
     "replica_pids": [...], "run_dir": ..., "jobs_dir": ..., "autoscale": ...,
     "catalog": ..., "shards": ...}

Human chatter goes to stderr; every fleet session stamps an obs ``Run``
manifest (default run dir ``<export_dir>/fleet_runs/<unix-ts>``) whose
registry backs the front door's ``/metrics``, and which holds
``alerts.jsonl``, the proxy's flight dumps and ``incidents/``.

``--max-replicas`` turns the SLO-driven autoscaler on
(``serve/autoscale.py``: scale-up on a queue, rejection or availability
breach, slow scale-down through a zero-drop drain).  ``--shard-by-rows N``
runs N row shards of ``--replicas-per-shard`` replicas behind a
scatter-gather front door with the shard-atomic swap coordinator
(``serve/shardgroup.py``); the scaler then sizes each shard's pool, and
``--ggipnn-checkpoint`` backs the front door's cross-shard
``/v1/interaction`` scorer, which runs on ``--device`` (``cuda`` unless
``cpu``).  An unsharded fleet only checks that the checkpoint exists:
its replicas take a head through ``--serve-arg``.

``--catalog SPEC.json`` (``serve/catalog.py``) runs one replica pool per
named model, each replica a single-model server under its model's
``--export-dir``, ``--model-name``, ``--index`` and ``--dim``; the front
door routes ``/v1/<model>/*`` to the named pool and unprefixed ``/v1/*``
to the default model's, takes a token from the model's bucket first
(``ModelAdmission``), and with ``--max-replicas`` scales each pool on its
own (``PoolElasticController``).  ``--jobs-dir`` mounts ``/v1/jobs`` at
the front door (``batch/jobs.py``): jobs scatter through the shard group
on a sharded fleet and go through the resilient client otherwise, on the
``batch`` tenant lane, pausing between chunks while the replicas' queues
are deep.

A replica that cannot start (no GPU and no ``--device cpu`` serve arg)
exits at once; the restart-storm cap then gives up on its slot and the
fleet exits non-zero: it never serves on the CPU unless asked to.

The reference's shadow canary (ROADMAP A12) is not ported: its flag
parses and is refused with exit 2.

SIGTERM and SIGINT shut the fleet down in order (scaler, swap
coordinator, front door, drain, replicas) whichever of the process's
threads the kernel hands the signal to: the main thread waits in short
slices, so Python runs the handler within a quarter second.
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
    "enable_shadow": "A12 (the shadow canary)",
}

#: the main thread's wait slice: a signal taken by a helper thread runs
#: its Python handler only when the main thread next returns to the
#: interpreter, so the main thread never blocks longer than this
_WAIT_SLICE_S = 0.25


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
                   help="autoscaling floor (0 = --replicas, or "
                        "--replicas-per-shard per shard pool)")
    p.add_argument("--max-replicas", type=int, default=0,
                   help="autoscaling ceiling; > 0 turns the SLO-driven "
                        "scaler ON (serve/autoscale.py: scale-up on "
                        "queue/rejection/availability breach, slow "
                        "hysteresis scale-down with a zero-drop drain); "
                        "with --shard-by-rows the bounds apply to each "
                        "shard's pool")
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
                   help="max seconds a scale-down (and the shutdown) "
                        "waits for the front door's in-flight forwards "
                        "to a replica to settle before terminating it "
                        "anyway")
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
                   help="the continuous-learning shadow canary; not "
                        "ported: refused (ROADMAP A12)")
    p.add_argument("--shard-by-rows", type=int, default=0, metavar="N",
                   help="fleet-sharded index serving: run N row shards "
                        "each owning a CONTIGUOUS row range of the "
                        "table (+ its inverted lists), with the front "
                        "door scatter-gathering /v1/similar across all "
                        "shards and merging shard-local top-k.  "
                        "Overrides --replicas (total = N x "
                        "--replicas-per-shard).  With --max-replicas the "
                        "bounds apply PER SHARD POOL.  Hot swap becomes "
                        "shard-ATOMIC: every (shard, replica) cell stages "
                        "the new iteration, then all flip under one "
                        "epoch token")
    p.add_argument("--replicas-per-shard", type=int, default=1,
                   metavar="R",
                   help="replica GROUP size per row shard (sharded "
                        "mode only): the front door scatters each "
                        "shard leg to any live sibling and fails over "
                        "within the leg's deadline, so a single "
                        "replica death costs zero degraded answers")
    p.add_argument("--ggipnn-checkpoint", default=None,
                   help="GGIPNN checkpoint npz (checkpoints/model-<step>.npz) "
                        "backing the sharded front door's cross-shard "
                        "/v1/interaction (without it the MLP head is "
                        "untrained and responses say so); an unsharded "
                        "fleet only checks that it exists: its replicas "
                        "take a head through --serve-arg")
    p.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                   help="where the sharded front door's interaction "
                        "scorer runs (built at the first "
                        "/v1/interaction); replicas take theirs through "
                        "--serve-arg")
    p.add_argument("--shard-deadline-ms", type=float, default=2000.0,
                   help="per-shard scatter-leg deadline; a dead or "
                        "slow shard costs at most this before the "
                        "merge proceeds without it (the answer is "
                        "flagged degraded, never a 5xx)")
    p.add_argument("--swap-interval", type=float, default=2.0,
                   help="seconds between the shard swap coordinator's "
                        "export-dir polls (sharded mode only)")
    p.add_argument("--catalog", default=None, metavar="SPEC.json",
                   help="serve a multi-model catalog (serve/catalog.py): one "
                        "replica pool per named model (its 'replicas'), "
                        "/v1/<model>/* routed to the named pool, unprefixed "
                        "/v1/* to the default model's, per-model token "
                        "buckets at the door; overrides --replicas; with "
                        "--max-replicas the bounds apply to each model's "
                        "pool.  Never combines with --shard-by-rows")
    p.add_argument("--jobs-dir", default=None, metavar="DIR",
                   help="batch-job store root: mounts /v1/jobs at the front "
                        "door (batch/jobs.py); jobs scatter through the shard "
                        "group when sharded, else go through the replicas on "
                        "the 'batch' tenant lane, and resume from their "
                        "committed cursor after a restart")
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


def refused_flags(parser: argparse.ArgumentParser, args) -> List[str]:
    """One message for each flag given whose feature is not ported."""
    return [
        f"error: --{name.replace('_', '-')} needs ROADMAP {item}, which "
        "gene2vec_tpu_torch does not port yet"
        for name, item in REFUSED.items()
        if getattr(args, name) != parser.get_default(name)
    ]


def check_flags(parser: argparse.ArgumentParser, args) -> Optional[str]:
    """The first reason the flags cannot run, before any replica spawns
    (None when they can).  Fills ``args.replicas`` in sharded mode."""
    if args.shard_by_rows < 0:
        return "error: --shard-by-rows must be >= 0"
    if args.replicas_per_shard < 1:
        return "error: --replicas-per-shard must be >= 1"
    if args.replicas_per_shard > 1 and not args.shard_by_rows:
        return ("error: --replicas-per-shard needs --shard-by-rows (an "
                "unsharded fleet's replicas are already one "
                "interchangeable pool; use --replicas)")
    if args.ggipnn_checkpoint and not os.path.isfile(args.ggipnn_checkpoint):
        return f"error: --ggipnn-checkpoint {args.ggipnn_checkpoint!r} does not exist"
    if args.catalog and args.shard_by_rows:
        # a catalog partitions replicas by model, row sharding by row
        # range of one model's table
        return ("error: --catalog cannot combine with --shard-by-rows "
                "(model pools and row shards are different fleet "
                "partitions)")
    refused = refused_flags(parser, args)
    if refused:
        return "\n".join(refused)
    if args.shard_by_rows:
        args.replicas = args.shard_by_rows * args.replicas_per_shard
    if args.replicas < 1:
        return "error: --replicas must be >= 1"
    return None


def main(argv: Optional[List[str]] = None) -> int:
    parser = build_parser()
    args = parser.parse_args(argv)
    problem = check_flags(parser, args)
    if problem:
        print(problem, file=sys.stderr)
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

    # parse and check the catalog spec before paying N spawns; slots
    # partition into contiguous per-model pools in spec order, and each
    # pool's flags override the supervisor's defaults (argparse last-wins)
    catalog_spec = model_admission = model_of = model_args = None
    if args.catalog:
        from gene2vec_tpu_torch.serve.catalog import ModelAdmission, load_catalog_spec

        try:
            catalog_spec = load_catalog_spec(args.catalog)
        except (ValueError, OSError) as e:
            print(f"error: bad catalog spec {args.catalog!r}: {e}", file=sys.stderr)
            return 2
        model_of, model_args = {}, {}
        slot = 0
        for entry in catalog_spec.entries:
            for _ in range(entry.replicas):
                model_of[slot] = entry.name
                slot += 1
            flags = ["--export-dir", entry.export_dir, "--model-name", entry.name,
                     "--index", entry.index_mode]
            if entry.dim is not None:
                flags += ["--dim", str(entry.dim)]
            if entry.ggipnn_checkpoint:
                flags += ["--ggipnn-checkpoint", entry.ggipnn_checkpoint]
            model_args[entry.name] = flags + list(entry.extra_args)
        args.replicas = slot
        model_admission = ModelAdmission(catalog_spec)

    if args.shard_by_rows:
        from gene2vec_tpu_torch.device import resolve_device

        # the front door's scorer runs on the card unless asked otherwise:
        # without a GPU it fails here, before any replica spawns
        try:
            resolve_device(args.device)
        except RuntimeError as e:
            print(f"error: --device {args.device}: {e}", file=sys.stderr)
            return 2
    # the autoscale bounds, checked before paying N spawns; in sharded mode
    # they apply to each shard's pool (the shard count is fixed)
    autoscale_cfg = None
    if args.shard_by_rows:
        pool_base = args.replicas_per_shard
    elif catalog_spec is not None:
        # every model pool's default floor: the smallest boot-time pool
        pool_base = min(e.replicas for e in catalog_spec.entries)
    else:
        pool_base = args.replicas
    if args.max_replicas > 0:
        from gene2vec_tpu_torch.serve.autoscale import AutoscaleConfig

        if args.scrape_interval <= 0:
            print("error: --max-replicas needs --scrape-interval > 0 — the "
                  "scaler reads the fleet aggregator's snapshot each scrape "
                  "tick", file=sys.stderr)
            return 2
        try:
            autoscale_cfg = AutoscaleConfig(
                min_replicas=args.min_replicas or pool_base,
                max_replicas=args.max_replicas,
                up_queue_per_replica=args.scale_up_queue,
                up_rejection_rate=args.scale_up_rejection,
                up_after_ticks=args.scale_up_after,
                down_queue_per_replica=args.scale_down_queue,
                down_after_ticks=args.scale_down_after,
                cooldown_s=args.scale_cooldown,
            )
        except ValueError as e:
            print(f"error: bad autoscale flags: {e}", file=sys.stderr)
            return 2
        if catalog_spec is not None:
            # the bounds apply to each model's pool: every entry's boot
            # size must lie inside them, or the first tick fights the spec
            for entry in catalog_spec.entries:
                if not (autoscale_cfg.min_replicas <= entry.replicas
                        <= autoscale_cfg.max_replicas):
                    print(f"error: catalog model {entry.name!r} replicas "
                          f"{entry.replicas} outside [{autoscale_cfg.min_replicas}, "
                          f"{autoscale_cfg.max_replicas}]", file=sys.stderr)
                    return 2
        elif not autoscale_cfg.min_replicas <= pool_base <= autoscale_cfg.max_replicas:
            what = "--replicas-per-shard" if args.shard_by_rows else "--replicas"
            print(f"error: {what} {pool_base} outside [{autoscale_cfg.min_replicas}, "
                  f"{autoscale_cfg.max_replicas}]", file=sys.stderr)
            return 2
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
    # the front door touches no device until a sharded fleet scores a pair
    run = Run(run_dir, name="fleet", config=vars(args), probe_devices=False)

    # installed BEFORE any replica exists: a SIGTERM during the (long)
    # start window must still tear the replicas down — dying silently
    # would orphan N serving processes.  Python runs the handler on the
    # main thread once that thread is back in the interpreter, whichever
    # thread took the signal: every wait below is a short slice
    def _on_term(signum, frame):
        raise KeyboardInterrupt

    signal.signal(signal.SIGTERM, _on_term)
    signal.signal(signal.SIGINT, _on_term)
    shard_of = shard_args = None
    if args.shard_by_rows:
        # the (shard, replica) grid: slot i serves shard i // R, and the
        # shard flags are keyed by shard, so restarts and added siblings
        # load exactly their shard's rows
        shard_of = {i: i // args.replicas_per_shard for i in range(args.replicas)}
        shard_args = {
            s: ["--shard-index", str(s), "--num-shards", str(args.shard_by_rows)]
            for s in range(args.shard_by_rows)
        }
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
        serve_args=args.serve_arg,
        replica_args=parse_replica_args(args.replica_arg),
        metrics=run.registry,
        rng=random.Random(args.seed),
        shard_of=shard_of,
        shard_args=shard_args,
        model_of=model_of,
        model_args=model_args,
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
        catalog=catalog_spec,
        model_admission=model_admission,
    )
    if catalog_spec is not None and proxy.aggregator is not None:
        # per-model telemetry: queue depth, staleness and replicas up
        # keyed by the supervisor's slot -> model map
        proxy.aggregator.model_of = supervisor.model_of_url
        proxy.aggregator.model_pool_facts = supervisor.model_up_counts
    coordinator = None
    if args.shard_by_rows:
        from gene2vec_tpu_torch.serve.shardgroup import (
            RoutingTable,
            ShardGroup,
            ShardGroupConfig,
            SwapCoordinator,
        )

        routing = RoutingTable(args.export_dir, args.shard_by_rows, dim=None)
        if not routing.reload():
            print("error: no verified checkpoint to derive the gene->shard "
                  "routing table from", file=sys.stderr)
            supervisor.stop()
            run.close()
            return 2
        proxy.shard_group = ShardGroup(
            ShardGroupConfig(
                num_shards=args.shard_by_rows,
                shard_deadline_s=args.shard_deadline_ms / 1000.0,
                default_timeout_s=args.proxy_timeout_ms / 1000.0,
            ),
            # the whole replica GROUP of a shard: its client round-robins
            # the siblings and fails over within the leg deadline
            supervisor.shard_urls,
            metrics=run.registry,
            policy=RetryPolicy(
                max_attempts=args.proxy_attempts,
                default_timeout_s=args.shard_deadline_ms / 1000.0,
                hedge=args.hedge,
            ),
            inflight=proxy.inflight,
            routing=routing,
            ggipnn_checkpoint=args.ggipnn_checkpoint,
            scorer_device=args.device,
        )
        if proxy.aggregator is not None:
            # per-shard telemetry and the redundancy view; desired follows
            # the current promise, so a deliberate scale-down pages nothing
            proxy.aggregator.shard_of = supervisor.shard_of_url
            proxy.aggregator.shard_facts = supervisor.shard_redundancy_facts
        coordinator = SwapCoordinator(
            args.export_dir, proxy.shard_group, interval_s=args.swap_interval,
            metrics=run.registry,
        ).start()
    controller = None
    if autoscale_cfg is not None:
        from gene2vec_tpu_torch.serve.autoscale import (
            ElasticController,
            PoolElasticController,
            ShardElasticController,
        )

        if args.shard_by_rows:
            controller = ShardElasticController(
                supervisor, proxy, autoscale_cfg, num_shards=args.shard_by_rows,
                metrics=run.registry, drain_timeout_s=args.drain_timeout,
            )
        elif catalog_spec is not None:
            # one policy per model pool; the hottest pool's signal wins the
            # tick, and a scale-down never drains a model's last UP replica
            controller = PoolElasticController(
                supervisor, proxy, autoscale_cfg,
                pools=[(name, None) for name in catalog_spec.names],
                metrics=run.registry, drain_timeout_s=args.drain_timeout,
            )
        else:
            controller = ElasticController(
                supervisor, proxy, autoscale_cfg, metrics=run.registry,
                drain_timeout_s=args.drain_timeout,
            )
        # the scaler rides the aggregator's scrape tick, after the alert
        # evaluator: the same snapshot, nothing on the serve path
        proxy.aggregator.observers.append(controller.observe)
    if args.jobs_dir:
        from gene2vec_tpu_torch.batch.jobs import JobManager
        from gene2vec_tpu_torch.batch.runner import ClientBackend, ShardGroupBackend

        # the sharded backend's Pacer guard: the replicas' summed queue
        # depth from each scrape tick, normalized so ~2 queued requests a
        # replica reads as 1.0; batch pauses between chunks above it
        batch_pressure = {"value": 0.0}
        if proxy.aggregator is not None:
            def _note_batch_pressure(snapshot, wall=None) -> None:
                depth = float(snapshot.get("fleet_queue_depth", 0.0) or 0.0)
                batch_pressure["value"] = depth / (2.0 * max(1, len(supervisor.replicas)))

            proxy.aggregator.observers.append(_note_batch_pressure)

        def _job_backend():
            # built per job run, so each pins the iteration the fleet
            # serves at that moment (batch/runner.py's determinism contract)
            if proxy.shard_group is not None:
                return ShardGroupBackend(
                    proxy.shard_group, pressure_fn=lambda: batch_pressure["value"],
                )
            return ClientBackend(proxy.client)

        proxy.jobs = JobManager(args.jobs_dir, _job_backend, metrics=run.registry)
    url = proxy.serve(args.host, args.port)
    run.annotate(fleet_url=url)
    run.event(
        "fleet_start", url=url, replicas=args.replicas,
        replica_urls=[r.url for r in supervisor.replicas],
    )
    group = proxy.shard_group
    print(
        json.dumps({
            "url": url,
            "replicas": args.replicas,
            "replica_urls": [r.url for r in supervisor.replicas],
            "replica_pids": [r.pid for r in supervisor.replicas],
            "run_dir": run.run_dir,
            "jobs_dir": args.jobs_dir,
            "autoscale": (
                {"min": autoscale_cfg.min_replicas, "max": autoscale_cfg.max_replicas}
                if autoscale_cfg is not None else None
            ),
            "catalog": (
                {
                    "default": catalog_spec.default,
                    # slot indices per model: a drill targets one pool by these
                    "models": {
                        e.name: {
                            "replicas": e.replicas,
                            "slots": [r.index for r in supervisor.replicas
                                      if r.model == e.name],
                        }
                        for e in catalog_spec.entries
                    },
                }
                if catalog_spec is not None else None
            ),
            "shards": (
                {
                    "num_shards": args.shard_by_rows,
                    "replicas_per_shard": args.replicas_per_shard,
                    "total_rows": group.routing.total_rows,
                    "ranges": [list(r) for r in group.routing.ranges],
                    # slot indices per shard: a drill kills one sibling by these
                    "groups": {
                        str(s): [r.index for r in supervisor.replicas if r.shard == s]
                        for s in range(args.shard_by_rows)
                    },
                }
                if group is not None else None
            ),
        }),
        flush=True,
    )
    print(
        f"fleet of {args.replicas} replicas over {args.export_dir} "
        f"fronted at {url}; run dir {run.run_dir}"
        + (f"; autoscaling [{autoscale_cfg.min_replicas}, {autoscale_cfg.max_replicas}]"
           if autoscale_cfg is not None else ""),
        file=sys.stderr,
    )
    try:
        while True:
            time.sleep(_WAIT_SLICE_S)
    except KeyboardInterrupt:
        print("shutting down fleet", file=sys.stderr)
    finally:
        # graceful, zero-drop shutdown ordering: stop scaling and swapping,
        # stop accepting (front door down), DRAIN the forwards the proxy
        # already dispatched, and only then SIGTERM the replicas
        if controller is not None:
            controller.stop()
        if coordinator is not None:
            coordinator.stop()
        proxy.stop()
        proxy.drain(timeout_s=args.drain_timeout)
        supervisor.stop()
        run.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
