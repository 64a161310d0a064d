"""Replica fleet: supervision, health-based rotation, front-door proxy —
the port of ``gene2vec_tpu/serve/fleet.py``.

One ``cli.serve`` process is a single point of failure; a fleet is N
replicas over the same export dir behind a router that treats replica
death, wedging and overload as routine.  Stdlib only, like the rest of
``serve/``; the replicas are the port's servers, each on the card.

* :class:`FleetSupervisor` spawns N ``python -m gene2vec_tpu_torch.cli.serve``
  children over one export dir, parses each child's one-line stdout JSON
  contract for its bound URL, and runs a monitor loop that

  - **health-checks** every replica's ``/healthz`` (the readiness probe:
    a replica that answers but has no model is ejected, not restarted);
  - **ejects** a replica from rotation after ``unhealthy_after``
    consecutive probe failures and **re-admits** it after
    ``readmit_after`` consecutive passes;
  - **restarts** crashed or wedged replicas with jittered exponential
    backoff, and gives up on a slot that restarts more than
    ``storm_max_restarts`` times within ``storm_window_s`` (a
    restart-storm cap: a child that cannot start, say on a host with no
    GPU, must not grind the host with fork loops);
  - publishes fleet state as metrics: ``replica_up`` (gauge, in-rotation
    count), ``replica_restarts_total`` (counter) and per-replica
    ``replica_<i>_up`` gauges.

* :class:`FleetProxy` is the front door: an event-loop HTTP server that
  forwards ``/v1/*`` to the healthy set through a
  :class:`~gene2vec_tpu_torch.serve.client.ResilientClient` (round-robin,
  retry-safe failover, per-replica circuit breakers, deadline propagation
  through the body's ``timeout_ms``).  ``/healthz`` reports fleet
  readiness (503 until a replica is in rotation), ``/livez`` process
  liveness, ``/metrics`` the fleet registry, ``/metrics/fleet`` the
  merged replica view (``obs/aggregate.py``) and ``/debug/flight`` the
  proxy's flight ring.  Alert rules run on every scrape tick and a rule
  that fires assembles an incident bundle (``obs/alerts.py``,
  ``obs/incident.py``).

The supervisor also keeps the (shard, replica) grid of a row-sharded
fleet (``shard_urls``, ``shard_up_counts``, ``shard_redundancy_facts``;
the proxy then scatter-gathers through ``serve/shardgroup.py``) and the
elastic controller's slots (``active_count``, ``scale_up``,
``pick_drain_victim``, ``begin_drain`` / ``finish_drain``;
``serve/autoscale.py``).

``python -m gene2vec_tpu_torch.cli.fleet`` runs both and prints the same
one-line stdout contract as ``cli.serve`` plus replica facts.  Not in
this slice: the shadow canary.  A catalog fleet (``catalog``) runs one
pool per model behind ``/v1/<model>/*``; a front door with a job store
(``jobs``) answers ``/v1/jobs`` itself (``batch/jobs.py``).
"""

from __future__ import annotations

import dataclasses
import json
import os
import queue as queue_mod
import random
import subprocess
import sys
import threading
import time
import urllib.request
from collections import deque
from typing import Deque, Dict, List, Optional, Sequence
from urllib.parse import parse_qs, urlparse

from gene2vec_tpu_torch.obs import tracecontext
from gene2vec_tpu_torch.obs.aggregate import FleetAggregator
from gene2vec_tpu_torch.obs.alerts import ALERTS_LOG_NAME, AlertEvaluator, RateLimiter
from gene2vec_tpu_torch.obs.flight import FlightRecorder
from gene2vec_tpu_torch.obs.incident import IncidentManager
from gene2vec_tpu_torch.obs.trace import ambient_span
from gene2vec_tpu_torch.obs.tracecontext import Sampler, TraceContext
from gene2vec_tpu_torch.serve.client import (
    InFlightTracker,
    ResilientClient,
    RetryPolicy,
)
from gene2vec_tpu_torch.serve.eventloop import (
    ConnHandle,
    EventLoopConfig,
    EventLoopHTTPServer,
    HandlerPool,
    HTTPRequest,
    Response,
    parse_json_body,
)
# the proxy labels per-route latency over the same /v1 surface the
# replicas label; everything else is "other" (no label cardinality from
# garbage paths)
from gene2vec_tpu_torch.serve.routes import (
    JOBS_ROUTE,
    V1_ROUTES,
    collapse_jobs_route,
    model_label,
    split_model_route,
)

#: routes the proxy labels latency under; job sub-routes collapse to the
#: table entry first (collapse_jobs_route)
_PROXY_ROUTES = V1_ROUTES | frozenset((JOBS_ROUTE,))


class ReplicaState:
    STARTING = "starting"    # spawned, waiting for contract line / health
    UP = "up"                # in rotation
    EJECTED = "ejected"      # alive but failing readiness; out of rotation
    BACKOFF = "backoff"      # dead, waiting out restart backoff
    FAILED = "failed"        # restart storm cap hit; given up
    DRAINING = "draining"    # leaving the fleet: out of rotation, alive
    #                          until its in-flight requests settle
    #                          (serve/autoscale.py scale-down)


@dataclasses.dataclass(frozen=True)
class FleetConfig:
    """Supervision policy (cli/fleet.py flags)."""

    replicas: int = 3
    health_interval_s: float = 0.5
    health_timeout_s: float = 2.0
    unhealthy_after: int = 3     # consecutive probe failures -> eject
    readmit_after: int = 2       # consecutive passes -> back in rotation
    backoff_base_s: float = 0.5
    backoff_max_s: float = 30.0
    jitter_frac: float = 0.5     # uniform [1-j, 1+j] x the backoff
    storm_window_s: float = 60.0
    storm_max_restarts: int = 5
    contract_timeout_s: float = 120.0  # first stdout line deadline


class Replica:
    """One supervised ``cli.serve`` child and its rotation state.

    ``shard`` is the row shard this slot serves (None in an unsharded
    fleet).  With ``--replicas-per-shard`` several slots share one shard,
    and the front door's scatter treats them as interchangeable
    siblings.  ``model`` is the catalog model this slot serves (None in a
    single-model fleet): a catalog fleet partitions its slots into
    per-model pools as a sharded fleet does into per-shard pools, and the
    two never combine (cli.fleet refuses ``--catalog`` with
    ``--shard-by-rows``)."""

    def __init__(self, index: int, shard: Optional[int] = None,
                 model: Optional[str] = None):
        self.index = index
        self.shard = shard
        self.model = model
        self.proc: Optional[subprocess.Popen] = None
        self.url: Optional[str] = None
        self.state = ReplicaState.STARTING
        self.consecutive_failures = 0
        self.consecutive_passes = 0
        self.restarts = 0
        self.restart_times: Deque[float] = deque()
        self.next_restart_at = 0.0
        self.last_error: Optional[str] = None
        self.spawning = False  # a respawn thread is working on this slot

    @property
    def pid(self) -> Optional[int]:
        return self.proc.pid if self.proc is not None else None

    @property
    def alive(self) -> bool:
        return self.proc is not None and self.proc.poll() is None


def read_contract_line(proc: subprocess.Popen, timeout_s: float) -> dict:
    """Parse a serve-family CLI's one stdout JSON contract line under a
    deadline — a child that wedges before printing must fail the caller,
    not hang it (the chaos-drill lesson, now shared)."""
    q: "queue_mod.Queue[Optional[str]]" = queue_mod.Queue()
    assert proc.stdout is not None

    def pump() -> None:
        q.put(proc.stdout.readline())

    threading.Thread(target=pump, daemon=True).start()
    try:
        line = q.get(timeout=timeout_s)
    except queue_mod.Empty:
        raise TimeoutError(
            f"child pid {proc.pid} printed no contract line within "
            f"{timeout_s}s"
        ) from None
    if not line:
        raise RuntimeError(
            f"child exited (rc={proc.poll()}) before printing its "
            "contract line (its stderr is above)"
        )
    return json.loads(line)


class FleetSupervisor:
    """Spawns, health-checks, ejects/re-admits, and restarts N replicas.

    ``serve_args`` go to every child verbatim; ``replica_args`` maps a
    replica index to extra per-replica flags (a drill turns fault
    injection on for exactly one replica this way).  ``rng`` seeds the
    restart jitter for reproducible drills.  ``shard_of`` maps a slot to
    its row shard and ``shard_args`` a shard to the flags every slot of
    it spawns with (``--shard-index/--num-shards``): keyed by shard, so a
    restarted or elastically added sibling loads exactly its shard's rows.
    ``model_of`` and ``model_args`` are the same grid on the catalog's
    model axis (``--export-dir``, ``--model-name`` and the entry's flags,
    keyed by model name; argparse's last-wins lets them override the
    defaults).
    """

    def __init__(
        self,
        export_dir: str,
        config: FleetConfig = FleetConfig(),
        serve_args: Sequence[str] = (),
        replica_args: Optional[Dict[int, Sequence[str]]] = None,
        metrics=None,
        env: Optional[Dict[str, str]] = None,
        rng: Optional[random.Random] = None,
        shard_of: Optional[Dict[int, int]] = None,
        shard_args: Optional[Dict[int, Sequence[str]]] = None,
        model_of: Optional[Dict[int, str]] = None,
        model_args: Optional[Dict[str, Sequence[str]]] = None,
    ):
        self.export_dir = export_dir
        self.config = config
        self.serve_args = list(serve_args)
        self.replica_args = {
            int(k): list(v) for k, v in (replica_args or {}).items()
        }
        self.metrics = metrics
        self.env = env
        self._rng = rng if rng is not None else random.Random()
        self._shard_of: Dict[int, int] = {
            int(k): int(v) for k, v in (shard_of or {}).items()
        }
        self._shard_args: Dict[int, List[str]] = {
            int(k): list(v) for k, v in (shard_args or {}).items()
        }
        self._model_of: Dict[int, str] = {
            int(k): str(v) for k, v in (model_of or {}).items()
        }
        self._model_args: Dict[str, List[str]] = {
            str(k): list(v) for k, v in (model_args or {}).items()
        }
        self.replicas = [
            Replica(i, shard=self._shard_of.get(i), model=self._model_of.get(i))
            for i in range(config.replicas)
        ]
        #: next index for an elastically added replica: indices are never
        #: reused, so per-replica metrics and log lines stay unambiguous
        self._next_index = config.replicas
        self._lock = threading.Lock()
        self._stop = threading.Event()
        self._monitor: Optional[threading.Thread] = None

    # -- metrics -----------------------------------------------------------

    def _publish(self) -> None:
        if self.metrics is None:
            return
        with self._lock:
            replicas = list(self.replicas)
        up = sum(1 for r in replicas if r.state == ReplicaState.UP)
        self.metrics.gauge("replica_up").set(up)
        self.metrics.gauge("replica_count").set(len(replicas))
        for r in replicas:
            self.metrics.gauge(f"replica_{r.index}_up").set(
                1 if r.state == ReplicaState.UP else 0
            )

    def _count_restart(self) -> None:
        if self.metrics is not None:
            self.metrics.counter("replica_restarts_total").inc()

    # -- spawning ----------------------------------------------------------

    def _argv(self, index: int) -> List[str]:
        shard = self._shard_of.get(index)
        shard_flags = self._shard_args.get(shard, []) if shard is not None else []
        model = self._model_of.get(index)
        model_flags = self._model_args.get(model, []) if model is not None else []
        return [
            sys.executable, "-m", "gene2vec_tpu_torch.cli.serve",
            "--export-dir", self.export_dir, "--port", "0",
            *self.serve_args, *shard_flags, *model_flags,
            *self.replica_args.get(index, []),
        ]

    def _spawn(self, replica: Replica) -> None:
        """Start (or restart) one replica and read its contract line."""
        self._launch(replica)
        self._await_contract(replica)

    def _launch(self, replica: Replica) -> None:
        env = dict(os.environ)
        # the contract line must not sit in a block buffer while the
        # supervisor waits on it
        env["PYTHONUNBUFFERED"] = "1"
        env.update(self.env or {})
        replica.url = None  # no probe may hit the previous incarnation
        replica.proc = subprocess.Popen(
            self._argv(replica.index),
            stdout=subprocess.PIPE, stderr=None, text=True, env=env,
        )

    def _await_contract(self, replica: Replica) -> None:
        """Read a launched replica's contract line.  Raises on a child
        that dies or wedges before binding — and in that case KILLS the
        child first: a wedged-but-alive process left behind would make
        the slot look alive forever (``r.alive`` gates the restart
        branch) while probing a stale URL."""
        try:
            info = read_contract_line(
                replica.proc, self.config.contract_timeout_s
            )
        except Exception:
            replica.proc.kill()
            try:
                replica.proc.wait(timeout=10.0)
            except subprocess.TimeoutExpired:
                pass
            raise
        replica.url = info["url"].rstrip("/")
        replica.consecutive_failures = 0
        replica.consecutive_passes = 0
        replica.state = ReplicaState.STARTING

    def start(self) -> "FleetSupervisor":
        """Spawn every replica, wait until each passes readiness once,
        then start the monitor loop.  A replica that cannot start at all
        fails ``start`` — a fleet that begins life degraded is a config
        error, not a runtime event.  ANY startup failure (a _spawn
        exception, a readiness timeout, a SIGTERM mid-start) tears down
        the replicas already launched — a failed start must not orphan
        N serving processes.  The replicas start side by side: each
        spends its start-up (a torch import, the card's context, the
        table's placement) while the others spend theirs."""
        try:
            for r in self.replicas:
                self._launch(r)
            errors: List[BaseException] = []

            def await_one(r: Replica) -> None:
                try:
                    self._await_contract(r)
                except BaseException as e:
                    errors.append(e)

            waiters = [threading.Thread(target=await_one, args=(r,), daemon=True)
                       for r in self.replicas]
            for t in waiters:
                t.start()
            for t in waiters:
                t.join()
            if errors:
                raise errors[0]
            deadline = time.monotonic() + self.config.contract_timeout_s
            for r in self.replicas:
                while time.monotonic() < deadline:
                    if self._probe(r):
                        r.state = ReplicaState.UP
                        break
                    time.sleep(0.1)
                if r.state != ReplicaState.UP:
                    raise TimeoutError(
                        f"replica {r.index} ({r.url}) never became ready"
                    )
        except BaseException:
            self.stop()
            raise
        self._publish()
        self._stop.clear()
        self._monitor = threading.Thread(
            target=self._monitor_loop, name="fleet-monitor", daemon=True
        )
        self._monitor.start()
        return self

    def stop(self) -> None:
        self._stop.set()
        if self._monitor is not None:
            self._monitor.join(timeout=10.0)
            self._monitor = None
        with self._lock:
            replicas = list(self.replicas)
        for r in replicas:
            if r.proc is not None and r.proc.poll() is None:
                r.proc.terminate()
        for r in replicas:
            if r.proc is not None:
                try:
                    r.proc.wait(timeout=10.0)
                except subprocess.TimeoutExpired:
                    r.proc.kill()
                    r.proc.wait(timeout=10.0)

    # -- health ------------------------------------------------------------

    def _probe(self, replica: Replica) -> bool:
        """One readiness probe.  False for connect failure, non-200, or
        a wedged replica (read timeout) alike — rotation only cares
        whether this replica can answer a real request right now."""
        if replica.url is None:
            return False
        try:
            with urllib.request.urlopen(
                f"{replica.url}/healthz",
                timeout=self.config.health_timeout_s,
            ) as resp:
                return resp.status == 200
        except Exception as e:
            replica.last_error = repr(e)[:200]
            return False

    def healthy_urls(self) -> List[str]:
        """The current rotation — what the proxy's client routes over."""
        with self._lock:
            return [
                r.url for r in self.replicas
                if r.state == ReplicaState.UP and r.url
            ]

    def live_urls(self) -> List[str]:
        """Every replica that is alive with a bound URL — the telemetry
        scrape set.  Wider than the rotation on purpose: an EJECTED
        replica's queue depth and error counters are exactly what the
        fleet view must not lose sight of."""
        with self._lock:
            return [r.url for r in self.replicas if r.alive and r.url]

    def states(self) -> List[Dict]:
        with self._lock:
            return [
                {
                    "index": r.index,
                    "state": r.state,
                    "url": r.url,
                    "pid": r.pid,
                    "shard": r.shard,
                    "model": r.model,
                    "restarts": r.restarts,
                    "last_error": r.last_error,
                }
                for r in self.replicas
            ]

    # -- the (shard, replica) grid -----------------------------------------

    def shard_urls(self, shard: int) -> List[str]:
        """Every UP replica of one shard: the target list the front
        door's per-shard client fails over across."""
        with self._lock:
            return [
                r.url for r in self.replicas
                if r.shard == shard and r.state == ReplicaState.UP and r.url
            ]

    def shard_up_counts(self) -> Dict[int, int]:
        """UP replicas per shard."""
        with self._lock:
            out: Dict[int, int] = {}
            for r in self.replicas:
                if r.shard is None:
                    continue
                out.setdefault(r.shard, 0)
                if r.state == ReplicaState.UP:
                    out[r.shard] += 1
            return out

    def shard_redundancy_facts(self) -> Dict[int, Dict[str, int]]:
        """Per-shard ``{"up", "desired"}`` for the aggregator's
        ``shard_facts`` hook.  ``desired`` is the shard's current
        redundancy promise: a slot the elastic controller is draining has
        left it (a scale-down is policy, not an incident), and a slot in
        its first start (STARTING with no restart yet) has not joined it;
        a dead slot in backoff, an ejected replica and a FAILED slot still
        count, so the ``shard-redundancy-lost`` rule fires on them."""
        with self._lock:
            out: Dict[int, Dict[str, int]] = {}
            for r in self.replicas:
                if r.shard is None:
                    continue
                f = out.setdefault(r.shard, {"up": 0, "desired": 0})
                if r.state == ReplicaState.UP:
                    f["up"] += 1
                if r.state == ReplicaState.DRAINING or (
                    r.state == ReplicaState.STARTING and r.restarts == 0
                ):
                    continue
                f["desired"] += 1
            return out

    def shard_of_url(self, url: str) -> Optional[int]:
        """The shard a replica URL serves (None when unknown or
        unsharded): the aggregator's ``shard_of`` hook."""
        u = url.rstrip("/")
        with self._lock:
            for r in self.replicas:
                if r.url == u:
                    return r.shard
        return None

    # -- the (model, replica) grid -----------------------------------------

    def model_urls(self, model: str) -> List[str]:
        """Every UP replica of one catalog model: the target list the
        front door's per-model client routes over."""
        with self._lock:
            return [
                r.url for r in self.replicas
                if r.model == model and r.state == ReplicaState.UP and r.url
            ]

    def model_up_counts(self) -> Dict[str, int]:
        """UP replicas per catalog model, behind
        ``fleet_model_replicas_up{model=}``."""
        with self._lock:
            out: Dict[str, int] = {}
            for r in self.replicas:
                if r.model is None:
                    continue
                out.setdefault(r.model, 0)
                if r.state == ReplicaState.UP:
                    out[r.model] += 1
            return out

    def model_of_url(self, url: str) -> Optional[str]:
        """The catalog model a replica URL serves (None when unknown or
        single-model): the aggregator's ``model_of`` hook."""
        if not url:
            return None
        u = url.rstrip("/")
        with self._lock:
            for r in self.replicas:
                if r.url == u:
                    return r.model
        return None

    # -- elasticity (serve/autoscale.py ElasticController) -----------------

    def active_count(self, shard: Optional[int] = None,
                     model: Optional[str] = None) -> int:
        """Slots that count toward capacity: all but abandoned (FAILED)
        and departing (DRAINING) ones; a dead slot in backoff counts, since
        its restart is coming.  ``shard`` restricts the count to one
        shard's pool, ``model`` to one catalog model's."""
        with self._lock:
            return sum(
                1 for r in self.replicas
                if r.state not in (ReplicaState.FAILED, ReplicaState.DRAINING)
                and (shard is None or r.shard == shard)
                and (model is None or r.model == model)
            )

    def scale_up(self, shard: Optional[int] = None,
                 model: Optional[str] = None) -> Replica:
        """Spawn one NEW slot (never reusing an index) and read its
        contract line; the monitor loop admits it once its readiness
        probes pass.  A spawn failure removes the slot again and raises.
        ``shard`` spawns it into that shard's pool with the shard's
        flags, ``model`` into that catalog model's pool with its export
        dir and name."""
        with self._lock:
            replica = Replica(self._next_index, shard=shard, model=model)
            if shard is not None:
                self._shard_of[replica.index] = shard
            if model is not None:
                self._model_of[replica.index] = model
            self._next_index += 1
            replica.spawning = True
            self.replicas.append(replica)
        try:
            self._spawn(replica)
        except Exception:
            with self._lock:
                if replica in self.replicas:
                    self.replicas.remove(replica)
            raise
        finally:
            replica.spawning = False
        if self._stop.is_set():
            # raced a fleet stop: this child slipped past stop()'s
            # terminate sweep, so reap it here
            if replica.proc is not None:
                replica.proc.kill()
                replica.proc.wait(timeout=10.0)
            with self._lock:
                if replica in self.replicas:
                    self.replicas.remove(replica)
            return replica
        self._publish()
        return replica

    def pick_drain_victim(self, shard: Optional[int] = None,
                          model: Optional[str] = None) -> Optional[Replica]:
        """The slot a scale-down removes: a dead or not-ready one first
        (trivially zero-drop), else the NEWEST serving replica, and never
        the last one in rotation (of ``shard``'s or ``model``'s pool, when
        given: draining it would un-serve the shard's rows or the whole
        model).  A slot with a spawn in flight is never picked: draining
        it would orphan the new child."""
        with self._lock:
            candidates = [
                r for r in self.replicas
                if r.state not in (ReplicaState.FAILED, ReplicaState.DRAINING)
                and not r.spawning and (shard is None or r.shard == shard)
                and (model is None or r.model == model)
            ]
            not_up = [r for r in candidates if r.state != ReplicaState.UP]
            if not_up:
                return max(not_up, key=lambda r: r.index)
            ups = [r for r in candidates if r.state == ReplicaState.UP]
            if len(ups) > 1:
                return max(ups, key=lambda r: r.index)
            return None

    def begin_drain(self, replica: Replica) -> None:
        """Take the victim out of rotation: ``healthy_urls`` (the proxy's
        target callable) stops offering it on the next pick, while
        ``live_urls`` keeps scraping it."""
        with self._lock:
            replica.state = ReplicaState.DRAINING
        self._publish()

    def finish_drain(self, replica: Replica) -> None:
        """SIGTERM the drained victim (SIGKILL if it lingers) and retire
        its slot.  Call only once the front door's in-flight count on its
        URL has settled; the controller owns that wait."""
        proc = replica.proc
        if proc is not None and proc.poll() is None:
            proc.terminate()
        if proc is not None:
            try:
                proc.wait(timeout=15.0)
            except subprocess.TimeoutExpired:
                proc.kill()
                proc.wait(timeout=10.0)
        with self._lock:
            if replica in self.replicas:
                self.replicas.remove(replica)
        if self.metrics is not None:
            # retire the per-replica gauge with the slot
            self.metrics.remove(f"replica_{replica.index}_up")
        self._publish()

    # -- the monitor loop --------------------------------------------------

    def _schedule_restart(self, replica: Replica, now: float) -> None:
        """Death observed: apply the storm cap, then pick the jittered
        exponential backoff for the next spawn attempt."""
        window = self.config.storm_window_s
        while replica.restart_times and (
            now - replica.restart_times[0] > window
        ):
            replica.restart_times.popleft()
        if len(replica.restart_times) >= self.config.storm_max_restarts:
            replica.state = ReplicaState.FAILED
            replica.last_error = (
                f"restart storm: {len(replica.restart_times)} restarts "
                f"in {window:.0f}s — giving up on this slot"
            )
            if self.metrics is not None:
                self.metrics.counter("replica_storm_failures_total").inc()
            return
        n = len(replica.restart_times)
        backoff = min(
            self.config.backoff_base_s * (2 ** n),
            self.config.backoff_max_s,
        ) * (
            1.0 + self.config.jitter_frac * (2 * self._rng.random() - 1)
        )
        replica.state = ReplicaState.BACKOFF
        replica.next_restart_at = now + backoff

    def _respawn(self, replica: Replica) -> None:
        """One restart attempt, on its own thread: a respawn blocks on
        the child's whole startup (a torch import, the kernel libraries'
        load and the table's placement on the card), and running it inside
        the monitor loop would blind supervision of every OTHER replica
        for that long."""
        try:
            if self._stop.is_set():
                return
            self._spawn(replica)
            with self._lock:
                retired = (replica not in self.replicas
                           or replica.state == ReplicaState.DRAINING)
            if self._stop.is_set() or retired:
                # the fleet stopped, or a scale-down retired this slot,
                # while we were spawning: this child raced past the
                # terminate sweep, reap it here (an orphaned serving
                # process on a bound port is the alternative)
                if replica.proc is not None:
                    replica.proc.kill()
                    replica.proc.wait(timeout=10.0)
                return
            replica.restarts += 1
            self._count_restart()
        except Exception as e:
            replica.last_error = repr(e)[:200]
            self._schedule_restart(replica, time.monotonic())
        finally:
            replica.spawning = False

    def _tick(self) -> None:
        now = time.monotonic()
        probe_list: List[Replica] = []
        with self._lock:
            replicas = list(self.replicas)
        for r in replicas:
            if r.state in (ReplicaState.FAILED, ReplicaState.DRAINING) or r.spawning:
                # a DRAINING replica leaves on purpose: no probes and no
                # restart if it exits (the controller owns its death)
                continue
            if not r.alive:
                if r.state == ReplicaState.BACKOFF:
                    if now >= r.next_restart_at:
                        # the ATTEMPT counts toward the storm window —
                        # a child that crashes before its contract line
                        # must still grow the backoff and trip the cap,
                        # or a bad flag becomes an eternal fork loop
                        r.restart_times.append(now)
                        r.spawning = True
                        threading.Thread(
                            target=self._respawn, args=(r,),
                            name=f"fleet-respawn-{r.index}", daemon=True,
                        ).start()
                else:
                    # freshly observed death (crash or wedge-kill)
                    self._schedule_restart(r, now)
                continue
            probe_list.append(r)
        # probes run CONCURRENTLY: one wedged replica (accepts TCP,
        # never answers — the blackhole class) costs its own
        # health_timeout_s, not everyone's detection cadence
        outcomes: Dict[int, bool] = {}
        probers = [
            threading.Thread(
                target=lambda r=r: outcomes.__setitem__(
                    r.index, self._probe(r)
                ),
                daemon=True,
            )
            for r in probe_list
        ]
        for t in probers:
            t.start()
        probe_deadline = (
            time.monotonic() + self.config.health_timeout_s + 1.0
        )
        for t in probers:
            t.join(timeout=max(0.0, probe_deadline - time.monotonic()))
        for r in probe_list:
            # a probe thread still stuck past the deadline counts as a
            # failed probe — exactly what a wedged replica deserves
            ok = outcomes.get(r.index, False)
            with self._lock:
                if ok:
                    r.consecutive_failures = 0
                    r.consecutive_passes += 1
                    if r.state in (
                        ReplicaState.STARTING, ReplicaState.EJECTED
                    ) and r.consecutive_passes >= self.config.readmit_after:
                        r.state = ReplicaState.UP
                else:
                    r.consecutive_passes = 0
                    r.consecutive_failures += 1
                    if (
                        r.state == ReplicaState.UP
                        and r.consecutive_failures
                        >= self.config.unhealthy_after
                    ):
                        r.state = ReplicaState.EJECTED
        self._publish()

    def _monitor_loop(self) -> None:
        while not self._stop.wait(self.config.health_interval_s):
            try:
                self._tick()
            except Exception as e:  # supervision must outlive surprises
                if self.metrics is not None:
                    self.metrics.counter(
                        "fleet_monitor_errors_total"
                    ).inc()
                print(f"fleet monitor error: {e!r}", file=sys.stderr)




# -- the front-door proxy ----------------------------------------------------


_LIVEZ_BODY = b'{"status": "alive"}'
_POOL_FULL_BODY = b'{"error": "proxy handler pool saturated; shed load"}'
_DEADLINE_BODY = (
    b'{"error": "fleet deadline exhausted before a replica answered"}'
)
_PROM_CT = b"text/plain; version=0.0.4"


class _ProxyAdapter:
    """Event-loop handler for the front door.  ``/livez`` answers
    inline from the loop; everything else runs on a bounded worker
    pool because forwarding blocks on replica round trips.  Successful
    replica responses pass through as raw bytes, so the proxy adds
    routing and resilience, not a JSON decode/encode cycle per request."""

    def __init__(self, proxy: "FleetProxy", workers: int,
                 max_queue: int = 2048):
        self.proxy = proxy
        self.pool = HandlerPool(workers, max_queue, name="fleet-proxy")

    def close(self) -> None:
        self.pool.stop()

    def account_protocol_error(self, status: int) -> None:
        """Loop-generated 400/408 responses (malformed request line,
        slow-loris reap) keep the proxy's error counters."""
        self.proxy.metrics.counter(f"fleet_http_{status}_total").inc()

    def __call__(self, req: HTTPRequest,
                 peer: ConnHandle) -> Optional[Response]:
        if req.method == "GET" and req.target in ("/livez", "/livez/"):
            return Response(200, _LIVEZ_BODY)
        if not self.pool.submit(lambda: self._run(req, peer)):
            self.proxy.metrics.counter("fleet_http_429_total").inc()
            return Response(429, _POOL_FULL_BODY)
        return None

    # -- worker-pool side --------------------------------------------------

    def _run(self, req: HTTPRequest, peer: ConnHandle) -> None:
        proxy = self.proxy
        route = urlparse(req.target).path.rstrip("/") or "/"
        if req.method == "GET" and route == "/healthz":
            status, doc = proxy.healthz()
            peer.respond(Response(
                status, json.dumps(doc).encode("utf-8")
            ))
            return
        if req.method == "GET" and route == "/metrics":
            proxy.publish_kernel_launches()
            peer.respond(Response(
                200, proxy.metrics.prometheus_text().encode("utf-8"),
                _PROM_CT,
            ))
            return
        if req.method == "GET" and route == "/debug/flight":
            # the proxy's own ring, same contract as a replica's
            # /debug/flight (serve/server.py)
            peer.respond(Response(
                200,
                json.dumps(
                    proxy.flight.snapshot_doc("debug")
                ).encode("utf-8"),
            ))
            return
        if req.method == "GET" and route == "/metrics/fleet":
            # the merged fleet-level SLO view: availability, per-route
            # p50/p99, total queue depth, rejection rate in one scrape
            if proxy.aggregator is None:
                peer.respond(Response(
                    404,
                    b'{"error": "fleet aggregation disabled '
                    b'(--scrape-interval 0)"}',
                ))
                return
            peer.respond(Response(
                200, proxy.aggregator.fleet_text().encode("utf-8"),
                _PROM_CT,
            ))
            return
        if proxy.jobs is not None and (
            route == "/v1/jobs" or route.startswith("/v1/jobs/")
        ):
            # the batch-job surface (batch/jobs.py) is handled here and
            # never forwarded: the front door owns the job store and the
            # fleet-wide query backend
            from gene2vec_tpu_torch.batch.jobs import dispatch_jobs

            jbody: Optional[dict] = None
            if req.method == "POST":
                jbody, err = parse_json_body(req)
                if err is not None:
                    peer.respond(err)
                    return
            status, doc = dispatch_jobs(
                proxy.jobs, req.method, route,
                parse_qs(urlparse(req.target).query), jbody,
            )
            proxy.metrics.counter("fleet_proxy_responses_total").inc()
            peer.respond(Response(status, json.dumps(doc).encode("utf-8")))
            return
        if not route.startswith("/v1/"):
            peer.respond(Response(
                404,
                json.dumps(
                    {"error": f"no route {req.method} {route}"}
                ).encode("utf-8"),
            ))
            return
        # catalog routing: /v1/<model>/* goes to the named model's pool
        # (the prefixed target forwards verbatim: a replica takes its own
        # name as an alias), unprefixed /v1/* to the default pool.  An
        # unknown name 404s and an over-budget model 429s here, before a
        # replica round trip and before any label is minted from the name
        model: Optional[str] = None
        canonical = route
        if proxy.catalog is not None:
            name, canonical = split_model_route(route)
            if name is not None and name not in proxy.model_clients:
                proxy.metrics.counter("fleet_http_404_total").inc()
                peer.respond(Response(404, json.dumps(
                    {"error": f"unknown model {name!r}"}
                ).encode("utf-8")))
                return
            model = name if name is not None else proxy.catalog.default
            if (
                proxy.model_admission is not None
                and not proxy.model_admission.admit(model)
            ):
                proxy.metrics.counter(
                    "fleet_model_rejected_total",
                    labels={"model": model_label(model, proxy.model_clients)},
                ).inc()
                proxy.metrics.counter("fleet_http_429_total").inc()
                peer.respond(Response(429, json.dumps({
                    "error": f"model {model!r} over its request budget; "
                             "retry later"
                }).encode("utf-8")))
                return
        body: Optional[dict] = None
        if req.method == "POST":
            body, err = parse_json_body(req)
            if err is not None:
                peer.respond(err)
                return
        if proxy.shard_group is not None:
            self._scatter_dispatch(req, peer, route, body)
            return
        self._forward(
            req, peer, canonical, body,
            client=proxy.model_clients.get(model) if model else None,
            model=model,
        )

    # -- sharded mode: scatter-gather instead of round-robin ---------------

    def _scatter_dispatch(self, req: HTTPRequest, peer: ConnHandle,
                          route: str, body: Optional[dict]) -> None:
        """Route the /v1 surface through the shard group
        (``serve/shardgroup.py``): ``/v1/similar`` scatter-gathers every
        shard, ``/v1/embedding`` goes to the owning shards, ``/v1/genes``
        answers from the routing table and ``/v1/interaction`` scores at
        the front door.  The same trace ingress as the round-robin path:
        the legs' attempts become sibling spans under ``proxy_scatter``."""
        proxy = self.proxy
        group = proxy.shard_group
        incoming = TraceContext.from_header(req.headers.get("traceparent"))
        ctx = incoming.child() if incoming is not None else (
            proxy.sampler.maybe_new_trace() if proxy.sampler is not None else None
        )
        t0 = time.monotonic()
        with tracecontext.use(ctx):
            with ambient_span("proxy_request", route=route) as span:
                if route == "/v1/similar":
                    if req.method == "GET":
                        q = parse_qs(urlparse(req.target).query)
                        gene = q.get("gene", [None])[0]
                        if gene is None:
                            status, doc = 400, {"error": "missing ?gene= parameter"}
                        else:
                            try:
                                k = int(q.get("k", ["10"])[0])
                            except ValueError:
                                k = -1  # rejected by validation below
                            status, doc = group.similar({"genes": [gene], "k": k})
                    else:
                        status, doc = group.similar(body or {})
                elif route == "/v1/embedding" and req.method == "POST":
                    status, doc = group.embedding(body or {})
                elif route == "/v1/genes" and req.method == "GET":
                    q = parse_qs(urlparse(req.target).query)
                    try:
                        limit = int(q.get("limit", ["100"])[0])
                        offset = int(q.get("offset", ["0"])[0])
                    except ValueError:
                        limit, offset = -1, -1
                    if limit < 0 or offset < 0:
                        status, doc = 400, {"error": "limit/offset must be >= 0"}
                    else:
                        status, doc = 200, group.routing.genes_doc(limit, offset)
                elif route == "/v1/interaction" and req.method == "POST":
                    # each gene's vector from its owner group, the GGIPNN
                    # head at the front door
                    status, doc = group.interaction(body or {})
                else:
                    status, doc = 404, {"error": f"no route {req.method} {route}"}
                span["status"] = status
        dur = time.monotonic() - t0
        proxy.account(route, status, dur, ctx.trace_id if ctx is not None else None)
        peer.respond(Response(status, json.dumps(doc).encode("utf-8")))

    def _forward(self, req: HTTPRequest, peer: ConnHandle, route: str,
                 body: Optional[dict],
                 client: Optional[ResilientClient] = None,
                 model: Optional[str] = None) -> None:
        proxy = self.proxy
        if client is None:
            client = proxy.client
        # the proxy is the fleet's trace ingress: honor a propagated
        # context (child it), else maybe start a root; the resilient
        # client below picks the installed context up as its base, so
        # every replica attempt becomes a child span of this hop
        incoming = TraceContext.from_header(
            req.headers.get("traceparent")
        )
        ctx = incoming.child() if incoming is not None else (
            proxy.sampler.maybe_new_trace()
            if proxy.sampler is not None else None
        )
        # tenant pass-through: the identity reaches whichever replica
        # answers
        tenant = req.headers.get("x-tenant")
        extra = {"X-Tenant": tenant} if tenant else None
        t0 = time.monotonic()
        with tracecontext.use(ctx):
            with ambient_span("proxy_request", route=route) as span:
                resp = client.request(
                    req.target, body=body, method=req.method,
                    timeout_s=(
                        float(body["timeout_ms"]) / 1000.0
                        if body
                        and isinstance(
                            body.get("timeout_ms"), (int, float)
                        )
                        else None
                    ),
                    headers=extra,
                )
                span["attempts"] = resp.attempts
        if resp.ok and resp.raw is not None:
            # zero-copy passthrough: the replica's encoded body goes to
            # the client verbatim — no parse, no re-serialization
            status, payload = resp.status, resp.raw
        elif resp.doc is not None:
            status, payload = resp.status, (
                resp.raw if resp.raw else
                json.dumps(resp.doc).encode("utf-8")
            )
        elif resp.error_class == "deadline":
            status, payload = 504, _DEADLINE_BODY
        else:
            status, payload = 502, json.dumps(
                {"error": f"no replica answered ({resp.error_class})"}
            ).encode("utf-8")
        # account BEFORE the reply write can fail: a client gone mid-
        # reply (broken pipe during an incident) must still count in
        # the availability view and the flight ring
        dur = time.monotonic() - t0
        proxy.account(route, status, dur,
                      ctx.trace_id if ctx is not None else None, model=model)
        peer.respond(Response(status, payload))


class FleetProxy:
    """The fleet's single public address.  Owns the resilient client
    whose target set is the supervisor's LIVE rotation (a callable, so
    ejections and re-admissions apply to the very next request)."""

    def __init__(
        self,
        supervisor: FleetSupervisor,
        metrics,
        policy: Optional[RetryPolicy] = None,
        read_timeout_s: float = 10.0,
        trace_sample: float = 0.0,
        scrape_interval_s: float = 2.0,
        telemetry_csv: Optional[str] = None,
        flight_dir: Optional[str] = None,
        proxy_workers: int = 16,
        idle_timeout_s: float = 30.0,
        acceptors: int = 1,
        alert_rules=None,
        shard_group=None,
        jobs=None,
        catalog=None,
        model_admission=None,
    ):
        self.supervisor = supervisor
        self.metrics = metrics
        #: serve/catalog.py CatalogSpec: set when the fleet serves a
        #: multi-model catalog (cli.fleet --catalog); slots partition into
        #: per-model pools, ``/v1/<model>/*`` routes to the named pool and
        #: unprefixed ``/v1/*`` to the default model's
        self.catalog = catalog
        #: serve/catalog.py ModelAdmission: the front door's per-model
        #: token buckets, crossed with the replicas' tenant buckets
        self.model_admission = model_admission
        #: batch/jobs.py JobManager: set under cli.fleet --jobs-dir; owns
        #: the /v1/jobs surface, answered here and never forwarded
        self.jobs = jobs
        #: serve/shardgroup.py ShardGroup: set when the fleet serves row
        #: shards of one table; the /v1 surface then scatter-gathers
        #: instead of forwarding round-robin (cli.fleet --shard-by-rows)
        self.shard_group = shard_group
        self.read_timeout_s = read_timeout_s
        self.proxy_workers = proxy_workers
        self.idle_timeout_s = idle_timeout_s
        self.acceptors = acceptors
        # per-replica in-flight accounting: the zero-drop contract for an
        # elastic scale-down and a graceful shutdown — a replica is
        # terminated only once its count here settles to zero
        # (serve/autoscale.py, FleetProxy.drain)
        self.inflight = InFlightTracker()
        _policy = policy if policy is not None else RetryPolicy(
            max_attempts=3,
            connect_timeout_s=1.0,
            default_timeout_s=5.0,
        )
        if catalog is not None:
            # one resilient client per model pool, all on ONE in-flight
            # tracker (the drain contract is per URL); unprefixed /v1/*
            # goes over the default model's pool only
            self.model_clients: Dict[str, ResilientClient] = {
                name: ResilientClient(
                    (lambda n=name: supervisor.model_urls(n)),
                    policy=_policy,
                    metrics=metrics,
                    inflight=self.inflight,
                )
                for name in catalog.names
            }
            self.client = self.model_clients[catalog.default]
        else:
            self.model_clients = {}
            self.client = ResilientClient(
                supervisor.healthy_urls,
                policy=_policy,
                metrics=metrics,
                inflight=self.inflight,
            )
        self.sampler = Sampler(trace_sample) if trace_sample > 0 else None
        # the telemetry plane: scrape every LIVE replica (not just the
        # rotation) + this registry's own availability counters
        self.aggregator: Optional[FleetAggregator] = (
            FleetAggregator(
                supervisor.live_urls,
                proxy_registry=metrics,
                interval_s=scrape_interval_s,
                csv_path=telemetry_csv,
            )
            if scrape_interval_s > 0 else None
        )
        # ONE rate limiter for everything that writes forensics to disk
        # from this process: the proxy's own 5xx-burst flight dumps and
        # rule-triggered incident bundles share the budget
        self.limiter = RateLimiter()
        self.flight = FlightRecorder(limiter=self.limiter)
        self.flight_dir = flight_dir
        # the detection loop: alert rules evaluated on every scrape
        # tick; a rule transitioning to firing hands the incident
        # manager a bundle job on its own thread (obs/alerts.py,
        # obs/incident.py) — nothing here ever runs on the serve path
        self.evaluator: Optional[AlertEvaluator] = None
        self.incidents: Optional[IncidentManager] = None
        if alert_rules and self.aggregator is not None and flight_dir:
            self.incidents = IncidentManager(
                os.path.join(flight_dir, "incidents"),
                scan_roots=[supervisor.export_dir, flight_dir],
                targets=supervisor.live_urls,
                local_flight=self.flight,
                aggregator=self.aggregator,
                limiter=self.limiter,
                metrics=metrics,
            )
            self.evaluator = AlertEvaluator(
                alert_rules,
                registry=self.aggregator.view,
                log_path=os.path.join(flight_dir, ALERTS_LOG_NAME),
                on_fire=self.incidents.fire_async,
            )
            self.aggregator.evaluator = self.evaluator
        self._server: Optional[EventLoopHTTPServer] = None
        self._thread: Optional[threading.Thread] = None
        #: kernel launches already published to /metrics, per kernel
        self._launches_published: Dict[str, int] = {}

    def publish_kernel_launches(self) -> None:
        """The front door's own kernel launches (the cross-shard scorer's
        row gather) as ``kernel_launches_total{kernel=}`` on ``/metrics``,
        by delta, once the scorer exists: a front door that scored no pair
        has loaded no kernel module."""
        group = self.shard_group
        if group is None or group._interaction_scorer is None:
            return
        from gene2vec_tpu_torch import kernels

        for name, count in kernels.launch_counts().items():
            delta = count - self._launches_published.get(name, 0)
            if delta > 0:
                self.metrics.counter(
                    "kernel_launches_total", "CUDA kernel launches by this process",
                    labels={"kernel": name},
                ).inc(delta)
                self._launches_published[name] = count

    def account(self, route: str, status: int, dur_s: float,
                trace_id: Optional[str],
                model: Optional[str] = None) -> None:
        """Per-forwarded-response bookkeeping: the availability
        counters the aggregator reads, the per-route latency series,
        and the proxy's flight-recorder ring.  ``route`` is the canonical
        route; in catalog mode the model rides along as a bounded
        ``model=`` label, so a single-model fleet's label sets stay as
        they were."""
        self.metrics.counter("fleet_proxy_responses_total").inc()
        if 200 <= status < 300:
            self.metrics.counter("fleet_proxy_ok_total").inc()
        elif status == 429:
            # explicit backpressure is deliberate shedding, not an
            # availability failure: the aggregator exports it apart
            self.metrics.counter("fleet_proxy_429_total").inc()
        label = collapse_jobs_route(route)
        labels = {"route": label if label in _PROXY_ROUTES else "other"}
        if self.catalog is not None:
            labels["model"] = model_label(
                model if model is not None else self.catalog.default,
                self.model_clients,
            )
        self.metrics.histogram("fleet_proxy_seconds", labels=labels).observe(dur_s)
        burst = self.flight.record(route, status, dur_s, trace_id=trace_id)
        if burst and self.flight_dir:
            try:
                self.flight.dump(self.flight_dir, "5xx-burst")
            except OSError:
                pass

    def healthz(self) -> "tuple":
        states = self.supervisor.states()
        up = [s for s in states if s["state"] == ReplicaState.UP]
        doc = {
            "status": "ok" if up else "not_ready",
            "replicas_up": len(up),
            "replicas": states,
        }
        if self.catalog is not None:
            # the per-model grid: pool membership and UP count per model;
            # a fleet with some empty pool is "degraded", not down
            counts = self.supervisor.model_up_counts()
            doc["default_model"] = self.catalog.default
            doc["models"] = {
                name: {
                    "up": counts.get(name, 0),
                    "replicas": [
                        {
                            "index": s["index"],
                            "up": s["state"] == ReplicaState.UP,
                            "pid": s["pid"],
                        }
                        for s in states if s.get("model") == name
                    ],
                }
                for name in self.catalog.names
            }
            if up and any(counts.get(n, 0) == 0 for n in self.catalog.names):
                doc["status"] = "degraded"
        if self.shard_group is not None:
            # per shard: row range, replica group, the epoch each cell was
            # last seen serving; a shard is up while any sibling is
            group = self.shard_group
            by_shard: Dict[int, List[Dict]] = {}
            for s in states:
                if s.get("shard") is None:
                    continue
                by_shard.setdefault(s["shard"], []).append({
                    "index": s["index"],
                    "up": s["state"] == ReplicaState.UP,
                    "pid": s["pid"],
                    "epoch": group.replica_epoch(s["url"]),
                })
            doc["shards"] = group.shard_states(
                up_for=lambda i: any(r["up"] for r in by_shard.get(i, [])),
                replicas_for=lambda i: by_shard.get(i, []),
            )
            doc["epoch"] = group.current_epoch
        return (200 if up else 503), doc

    def serve(self, host: str = "127.0.0.1", port: int = 0) -> str:
        """Bind the event-loop front end and serve on a daemon thread;
        returns the base URL."""
        adapter = _ProxyAdapter(self, workers=self.proxy_workers)
        server = EventLoopHTTPServer(
            adapter,
            host,
            port,
            config=EventLoopConfig(
                read_timeout_s=self.read_timeout_s,
                idle_timeout_s=self.idle_timeout_s,
                acceptors=self.acceptors,
            ),
            on_protocol_error=adapter.account_protocol_error,
        )
        self._server = server
        self._thread = threading.Thread(
            target=server.serve_forever, name="fleet-proxy", daemon=True
        )
        self._thread.start()
        if self.aggregator is not None:
            self.aggregator.start()
        if self.jobs is not None:
            # recover and start the batch worker once the front door can
            # answer the queries jobs send
            self.jobs.start()
        bound_host, bound_port = server.server_address[:2]
        return f"http://{bound_host}:{bound_port}"

    def drain(self, timeout_s: float = 10.0,
              poll_s: float = 0.05) -> bool:
        """Wait for every in-flight replica forward to settle — the
        graceful-shutdown half of the zero-drop contract: call after
        :meth:`stop` (no new requests are being accepted) and BEFORE
        ``supervisor.stop()`` tears the replicas down, so a forward the
        proxy already dispatched completes against a living replica
        instead of dying with it.  True when the front door is empty,
        False on timeout (callers proceed either way; the wait is the
        courtesy, not a lock)."""
        deadline = time.monotonic() + timeout_s
        while time.monotonic() < deadline:
            if self.inflight.total() == 0:
                return True
            time.sleep(poll_s)
        remaining = self.inflight.total()
        if remaining and self.metrics is not None:
            self.metrics.counter("fleet_drain_timeouts_total").inc()
        return remaining == 0

    def stop(self) -> None:
        if self.jobs is not None:
            # first: a running job stops querying before its replicas go
            # (it stays journal-"running" and resumes from its cursor)
            self.jobs.stop()
        if self.aggregator is not None:
            self.aggregator.stop()
        if self._server is not None:
            self._server.shutdown()
            self._server.server_close()
            self._server = None
        self._thread = None
