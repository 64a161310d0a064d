"""SLO-driven fleet autoscaling: the hysteresis policy and the elastic
controller — the port of ``gene2vec_tpu/serve/autoscale.py``.

The fleet aggregator (``obs/aggregate.py``) computes the signals on
every scrape tick (``fleet_queue_depth``, the ``fleet_requests`` /
``fleet_rejected`` / ``fleet_quota_rejected`` / ``fleet_ok`` /
``fleet_responses`` / ``fleet_throttled`` counters, per-route p99 and
``_fresh_targets``); the scaler reads that snapshot and moves the
replica count between ``min_replicas`` and ``max_replicas``.

* :class:`AutoscalePolicy` — a pure state machine, one ``observe(snapshot,
  now, current)`` a tick.  A breach (queue depth per replica, windowed
  rejection rate, windowed availability, route p99 over their ``up_*``
  bounds) must hold ``up_after_ticks`` ticks to scale up; scale-down needs
  ``down_after_ticks`` ticks fully clear of the lower ``down_*`` bounds;
  the band between resets both streaks.  A ``cooldown_s`` follows every
  action, and a stale snapshot (fewer than ``min_fresh_targets`` fresh
  targets) advances neither streak.  Rates are per-tick deltas of the
  counters, never lifetime ratios; tenant-quota rejections and 429s are
  deliberate shedding and drive no scale-up.
* :class:`ElasticController` — the shell: an aggregator observer that
  feeds the policy and applies one decision at a time on its own thread.
  Scale-up spawns a replica through the supervisor and waits for it.
  Scale-down is zero-drop: the victim leaves the rotation
  (``FleetSupervisor.begin_drain``), the front door's in-flight count on
  it settles at zero, and only then is it SIGTERMed; a drain that never
  settles times out and is counted.
* :class:`ShardAutoscalePolicy` and :class:`ShardElasticController` — one
  policy per row-shard pool (``cli.fleet --shard-by-rows``), the hottest
  pool winning the tick.
* :class:`PoolElasticController` — the same over a catalog fleet's
  (model, shard) pools (``cli.fleet --catalog``): scale-up spawns into the
  hot model's pool, scale-down never drains a model's last UP replica.

``python -m gene2vec_tpu_torch.cli.fleet --max-replicas N`` turns the loop
on.
"""

from __future__ import annotations

import dataclasses
import sys
import threading
import time
from typing import Dict, Optional, Tuple

__all__ = [
    "AutoscaleConfig",
    "AutoscalePolicy",
    "ElasticController",
    "PoolAutoscalePolicy",
    "PoolElasticController",
    "ScaleDecision",
    "ShardAutoscalePolicy",
    "ShardElasticController",
    "pool_snapshot",
    "shard_snapshot",
]


@dataclasses.dataclass(frozen=True)
class AutoscaleConfig:
    """Scaler policy knobs (cli/fleet.py flags).  All ``*_ticks``
    values count aggregator scrape ticks — the policy's only clock is
    the snapshot cadence."""

    min_replicas: int = 1
    max_replicas: int = 4
    # -- breach thresholds: scale up when ANY signal exceeds its up_*
    # bound for up_after_ticks consecutive ticks ------------------------
    up_queue_per_replica: float = 8.0
    up_rejection_rate: float = 0.02
    up_availability: float = 0.95     # windowed Δok/Δresponses below this
    up_p99_s: float = 0.0             # 0 disables the p99 signal
    p99_route: str = "/v1/similar"
    up_after_ticks: int = 2
    # -- clear thresholds: scale down only when EVERY signal sits below
    # its down_* bound for down_after_ticks consecutive ticks — the gap
    # between up_* and down_* is the hysteresis band ---------------------
    down_queue_per_replica: float = 1.0
    down_rejection_rate: float = 0.0
    down_availability: float = 0.999
    down_p99_s: float = 0.0
    down_after_ticks: int = 30
    # -- damping ---------------------------------------------------------
    cooldown_s: float = 10.0          # no two actions closer than this
    min_fresh_targets: int = 1        # stale snapshot -> hold
    min_window_responses: float = 1.0  # evidence floor for rate deltas


@dataclasses.dataclass(frozen=True)
class ScaleDecision:
    """One tick's verdict.  ``target`` is the replica count the fleet
    should move to (== ``current`` on hold).  ``shard`` scopes the
    action to one shard's replica pool, ``model`` to one catalog
    model's pool (both None = the whole fleet — the single pool
    model); together they name a (model, shard) pool."""

    action: str                # "up" | "down" | "hold"
    target: int
    reason: str
    breach_ticks: int = 0
    clear_ticks: int = 0
    shard: Optional[int] = None
    model: Optional[str] = None


def _route_key(route: str) -> str:
    return f"fleet_route_p99_seconds{{route={route}}}"


class AutoscalePolicy:
    """The pure hysteresis state machine.  One instance per fleet;
    :meth:`observe` is called with the aggregator's flat snapshot once
    per scrape tick and never blocks, sleeps, or spawns."""

    def __init__(self, config: AutoscaleConfig):
        if config.min_replicas < 1:
            raise ValueError("min_replicas must be >= 1")
        if config.max_replicas < config.min_replicas:
            raise ValueError("max_replicas must be >= min_replicas")
        self.config = config
        self._breach_ticks = 0
        self._clear_ticks = 0
        self._last_action_at: Optional[float] = None
        # counter baselines for the windowed rate signals; None until
        # the first snapshot seeds them (the first tick can never act)
        self._base: Optional[Dict[str, float]] = None

    # -- controller hooks --------------------------------------------------

    def note_action_done(self, now: float) -> None:
        """Re-arm the cooldown from the moment an action COMPLETED: a
        scale-up pays a full replica startup (a torch import, the
        card's context, the table's placement), and cooling down from the decision instant would let
        the still-breaching window trigger a second spawn mid-first."""
        self._last_action_at = now

    # -- signal extraction -------------------------------------------------

    def _window(self, snapshot: Dict[str, float]) -> Dict[str, Optional[float]]:
        """Per-tick deltas of the monotone counters -> windowed rates.
        Returns None for a rate with no evidence this window.

        Deliberate shedding is NOT load the fleet should chase:
        tenant-quota rejections (``fleet_quota_rejected``, the
        tenant-labeled slice of the rejection counter) are subtracted
        from the rejection signal — an abusive tenant saturating its
        own bucket must not buy itself N x quota by scaling the fleet
        — and 429 responses (``fleet_throttled``) leave the
        availability-burn window entirely, since backpressure is a
        policy outcome, not a failure.  Queue-full (capacity)
        rejections still drive scale-up through the rejection rate."""
        cur = {
            k: float(snapshot.get(k, 0.0))
            for k in ("fleet_requests", "fleet_rejected",
                      "fleet_quota_rejected", "fleet_ok",
                      "fleet_responses", "fleet_throttled")
        }
        base, self._base = self._base, cur
        if base is None:
            return {"rejection": None, "availability": None}
        d = {k: max(0.0, cur[k] - base[k]) for k in cur}
        floor = self.config.min_window_responses
        capacity_rejected = max(
            0.0, d["fleet_rejected"] - d["fleet_quota_rejected"]
        )
        rejection = (
            capacity_rejected / d["fleet_requests"]
            if d["fleet_requests"] >= floor else None
        )
        answered = d["fleet_responses"] - d["fleet_throttled"]
        availability = (
            min(1.0, d["fleet_ok"] / answered)
            if answered >= floor else None
        )
        return {"rejection": rejection, "availability": availability}

    def _classify(self, snapshot: Dict[str, float],
                  current: int) -> "tuple[bool, bool, str]":
        """(breach, clear, detail) for one snapshot.  ``breach`` = any
        signal over its up_* bound; ``clear`` = every measurable signal
        under its down_* bound (quiet windows with no traffic count as
        clear — that is exactly when capacity should shrink)."""
        cfg = self.config
        rates = self._window(snapshot)
        queue_per = (
            float(snapshot.get("fleet_queue_depth", 0.0)) / max(current, 1)
        )
        p99 = snapshot.get(_route_key(cfg.p99_route))
        breaches = []
        if queue_per > cfg.up_queue_per_replica:
            breaches.append(f"queue/replica {queue_per:.1f}")
        r = rates["rejection"]
        if r is not None and r > cfg.up_rejection_rate:
            breaches.append(f"rejection {r:.3f}")
        a = rates["availability"]
        if a is not None and a < cfg.up_availability:
            breaches.append(f"availability {a:.3f}")
        if cfg.up_p99_s > 0 and p99 is not None and p99 > cfg.up_p99_s:
            breaches.append(f"p99 {p99:.3f}s")
        if breaches:
            return True, False, "+".join(breaches)
        clear = queue_per <= cfg.down_queue_per_replica
        if r is not None and r > cfg.down_rejection_rate:
            clear = False
        if a is not None and a < cfg.down_availability:
            clear = False
        if cfg.down_p99_s > 0 and p99 is not None and p99 > cfg.down_p99_s:
            clear = False
        return False, clear, "clear" if clear else "between thresholds"

    # -- the tick ----------------------------------------------------------

    def observe(self, snapshot: Dict[str, float], now: float,
                current: int) -> ScaleDecision:
        cfg = self.config

        def hold(reason: str) -> ScaleDecision:
            return ScaleDecision(
                "hold", current, reason,
                breach_ticks=self._breach_ticks,
                clear_ticks=self._clear_ticks,
            )

        fresh = snapshot.get("_fresh_targets")
        if fresh is not None and fresh < cfg.min_fresh_targets:
            # frozen telemetry: neither streak may advance — acting on
            # a stale snapshot would scale on data from before the
            # outage that froze it
            return hold("stale snapshot (fresh targets "
                        f"{int(fresh)} < {cfg.min_fresh_targets})")
        if self._base is None:
            # the very first snapshot only seeds the counter baselines:
            # no windowed rate exists yet, so neither streak advances
            self._window(snapshot)
            return hold("seeding counter baselines")
        breach, clear, detail = self._classify(snapshot, current)
        if breach:
            self._breach_ticks += 1
            self._clear_ticks = 0
        elif clear:
            self._clear_ticks += 1
            self._breach_ticks = 0
        else:
            # the hysteresis band: ambiguous — freeze both streaks
            self._breach_ticks = 0
            self._clear_ticks = 0
        in_cooldown = (
            self._last_action_at is not None
            and now - self._last_action_at < cfg.cooldown_s
        )
        if breach and self._breach_ticks >= cfg.up_after_ticks:
            if current >= cfg.max_replicas:
                return hold(f"breach ({detail}) but at max_replicas "
                            f"{cfg.max_replicas}")
            if in_cooldown:
                return hold(f"breach ({detail}) held by cooldown")
            decision = ScaleDecision(
                "up", min(cfg.max_replicas, current + 1),
                f"breach for {self._breach_ticks} ticks: {detail}",
                breach_ticks=self._breach_ticks,
            )
            self._breach_ticks = 0
            self._clear_ticks = 0
            self._last_action_at = now
            return decision
        if clear and self._clear_ticks >= cfg.down_after_ticks:
            if current <= cfg.min_replicas:
                return hold(f"clear but at min_replicas "
                            f"{cfg.min_replicas}")
            if in_cooldown:
                return hold("clear window complete but held by cooldown")
            decision = ScaleDecision(
                "down", max(cfg.min_replicas, current - 1),
                f"clear for {self._clear_ticks} ticks",
                clear_ticks=self._clear_ticks,
            )
            self._breach_ticks = 0
            self._clear_ticks = 0
            self._last_action_at = now
            return decision
        return hold(detail)


class ElasticController:
    """Applies :class:`AutoscalePolicy` decisions to a live fleet.

    Registered as a :class:`~gene2vec_tpu_torch.obs.aggregate.FleetAggregator`
    observer — :meth:`observe` runs on the aggregator's scrape thread
    and must stay cheap, so actions run on their own daemon thread and
    at most ONE action is in flight at a time (ticks during an action
    are skipped outright: a 20-second replica spawn must not queue up
    twenty more decisions behind it)."""

    def __init__(
        self,
        supervisor,
        proxy,
        config: AutoscaleConfig,
        metrics=None,
        policy: Optional[AutoscalePolicy] = None,
        drain_timeout_s: float = 30.0,
        drain_poll_s: float = 0.05,
        drain_settle_polls: int = 3,
    ):
        self.supervisor = supervisor
        self.proxy = proxy
        self.config = config
        self.metrics = metrics
        self.policy = policy if policy is not None else (
            AutoscalePolicy(config)
        )
        self.drain_timeout_s = drain_timeout_s
        self.drain_poll_s = drain_poll_s
        # consecutive zero-in-flight polls required before the victim
        # is terminated: closes the pick-to-dispatch race window where
        # the client chose the victim just before it left the rotation
        self.drain_settle_polls = max(1, int(drain_settle_polls))
        self._lock = threading.Lock()
        self._busy = False
        self._stopped = False
        if metrics is not None:
            # pre-register the action counters at 0 so /metrics shows
            # them from the first scrape and a steady-state
            # delta math never reads "absent" as "changed"
            metrics.counter("fleet_scale_up_total")
            metrics.counter("fleet_scale_down_total")
            metrics.gauge("fleet_replicas_active").set(
                supervisor.active_count()
            )

    # -- metrics -----------------------------------------------------------

    def _count(self, name: str) -> None:
        if self.metrics is not None:
            self.metrics.counter(name).inc()

    def _publish(self, decision: ScaleDecision, current: int) -> None:
        if self.metrics is None:
            return
        self.metrics.gauge("fleet_replicas_active").set(current)
        self.metrics.gauge("fleet_replicas_target").set(decision.target)
        self.metrics.gauge("fleet_scale_breach_ticks").set(
            decision.breach_ticks
        )
        self.metrics.gauge("fleet_scale_clear_ticks").set(
            decision.clear_ticks
        )

    # -- aggregator observer ----------------------------------------------

    def _decide(
        self, snapshot: Dict[str, float], now: float
    ) -> Tuple[ScaleDecision, int]:
        """Policy seam: this tick's decision + the capacity it was
        made against.  The shard subclass swaps in the per-shard grid
        here; everything else — the one-action gate, counters, drain
        path — is shared."""
        current = self.supervisor.active_count()
        decision = self.policy.observe(
            snapshot, now=now, current=current
        )
        return decision, current

    def _describe(self, decision: ScaleDecision) -> str:
        return (
            f"{decision.action} -> {decision.target} replicas "
            f"({decision.reason})"
        )

    def observe(self, snapshot: Dict[str, float], wall=None) -> None:
        del wall  # the policy runs on the monotonic clock
        with self._lock:
            if self._busy or self._stopped:
                return
        decision, current = self._decide(snapshot, time.monotonic())
        self._publish(decision, current)
        if decision.action == "hold":
            return
        with self._lock:
            if self._busy or self._stopped:
                return
            self._busy = True
        # counted at DECISION time: detection in scrape ticks measures
        # how fast the loop NOTICED, not how fast a replica starts
        self._count(f"fleet_scale_{decision.action}_total")
        print(f"autoscale: {self._describe(decision)}", file=sys.stderr)
        threading.Thread(
            target=self._apply, args=(decision,),
            name=f"fleet-scale-{decision.action}", daemon=True,
        ).start()

    def stop(self) -> None:
        with self._lock:
            self._stopped = True

    # -- actions (their own thread) ----------------------------------------

    def _apply(self, decision: ScaleDecision) -> None:
        try:
            if decision.action == "up":
                self._scale_up(decision.shard, decision.model)
            else:
                self._scale_down(decision.shard, decision.model)
        except Exception as e:
            self._count("fleet_scale_failures_total")
            print(f"autoscale: {decision.action} failed: {e!r}",
                  file=sys.stderr)
        finally:
            # cooldown restarts from action COMPLETION — a long spawn
            # must not be immediately followed by another
            self.policy.note_action_done(time.monotonic())
            with self._lock:
                self._busy = False
            if self.metrics is not None:
                self.metrics.gauge("fleet_replicas_active").set(
                    self.supervisor.active_count()
                )

    def _scale_up(self, shard: Optional[int] = None,
                  model: Optional[str] = None) -> None:
        # keywords passed only when set: single-pool supervisors (and
        # the test fakes) keep their no-arg signature
        kwargs = {}
        if shard is not None:
            kwargs["shard"] = shard
        if model is not None:
            kwargs["model"] = model
        replica = self.supervisor.scale_up(**kwargs)
        # hold the action slot until the new replica actually serves
        # (or demonstrably cannot): the breach persists while it warms
        # up, and releasing early would spawn a second replica for the
        # same breach
        deadline = (
            time.monotonic() + self.supervisor.config.contract_timeout_s
        )
        from gene2vec_tpu_torch.serve.fleet import ReplicaState

        while time.monotonic() < deadline:
            with self._lock:
                if self._stopped:
                    return
            if replica.state in (ReplicaState.UP, ReplicaState.FAILED):
                break
            if not replica.alive and not replica.spawning:
                break
            time.sleep(0.1)

    def _scale_down(self, shard: Optional[int] = None,
                    model: Optional[str] = None) -> None:
        kwargs = {}
        if shard is not None:
            kwargs["shard"] = shard
        if model is not None:
            kwargs["model"] = model
        victim = self.supervisor.pick_drain_victim(**kwargs)
        if victim is None:
            return
        self.supervisor.begin_drain(victim)
        url = victim.url
        tracker = getattr(self.proxy, "inflight", None)
        if tracker is not None and url is not None:
            deadline = time.monotonic() + self.drain_timeout_s
            settled = 0
            while time.monotonic() < deadline:
                with self._lock:
                    if self._stopped:
                        break
                if tracker.count(url) == 0:
                    settled += 1
                    if settled >= self.drain_settle_polls:
                        break
                else:
                    settled = 0
                time.sleep(self.drain_poll_s)
            else:
                self._count("fleet_drain_timeouts_total")
                print(
                    f"autoscale: drain of {url} timed out after "
                    f"{self.drain_timeout_s:g}s with "
                    f"{tracker.count(url)} request(s) in flight",
                    file=sys.stderr,
                )
        self.supervisor.finish_drain(victim)


# -- the (model, shard) pool model -------------------------------------------
#
# A fleet partitions its slots into POOLS — per row shard
# (--shard-by-rows), per catalog model (--catalog), or in principle
# both — and each pool scales independently inside
# [min_replicas, max_replicas].  The pool key is a (model, shard)
# tuple with the unused axis None; `pool_snapshot` projects one pool's
# signals out of the aggregator's flat snapshot, and
# `PoolAutoscalePolicy` runs one plain AutoscalePolicy per pool with
# hottest-signal-wins arbitration.  The shard classes below are the
# pre-catalog API, now thin delegations.


def _pool_queue_key(model: Optional[str], shard: Optional[int]) -> str:
    """The aggregator gauge one pool's queue pressure lives under:
    ``fleet_model_queue_depth{model=}`` for a model pool,
    ``fleet_shard_queue_depth{shard=}`` for a shard pool (a hybrid
    pool reads the model axis — the finer partition in practice)."""
    if model is not None:
        return f"fleet_model_queue_depth{{model={model}}}"
    return f"fleet_shard_queue_depth{{shard={shard}}}"


def _pool_desc(model: Optional[str], shard: Optional[int]) -> str:
    parts = []
    if model is not None:
        parts.append(f"model {model}")
    if shard is not None:
        parts.append(f"shard {shard}")
    return " ".join(parts) if parts else "fleet"


def pool_snapshot(snapshot: Dict[str, float], model: Optional[str],
                  shard: Optional[int],
                  p99_route: str) -> Dict[str, float]:
    """Project one (model, shard) pool's signals out of the
    aggregator's flat snapshot into the key names
    :class:`AutoscalePolicy` reads — the per-pool policies are plain
    AutoscalePolicy instances evaluating their own pool's queue depth
    (and per-shard scatter p99, when the pool has a shard axis).  The
    fleet-wide counter pairs are deliberately ABSENT: rejection/
    availability rates then carry no evidence (None) and neither
    breach nor block a clear, so a pool scales on ITS load, not on
    another pool's burn."""
    sub: Dict[str, float] = {}
    fresh = snapshot.get("_fresh_targets")
    if fresh is not None:
        sub["_fresh_targets"] = fresh
    q = snapshot.get(_pool_queue_key(model, shard))
    if q is None:
        # no queue evidence from ANY of this pool's replicas this
        # round (every scrape missed — the aggregator only publishes
        # the key from successful scrapes): the fleet-wide freshness
        # guard can't see a single dark pool, so zero THIS pool's
        # freshness — the policy must HOLD, not read "idle" and drain
        # capacity from exactly the pool it is blind to
        sub["_fresh_targets"] = 0.0
        sub["fleet_queue_depth"] = 0.0
    else:
        sub["fleet_queue_depth"] = float(q)
    if shard is not None:
        p99 = snapshot.get(f"fleet_shard_p99_seconds{{shard={shard}}}")
        if p99 is not None:
            sub[_route_key(p99_route)] = float(p99)
    return sub


def shard_snapshot(snapshot: Dict[str, float], shard: int,
                   p99_route: str) -> Dict[str, float]:
    """One shard pool's projection — ``pool_snapshot`` with no model
    axis (the pre-catalog name, kept for callers and tests)."""
    return pool_snapshot(snapshot, None, shard, p99_route)


class PoolAutoscalePolicy:
    """Per-pool model: one :class:`AutoscalePolicy` per (model, shard)
    pool, each fed its own pool's signals, deciding that pool's
    replica count inside [min_replicas, max_replicas].  Pure like the
    underlying policies; one :meth:`observe` per scrape tick returns
    at most ONE non-hold decision (scale-ups first, hottest-queue
    pool wins ties) because the controller applies one action at a
    time anyway — a pool whose decision lost the tie re-breaches and
    wins a later tick (its breach window re-accumulates under the
    fleet-wide cooldown, the same anti-flap the single pool has)."""

    def __init__(self, config: AutoscaleConfig, pools):
        pools = [
            (m, None if s is None else int(s)) for m, s in pools
        ]
        if not pools:
            raise ValueError("need at least one pool")
        if len(set(pools)) != len(pools):
            raise ValueError(f"duplicate pool keys in {pools}")
        self.config = config
        self.pools = pools
        self.pool_policies = {
            p: AutoscalePolicy(config) for p in pools
        }
        #: per-pool policy table; the shard subclass re-keys this view
        #: by shard index (the pre-catalog API) over the SAME instances
        self.policies = self.pool_policies

    def note_action_done(self, now: float) -> None:
        # cooldown is FLEET-wide: every pool re-arms, or two pools
        # could interleave actions faster than any one pool allows
        for p in self.pool_policies.values():
            p.note_action_done(now)

    def observe(
        self,
        snapshot: Dict[str, float],
        now: float,
        current_of: Dict[Tuple[Optional[str], Optional[int]], int],
    ) -> ScaleDecision:
        decisions: Dict[tuple, ScaleDecision] = {}
        for pool, policy in self.pool_policies.items():
            model, shard = pool
            sub = pool_snapshot(
                snapshot, model, shard, self.config.p99_route
            )
            decisions[pool] = policy.observe(
                sub, now=now, current=current_of.get(pool, 0)
            )

        def queue_of(pool: tuple) -> float:
            return float(snapshot.get(_pool_queue_key(*pool), 0.0))

        def tag(pool: tuple, d: ScaleDecision) -> ScaleDecision:
            return dataclasses.replace(
                d, model=pool[0], shard=pool[1],
                reason=f"{_pool_desc(*pool)}: {d.reason}",
            )

        for action in ("up", "down"):
            picked = [
                p for p, d in decisions.items() if d.action == action
            ]
            if picked:
                p = max(picked, key=queue_of) if action == "up" else (
                    min(picked, key=queue_of)
                )
                return tag(p, decisions[p])
        # all holds: surface the busiest pool's reason for telemetry
        p = max(decisions, key=queue_of)
        return tag(p, decisions[p])


class ShardAutoscalePolicy(PoolAutoscalePolicy):
    """Per-shard pool model — :class:`PoolAutoscalePolicy` over the
    shard-only pool keys, keeping the pre-catalog shard-keyed
    ``observe(current_of: {shard: count})`` signature."""

    def __init__(self, config: AutoscaleConfig, num_shards: int):
        if num_shards < 1:
            raise ValueError("num_shards must be >= 1")
        super().__init__(
            config, [(None, s) for s in range(int(num_shards))]
        )
        self.num_shards = int(num_shards)
        self.policies = {
            s: self.pool_policies[(None, s)]
            for s in range(self.num_shards)
        }

    def observe(
        self,
        snapshot: Dict[str, float],
        now: float,
        current_of: Dict[int, int],
    ) -> ScaleDecision:
        return super().observe(
            snapshot, now=now,
            current_of={
                (None, s): n for s, n in current_of.items()
            },
        )


class ShardElasticController(ElasticController):
    """The elastic controller for a replicated-shard fleet: the same
    one-action-at-a-time shell, drain path, and metrics, driving a
    :class:`ShardAutoscalePolicy` — scale-up spawns a SIBLING into the
    hot shard's replica group (``FleetSupervisor.scale_up(shard=)``),
    scale-down drains the newest sibling of an idle shard and never
    its last UP replica (``pick_drain_victim(shard=)`` — the shard's
    rows must stay served)."""

    def __init__(self, supervisor, proxy, config: AutoscaleConfig,
                 num_shards: int, metrics=None, **kw):
        super().__init__(
            supervisor, proxy, config, metrics=metrics,
            # the grid IS the controller's policy: the base class's
            # note_action_done in _apply's finally re-arms every pool's
            # cooldown (ShardAutoscalePolicy fans it out), and _apply
            # already threads decision.shard through scale_up/drain
            policy=ShardAutoscalePolicy(config, num_shards),
            **kw,
        )
        self.shard_policy = self.policy
        self.num_shards = int(num_shards)
        # the deciding shard's pool size at _decide time, consumed by
        # _publish in the same tick (observe is single-threaded per
        # aggregator tick) to translate the pool target fleet-wide
        self._decision_pool = 0

    def _decide(
        self, snapshot: Dict[str, float], now: float
    ) -> Tuple[ScaleDecision, int]:
        current_of = {
            s: self.supervisor.active_count(shard=s)
            for s in range(self.num_shards)
        }
        decision = self.shard_policy.observe(
            snapshot, now=now, current_of=current_of,
        )
        self._decision_pool = current_of.get(decision.shard, 0)
        if self.metrics is not None:
            # every pool, every tick — publishing only the deciding
            # shard would freeze the other pools' gauges at whatever
            # size they had the last time they happened to decide
            for s, n in current_of.items():
                self.metrics.gauge(
                    "fleet_shard_replicas_active",
                    labels={"shard": str(s)},
                ).set(n)
        return decision, sum(current_of.values())

    def _publish(self, decision: ScaleDecision, current: int) -> None:
        # decision.target is the chosen SHARD pool's target; the
        # fleet_replicas_active/fleet_replicas_target gauge pair is
        # meant to be compared, so export the
        # post-action FLEET-wide total instead of one pool's target —
        # a hot-shard 2->3 on a 4x2 grid must read 8->9, not 8->3
        if decision.shard is not None:
            decision = dataclasses.replace(
                decision,
                target=current + (decision.target - self._decision_pool),
            )
        super()._publish(decision, current)

    def _describe(self, decision: ScaleDecision) -> str:
        return (
            f"{decision.action} shard {decision.shard} -> "
            f"{decision.target} replicas ({decision.reason})"
        )


class PoolElasticController(ElasticController):
    """The elastic controller for a multi-model catalog fleet: the
    same one-action-at-a-time shell, drain path, and metrics, driving
    a :class:`PoolAutoscalePolicy` over (model, shard) pool keys —
    scale-up spawns a new member into the hot model's pool
    (``FleetSupervisor.scale_up(model=)``), scale-down drains the
    newest member of an idle pool and never a model's last UP replica
    (``pick_drain_victim(model=)``)."""

    def __init__(self, supervisor, proxy, config: AutoscaleConfig,
                 pools, metrics=None, **kw):
        super().__init__(
            supervisor, proxy, config, metrics=metrics,
            policy=PoolAutoscalePolicy(config, pools),
            **kw,
        )
        self.pool_policy = self.policy
        self.pools = list(self.pool_policy.pools)
        # the deciding pool's size at _decide time, consumed by
        # _publish in the same tick (observe is single-threaded per
        # aggregator tick) to translate the pool target fleet-wide
        self._decision_pool = 0

    def _decide(
        self, snapshot: Dict[str, float], now: float
    ) -> Tuple[ScaleDecision, int]:
        current_of = {
            (m, s): self.supervisor.active_count(shard=s, model=m)
            for m, s in self.pools
        }
        decision = self.pool_policy.observe(
            snapshot, now=now, current_of=current_of,
        )
        self._decision_pool = current_of.get(
            (decision.model, decision.shard), 0
        )
        if self.metrics is not None:
            # every pool, every tick — publishing only the deciding
            # pool would freeze the other pools' gauges at whatever
            # size they had the last time they happened to decide
            for (m, s), n in current_of.items():
                if m is not None:
                    self.metrics.gauge(
                        "fleet_model_replicas_active",
                        labels={"model": m},
                    ).set(n)
                if s is not None:
                    self.metrics.gauge(
                        "fleet_shard_replicas_active",
                        labels={"shard": str(s)},
                    ).set(n)
        return decision, sum(current_of.values())

    def _publish(self, decision: ScaleDecision, current: int) -> None:
        # decision.target is the chosen POOL's target; the
        # fleet_replicas_active/fleet_replicas_target gauge pair is
        # documented as comparable (docs/SERVING.md), so export the
        # post-action FLEET-wide total instead of one pool's target
        if decision.model is not None or decision.shard is not None:
            decision = dataclasses.replace(
                decision,
                target=current + (decision.target - self._decision_pool),
            )
        super()._publish(decision, current)

    def _describe(self, decision: ScaleDecision) -> str:
        return (
            f"{decision.action} {_pool_desc(decision.model, decision.shard)} "
            f"-> {decision.target} replicas ({decision.reason})"
        )
