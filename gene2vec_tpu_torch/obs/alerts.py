"""SLO alerting: declarative burn-rate/threshold rules over the fleet view.

The fleet telemetry plane (``obs/aggregate.py``) computes the SLO signals — merged
availability counters, per-route latency quantiles, queue depth,
rejection rate — but nothing *watches* them; an operator has to notice a
p99 blowout by hand.  This module closes that loop:

* :class:`AlertRule` — one declarative rule, loadable from a
  ``budgets.json``-style ``alerts.json`` (``{"rules": [...]}``).  Two
  kinds:

  - ``threshold`` — a gauge selector (``fleet_queue_depth``, or a
    labeled series as ``fleet_route_p99_seconds{route=/v1/similar}``)
    compared against ``value`` with ``op``; hysteresis via
    ``clear_value`` (the condition must drop past it, and STAY there
    for ``clear_for_s``, before the alert clears);
  - ``burn_rate`` — an error fraction derived from a cumulative
    good/total counter pair (``fleet_ok`` / ``fleet_responses``),
    evaluated over a SHORT and a LONG window simultaneously: both
    windows' bad fraction must exceed ``max_bad_frac``, so a brief blip
    cannot fire (long window) and a real incident is seen quickly
    (short window).  Counter resets (a restarted replica zeroing its
    counters) are rebased exactly like the aggregator rebases its fleet
    sums, so a reset can never fake a burn-rate spike.

* ``for_s`` debounces firing: the condition must hold continuously for
  at least ``for_s`` (boundary inclusive) before the rule transitions
  to ``firing``.
* :class:`AlertEvaluator` — streaming evaluation, fed one snapshot per
  :class:`~gene2vec_tpu_torch.obs.aggregate.FleetAggregator` scrape tick (the
  evaluator never touches the serve path; alerting costs zero per
  request).  State is exported as ``fleet_alert_active{rule=}`` /
  ``fleet_alert_transitions_total{rule=,to=}`` on the fleet view and
  every transition is appended to ``alerts.jsonl`` in the fleet run
  dir; a transition to ``firing`` invokes ``on_fire`` (the incident
  manager, :mod:`gene2vec_tpu_torch.obs.incident`).
* :class:`RateLimiter` — the ONE limiter shared by the flight
  recorder's 5xx-burst dumps and rule-triggered incident bundles, so a
  flapping rule plus an error storm cannot multiply disk writes past
  one budget.

Staleness guard: the aggregator stamps ``_fresh_targets`` (replicas
that answered THIS scrape) into every snapshot; a rule whose
``min_fresh_targets`` is not met is **held** — no state transition, no
timer progress — so rules never evaluate (or clear on) frozen data
(docs/OBSERVABILITY.md#alerting).

``python -m gene2vec_tpu_torch.cli.obs alerts <run_dir>`` renders the
transition timeline.
"""

from __future__ import annotations

import collections
import dataclasses
import json
import os
import sys
import threading
import time
from typing import Callable, Deque, Dict, List, Optional, Sequence, Tuple

ALERTS_LOG_NAME = "alerts.jsonl"

RULE_KINDS = ("threshold", "burn_rate")
_OPS: Dict[str, Callable[[float, float], bool]] = {
    ">": lambda a, b: a > b,
    ">=": lambda a, b: a >= b,
    "<": lambda a, b: a < b,
    "<=": lambda a, b: a <= b,
}

#: alert states (the full machine: inactive -> pending -> firing -> inactive)
INACTIVE, PENDING, FIRING = "inactive", "pending", "firing"


@dataclasses.dataclass(frozen=True)
class AlertRule:
    """One declarative rule.  ``metric`` selectors address the
    aggregator's snapshot keys: a bare name (``fleet_queue_depth``) or
    ``name{label=value}`` for a labeled series
    (``fleet_route_p99_seconds{route=/v1/similar}``)."""

    name: str
    kind: str = "threshold"          # threshold | burn_rate
    severity: str = "warn"           # free-form; "page"/"warn" by convention
    # -- threshold rules --------------------------------------------------
    metric: str = ""
    op: str = ">"
    value: float = 0.0
    # hysteresis: while firing, the value must cross BACK past
    # clear_value (default: value) and stay there for clear_for_s
    clear_value: Optional[float] = None
    # -- burn-rate rules --------------------------------------------------
    good: str = ""                   # cumulative "success" counter
    total: str = ""                  # cumulative "all events" counter
    max_bad_frac: float = 0.02       # (Δtotal-Δgood)/Δtotal ceiling
    short_window_s: float = 30.0
    long_window_s: float = 300.0
    min_count: float = 20.0          # Δtotal below this = no evidence
    # -- shared -----------------------------------------------------------
    for_s: float = 0.0               # debounce before firing (inclusive)
    clear_for_s: float = 30.0        # hysteresis hold before clearing
    # hold the rule when fewer replicas answered the current scrape;
    # set 0 for rules whose inputs are proxy-local counters (the
    # availability pair) — those stay fresh when every scrape fails
    min_fresh_targets: int = 1

    def validate(self) -> None:
        if not self.name:
            raise ValueError("alert rule needs a non-empty name")
        if self.kind not in RULE_KINDS:
            raise ValueError(
                f"rule {self.name!r}: kind must be one of {RULE_KINDS}, "
                f"got {self.kind!r}"
            )
        if self.kind == "threshold":
            if not self.metric:
                raise ValueError(
                    f"threshold rule {self.name!r} needs a 'metric'"
                )
            if self.op not in _OPS:
                raise ValueError(
                    f"rule {self.name!r}: op must be one of "
                    f"{sorted(_OPS)}, got {self.op!r}"
                )
        else:
            if not self.good or not self.total:
                raise ValueError(
                    f"burn_rate rule {self.name!r} needs 'good' and "
                    "'total' counter names"
                )
            if self.short_window_s <= 0 or (
                self.long_window_s < self.short_window_s
            ):
                raise ValueError(
                    f"rule {self.name!r}: need 0 < short_window_s <= "
                    "long_window_s"
                )
        if self.for_s < 0 or self.clear_for_s < 0:
            raise ValueError(
                f"rule {self.name!r}: for_s/clear_for_s must be >= 0"
            )


def parse_rules(doc: Dict) -> List[AlertRule]:
    """``{"rules": [...]}`` (an ``alerts.json`` document) → validated
    rules.  Unknown fields and duplicate names are errors — a typo'd
    threshold key must not silently produce a rule that never fires."""
    raw = doc.get("rules")
    if not isinstance(raw, list) or not raw:
        raise ValueError("alert rules document needs a non-empty 'rules' list")
    known = {f.name for f in dataclasses.fields(AlertRule)}
    rules: List[AlertRule] = []
    seen = set()
    for i, entry in enumerate(raw):
        if not isinstance(entry, dict):
            raise ValueError(f"rules[{i}] must be an object")
        unknown = set(entry) - known
        if unknown:
            raise ValueError(
                f"rules[{i}] ({entry.get('name', '?')!r}): unknown "
                f"field(s) {sorted(unknown)}"
            )
        rule = AlertRule(**entry)
        rule.validate()
        if rule.name in seen:
            raise ValueError(f"duplicate rule name {rule.name!r}")
        seen.add(rule.name)
        rules.append(rule)
    return rules


def load_rules(path: str) -> List[AlertRule]:
    with open(path, "r", encoding="utf-8") as f:
        return parse_rules(json.load(f))


def default_rules() -> List[AlertRule]:
    """The rules ``cli.fleet`` ships by default — one per SLO signal the
    aggregator computes (availability, route p99, rejection rate, queue
    depth).  Thresholds are the docs/SERVING.md capacity-planning
    values; override with ``--alert-rules <file>``."""
    return [
        AlertRule(
            name="availability-burn", kind="burn_rate", severity="page",
            good="fleet_ok", total="fleet_responses",
            max_bad_frac=0.02, short_window_s=30.0, long_window_s=300.0,
            min_count=20.0, for_s=0.0, clear_for_s=60.0,
            # the burn pair is PROXY-local (forwarded-response
            # counters), not replica-scraped: it stays perfectly fresh
            # during exactly the every-replica-wedged outage that
            # zeroes _fresh_targets, so the staleness hold must not
            # silence the page
            min_fresh_targets=0,
        ),
        AlertRule(
            name="route-p99", kind="threshold", severity="warn",
            metric="fleet_route_p99_seconds{route=/v1/similar}",
            # 0.5s sits an order of magnitude above the measured serve
            # p99 (BENCH_SERVE_r11: 0.8 ms single replica) yet clear of
            # the one-off jit-compile observations a cold replica's
            # cumulative histogram carries
            op=">", value=0.5, clear_value=0.25,
            for_s=15.0, clear_for_s=60.0,
        ),
        AlertRule(
            name="degraded-burn", kind="burn_rate", severity="warn",
            # sharded-fleet recall degradation (serve/shardgroup.py):
            # a response assembled from a PARTIAL shard gather is a
            # 200, so the availability burn never sees it — this rule
            # pages on the complete-answer fraction instead.  The
            # counter pair is proxy-local like availability-burn, so
            # the staleness hold must not silence it; on an unsharded
            # fleet fleet_degraded stays 0 and the rule never fires.
            good="fleet_undegraded", total="fleet_responses",
            max_bad_frac=0.05, short_window_s=30.0, long_window_s=300.0,
            min_count=20.0, for_s=0.0, clear_for_s=60.0,
            min_fresh_targets=0,
        ),
        AlertRule(
            name="shard-redundancy-lost", kind="threshold",
            severity="page",
            # replicated-shard fleets (--replicas-per-shard >= 2): some
            # shard's live replica count dropped to 1 (or 0) — ONE more
            # failure costs that shard's row fraction of recall.  This
            # is the page that precedes the degraded-burn page: fire
            # immediately (redundancy is already gone), clear only
            # after the supervisor re-admits a sibling and holds it.
            # The gauge counts shards below their configured redundancy
            # and exists only on sharded fleets — elsewhere the
            # selector is absent and the rule holds forever.
            metric="fleet_shards_redundancy_lost",
            op=">", value=0.0, for_s=0.0, clear_for_s=10.0,
            # supervisor-truth via the proxy process, not a replica
            # scrape: stays fresh during exactly the all-replicas-down
            # window it pages on
            min_fresh_targets=0,
        ),
        AlertRule(
            name="rejection-rate", kind="threshold", severity="warn",
            metric="fleet_rejection_rate",
            op=">", value=0.05, clear_value=0.01,
            for_s=5.0, clear_for_s=60.0,
        ),
        AlertRule(
            name="model-staleness", kind="threshold", severity="warn",
            # continuous-learning freshness (docs/CONTINUOUS.md): the
            # oldest served artifact across the fleet.  Two days is
            # deliberately generous — the loop retrains on study-batch
            # cadence, and a fleet quietly pinned to an old iteration
            # (every candidate quarantined, promotion wedged) must
            # FIRE, not linger; override per deployment cadence.
            metric="fleet_model_age_seconds_max",
            op=">", value=2 * 86400.0, clear_value=86400.0,
            for_s=60.0, clear_for_s=60.0,
        ),
        AlertRule(
            name="model-iteration-skew", kind="threshold",
            severity="warn",
            # replicas serving DIFFERENT iterations: normal for the
            # seconds a swap wave takes, never for minutes — a wedged
            # promotion (one replica quarantined its candidate, the
            # rest flipped) is exactly this signal held high
            metric="fleet_model_iteration_skew",
            op=">", value=0.0, for_s=120.0, clear_for_s=30.0,
        ),
        AlertRule(
            name="catalog-model-staleness", kind="threshold",
            severity="warn",
            # multi-model catalog fleets (serve/catalog.py): COUNT of
            # models whose freshest replica serves an artifact older
            # than the aggregator's model_stale_after_s.  Distinct from
            # model-staleness above, which watches the single oldest
            # artifact fleet-wide: in a catalog, one cold rarely-
            # retrained model would hold that rule firing forever while
            # a genuinely wedged sibling hides behind it — this rule
            # fires per-model, on the count.  The gauge exists only on
            # catalog fleets (mirrors shard-redundancy-lost) —
            # elsewhere the selector is absent and the rule holds.
            metric="fleet_models_stale",
            op=">", value=0.0, for_s=60.0, clear_for_s=60.0,
        ),
        AlertRule(
            name="queue-depth", kind="threshold", severity="warn",
            metric="fleet_queue_depth",
            op=">", value=192.0, clear_value=64.0,
            for_s=5.0, clear_for_s=60.0,
        ),
        AlertRule(
            name="jit-recompile-storm", kind="threshold",
            severity="warn",
            # compiles observed fleet-wide during the last scrape tick
            # (aggregate.py sums the replicas' jit_compile_events_total
            # counters and deltas them per tick).  A warm bucketed
            # engine compiles NOTHING in steady state — every padded
            # shape is in the jit cache — so sustained nonzero deltas
            # mean a shape leak or cache churn eating serve ticks
            # (the hazard class graftcheck's hlo-cache-stability pass
            # gates statically; this is the live-fleet view).  for_s
            # spans the legitimate compile burst of a cold replica or
            # an index-mode rollout warming its buckets.
            metric="fleet_jit_compile_delta",
            op=">", value=0.0, for_s=30.0, clear_for_s=60.0,
        ),
    ]


class RateLimiter:
    """Shared dump/bundle budget: at most one event per ``key`` per
    ``min_interval_s`` AND at most ``max_per_window`` events across ALL
    keys per ``window_s``.  The flight recorder's 5xx-burst dumps and
    the incident manager's bundles consult the SAME instance in the
    proxy process, so an error storm plus a flapping rule share one
    disk-write budget instead of multiplying each other."""

    def __init__(
        self,
        min_interval_s: float = 30.0,
        max_per_window: int = 8,
        window_s: float = 3600.0,
        clock=time.monotonic,
    ):
        self.min_interval_s = float(min_interval_s)
        self.max_per_window = int(max_per_window)
        self.window_s = float(window_s)
        self._clock = clock
        self._events: Deque[float] = collections.deque()
        self._last: Dict[str, float] = {}
        self.denied = 0
        self._lock = threading.Lock()

    def allow(self, key: str) -> bool:
        now = self._clock()
        with self._lock:
            while self._events and self._events[0] <= now - self.window_s:
                self._events.popleft()
            if len(self._events) >= self.max_per_window:
                self.denied += 1
                return False
            last = self._last.get(key)
            if last is not None and now - last < self.min_interval_s:
                self.denied += 1
                return False
            self._last[key] = now
            self._events.append(now)
            return True


class _RuleState:
    """Mutable evaluation state for one rule."""

    __slots__ = (
        "state", "pending_since", "clear_since", "value",
        "samples", "last_good", "last_total", "acc_good", "acc_total",
        "held",
    )

    def __init__(self):
        self.state = INACTIVE
        self.pending_since: Optional[float] = None
        self.clear_since: Optional[float] = None
        self.value: Optional[float] = None
        # burn-rate: reset-rebased cumulative (t, good, total) samples
        self.samples: Deque[Tuple[float, float, float]] = collections.deque()
        self.last_good: Optional[float] = None
        self.last_total: Optional[float] = None
        self.acc_good = 0.0
        self.acc_total = 0.0
        self.held = 0


class AlertEvaluator:
    """Streaming rule evaluation over aggregator snapshots.

    ``observe`` is called once per scrape tick with the flat snapshot
    the aggregator builds (headline gauges + labeled route quantiles +
    ``_fresh_targets``).  Transitions are appended to ``log_path``
    (``alerts.jsonl``), exported on ``registry``
    (``fleet_alert_active{rule=}``,
    ``fleet_alert_transitions_total{rule=,to=}``), and a transition to
    ``firing`` invokes ``on_fire(rule, snapshot, record)`` — which must
    not block (the fleet proxy hands it to the incident manager's
    background thread).
    """

    def __init__(
        self,
        rules: Sequence[AlertRule],
        registry=None,
        log_path: Optional[str] = None,
        on_fire: Optional[Callable[[AlertRule, Dict, Dict], None]] = None,
        clock=time.monotonic,
    ):
        names = [r.name for r in rules]
        if len(names) != len(set(names)):
            raise ValueError(f"duplicate rule names in {names}")
        self.rules = list(rules)
        self.registry = registry
        self.log_path = log_path
        self.on_fire = on_fire
        self._clock = clock
        self._states: Dict[str, _RuleState] = {
            r.name: _RuleState() for r in self.rules
        }
        self._lock = threading.Lock()
        if self.registry is not None:
            for r in self.rules:  # every rule visible from tick zero
                self.registry.gauge(
                    "fleet_alert_active", labels={"rule": r.name}
                ).set(0)

    # -- introspection -----------------------------------------------------

    def states(self) -> Dict[str, str]:
        with self._lock:
            return {name: st.state for name, st in self._states.items()}

    def firing(self) -> List[str]:
        with self._lock:
            return [
                name for name, st in self._states.items()
                if st.state == FIRING
            ]

    # -- evaluation --------------------------------------------------------

    def observe(
        self,
        snapshot: Dict[str, float],
        wall: Optional[float] = None,
        now: Optional[float] = None,
    ) -> List[Dict]:
        """Evaluate every rule against one snapshot; returns the
        transition records emitted this tick (tests assert on them)."""
        now = self._clock() if now is None else now
        wall = time.time() if wall is None else wall
        fresh = snapshot.get("_fresh_targets")
        transitions: List[Dict] = []
        fired: List[Tuple[AlertRule, Dict]] = []
        with self._lock:
            for rule in self.rules:
                st = self._states[rule.name]
                if fresh is not None and fresh < rule.min_fresh_targets:
                    # frozen data: neither fire nor clear on it — hold
                    st.held += 1
                    continue
                breach, hot, value = self._condition(rule, st, snapshot, now)
                if breach is None:
                    st.held += 1  # selector absent from this snapshot
                    continue
                st.value = value
                for rec in self._advance(rule, st, breach, hot, now, wall):
                    transitions.append(rec)
                    if rec["to"] == FIRING:
                        fired.append((rule, rec))
            if self.registry is not None:
                for rule in self.rules:
                    st = self._states[rule.name]
                    self.registry.gauge(
                        "fleet_alert_active", labels={"rule": rule.name}
                    ).set(1 if st.state == FIRING else 0)
        for rec in transitions:
            self._log(rec)
        if self.on_fire is not None:
            for rule, rec in fired:
                try:
                    self.on_fire(rule, dict(snapshot), rec)
                except Exception as e:  # alerting must outlive its sink
                    print(
                        f"alerts: on_fire({rule.name}) failed: {e!r}",
                        file=sys.stderr,
                    )
        return transitions

    def _condition(
        self, rule: AlertRule, st: _RuleState, snapshot: Dict[str, float],
        now: float,
    ):
        """(breach, still_hot, value) for one rule this tick; breach is
        None when the snapshot lacks the rule's inputs (→ hold).
        ``still_hot`` is the hysteresis condition: while firing, the
        alert only starts its clear timer once still_hot is False."""
        if rule.kind == "threshold":
            raw = snapshot.get(rule.metric)
            if raw is None:
                return None, None, None
            value = float(raw)
            cmp = _OPS[rule.op]
            clear_value = (
                rule.value if rule.clear_value is None else rule.clear_value
            )
            return cmp(value, rule.value), cmp(value, clear_value), value
        # burn_rate: rebase the cumulative pair (a restarted replica's
        # zeroed counters must never read as a negative — or a giant —
        # delta), then delta over the two windows
        g = snapshot.get(rule.good)
        t = snapshot.get(rule.total)
        if g is None or t is None:
            return None, None, None
        g, t = float(g), float(t)
        # first sample is the baseline; afterwards a value that went
        # BACKWARD is a counter reset — the raw value is the new
        # increment (the aggregator's own rebase rule)
        if st.last_good is not None:
            st.acc_good += (g - st.last_good) if g >= st.last_good else g
        if st.last_total is not None:
            st.acc_total += (t - st.last_total) if t >= st.last_total else t
        st.last_good, st.last_total = g, t
        st.samples.append((now, st.acc_good, st.acc_total))
        horizon = now - rule.long_window_s - 1.0
        while st.samples and st.samples[0][0] < horizon:
            st.samples.popleft()

        def frac_over(window_s: float) -> Optional[float]:
            # the newest sample at least window_s old (else the oldest:
            # a young series evaluates over the data it has)
            base = st.samples[0]
            for s in st.samples:
                if s[0] <= now - window_s:
                    base = s
                else:
                    break
            d_total = st.acc_total - base[2]
            if d_total < rule.min_count:
                return None  # not enough evidence either way
            d_bad = d_total - (st.acc_good - base[1])
            return max(0.0, d_bad) / d_total

        short = frac_over(rule.short_window_s)
        long_ = frac_over(rule.long_window_s)
        if short is None or long_ is None:
            return False, False, short
        breach = short > rule.max_bad_frac and long_ > rule.max_bad_frac
        # hysteresis for burn rates is the time hold (clear_for_s); the
        # hot condition is the short-window frac still over budget
        return breach, short > rule.max_bad_frac, short

    def _advance(
        self, rule: AlertRule, st: _RuleState, breach: bool, hot: bool,
        now: float, wall: float,
    ) -> List[Dict]:
        out: List[Dict] = []

        def move(to: str, **extra) -> None:
            rec = {
                "wall": wall,
                "rule": rule.name,
                "severity": rule.severity,
                "from": st.state,
                "to": to,
                "value": st.value,
                **extra,
            }
            st.state = to
            out.append(rec)
            if self.registry is not None:
                self.registry.counter(
                    "fleet_alert_transitions_total",
                    labels={"rule": rule.name, "to": to},
                ).inc()

        if st.state == INACTIVE and breach:
            st.pending_since = now
            move(PENDING)
        if st.state == PENDING:
            if not breach:
                st.pending_since = None
                move(INACTIVE)
            elif now - st.pending_since >= rule.for_s:  # boundary fires
                st.clear_since = None
                move(FIRING, for_s=rule.for_s)
        if st.state == FIRING:
            if hot:
                # hysteresis: any re-breach resets the clear timer; the
                # rule stays firing with NO flapping transitions
                st.clear_since = None
            else:
                if st.clear_since is None:
                    st.clear_since = now
                if now - st.clear_since >= rule.clear_for_s:
                    st.pending_since = None
                    st.clear_since = None
                    move(INACTIVE, cleared_after_s=rule.clear_for_s)
        return out

    def _log(self, rec: Dict) -> None:
        if not self.log_path:
            return
        try:
            with open(self.log_path, "a", encoding="utf-8") as f:
                f.write(json.dumps(rec, separators=(",", ":"),
                                   default=str) + "\n")
        except OSError as e:  # a full disk must not take alerting down
            print(f"alerts: cannot append {self.log_path}: {e!r}",
                  file=sys.stderr)


# -- timeline rendering (cli.obs alerts) --------------------------------------


def collect_transitions(root_dir: str) -> List[Dict]:
    """Every ``alerts.jsonl`` record under ``root_dir`` (a fleet run dir,
    or an export dir covering several), wall-ordered."""
    records: List[Dict] = []
    for dirpath, _, filenames in os.walk(root_dir):
        if ALERTS_LOG_NAME not in filenames:
            continue
        path = os.path.join(dirpath, ALERTS_LOG_NAME)
        try:
            with open(path, "r", encoding="utf-8") as f:
                for line in f:
                    line = line.strip()
                    if not line:
                        continue
                    try:
                        rec = json.loads(line)
                    except json.JSONDecodeError:
                        continue  # torn trailing line
                    rec["source"] = path
                    records.append(rec)
        except OSError:
            continue
    records.sort(key=lambda r: r.get("wall", 0.0))
    return records


def format_timeline(records: List[Dict]) -> str:
    """Human-readable alert timeline for ``cli.obs alerts``."""
    if not records:
        return "no alert transitions recorded"
    t0 = records[0].get("wall", 0.0)
    lines = [f"{len(records)} alert transition(s):"]
    active: Dict[str, str] = {}
    for rec in records:
        offset = (rec.get("wall", t0) or t0) - t0
        value = rec.get("value")
        shown = f" value={value:g}" if isinstance(value, (int, float)) else ""
        lines.append(
            f"  +{offset:8.1f}s {rec.get('to', '?').upper():8} "
            f"{rec.get('rule')} [{rec.get('severity')}]"
            f" (was {rec.get('from')}){shown}"
        )
        active[rec.get("rule", "?")] = rec.get("to", "?")
    firing = sorted(r for r, s in active.items() if s == FIRING)
    lines.append(
        "currently firing: " + (", ".join(firing) if firing else "none")
    )
    return "\n".join(lines)
