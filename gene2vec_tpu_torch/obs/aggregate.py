"""Fleet telemetry aggregation: scrape every replica, serve one view.

A fleet of N replicas exports N separate ``/metrics`` expositions;
nothing autoscaling (ROADMAP item 4) can act on lives in any single one
of them.  :class:`FleetAggregator` runs inside the front-door proxy
process, periodically scrapes every live replica's ``/metrics`` plus
the proxy's own registry, and maintains a merged **fleet-level view**
served at ``/metrics/fleet``:

* ``fleet_availability`` — ok / total over the proxy's forwarded
  responses (the client-observed number, not a replica's self-report);
* ``fleet_route_p50_seconds{route=...}`` / ``fleet_route_p99_seconds``
  — per-route latency quantiles estimated from the replicas' merged
  ``serve_route_seconds`` histogram buckets (bucket upper bounds, so
  estimates are conservative);
* ``fleet_queue_depth`` — Σ replica ``serve_queue_depth``;
* ``fleet_rejection_rate`` — Σ ``serve_rejected_total`` / Σ
  ``serve_requests_total``;
* raw sums (``fleet_requests``, ``fleet_rejected``,
  ``fleet_ok``, ``fleet_responses``) so dashboards and the
  chaos drill can do exact delta math across a load window — monotone
  series (counters, histogram buckets) are accumulated per replica
  with reset detection, so a replica dying or restarting with zeroed
  counters never makes a fleet sum go backward;
* scrape health: ``fleet_replicas_scraped``,
  ``fleet_scrape_errors_total``, and per-target
  ``fleet_scrape_staleness{target=}`` (consecutive missed scrapes; a
  target missing ``stale_after`` scrapes in a row is **stale** — its
  frozen histogram history is excluded from the per-route quantile
  estimates, and the snapshot handed to the alert evaluator carries
  ``_fresh_targets`` so rules hold instead of evaluating frozen data).

Every scrape also appends one CSV row (``fleet_telemetry.csv`` in the
fleet run dir) through the registry's CSV sink, so the load-signal
history survives the process.

The Prometheus text parser here is the escape-aware inverse of
``obs/registry.py``'s exposition (label values may contain ``\\``,
``"``, and newlines); ``tests/test_tracing.py`` round-trips them.
"""

from __future__ import annotations

import collections
import dataclasses
import math
import threading
import time
import urllib.request
from typing import Callable, Dict, List, Optional, Sequence, Tuple, Union

from gene2vec_tpu_torch.obs.registry import MetricsRegistry, unescape_label_value

#: canonical label-set key: sorted (k, v) tuples
LabelKey = Tuple[Tuple[str, str], ...]


@dataclasses.dataclass(frozen=True)
class Sample:
    """One exposition line: ``name{labels} value``."""

    name: str
    labels: LabelKey
    value: float

    def label(self, key: str) -> Optional[str]:
        for k, v in self.labels:
            if k == key:
                return v
        return None


def _parse_labels(body: str) -> Optional[LabelKey]:
    """Parse the inside of ``{...}`` respecting escaped quotes; None on
    malformed input (a scrape must never crash the aggregator)."""
    labels: List[Tuple[str, str]] = []
    i = 0
    n = len(body)
    while i < n:
        eq = body.find("=", i)
        if eq < 0:
            return None
        key = body[i:eq].strip().strip(",").strip()
        if not key:
            return None
        j = eq + 1
        if j >= n or body[j] != '"':
            return None
        j += 1
        raw: List[str] = []
        while j < n:
            c = body[j]
            if c == "\\" and j + 1 < n:
                raw.append(body[j:j + 2])
                j += 2
                continue
            if c == '"':
                break
            raw.append(c)
            j += 1
        if j >= n:
            return None  # unterminated value
        labels.append((key, unescape_label_value("".join(raw))))
        i = j + 1
    return tuple(sorted(labels))


def parse_prometheus(text: str) -> List[Sample]:
    """Parse a text exposition into samples, skipping comments and any
    malformed line (tolerant by design: one bad line must not discard a
    replica's whole scrape)."""
    out: List[Sample] = []
    for line in text.splitlines():
        line = line.strip()
        if not line or line.startswith("#"):
            continue
        if "{" in line:
            brace = line.index("{")
            name = line[:brace]
            end = line.rfind("}")
            if end < brace:
                continue
            labels = _parse_labels(line[brace + 1:end])
            if labels is None:
                continue
            rest = line[end + 1:].strip()
        else:
            name, _, rest = line.partition(" ")
            labels = ()
            rest = rest.strip()
        if not name or not rest:
            continue
        value_str = rest.split()[0]
        try:
            value = float(value_str.replace("+Inf", "inf"))
        except ValueError:
            continue
        out.append(Sample(name, labels, value))
    return out


def merge_samples(
    scrapes: Sequence[Sequence[Sample]],
) -> Dict[Tuple[str, LabelKey], float]:
    """Sum samples across replicas by (name, label set) — the right
    merge for counters, cumulative histogram buckets, and additive
    gauges like queue depth."""
    merged: Dict[Tuple[str, LabelKey], float] = {}
    for samples in scrapes:
        for s in samples:
            key = (s.name, s.labels)
            merged[key] = merged.get(key, 0.0) + s.value
    return merged


def histogram_quantile(
    merged: Dict[Tuple[str, LabelKey], float],
    name: str,
    labels: LabelKey,
    q: float,
) -> Optional[float]:
    """Quantile estimate from merged cumulative ``<name>_bucket``
    samples matching ``labels`` (+ their ``le``): the smallest bucket
    upper bound whose cumulative count covers ``q`` of observations.
    A quantile landing in the ``+Inf`` bucket SATURATES to the largest
    finite bucket bound — a truthful "at least this" that keeps the
    fleet gauges moving during exactly the overload they exist to
    expose (skipping the update would freeze them at the pre-overload
    value).  None when the histogram is empty or absent."""
    buckets: List[Tuple[float, float]] = []
    for (n, lk), value in merged.items():
        if n != f"{name}_bucket":
            continue
        le = None
        rest = []
        for k, v in lk:
            if k == "le":
                le = v
            else:
                rest.append((k, v))
        if le is None or tuple(sorted(rest)) != labels:
            continue
        try:
            buckets.append((float(le.replace("+Inf", "inf")), value))
        except ValueError:
            continue
    if not buckets:
        return None
    buckets.sort()
    total = buckets[-1][1]
    if total <= 0:
        return None
    finite = [le for le, _ in buckets if math.isfinite(le)]
    target = q * total
    for le, cum in buckets:
        if cum >= target:
            if math.isfinite(le):
                return le
            break
    return max(finite) if finite else None


def histogram_routes(
    merged: Dict[Tuple[str, LabelKey], float], name: str
) -> List[LabelKey]:
    """Distinct non-``le`` label sets present for ``<name>_bucket``."""
    seen = set()
    for (n, lk), _ in merged.items():
        if n != f"{name}_bucket":
            continue
        rest = tuple(sorted((k, v) for k, v in lk if k != "le"))
        seen.add(rest)
    return sorted(seen)


def _default_fetch(url: str, timeout_s: float) -> str:
    with urllib.request.urlopen(f"{url}/metrics", timeout=timeout_s) as r:
        return r.read().decode("utf-8")


class FleetAggregator:
    """Periodic scraper + merged fleet-level metrics view.

    ``targets`` is a list of replica base URLs or a zero-arg callable
    returning the current list (the supervisor's live set).
    ``proxy_registry`` is the front door's own registry — the source of
    the client-observed availability counters.  ``fetch`` and ``clock``
    are injectable for tests.
    """

    #: replica histogram whose buckets back the per-route quantiles
    ROUTE_HISTOGRAM = "serve_route_seconds"

    def __init__(
        self,
        targets: Union[Sequence[str], Callable[[], Sequence[str]]],
        proxy_registry: Optional[MetricsRegistry] = None,
        interval_s: float = 2.0,
        csv_path: Optional[str] = None,
        fetch: Callable[[str, float], str] = _default_fetch,
        timeout_s: float = 2.0,
        evaluator=None,
        stale_after: int = 3,
        raw_window_records: int = 512,
    ):
        self._targets = targets
        self.proxy_registry = proxy_registry
        self.interval_s = interval_s
        self.timeout_s = timeout_s
        self._fetch = fetch
        #: optional obs.alerts.AlertEvaluator fed one snapshot per tick
        self.evaluator = evaluator
        #: sharded-fleet hooks (cli.fleet wires them for
        #: --shard-by-rows): ``shard_of(url) -> shard index`` maps a
        #: scrape target onto its row shard so per-shard queue depth
        #: and scatter p99 can be projected out of the merge, and
        #: ``shard_facts() -> {shard: {"up": n, "desired": r}}`` is the
        #: supervisor's redundancy view behind
        #: ``fleet_shard_replicas_up{shard=}`` and the
        #: ``shard-redundancy-lost`` alert.  Both None on an unsharded
        #: fleet — no per-shard series exist and the alert rule holds.
        self.shard_of: Optional[Callable[[str], Optional[int]]] = None
        self.shard_facts: Optional[Callable[[], Dict]] = None
        #: shards whose queue/p99 series were published last round —
        #: a shard that stops reporting (every replica down or stale)
        #: has its labeled gauges RETIRED, not frozen: a dead shard
        #: showing its last queue depth on /metrics is the stale-skew
        #: trap the model-fact gauges already guard against
        self._shard_queue_series: set = set()
        self._shard_p99_series: set = set()
        #: catalog-fleet hooks (cli.fleet wires them for --catalog):
        #: ``model_of(url) -> model name`` maps a scrape target onto
        #: its catalog model so per-model queue depth can be projected
        #: out of the merge and the iteration-skew headline can group
        #: by model (skew ACROSS models is expected — each trains on
        #: its own cadence), and ``model_pool_facts() -> {name: up}``
        #: is the supervisor's per-model redundancy view behind
        #: ``fleet_model_replicas_up{model=}``.  Both None on a
        #: single-model fleet — no per-model series exist.
        self.model_of: Optional[Callable[[str], Optional[str]]] = None
        self.model_pool_facts: Optional[Callable[[], Dict]] = None
        #: a model whose FRESHEST replica serves an artifact older than
        #: this counts into the ``fleet_models_stale`` gauge (the
        #: per-model staleness alert's input)
        self.model_stale_after_s: float = 2 * 86400.0
        self._model_queue_series: set = set()
        self._model_age_series: set = set()
        #: additional per-tick snapshot consumers, called AFTER the
        #: evaluator with the same (snapshot, wall) — the autoscaler
        #: (serve/autoscale.py ElasticController.observe) registers
        #: here.  Each observer is exception-isolated: a scaling bug
        #: must not cost a telemetry tick.
        self.observers: List[Callable[..., None]] = []
        #: consecutive missed scrapes before a target's series go stale
        self.stale_after = int(stale_after)
        #: the merged fleet-level registry served at /metrics/fleet
        self.view = MetricsRegistry()
        if csv_path:
            self.view.attach_csv(csv_path)
        self._scrapes = 0
        # per-target consecutive-miss counts (exported as
        # fleet_scrape_staleness{target=}); >= stale_after -> stale
        self._missed: Dict[str, int] = {}
        # targets whose per-replica model facts are currently exported
        # (fleet_model_iteration{target=}); departures retire them
        self._model_targets: set = set()
        # last-known model facts per target — carried through missed
        # scrapes until the target goes stale, so the skew/age headline
        # doesn't flicker on a single flaky scrape
        self._model_facts: Dict[str, Dict[str, float]] = {}
        # last fleet-summed jit_compile_events_total — None until the
        # first scrape, so the first observation seeds the baseline and
        # fleet_jit_compile_delta starts at 0 rather than the fleet's
        # whole compile history
        self._last_compile_sum: Optional[float] = None
        # bounded ring of RAW per-target scrapes — the UN-merged series
        # an incident bundle files so per-replica attribution survives
        self._raw_ring: "collections.deque" = collections.deque(
            maxlen=int(raw_window_records)
        )
        # per-(target, series) monotone-counter state: (last_raw,
        # accumulated).  A replica that dies keeps its accumulated
        # contribution, and one that restarts (counters back at 0) is
        # detected by raw < last and resumes accumulating — so the
        # fleet sums never go backward and window delta math stays
        # honest across exactly the SIGKILL the fleet exists to absorb.
        # Targets that leave the target LIST (a dead replica respawns
        # on a fresh ephemeral port; its old URL never returns) are
        # retired: their accumulation folds into _retired, bounding
        # per-target state in a long-lived proxy.  A scrape FAILURE is
        # not retirement — a blackholed replica stays listed and keeps
        # its live state.
        self._counter_state: Dict[
            Tuple[str, str, LabelKey], Tuple[float, float]
        ] = {}
        self._retired: Dict[Tuple[str, LabelKey], float] = {}
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self._lock = threading.Lock()

    def targets(self) -> List[str]:
        t = self._targets() if callable(self._targets) else self._targets
        return [u.rstrip("/") for u in t]

    @staticmethod
    def _monotone(name: str) -> bool:
        """Series that only ever grow on a live replica: counters and
        cumulative histogram components.  These are retained across
        replica death/restart; gauges (queue depth) are live-only."""
        return name.endswith(("_total", "_bucket", "_count", "_sum"))

    def _accumulate(self, target: str, samples: List[Sample]) -> None:
        for s in samples:
            if not self._monotone(s.name):
                continue
            key = (target, s.name, s.labels)
            last, acc = self._counter_state.get(key, (0.0, 0.0))
            inc = s.value - last if s.value >= last else s.value
            self._counter_state[key] = (s.value, acc + inc)

    # -- one scrape --------------------------------------------------------

    def scrape_once(self) -> Dict[str, float]:
        """Scrape every target, merge, refresh the view, append the CSV
        row.  Returns the headline values (tests assert on them).

        Targets are fetched CONCURRENTLY: one wedged/blackholed replica
        costs its own timeout, not everyone's scrape cadence (the same
        lesson the fleet supervisor's health probes learned)."""
        target_list = self.targets()
        results: Dict[str, List[Sample]] = {}

        def one(url: str) -> None:
            try:
                results[url] = parse_prometheus(
                    self._fetch(url, self.timeout_s)
                )
            except Exception:
                pass  # absent from results -> counted as a scrape error

        fetchers = [
            threading.Thread(
                target=lambda u=u: one(u), daemon=True
            )
            for u in target_list
        ]
        for t in fetchers:
            t.start()
        deadline = time.monotonic() + self.timeout_s + 1.0
        for t in fetchers:
            t.join(timeout=max(0.0, deadline - time.monotonic()))
        ok_targets = 0
        scrape_wall = time.time()
        scrapes: List[List[Sample]] = []
        with self._lock:
            for url in target_list:
                samples = results.get(url)
                if samples is None:
                    # fetch raised or is still stuck past the deadline
                    self.view.counter(
                        "fleet_scrape_errors_total",
                        "replica /metrics scrapes that failed",
                    ).inc()
                    self._missed[url] = self._missed.get(url, 0) + 1
                    continue
                self._missed[url] = 0
                ok_targets += 1
                scrapes.append(samples)
                self._accumulate(url, samples)
                # raw (un-merged) window ring for incident bundles:
                # which REPLICA's series went bad must survive the merge
                self._raw_ring.append({
                    "wall": scrape_wall,
                    "target": url,
                    "samples": {
                        s.name + (
                            "{" + ",".join(
                                f"{k}={v}" for k, v in s.labels
                            ) + "}" if s.labels else ""
                        ): s.value
                        for s in samples
                    },
                })
            # staleness bookkeeping: consecutive misses per LISTED
            # target; a departed URL's series is REMOVED, not zeroed —
            # ephemeral-port targets never recur, and a crash-looping
            # replica must not grow /metrics/fleet one dead
            # target= label set per restart
            current_targets = set(target_list)
            for url in [u for u in self._missed if u not in current_targets]:
                del self._missed[url]
                self.view.remove(
                    "fleet_scrape_staleness", labels={"target": url}
                )
            stale = {
                url for url, n in self._missed.items()
                if n >= self.stale_after
            }
            for url in target_list:
                self.view.gauge(
                    "fleet_scrape_staleness", labels={"target": url}
                ).set(self._missed.get(url, 0))
            # per-replica served-model facts (docs/CONTINUOUS.md): which
            # iteration each target serves and how old its artifact is.
            # A fleet silently wedged on an old iteration (quarantined
            # candidate, half-finished promotion) shows up here as
            # iteration skew / growing age — the default staleness and
            # skew alert rules watch the fleet-level reductions below.
            for url in target_list:
                samples = results.get(url)
                if samples is None:
                    # missed scrape: keep the last-known facts until the
                    # target goes STALE (same tolerance as the quantile
                    # machinery) — one flaky scrape must not zero the
                    # skew headline and reset a skew alert's debounce
                    # exactly when a wedged replica matters most
                    if url in stale:
                        self._model_facts.pop(url, None)
                    continue
                facts: Dict[str, float] = {}
                for s in samples:
                    if s.name in (
                        "model_iteration", "model_age_seconds"
                    ) and not s.labels:
                        facts[s.name] = s.value
                if facts:
                    self._model_facts[url] = facts
                else:
                    # scraped fine but reports no model facts (replica
                    # restarted unloaded): genuinely gone, retire both
                    # the cached facts and the per-target series
                    self._model_facts.pop(url, None)
                    for gauge in (
                        "fleet_model_iteration",
                        "fleet_model_age_seconds",
                    ):
                        self.view.remove(gauge, labels={"target": url})
                for name, gauge in (
                    ("model_iteration", "fleet_model_iteration"),
                    ("model_age_seconds", "fleet_model_age_seconds"),
                ):
                    if name in facts:
                        self.view.gauge(
                            gauge, labels={"target": url}
                        ).set(facts[name])
            model_facts = {
                u: f for u, f in self._model_facts.items()
                if u in set(target_list)
            }
            for url in [
                u for u in self._model_targets
                if u not in set(target_list)
            ]:
                # departed targets retire their labeled series like the
                # staleness gauges do — ephemeral ports never recur
                for gauge in (
                    "fleet_model_iteration", "fleet_model_age_seconds"
                ):
                    self.view.remove(gauge, labels={"target": url})
                self._model_facts.pop(url, None)
            self._model_targets = set(target_list)
            # group per-target facts by served catalog model: iteration
            # skew ACROSS models is expected (each model trains on its
            # own cadence), so in a catalog fleet the skew headline is
            # the max WITHIN-model skew — a heterogeneous two-model
            # fleet must not hold the skew alert firing forever.  On a
            # single-model fleet every target lands in one group and
            # the math is unchanged.
            groups: Dict[Optional[str], List[Dict[str, float]]] = {}
            for u, f in model_facts.items():
                m = (
                    self.model_of(u)
                    if self.model_of is not None else None
                )
                groups.setdefault(m, []).append(f)
            iters = [
                f["model_iteration"] for f in model_facts.values()
                if "model_iteration" in f
            ]
            ages = [
                f["model_age_seconds"] for f in model_facts.values()
                if "model_age_seconds" in f
            ]
            model_headline: Dict[str, float] = {}
            if iters:
                model_headline["fleet_model_iteration_min"] = min(iters)
                model_headline["fleet_model_iteration_max"] = max(iters)
                skews = []
                for fs in groups.values():
                    gi = [
                        f["model_iteration"] for f in fs
                        if "model_iteration" in f
                    ]
                    if gi:
                        skews.append(max(gi) - min(gi))
                model_headline["fleet_model_iteration_skew"] = (
                    max(skews) if skews else 0.0
                )
            if ages:
                model_headline["fleet_model_age_seconds_max"] = max(ages)
            # per-model labeled age + the stale-models count: a model
            # counts as stale only when even its FRESHEST replica's
            # artifact is old — one lagging replica is iteration skew's
            # problem, a whole model nobody retrains is this one's
            pub_age_models: set = set()
            stale_models = 0
            for m in sorted(k for k in groups if k is not None):
                ga = [
                    f["model_age_seconds"] for f in groups[m]
                    if "model_age_seconds" in f
                ]
                if not ga:
                    continue
                self.view.gauge(
                    "fleet_model_age_seconds_max", labels={"model": m}
                ).set(max(ga))
                model_headline[
                    f"fleet_model_age_seconds_max{{model={m}}}"
                ] = max(ga)
                pub_age_models.add(m)
                if min(ga) > self.model_stale_after_s:
                    stale_models += 1
            for m in self._model_age_series - pub_age_models:
                self.view.remove(
                    "fleet_model_age_seconds_max", labels={"model": m}
                )
            self._model_age_series = pub_age_models
            if pub_age_models:
                self.view.gauge("fleet_models_stale").set(stale_models)
                model_headline["fleet_models_stale"] = float(stale_models)
            else:
                # no named models reporting: retire the count like the
                # per-target series — a frozen stale-count would hold
                # the per-model staleness alert firing forever
                self.view.remove("fleet_models_stale")
            for key in (
                "fleet_model_iteration_min",
                "fleet_model_iteration_max",
                "fleet_model_iteration_skew",
                "fleet_model_age_seconds_max",
            ):
                if key in model_headline:
                    self.view.gauge(key).set(model_headline[key])
                else:
                    # model facts gone (every scrape missed, or the
                    # replicas restarted unloaded): retire the headline
                    # like the per-target series — a stale skew gauge
                    # would hold a skew alert firing forever
                    self.view.remove(key)
            # fold state for targets no longer LISTED into the retired
            # baseline (caveat: a target re-listed later under the SAME
            # url restarts from its current raw value — supervisor
            # fleets never reuse urls, and static target lists never
            # unlist, so neither path double-counts in practice)
            for key in [
                k for k in self._counter_state
                if k[0] not in current_targets
            ]:
                _target, name, labels = key
                _last, acc = self._counter_state.pop(key)
                rkey = (name, labels)
                self._retired[rkey] = self._retired.get(rkey, 0.0) + acc
            # monotone series come from the RETAINED accumulation (dead
            # replicas keep their history); live-only series merge from
            # this round's successful scrapes
            merged = {
                key: value
                for key, value in merge_samples(scrapes).items()
                if not self._monotone(key[0])
            }
            # quantile estimates use FRESH histogram history only: a
            # stale (or retired) target's buckets are frozen — letting
            # them keep weighing the percentile would freeze exactly
            # the gauge an alert rule is watching (the staleness
            # satellite's contract); fleet SUMS still include every
            # accumulation so counters never go backward
            fresh_hist: Dict[Tuple[str, LabelKey], float] = {}
            # per-shard projections (replicated-shard fleets): the same
            # fresh-histogram rule, bucketed by the target's shard, so
            # the per-shard autoscaler sees ITS pool's scatter latency
            shard_hist: Dict[int, Dict[Tuple[str, LabelKey], float]] = {}
            for (
                (target, name, labels), (_last, acc)
            ) in self._counter_state.items():
                key = (name, labels)
                merged[key] = merged.get(key, 0.0) + acc
                if target not in stale and name.startswith(
                    self.ROUTE_HISTOGRAM
                ):
                    fresh_hist[key] = fresh_hist.get(key, 0.0) + acc
                    if self.shard_of is not None:
                        s = self.shard_of(target)
                        if s is not None:
                            h = shard_hist.setdefault(s, {})
                            h[key] = h.get(key, 0.0) + acc
            for rkey, acc in self._retired.items():
                merged[rkey] = merged.get(rkey, 0.0) + acc
            shard_queue: Dict[int, float] = {}
            if self.shard_of is not None:
                # live-only like the fleet queue gauge: this round's
                # successful scrapes, summed per shard
                for url in target_list:
                    samples = results.get(url)
                    if samples is None:
                        continue
                    s = self.shard_of(url)
                    if s is None:
                        continue
                    for smp in samples:
                        if smp.name == "serve_queue_depth":
                            shard_queue[s] = (
                                shard_queue.get(s, 0.0) + smp.value
                            )
            model_queue: Dict[str, float] = {}
            if self.model_of is not None:
                # per-model pool pressure, live-only like the shard
                # twin: each target's whole queue depth (labeled or
                # not) belongs to exactly one model in a catalog fleet
                for url in target_list:
                    samples = results.get(url)
                    if samples is None:
                        continue
                    m = self.model_of(url)
                    if m is None:
                        continue
                    for smp in samples:
                        if smp.name == "serve_queue_depth":
                            model_queue[m] = (
                                model_queue.get(m, 0.0) + smp.value
                            )

        def msum(name: str) -> float:
            return sum(
                v for (n, _), v in merged.items() if n == name
            )

        requests = msum("serve_requests_total")
        rejected = msum("serve_rejected_total")
        # the tenant-labeled slice of the rejections: per-tenant quota
        # shedding (serve/tenancy.py).  Kept distinct so the autoscaler
        # can scale on CAPACITY rejections (queue-full, unlabeled) and
        # not on traffic a quota is deliberately rejecting.
        quota_rejected = sum(
            v for (n, lk), v in merged.items()
            if n == "serve_rejected_total"
            and any(k == "tenant" for k, _ in lk)
        )
        queue_depth = msum("serve_queue_depth")
        rejection_rate = (rejected / requests) if requests > 0 else 0.0
        # fleet-wide jit compile events: replicas mirror their
        # CompileWatcher into the monotone jit_compile_events_total
        # counter (reset-rebased across restarts by the merge above);
        # the per-tick delta is what the default jit-recompile-storm
        # rule watches — compiles during steady-state serving are a
        # recompile storm.  The first scrape only seeds the baseline,
        # so an aggregator joining a warm fleet never false-fires on
        # the backlog.
        jit_compiles = msum("jit_compile_events_total")
        if self._last_compile_sum is None:
            compile_delta = 0.0
        else:
            compile_delta = max(
                0.0, jit_compiles - self._last_compile_sum
            )
        self._last_compile_sum = jit_compiles

        ok_total = total = throttled = degraded = 0.0
        if self.proxy_registry is not None:
            ok_total = self.proxy_registry.counter(
                "fleet_proxy_ok_total"
            ).value
            total = self.proxy_registry.counter(
                "fleet_proxy_responses_total"
            ).value
            throttled = self.proxy_registry.counter(
                "fleet_proxy_429_total"
            ).value
            # sharded-fleet degradation: 200s built from a PARTIAL
            # shard gather (serve/shardgroup.py).  Exported alongside
            # the plain availability pair — and as the good-counter
            # complement fleet_undegraded, so the degraded-burn alert
            # rule can treat "complete answer" as the good event.
            degraded = self.proxy_registry.counter(
                "fleet_degraded_responses_total"
            ).value
        availability = (ok_total / total) if total > 0 else 1.0
        undegraded = max(0.0, total - degraded)

        # the flat snapshot handed to the alert evaluator: headline
        # values, the raw availability counter pair (burn-rate rules
        # delta them), labeled route quantiles, and the freshness facts
        # that let rules HOLD instead of evaluating frozen data
        snapshot: Dict[str, float] = {}
        with self._lock:
            self._scrapes += 1
            v = self.view
            v.gauge("fleet_replicas_scraped").set(ok_targets)
            v.gauge("fleet_queue_depth").set(queue_depth)
            v.gauge("fleet_requests").set(requests)
            v.gauge("fleet_rejected").set(rejected)
            v.gauge("fleet_quota_rejected").set(quota_rejected)
            v.gauge("fleet_rejection_rate").set(rejection_rate)
            v.gauge("fleet_ok").set(ok_total)
            v.gauge("fleet_responses").set(total)
            v.gauge("fleet_throttled").set(throttled)
            v.gauge("fleet_degraded").set(degraded)
            v.gauge("fleet_undegraded").set(undegraded)
            v.gauge("fleet_availability").set(availability)
            v.gauge("fleet_stale_targets").set(len(stale))
            v.gauge("fleet_last_scrape_unix").set(scrape_wall)
            v.gauge("fleet_jit_compiles").set(jit_compiles)
            v.gauge("fleet_jit_compile_delta").set(compile_delta)
            for labels in histogram_routes(fresh_hist, self.ROUTE_HISTOGRAM):
                label_dict = dict(labels)
                for gauge_name, q in (
                    ("fleet_route_p50_seconds", 0.50),
                    ("fleet_route_p99_seconds", 0.99),
                ):
                    quant = histogram_quantile(
                        fresh_hist, self.ROUTE_HISTOGRAM, labels, q
                    )
                    if quant is not None and math.isfinite(quant):
                        v.gauge(gauge_name, labels=label_dict).set(quant)
                        suffix = ",".join(
                            f"{k}={val}" for k, val in sorted(
                                label_dict.items()
                            )
                        )
                        snapshot[f"{gauge_name}{{{suffix}}}"] = quant
            # per-shard pool signals + the redundancy view
            # (docs/SERVING.md#replicated-shards): queue depth and
            # scatter p99 per shard feed the per-shard autoscaler;
            # fleet_shard_replicas_up{shard=} + the
            # fleet_shards_redundancy_lost headline feed the
            # shard-redundancy-lost alert — the page that precedes the
            # recall-degradation page
            if self.shard_of is not None:
                pub_queue: set = set()
                pub_p99: set = set()
                for s, q in sorted(shard_queue.items()):
                    v.gauge(
                        "fleet_shard_queue_depth",
                        labels={"shard": str(s)},
                    ).set(q)
                    snapshot[f"fleet_shard_queue_depth{{shard={s}}}"] = q
                    pub_queue.add(s)
                topk_labels = (("route", "/v1/shard/topk"),)
                for s, hist in sorted(shard_hist.items()):
                    quant = histogram_quantile(
                        hist, self.ROUTE_HISTOGRAM, topk_labels, 0.99
                    )
                    if quant is not None and math.isfinite(quant):
                        v.gauge(
                            "fleet_shard_p99_seconds",
                            labels={"shard": str(s)},
                        ).set(quant)
                        snapshot[
                            f"fleet_shard_p99_seconds{{shard={s}}}"
                        ] = quant
                        pub_p99.add(s)
                # a shard with no fresh evidence this round retires its
                # series (the snapshot above is already rebuilt fresh,
                # so this only stops /metrics/fleet from freezing a
                # dead shard's last queue/p99 forever)
                for name, pub, prev in (
                    ("fleet_shard_queue_depth", pub_queue,
                     self._shard_queue_series),
                    ("fleet_shard_p99_seconds", pub_p99,
                     self._shard_p99_series),
                ):
                    for s in prev - pub:
                        v.remove(name, labels={"shard": str(s)})
                self._shard_queue_series = pub_queue
                self._shard_p99_series = pub_p99
            if self.shard_facts is not None:
                try:
                    facts = self.shard_facts() or {}
                except Exception:
                    facts = {}
                lost = 0
                for s, f in sorted(facts.items()):
                    up = float(f.get("up", 0))
                    v.gauge(
                        "fleet_shard_replicas_up",
                        labels={"shard": str(s)},
                    ).set(up)
                    snapshot[f"fleet_shard_replicas_up{{shard={s}}}"] = up
                    if float(f.get("desired", 1)) >= 2 and up < 2:
                        lost += 1
                if facts:
                    v.gauge("fleet_shards_redundancy_lost").set(lost)
                    snapshot["fleet_shards_redundancy_lost"] = float(lost)
            # per-model pool signals (docs/SERVING.md#multi-model-
            # catalog): queue depth per model feeds the (model, shard)
            # pool autoscaler; fleet_model_replicas_up{model=} is the
            # per-model redundancy view.  Retirement mirrors the shard
            # series — a model whose every replica went dark must not
            # freeze its last queue depth on /metrics/fleet.
            if self.model_of is not None:
                pub_mq: set = set()
                for m, q in sorted(model_queue.items()):
                    v.gauge(
                        "fleet_model_queue_depth", labels={"model": m}
                    ).set(q)
                    snapshot[f"fleet_model_queue_depth{{model={m}}}"] = q
                    pub_mq.add(m)
                for m in self._model_queue_series - pub_mq:
                    v.remove(
                        "fleet_model_queue_depth", labels={"model": m}
                    )
                self._model_queue_series = pub_mq
            if self.model_pool_facts is not None:
                try:
                    mfacts = self.model_pool_facts() or {}
                except Exception:
                    mfacts = {}
                for m, up in sorted(mfacts.items()):
                    v.gauge(
                        "fleet_model_replicas_up",
                        labels={"model": str(m)},
                    ).set(float(up))
                    snapshot[
                        f"fleet_model_replicas_up{{model={m}}}"
                    ] = float(up)
            headline = {
                "fleet_availability": availability,
                "fleet_queue_depth": queue_depth,
                "fleet_rejection_rate": rejection_rate,
                "fleet_replicas_scraped": float(ok_targets),
                "fleet_requests": requests,
                "fleet_rejected": rejected,
            }
            snapshot.update(headline)
            snapshot.update(model_headline)
            snapshot.update({
                "fleet_ok": ok_total,
                "fleet_responses": total,
                "fleet_throttled": throttled,
                "fleet_degraded": degraded,
                "fleet_undegraded": undegraded,
                "fleet_quota_rejected": quota_rejected,
                "fleet_stale_targets": float(len(stale)),
                "fleet_jit_compiles": jit_compiles,
                "fleet_jit_compile_delta": compile_delta,
                "_fresh_targets": float(ok_targets),
            })
            # CSV history: one row per scrape through the standard sink
            v.log_row(self._scrapes, headline)
        if self.evaluator is not None:
            # outside the view lock: the evaluator takes its own lock
            # and writes alert gauges back through the registry's
            self.evaluator.observe(snapshot, wall=scrape_wall)
        for observer in list(self.observers):
            try:
                observer(snapshot, wall=scrape_wall)
            except Exception:
                self.view.counter(
                    "fleet_observer_errors_total",
                    "snapshot observers (autoscaler) that raised",
                ).inc()
        return headline

    def raw_recent(self) -> List[Dict]:
        """The raw per-target scrape ring (newest last) — what an
        incident bundle files as ``metrics_window.json``."""
        with self._lock:
            return list(self._raw_ring)

    def fleet_text(self) -> str:
        """The ``/metrics/fleet`` exposition."""
        with self._lock:
            return self.view.prometheus_text()

    # -- lifecycle ---------------------------------------------------------

    def start(self) -> "FleetAggregator":
        if self._thread is None:
            self._stop.clear()
            self._thread = threading.Thread(
                target=self._loop, name="fleet-aggregator", daemon=True
            )
            self._thread.start()
        return self

    def _loop(self) -> None:
        while not self._stop.wait(self.interval_s):
            try:
                self.scrape_once()
            except Exception:
                # aggregation must outlive surprises; the error counter
                # above records per-target trouble, this guards the rest
                self.view.counter("fleet_scrape_errors_total").inc()

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=10.0)
            self._thread = None
        self.view.close()
