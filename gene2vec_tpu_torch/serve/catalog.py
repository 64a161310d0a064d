"""Multi-model serving catalog: named models behind ``/v1/<model>/*`` —
the port of ``gene2vec_tpu/serve/catalog.py``.

A *catalog spec* is a small JSON document mapping model names onto
export directories plus per-model serving knobs::

    {
      "schema": "gene2vec-tpu/catalog/v1",
      "default": "dim200",
      "models": {
        "dim200": {"export_dir": "exports/dim200"},
        "dim512": {
          "export_dir": "exports/dim512",
          "dim": 512,
          "index": "exact",
          "ggipnn_checkpoint": null,
          "rate": 0.0, "burst": 0,
          "replicas": 1,
          "partition_rules": [["(^|/)(emb|ctx|unit)$", ["model", null]]],
          "extra_args": []
        }
      }
    }

Relative ``export_dir`` paths resolve against the spec file's own
directory, so a catalog travels with its exports.  Names are capped at
:data:`~gene2vec_tpu_torch.serve.routes.MAX_CATALOG_MODELS` and validated
against the route grammar (a model may not be called ``similar`` or
``shard`` — the URL would be ambiguous), which is also what bounds the
``model=`` metric label space.

:class:`ModelCatalog` materializes the spec on a replica: one
:class:`~gene2vec_tpu_torch.serve.registry.ModelRegistry` + one
:class:`~gene2vec_tpu_torch.serve.server.ServeApp` (engine, micro-batcher,
response cache, jit cache) **per model**, all sharing one metrics
registry and one tenant-admission table.  Isolation is
structural: per-model registries mean hot swap, shadow canary, and
manifest-CRC verification never mix models (one watcher per entry),
per-model apps mean a swap invalidates only its own response cache,
and per-model engines keep each model's launch plans apart.  Every
engine runs on the same card (``device``): on one card each entry's
partition rules (``parallel/partition_rules.py``) place the whole table
there, so they are parsed and checked only.

The spec parser and :class:`ModelAdmission` (the front door's
per-model token buckets, crossing with per-tenant admission) are
dependency-light on purpose: the fleet proxy process reads the same
spec to learn names/rates/replica counts without importing numpy or
the model-loading stack: torch and the serving stack are imported only
inside :meth:`ModelCatalog.build`.
"""

from __future__ import annotations

import dataclasses
import json
import os
import re
from typing import Any, Dict, List, Optional, Tuple

from gene2vec_tpu_torch.serve.routes import MAX_CATALOG_MODELS
from gene2vec_tpu_torch.serve.tenancy import RateBucket

CATALOG_SCHEMA = "gene2vec-tpu/catalog/v1"

#: names that would collide with route segments under /v1/<name>/...
RESERVED_MODEL_NAMES = frozenset((
    "similar", "embedding", "interaction", "genes", "shard", "jobs",
    "shadow", "metrics", "healthz", "livez", "default",
))

_NAME_RE = re.compile(r"^[A-Za-z0-9][A-Za-z0-9_.-]{0,63}$")


@dataclasses.dataclass(frozen=True)
class CatalogEntry:
    """One named model in the catalog."""

    name: str
    export_dir: str
    dim: Optional[int] = None
    index_mode: str = "exact"
    ggipnn_checkpoint: Optional[str] = None
    #: front-door token bucket (requests/s + burst); 0 = unlimited
    rate: float = 0.0
    burst: int = 0
    #: initial replicas for this model's fleet pool
    replicas: int = 1
    #: raw [[pattern, axes], ...] rules (parallel/partition_rules.py
    #: parse_rules); None -> the library defaults
    partition_rules: Optional[Tuple] = None
    #: extra cli.serve args appended to this model's replica argv
    extra_args: Tuple[str, ...] = ()


@dataclasses.dataclass(frozen=True)
class CatalogSpec:
    """Parsed, validated catalog: ordered entries + the default name."""

    entries: Tuple[CatalogEntry, ...]
    default: str
    path: str = ""

    @property
    def names(self) -> Tuple[str, ...]:
        return tuple(e.name for e in self.entries)

    def entry(self, name: str) -> CatalogEntry:
        for e in self.entries:
            if e.name == name:
                return e
        raise KeyError(f"model {name!r} not in catalog {self.names}")

    @property
    def default_entry(self) -> CatalogEntry:
        return self.entry(self.default)


def _validate_name(name: str) -> str:
    if not _NAME_RE.match(name or ""):
        raise ValueError(
            f"catalog model name {name!r} must match "
            f"{_NAME_RE.pattern} (it becomes a URL segment and a "
            "metric label)"
        )
    if name in RESERVED_MODEL_NAMES:
        raise ValueError(
            f"catalog model name {name!r} is reserved (collides with "
            "the /v1 route grammar)"
        )
    return name


def parse_catalog_spec(doc: Dict[str, Any], base_dir: str = "",
                       path: str = "") -> CatalogSpec:
    """Validate a catalog document into a :class:`CatalogSpec`.
    Every structural error is raised here, at spec-load time — a bad
    catalog never makes it to a half-started fleet."""
    if not isinstance(doc, dict) or not isinstance(
        doc.get("models"), dict
    ):
        raise ValueError("catalog spec must be {'models': {name: {...}}}")
    models = doc["models"]
    if not models:
        raise ValueError("catalog spec has no models")
    if len(models) > MAX_CATALOG_MODELS:
        raise ValueError(
            f"catalog has {len(models)} models; cap is "
            f"{MAX_CATALOG_MODELS} (the model= label bound)"
        )
    entries: List[CatalogEntry] = []
    for name, m in models.items():
        _validate_name(name)
        if not isinstance(m, dict) or not m.get("export_dir"):
            raise ValueError(
                f"catalog model {name!r} needs an 'export_dir'"
            )
        export_dir = str(m["export_dir"])
        if base_dir and not os.path.isabs(export_dir):
            export_dir = os.path.join(base_dir, export_dir)
        ggipnn = m.get("ggipnn_checkpoint")
        if ggipnn and base_dir and not os.path.isabs(ggipnn):
            ggipnn = os.path.join(base_dir, ggipnn)
        rules = m.get("partition_rules")
        if rules is not None:
            # validate eagerly (regex + shape), store the raw form; the
            # replica parses it again when it builds its registry
            from gene2vec_tpu_torch.parallel.partition_rules import parse_rules

            parse_rules(rules)
            rules = tuple(tuple(r) for r in rules)
        replicas = int(m.get("replicas", 1))
        if replicas < 1:
            raise ValueError(
                f"catalog model {name!r}: replicas must be >= 1"
            )
        rate = float(m.get("rate", 0.0))
        burst = int(m.get("burst", 0))
        if rate < 0 or burst < 0:
            raise ValueError(
                f"catalog model {name!r}: rate/burst must be >= 0"
            )
        entries.append(CatalogEntry(
            name=name,
            export_dir=export_dir,
            dim=int(m["dim"]) if m.get("dim") else None,
            index_mode=str(m.get("index", "exact")),
            ggipnn_checkpoint=ggipnn,
            rate=rate,
            burst=burst,
            replicas=replicas,
            partition_rules=rules,
            extra_args=tuple(str(a) for a in m.get("extra_args", ())),
        ))
    default = doc.get("default") or entries[0].name
    if default not in {e.name for e in entries}:
        raise ValueError(
            f"catalog default {default!r} names no model "
            f"(have {[e.name for e in entries]})"
        )
    return CatalogSpec(entries=tuple(entries), default=default, path=path)


def load_catalog_spec(path: str) -> CatalogSpec:
    """Read + validate a catalog spec file."""
    with open(path, "r", encoding="utf-8") as f:
        doc = json.load(f)
    return parse_catalog_spec(
        doc, base_dir=os.path.dirname(os.path.abspath(path)), path=path
    )


class ModelAdmission:
    """Front-door per-model token buckets (the model-axis twin of
    ``TenantAdmission``): a hot model exhausts *its own* budget and is
    429'd, it cannot starve a cold model's queue.  Crossed with
    per-tenant admission — a request must clear both gates.  Bounded by
    the catalog table, so the ``model=`` label space never grows with
    traffic."""

    def __init__(self, spec: CatalogSpec, clock=None):
        import time as _time

        clock = clock or _time.monotonic
        self._buckets: Dict[str, RateBucket] = {
            e.name: RateBucket(e.rate, max(e.burst, 1), clock=clock)
            for e in spec.entries if e.rate > 0
        }

    def admit(self, model: Optional[str]) -> bool:
        """Take one token from ``model``'s bucket; unlimited (no
        bucket) and unknown names admit — unknown names 404 later, the
        quota gate is not a validity gate."""
        bucket = self._buckets.get(model or "")
        return bucket.take() if bucket is not None else True


class ModelCatalog:
    """The replica-side materialized catalog: name -> ServeApp."""

    def __init__(
        self,
        spec: CatalogSpec,
        config=None,
        metrics=None,
        device=None,
        fault_injector=None,
    ):
        self.spec = spec
        self.config = config
        self.metrics = metrics
        self.device = device
        self.fault_injector = fault_injector
        self.apps: Dict[str, Any] = {}

    # -- construction ------------------------------------------------------

    def build(self) -> "ModelCatalog":
        """Build one registry + app per entry.  The default model must
        load (a catalog that cannot serve its backward-compat surface
        is DOA); a non-default entry that cannot load yet starts empty
        and is picked up by its own watcher — per-model quarantine
        keeps it from poisoning its siblings."""
        from gene2vec_tpu_torch.parallel.partition_rules import parse_rules
        from gene2vec_tpu_torch.serve.registry import ModelRegistry
        from gene2vec_tpu_torch.serve.server import ServeApp

        for entry in self.spec.entries:
            if entry.partition_rules is not None:
                # on one card every spec places the whole table there: the
                # rules are checked and go no further
                parse_rules(entry.partition_rules)
            registry = ModelRegistry(
                entry.export_dir,
                dim=entry.dim,
                metrics=self.metrics,
                index_mode=entry.index_mode,
                device=self.device,
                name=entry.name,
            )
            loaded = False
            try:
                loaded = registry.refresh()
            except Exception:
                loaded = False
            if not loaded and entry.name == self.spec.default:
                raise RuntimeError(
                    f"catalog default model {entry.name!r} has no "
                    f"loadable checkpoint in {entry.export_dir!r}"
                )
            app = ServeApp(
                registry,
                config=self.config,
                metrics=self.metrics,
                ggipnn_checkpoint=entry.ggipnn_checkpoint,
                fault_injector=self.fault_injector,
                model_name=entry.name,
            )
            self.apps[entry.name] = app
        # every app can address every sibling (and itself by name):
        # /v1/<name>/* delegates through this shared table
        for app in self.apps.values():
            app.catalog_apps = self.apps
        default_app = self.apps[self.spec.default]
        shared_tenants = default_app.tenants
        for app in self.apps.values():
            app.tenants = shared_tenants
        return self

    @property
    def default_app(self):
        return self.apps[self.spec.default]

    @property
    def names(self) -> Tuple[str, ...]:
        return tuple(self.apps)

    # -- lifecycle ---------------------------------------------------------

    def start(self, watch_interval_s: float = 0.0) -> "ModelCatalog":
        for app in self.apps.values():
            app.start()
            if watch_interval_s > 0:
                # one watcher per registry entry: swaps never mix
                # models because no watcher can even see another
                # model's export dir
                app.registry.start_watcher(watch_interval_s)
        return self

    def stop(self) -> None:
        for app in self.apps.values():
            try:
                app.registry.stop_watcher()
            except Exception:
                pass
            app.stop()


__all__ = [
    "CATALOG_SCHEMA",
    "RESERVED_MODEL_NAMES",
    "CatalogEntry",
    "CatalogSpec",
    "parse_catalog_spec",
    "load_catalog_spec",
    "ModelAdmission",
    "ModelCatalog",
]
