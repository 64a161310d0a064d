"""The public /v1 route surface, as one dependency-light constant — a
copy of ``gene2vec_tpu/serve/routes.py``.

The replica server (``serve/server.py``) labels per-route latency over
this exact set; the shard, job and catalog names are kept so the route
table reads as the reference's.
"""

from __future__ import annotations

V1_ROUTES = frozenset((
    "/v1/genes", "/v1/similar", "/v1/embedding", "/v1/interaction",
))

#: the shard-replica control/scatter surface (serve/shardgroup.py):
#: ``topk`` and ``vectors`` are the scatter data plane, ``stage`` and
#: ``flip`` the coordinator's two-step shard-atomic hot swap.  Kept
#: separate from V1_ROUTES so an unsharded fleet's label set is
#: unchanged; the replica server unions both for its latency labels.
SHARD_ROUTES = frozenset((
    "/v1/shard/topk", "/v1/shard/vectors", "/v1/shard/stage",
    "/v1/shard/flip",
))

#: the batch-job lifecycle surface (gene2vec_tpu/batch/jobs.py),
#: mounted on whichever process owns the job store — a single replica
#: or the fleet front door (never forwarded, like /v1/shadow).  Routes
#: under it carry job ids (``/v1/jobs/<id>/artifact``); the label
#: helpers collapse them all to ``/v1/jobs`` so metric cardinality
#: stays bounded by the route TABLE, not by job history.
JOBS_ROUTE = "/v1/jobs"

#: overflow label for model names beyond the catalog (mirrors
#: tenancy.OVERFLOW_TENANT): an unknown or over-cap model name never
#: mints a new metric series.
OVERFLOW_MODEL = "other"

#: hard cap on catalog size — keeps the ``model=`` label space (and the
#: per-(model, shard) autoscale pool count) bounded the same way the
#: tenant table bounds ``tenant=``.
MAX_CATALOG_MODELS = 16


def collapse_jobs_route(route: str) -> str:
    """``/v1/jobs/<id>[/verb]`` -> ``/v1/jobs`` for metric labels;
    every other route unchanged."""
    if route == JOBS_ROUTE or route.startswith(JOBS_ROUTE + "/"):
        return JOBS_ROUTE
    return route


def split_model_route(path: str):
    """``/v1/<model>/similar`` -> ``("<model>", "/v1/similar")``; every
    non-model-prefixed path -> ``(None, path)`` unchanged.

    The split is recognized **only** when the remainder is a V1 route,
    so ``/v1/shard/topk`` and ``/v1/jobs/<id>/artifact`` — whose second
    segment is a verb or an id, not a model — are never misparsed as a
    model prefix.  Validation of the name itself (is it in the catalog?)
    is the caller's job; this is pure syntax.
    """
    if not path.startswith("/v1/"):
        return None, path
    rest = path[len("/v1/"):]
    name, sep, tail = rest.partition("/")
    if not sep or not name or not tail:
        return None, path
    candidate = "/v1/" + tail
    if collapse_jobs_route(candidate) in V1_ROUTES | {JOBS_ROUTE}:
        return name, candidate
    return None, path


def model_label(name, known) -> str:
    """Bounded ``model=`` label value: a catalog name passes through,
    anything else (unknown, oversized, over-cap) collapses into
    :data:`OVERFLOW_MODEL` — cardinality is capped by the catalog
    table, never by request traffic."""
    if name is None:
        return OVERFLOW_MODEL
    name = str(name)[:64]
    return name if name in known else OVERFLOW_MODEL
