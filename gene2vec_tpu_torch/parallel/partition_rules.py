"""Declarative param placement: regex rules over param names — the
mesh-free half of ``gene2vec_tpu/parallel/partition_rules.py``.

A *partition rules* list is an ordered sequence of ``(pattern, spec)``
pairs.  :func:`match_partition_rules` walks a nested dict / list / tuple
of arrays, joins each leaf's path into a ``/``-separated name
(``"embedding/unit"``, ``"dense_0/kernel"``), and assigns the spec of the
**first** rule whose regex ``re.search``-matches that name.  A spec is a
plain tuple of mesh-axis names or ``None`` (``("model", None)`` row-shards
a table over the ``model`` axis, ``()`` replicates).  Two guarantees keep
the mapping total:

* scalar and size-1 leaves are never partitioned: they get ``()``
  whatever the rules say;
* a leaf no rule matches falls back to replicated (``()``) with a
  ``RuntimeWarning`` naming the leaf, so a new head with an unforeseen
  param name degrades to replication instead of crashing the server.

On one card the placement of every leaf is the whole table; the catalog
(``serve/catalog.py``) parses and validates each entry's rules through
:func:`parse_rules` so a bad spec fails at load time.  Placing a tree on
a multi-card mesh (the reference's ``named_sharding_tree``,
``make_shard_and_gather_fns``, ``shard_params``, ``gather_params``) is
ROADMAP A13's.
"""

from __future__ import annotations

import re
import warnings
from typing import Any, List, Optional, Sequence, Tuple

Spec = Tuple[Optional[str], ...]

#: rules covering every param family this repo ships: SGNS tables
#: (``emb``/``ctx``), the serve registry's unit-normalized table
#: (``embedding/unit``) and GGIPNN dense layers; heads replicate, only
#: vocab-sized tables row-shard over ``model``
DEFAULT_SERVE_RULES: Tuple[Tuple[str, Spec], ...] = (
    (r"(^|/)(emb|ctx)$", ("model", None)),
    (r"(^|/)(unit|table|embedding)$", ("model", None)),
    # GGIPNN / generic dense heads: small, replicate everywhere
    (r"(^|/)(kernel|bias|w[0-9]*|b[0-9]*)$", ()),
)

#: replicated-everything rules (single-device serving, tests)
REPLICATED_RULES: Tuple[Tuple[str, Spec], ...] = ((r".*", ()),)


def _key_name(entry: Any) -> str:
    """One path entry -> its bare name (a dict key, an attribute name or
    a sequence index; objects carrying ``key``/``name``/``idx`` give
    that)."""
    for attr in ("key", "name", "idx"):
        if hasattr(entry, attr):
            return str(getattr(entry, attr))
    return str(entry)


def tree_path_name(path: Sequence[Any]) -> str:
    """A leaf's path -> the ``/``-joined rule-matching name."""
    return "/".join(_key_name(p) for p in path)


def spec_for_name(
    rules: Sequence[Tuple[str, Spec]], name: str,
    shape: Optional[Tuple[int, ...]] = None,
) -> Spec:
    """The spec the rules assign to one named leaf.  ``shape`` (when
    known) short-circuits scalars and size-1 leaves to ``()``; no match
    warns and replicates."""
    if shape is not None and (len(shape) == 0 or _size(shape) == 1):
        return ()
    for pattern, spec in rules:
        if re.search(pattern, name):
            return tuple(spec)
    warnings.warn(
        f"partition_rules: no rule matched param {name!r}; "
        "falling back to replicated",
        RuntimeWarning,
        stacklevel=2,
    )
    return ()


def _size(shape: Tuple[int, ...]) -> int:
    n = 1
    for d in shape:
        n *= int(d)
    return n


def match_partition_rules(rules: Sequence[Tuple[str, Spec]], params: Any) -> Any:
    """Map a nested dict / list / tuple of arrays onto a same-shaped tree
    of specs.  The first matching rule wins (ordering is the API: the
    specific patterns first, a catch-all last); ``None`` stays ``None``
    (an empty subtree)."""

    def walk(node: Any, path: Tuple[Any, ...]) -> Any:
        if node is None:
            return None
        if isinstance(node, dict):
            return {k: walk(v, path + (k,)) for k, v in node.items()}
        if isinstance(node, (list, tuple)):
            out = [walk(v, path + (i,)) for i, v in enumerate(node)]
            return out if isinstance(node, list) else tuple(out)
        shape = tuple(getattr(node, "shape", ()))
        return spec_for_name(rules, tree_path_name(path), shape=shape)

    return walk(params, ())


def parse_rules(raw: Sequence[Sequence[Any]]) -> List[Tuple[str, Spec]]:
    """Catalog-spec JSON rules -> runtime rules.  Each entry is
    ``[pattern, axes]``, ``axes`` a list of mesh-axis names or null
    (``["(^|/)unit$", ["model", null]]``); an empty or null axes list
    means replicated.  A malformed entry or regex raises ValueError (or
    ``re.error``) at spec-load time, not at the first request."""
    rules: List[Tuple[str, Spec]] = []
    for entry in raw:
        if len(entry) != 2:
            raise ValueError(
                f"partition rule must be [pattern, axes], got {entry!r}"
            )
        pattern, axes = entry
        re.compile(pattern)  # fail fast on a bad regex
        if axes is None:
            axes = []
        if not isinstance(axes, (list, tuple)):
            raise ValueError(
                f"rule axes must be a list of axis names/null, got {axes!r}"
            )
        rules.append((str(pattern), tuple(axes)))
    return rules


__all__ = [
    "DEFAULT_SERVE_RULES",
    "REPLICATED_RULES",
    "match_partition_rules",
    "parse_rules",
    "spec_for_name",
    "tree_path_name",
]
