"""W3C-traceparent-style distributed trace context.

A request that traverses the fleet — drill/loadgen client → front-door
proxy → resilient-client attempt (possibly retried or hedged) → replica
HTTP handler → batcher ticket → engine compute — carries ONE
:class:`TraceContext` across every hop, serialized on the wire as the
standard ``traceparent`` HTTP header::

    traceparent: 00-<trace_id:32 hex>-<span_id:16 hex>-<01|00>

* ``trace_id`` names the whole request tree (the cross-process join
  key); ``span_id`` names the sender's hop, and becomes the receiver's
  parent; the trailing flags byte carries the **sampled** bit.
* Each hop derives its own id with :meth:`TraceContext.child` — the
  ``parent_id`` field is in-process lineage only and never travels.
* Sampling is decided ONCE, at the trace root (a client's
  ``trace_sample`` knob, a server's :class:`Sampler` for headerless
  traffic), and every downstream hop honors the propagated bit: an
  unsampled trace costs one header parse and nothing else.

The ambient side lives in ``obs/trace.py``: while a context is
installed for the current thread (:func:`use`), every tracer record
written from that thread is stamped with ``trace``/``tsid``/``tpid``
fields, which is what ``cli.obs trace`` reassembles into the
cross-process tree (docs/OBSERVABILITY.md#distributed-tracing).

Stdlib-only and import-light on purpose: the serve hot path touches
this module per request.
"""

from __future__ import annotations

import contextlib
import dataclasses
import os
import random
import threading
from typing import Iterator, Optional

TRACEPARENT_HEADER = "traceparent"

_TRACE_ID_LEN = 32
_SPAN_ID_LEN = 16
_HEX = set("0123456789abcdef")


def _rand_hex(n_chars: int) -> str:
    return os.urandom(n_chars // 2).hex()


def _is_hex(s: str, length: int) -> bool:
    return len(s) == length and not (set(s) - _HEX)


@dataclasses.dataclass(frozen=True)
class TraceContext:
    """One hop's identity within a distributed trace."""

    trace_id: str                    # 32 lowercase hex chars
    span_id: str                     # 16 lowercase hex chars (this hop)
    parent_id: Optional[str] = None  # sender/enclosing hop; never on the wire
    sampled: bool = True

    def to_header(self) -> str:
        """The ``traceparent`` value advertising THIS hop as the parent."""
        return (
            f"00-{self.trace_id}-{self.span_id}-"
            f"{'01' if self.sampled else '00'}"
        )

    @classmethod
    def from_header(cls, value: Optional[str]) -> Optional["TraceContext"]:
        """Parse a ``traceparent`` header; None for anything malformed
        (garbage from the network must never crash a handler).  Unknown
        future versions are accepted per the W3C spec (parse the fields
        we know); version ``ff`` is explicitly invalid."""
        if not value or not isinstance(value, str):
            return None
        parts = value.strip().lower().split("-")
        if len(parts) < 4:
            return None
        version, trace_id, span_id, flags = parts[:4]
        if not _is_hex(version, 2) or version == "ff":
            return None
        if not _is_hex(trace_id, _TRACE_ID_LEN) or trace_id == "0" * 32:
            return None
        if not _is_hex(span_id, _SPAN_ID_LEN) or span_id == "0" * 16:
            return None
        if not _is_hex(flags, 2):
            return None
        return cls(
            trace_id=trace_id,
            span_id=span_id,
            parent_id=None,
            sampled=bool(int(flags, 16) & 0x01),
        )

    def child(self) -> "TraceContext":
        """A new hop in the same trace, parented to this one — retries,
        hedges, and downstream handlers each get their own."""
        return TraceContext(
            trace_id=self.trace_id,
            span_id=_rand_hex(_SPAN_ID_LEN),
            parent_id=self.span_id,
            sampled=self.sampled,
        )


def new_trace(sampled: bool = True) -> TraceContext:
    """A fresh root context (no parent)."""
    return TraceContext(
        trace_id=_rand_hex(_TRACE_ID_LEN),
        span_id=_rand_hex(_SPAN_ID_LEN),
        parent_id=None,
        sampled=sampled,
    )


class Sampler:
    """Head sampling for traffic that arrives WITHOUT a traceparent:
    roll once per request and mint a sampled root at ``rate`` (0 never,
    1 always).  Propagated contexts bypass the sampler entirely — the
    root's decision already stands."""

    def __init__(self, rate: float, rng: Optional[random.Random] = None):
        self.rate = max(0.0, min(1.0, float(rate)))
        self._rng = rng if rng is not None else random.Random()

    def maybe_new_trace(self) -> Optional[TraceContext]:
        """A sampled root context, or None when this request is not
        selected (None means: do not trace at all, not even unsampled —
        headerless untraced requests must pay zero trace cost)."""
        if self.rate <= 0.0:
            return None
        if self._rng.random() >= self.rate:
            return None
        return new_trace(sampled=True)


# -- ambient (thread-local) context ------------------------------------------

_local = threading.local()


def current() -> Optional[TraceContext]:
    """The context installed for this thread, or None."""
    return getattr(_local, "ctx", None)


@contextlib.contextmanager
def use(ctx: Optional[TraceContext]) -> Iterator[Optional[TraceContext]]:
    """Install ``ctx`` for the current thread for the ``with`` body
    (``use(None)`` is a no-op pass-through, so call sites don't need a
    conditional).  Always restores the previous context — handlers
    recycle threads."""
    if ctx is None:
        yield None
        return
    prev = getattr(_local, "ctx", None)
    _local.ctx = ctx
    try:
        yield ctx
    finally:
        _local.ctx = prev
