"""Deterministic HTTP-layer fault injection for the serving stack — a
copy of ``gene2vec_tpu/resilience/faults.py``.

Production fleets treat replica failure, overload, and byzantine
responses as routine; this module manufactures those events *inside the
real server* so clients and drills rehearse against the actual HTTP
path, not a mock.  Fault classes:

* **latency**   — sleep before dispatch (a GC pause, a slow disk);
* **error**     — substitute the response with an HTTP error (default
  503; a replica mid-crash or mid-reload);
* **reset**     — close the TCP connection abruptly with an RST (a
  process SIGKILLed between accept and reply);
* **blackhole** — accept the request and never answer, holding the
  socket open up to ``blackhole_hold_s`` (a wedged handler thread; the
  caller's read timeout is the only way out).

Injection is **deterministic and seedable**: every decision consumes
draws from one seeded RNG in request-arrival order, so a drill replaying
the same request sequence sees the same fault sequence — the reference's
injector and this one make the same decisions on the same spec and
routes.  The injector is wired into ``serve/server.py`` behind an
explicit flag — the ``--faults`` CLI flag or the ``GENE2VEC_TPU_FAULTS``
env var, the reference's name, so one drill drives either server — and
is completely absent (no RNG draw, no lock) when unconfigured.

The **slow-loris client** (:func:`slow_loris`) is the inverse tool: a
deliberately stalling *client* that sends a request at a trickle, used
by the drill and tests to prove the server's read deadline (408 close)
actually unpins handler threads.
"""

from __future__ import annotations

import dataclasses
import json
import os
import random
import socket
import threading
import time
from typing import Dict, Optional, Tuple

#: env var ``cli.serve`` consults when ``--faults`` is not given
FAULTS_ENV = "GENE2VEC_TPU_FAULTS"

@dataclasses.dataclass(frozen=True)
class Decision:
    """One injected fault: an optional pre-dispatch delay plus at most
    one terminal action (``error`` with an HTTP status, ``reset``, or
    ``blackhole`` with a hold time).  ``kind is None`` with a positive
    ``delay_s`` is pure added latency — the request then proceeds
    normally."""

    delay_s: float = 0.0
    kind: Optional[str] = None  # "error" | "reset" | "blackhole"
    arg: float = 0.0            # status for error; hold_s for blackhole


@dataclasses.dataclass(frozen=True)
class FaultSpec:
    """One injection policy.  Probabilities are per matching request and
    evaluated in a fixed order (latency first, then exactly one of
    error/reset/blackhole), so a given seed yields one reproducible
    fault schedule."""

    seed: int = 0
    route_prefix: str = "/v1/"  # /healthz etc. stay clean by default
    latency_p: float = 0.0
    latency_ms: float = 0.0
    error_p: float = 0.0
    error_status: int = 503
    reset_p: float = 0.0
    blackhole_p: float = 0.0
    blackhole_hold_s: float = 5.0

    @classmethod
    def from_json(cls, blob: str) -> "FaultSpec":
        doc = json.loads(blob)
        if not isinstance(doc, dict):
            raise ValueError("fault spec must be a JSON object")
        unknown = set(doc) - {f.name for f in dataclasses.fields(cls)}
        if unknown:
            raise ValueError(f"unknown fault spec field(s) {sorted(unknown)}")
        return cls(**doc)

    def to_json(self) -> str:
        return json.dumps(dataclasses.asdict(self))


class FaultInjector:
    """Draws one fault decision per matching request from a seeded RNG.

    Thread-safe: handler threads serialize on one lock around the RNG so
    the draw sequence is request-arrival-ordered regardless of the
    thread interleaving that delivered them.
    """

    def __init__(self, spec: FaultSpec, metrics=None):
        self.spec = spec
        self.metrics = metrics
        self._rng = random.Random(spec.seed)
        self._lock = threading.Lock()
        self.decisions: Dict[str, int] = {
            "clean": 0, "latency": 0, "error": 0, "reset": 0, "blackhole": 0,
        }

    @classmethod
    def from_env(cls, metrics=None,
                 env_var: str = FAULTS_ENV) -> Optional["FaultInjector"]:
        blob = os.environ.get(env_var)
        if not blob:
            return None
        return cls(FaultSpec.from_json(blob), metrics=metrics)

    def _count(self, kind: str) -> None:
        self.decisions[kind] += 1
        if self.metrics is not None and kind != "clean":
            self.metrics.counter("serve_faults_injected_total").inc()
            self.metrics.counter(f"serve_fault_{kind}_total").inc()

    def decide(self, route: str) -> Optional[Decision]:
        """The fault (if any) for one request on ``route``.  Exactly two
        RNG draws per matching request — one latency draw, one terminal
        draw — regardless of outcome, so the schedule depends only on
        the seed and the request order, never on which faults fired."""
        if not route.startswith(self.spec.route_prefix):
            return None
        with self._lock:
            delay = (
                self.spec.latency_ms / 1000.0
                if self._rng.random() < self.spec.latency_p else 0.0
            )
            u = self._rng.random()
            if u < self.spec.error_p:
                kind: Optional[str] = "error"
                arg: float = float(self.spec.error_status)
            elif u < self.spec.error_p + self.spec.reset_p:
                kind, arg = "reset", 0.0
            elif (u < self.spec.error_p + self.spec.reset_p
                  + self.spec.blackhole_p):
                kind, arg = "blackhole", float(self.spec.blackhole_hold_s)
            else:
                kind, arg = None, 0.0
            if kind is not None:
                self._count(kind)
            if delay:
                self._count("latency")
            if kind is None and not delay:
                self._count("clean")
        if kind is None and not delay:
            return None
        return Decision(delay_s=delay, kind=kind, arg=arg)


def apply_reset(sock: socket.socket) -> None:
    """Close ``sock`` with an RST instead of a FIN: SO_LINGER with a zero
    timeout makes close() abort the connection, which the peer observes
    as ``ConnectionResetError`` — the signature of a replica that died
    mid-exchange rather than one that answered and hung up."""
    import struct

    try:
        sock.setsockopt(
            socket.SOL_SOCKET, socket.SO_LINGER, struct.pack("ii", 1, 0)
        )
    except OSError:
        pass  # already dead; the close below is best-effort either way
    try:
        sock.close()
    except OSError:
        pass


def slow_loris(
    host: str,
    port: int,
    path: str = "/v1/similar",
    total_body: int = 4096,
    drip_bytes: int = 1,
    drip_interval_s: float = 0.5,
    duration_s: float = 10.0,
    connect_timeout_s: float = 5.0,
) -> Tuple[Optional[int], float]:
    """A deliberately stalling client: send headers promising
    ``total_body`` bytes, then drip the body ``drip_bytes`` at a time
    every ``drip_interval_s`` for up to ``duration_s``.

    Returns ``(status, held_s)`` — the HTTP status the server eventually
    answered with (``408`` when its read deadline fired; ``None`` when
    the server never answered and the loris gave up) and how long the
    connection was held.  A server WITHOUT a read deadline holds a
    handler thread for the whole ``duration_s``; one with the deadline
    answers 408 and closes in ~its timeout.
    """
    t0 = time.monotonic()
    sock = socket.create_connection((host, port), timeout=connect_timeout_s)
    try:
        head = (
            f"POST {path} HTTP/1.1\r\n"
            f"Host: {host}:{port}\r\n"
            "Content-Type: application/json\r\n"
            f"Content-Length: {total_body}\r\n"
            "\r\n"
        )
        sock.sendall(head.encode("ascii"))
        sent = 0
        deadline = t0 + duration_s
        sock.settimeout(max(drip_interval_s, 0.05))
        status: Optional[int] = None
        while sent < total_body and time.monotonic() < deadline:
            try:
                sock.sendall(b"x" * min(drip_bytes, total_body - sent))
                sent += drip_bytes
            except OSError:
                break  # server closed on us — go read the status, if any
            # between drips, poll for an early server verdict (the 408)
            try:
                raw = sock.recv(4096)
            except socket.timeout:
                continue
            except OSError:
                break
            if raw:
                try:
                    status = int(raw.split(b" ", 2)[1])
                except (IndexError, ValueError):
                    status = -1
            break
        if status is None:
            # one last listen: the server may answer at close
            try:
                sock.settimeout(1.0)
                raw = sock.recv(4096)
                if raw:
                    status = int(raw.split(b" ", 2)[1])
            except (OSError, IndexError, ValueError):
                pass
        return status, time.monotonic() - t0
    finally:
        try:
            sock.close()
        except OSError:
            pass
