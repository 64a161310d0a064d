"""Cooperative preemption: SIGTERM/SIGINT → drain, checkpoint, exit — a
copy of ``gene2vec_tpu/resilience/preempt.py``.

GPU pools and batch schedulers preempt with SIGTERM and a grace window.
The default Python disposition (KeyboardInterrupt for SIGINT, hard death
for SIGTERM) can land anywhere — including between a checkpoint's npz
rename and its manifest commit — and loses the RNG/data-cursor position
of the running iteration.  :class:`PreemptionHandler` converts the
signal into a flag the training loops poll at iteration boundaries:
finish the current epoch, finish its checkpoint (a *committed* resume
point, manifest and all), stamp the obs run manifest
``interrupted=true``, and exit with :data:`EXIT_PREEMPTED` so harnesses
can distinguish "preempted, resume me" from success (0), failure (1/2),
and a watchdog timeout (124).  A signal that lands while the main thread
waits on the card (a ``float(loss)`` or a kernel call) runs the handler
when that call returns; the drain still happens at the next boundary.

A second signal while draining restores the previous disposition and
re-raises — an operator double-Ctrl-C still kills promptly.
"""

from __future__ import annotations

import signal
import threading
import time
from typing import Dict, Optional, Tuple

#: exit status for a clean preemption drain ("resume me"), distinct from
#: success (0), error (1), internal failure (2), and timeout(1)'s 124.
EXIT_PREEMPTED = 113


class PreemptionHandler:
    """Installable SIGTERM/SIGINT → flag converter.

    ``install()`` must run on the main thread (CPython restricts
    ``signal.signal``); loops on any thread may poll
    :attr:`triggered`.  Tests and non-main-thread embedders call
    :meth:`trigger` directly.
    """

    def __init__(
        self, signals: Tuple[int, ...] = (signal.SIGTERM, signal.SIGINT)
    ):
        self.signals = signals
        self.received: Optional[int] = None
        #: wall clock (time.time()) when the first signal landed — the
        #: goodput "preempted" bucket measures the drain tail from here
        self.received_wall: Optional[float] = None
        self._event = threading.Event()
        self._prev: Dict[int, object] = {}

    # -- lifecycle ---------------------------------------------------------

    def install(self) -> "PreemptionHandler":
        for s in self.signals:
            self._prev[s] = signal.signal(s, self._on_signal)
        return self

    def uninstall(self) -> None:
        for s, prev in self._prev.items():
            try:
                signal.signal(s, prev)
            except (ValueError, TypeError, OSError):
                pass
        self._prev.clear()

    def __enter__(self) -> "PreemptionHandler":
        return self.install()

    def __exit__(self, *exc) -> None:
        self.uninstall()

    # -- signal path -------------------------------------------------------

    def _on_signal(self, signum, frame) -> None:
        if self._event.is_set():
            # second signal: the drain is taking too long for the sender
            # — restore previous dispositions and re-deliver for a
            # prompt (default) death
            self.uninstall()
            signal.raise_signal(signum)
            return
        self.trigger(signum)

    def trigger(self, signum: Optional[int] = None) -> None:
        """Mark preemption requested (the signal handler's body; also
        the test/embedder entry point)."""
        if self.received is None:
            self.received = signum
            self.received_wall = time.time()
        self._event.set()

    # -- polling -----------------------------------------------------------

    @property
    def triggered(self) -> bool:
        return self._event.is_set()

    def wait(self, timeout: Optional[float] = None) -> bool:
        return self._event.wait(timeout)
