"""Double-buffered background checkpoint writer — a copy of
``gene2vec_tpu/resilience/async_writer.py``.

The train loop's per-iteration checkpoint is host work (device→host
copy, npz serialization, two text exports, fsync) that an inline save
pays while the card sits idle.  This writer splits the work at the only
point that must stay synchronous:

* **submit (train loop)** — the caller stages a host copy of the state
  (before ``submit``, because the next epoch updates the tables in
  place) and hands a ``write_fn`` closure over; ``submit`` itself does
  no disk I/O and returns immediately unless the double-buffer bound is
  hit.  The closure sees host copies only: the writer thread never
  touches a CUDA tensor;
* **write (background thread)** — ``write_fn`` runs the atomic
  save-with-manifest; durations land in the ``ckpt_write_seconds``
  histogram, payload bytes in ``ckpt_bytes_total``, and queue+in-flight
  occupancy in the ``ckpt_inflight`` gauge.

Double buffering: at most ``max_pending`` writes (default 1) may be
outstanding — staged or in flight — so with the caller's one
being-staged copy the peak is **two** table copies on the host, and a
slow disk back-pressures the train loop (``submit`` blocks until the
previous write retires) instead of accumulating snapshots.

A failed write is never silent: the first error is re-raised (wrapped in
:class:`CheckpointWriteError`) from the next ``submit``/``flush``/
``close`` on the train loop thread — a trainer that cannot persist
progress must crash loudly, not train on with a stale resume point.
"""

from __future__ import annotations

import queue
import threading
import time
from typing import Callable, Optional

from gene2vec_tpu_torch.obs.trace import ambient_span

_STOP = object()


class CheckpointWriteError(RuntimeError):
    """A background checkpoint write failed (original error chained)."""


class AsyncCheckpointWriter:
    """Background writer with a bounded staging queue.

    ``metrics`` is an obs ``MetricsRegistry`` (optional).  ``write_fn``
    closures may return an ``int`` byte count, which feeds
    ``ckpt_bytes_total``.
    """

    def __init__(self, metrics=None, max_pending: int = 1,
                 name: str = "ckpt-writer"):
        self.metrics = metrics
        self._queue: "queue.Queue" = queue.Queue()
        # the outstanding-writes bound: released by the worker only when
        # a write RETIRES, so queue-slot turnover cannot quietly admit a
        # third live snapshot (staged + queued + writing)
        self._slots = threading.Semaphore(max(1, max_pending))
        self._outstanding = 0
        self._count_lock = threading.Lock()
        self._error: Optional[BaseException] = None
        self._error_lock = threading.Lock()
        self._closed = False
        self._thread = threading.Thread(
            target=self._loop, name=name, daemon=True
        )
        self._thread.start()

    # -- train-loop side ---------------------------------------------------

    def submit(self, write_fn: Callable[[], Optional[int]], **attrs) -> None:
        """Enqueue one staged snapshot write.  Blocks only while
        ``max_pending`` earlier writes are still outstanding (the
        double-buffer bound); raises the first pending background error
        instead of dropping work after a failure."""
        if self._closed:
            raise CheckpointWriteError("writer is closed")
        self._raise_pending()
        self._slots.acquire()
        with self._count_lock:
            self._outstanding += 1
        self._queue.put((write_fn, attrs))
        self._set_inflight()

    def flush(self) -> None:
        """Block until every submitted write has completed; re-raise the
        first background error."""
        self._queue.join()
        self._raise_pending()

    def close(self) -> None:
        """Flush, stop the thread, and surface any pending error."""
        if self._closed:
            return
        self._closed = True
        self._queue.join()
        self._queue.put(_STOP)
        self._thread.join(timeout=30.0)
        self._raise_pending()

    @property
    def pending(self) -> int:
        """Staged + in-flight writes (the ``ckpt_inflight`` value)."""
        with self._count_lock:
            return self._outstanding

    # -- writer thread -----------------------------------------------------

    def _loop(self) -> None:
        while True:
            item = self._queue.get()
            if item is _STOP:
                self._queue.task_done()
                return
            write_fn, attrs = item
            t0 = time.perf_counter()
            try:
                with ambient_span("ckpt_write", **attrs):
                    nbytes = write_fn()
                dt = time.perf_counter() - t0
                if self.metrics is not None:
                    self.metrics.histogram("ckpt_write_seconds").observe(dt)
                    self.metrics.counter("ckpt_writes_total").inc()
                    if isinstance(nbytes, int):
                        self.metrics.counter("ckpt_bytes_total").inc(nbytes)
            except BaseException as e:  # surfaced on the train-loop thread
                with self._error_lock:
                    if self._error is None:
                        self._error = e
                if self.metrics is not None:
                    self.metrics.counter("ckpt_errors_total").inc()
            finally:
                with self._count_lock:
                    self._outstanding -= 1
                self._slots.release()
                self._queue.task_done()
                self._set_inflight()

    # -- shared ------------------------------------------------------------

    def _set_inflight(self) -> None:
        if self.metrics is not None:
            self.metrics.gauge("ckpt_inflight").set(self.pending)

    def _raise_pending(self) -> None:
        with self._error_lock:
            err, self._error = self._error, None
        if err is not None:
            raise CheckpointWriteError(
                f"background checkpoint write failed: {err!r}"
            ) from err

    def __enter__(self) -> "AsyncCheckpointWriter":
        return self

    def __exit__(self, *exc) -> None:
        self.close()
