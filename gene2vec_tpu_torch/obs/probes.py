"""Runtime probes — the port's part of ``gene2vec_tpu/obs/probes.py``:
one sample under the reference's gauge names, and the compile watcher.

``hbm_bytes`` is :func:`live_array_bytes`, ``torch.cuda.memory_allocated()``
once CUDA is initialized in this process (``None`` before: asking would
initialize it); ``host_rss_bytes`` this process's resident set as the
reference reads it; ``jit_compiles`` the :class:`CompileWatcher`'s count
once one is installed (``None`` before), as in the reference.

The port compiles no programs: its counterpart of a jit compile is a
kernel library's ``nvcc`` build or its load (``kernels/build.py``), which
the watcher counts.  The reference's HLO collective audit
(``shape_bytes``, ``collective_stats*``) waits for the port's NCCL
collectives (multi-GPU item).
"""

from __future__ import annotations

import sys
from typing import Dict, Optional


def live_array_bytes() -> Optional[int]:
    """Bytes of CUDA memory this process holds in tensors, or ``None``
    where CUDA is not initialized."""
    import torch

    if not torch.cuda.is_initialized():
        return None
    return int(torch.cuda.memory_allocated())


def host_rss_bytes() -> Optional[int]:
    """Resident set size of this process."""
    try:
        with open("/proc/self/status", "r", encoding="ascii") as f:
            for line in f:
                if line.startswith("VmRSS:"):
                    return int(line.split()[1]) * 1024
    except OSError:
        pass
    try:
        import resource

        # ru_maxrss is KiB on Linux, bytes on macOS — close enough as a
        # peak fallback when /proc is unavailable
        rss = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss
        return rss * 1024 if sys.platform != "darwin" else rss
    except (ImportError, OSError):
        return None


class CompileWatcher:
    """Counts the port's compile events: each ``nvcc`` build that
    ``build_all`` ran (``events["nvcc_build"]``) and each kernel library
    that ``build.load`` opened (``events["library_load"]``); ``count`` is
    their sum.  ``kernels/build.py`` keeps these tallies from the start of
    the process and the watcher reads them, so a watcher installed after
    the kernels loaded still counts those loads.  ``supported`` is always
    true: the tallies need no hook."""

    _installed: Optional["CompileWatcher"] = None

    def __init__(self):
        self.supported = True

    @property
    def events(self) -> Dict[str, int]:
        from gene2vec_tpu_torch.kernels import build

        return build.compile_events()

    @property
    def count(self) -> int:
        return sum(self.events.values())

    @classmethod
    def install(cls) -> "CompileWatcher":
        """Idempotent process-wide installation: one watcher serves every
        Run and server in the process."""
        if cls._installed is None:
            cls._installed = cls()
        return cls._installed


def sample(registry=None) -> Dict[str, Optional[int]]:
    """One probe sample: device bytes, host RSS, cumulative compile count.
    With ``registry`` (a :class:`~gene2vec_tpu_torch.obs.registry.
    MetricsRegistry`) the known values also land in gauges."""
    watcher = CompileWatcher._installed
    out = {
        "hbm_bytes": live_array_bytes(),
        "host_rss_bytes": host_rss_bytes(),
        "jit_compiles": watcher.count if watcher is not None else None,
    }
    if registry is not None:
        for k, v in out.items():
            if v is not None:
                registry.gauge(k).set(v)
    return out
