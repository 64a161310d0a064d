"""Runtime probes — the port's part of ``gene2vec_tpu/obs/probes.py``:
one sample under the reference's gauge names.

``hbm_bytes`` is ``torch.cuda.memory_allocated()`` once CUDA is
initialized in this process (``None`` before: asking would initialize
it), ``host_rss_bytes`` this process's resident set as the reference
reads it, ``jit_compiles`` ``None`` (the port compiles no programs; its
kernels build once at first use).  The HLO collective audit and the
compile watcher stay with the multi-GPU and profiler items.
"""

from __future__ import annotations

import sys
from typing import Dict, Optional


def device_bytes() -> Optional[int]:
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


def sample(registry=None) -> Dict[str, Optional[int]]:
    """One probe sample: device bytes, host RSS, compile count (always
    ``None`` here).  With ``registry`` (a :class:`~gene2vec_tpu_torch.obs.
    registry.MetricsRegistry`) the known values also land in gauges."""
    out = {
        "hbm_bytes": device_bytes(),
        "host_rss_bytes": host_rss_bytes(),
        "jit_compiles": None,
    }
    if registry is not None:
        for k, v in out.items():
            if v is not None:
                registry.gauge(k).set(v)
    return out
