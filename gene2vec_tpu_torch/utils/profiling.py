"""Step timer accumulating the north-star metric, gene-pairs/sec
(``gene2vec_tpu/utils/profiling.py:StepTimer``), and an optional
``torch.profiler`` trace context (the reference's ``jax.profiler`` one).
"""

from __future__ import annotations

import contextlib
import os
import time
from dataclasses import dataclass, field
from typing import List, Optional


@dataclass
class StepTimer:
    pairs: List[int] = field(default_factory=list)
    seconds: List[float] = field(default_factory=list)

    def record(self, num_pairs: int, elapsed_s: float) -> None:
        self.pairs.append(int(num_pairs))
        self.seconds.append(float(elapsed_s))

    @property
    def total_pairs(self) -> int:
        return sum(self.pairs)

    @property
    def total_seconds(self) -> float:
        return sum(self.seconds)

    def pairs_per_sec(self, skip_first: bool = True) -> float:
        """Throughput; drops the first record by default (it includes the
        kernels' first-use build)."""
        ps, ss = self.pairs, self.seconds
        if skip_first and len(ps) > 1:
            ps, ss = ps[1:], ss[1:]
        t = sum(ss)
        return sum(ps) / t if t > 0 else 0.0


@contextlib.contextmanager
def trace_context(log_dir: Optional[str]):
    """A ``torch.profiler`` trace of the block — the host and, where there
    is a card, its kernels — exported as a Chrome trace
    ``trace_<ms>.json`` into ``log_dir``; a no-op for None."""
    if log_dir is None:
        yield
        return
    import torch
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield
    prof.export_chrome_trace(os.path.join(log_dir, f"trace_{int(time.time() * 1e3)}.json"))
