"""Step timer accumulating the north-star metric, gene-pairs/sec
(``gene2vec_tpu/utils/profiling.py:StepTimer``)."""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import List


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
