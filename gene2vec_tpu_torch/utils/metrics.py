"""Structured step metrics — CSV always, TensorBoard when available (a
copy of ``gene2vec_tpu/utils/metrics.py``).

The reference logs through gensim INFO prints and TF1 summary writers
(loss/accuracy scalars + grad histograms, ``src/GGIPNN_Classification.py:
130-156``).  Here every trainer can emit one row per iteration/step to a
CSV next to its checkpoints, and mirror scalars to tensorboardX when that
package is installed.
"""

from __future__ import annotations

import csv
import os
import time
from typing import Dict, Optional


class MetricsLogger:
    """Append-only metrics log: CSV file + optional TensorBoard scalars."""

    def __init__(self, csv_path: Optional[str], tensorboard_dir: Optional[str] = None):
        self.csv_path = csv_path
        self._fieldnames: Optional[list] = None
        self._tb = None
        if csv_path:
            os.makedirs(os.path.dirname(os.path.abspath(csv_path)), exist_ok=True)
        if tensorboard_dir:
            try:
                from tensorboardX import SummaryWriter

                self._tb = SummaryWriter(tensorboard_dir)
            except ImportError:
                pass  # CSV remains the source of truth

    def log(self, step: int, metrics: Dict[str, float]) -> None:
        row = {"step": int(step), "time": time.time(), **metrics}
        if self.csv_path:
            new_fields = sorted(row)
            if self._fieldnames is None:
                exists = os.path.exists(self.csv_path)
                if exists:
                    with open(self.csv_path, "r", encoding="utf-8") as f:
                        header = f.readline().strip()
                    self._fieldnames = header.split(",") if header else new_fields
                else:
                    self._fieldnames = new_fields
                    with open(self.csv_path, "w", encoding="utf-8", newline="") as f:
                        csv.DictWriter(f, self._fieldnames).writeheader()
            new_keys = sorted(set(row) - set(self._fieldnames))
            if new_keys:
                # a metric key appeared after the header froze (e.g. a
                # trainer starts reporting stalls mid-run): rewrite the
                # CSV with the widened header, backfilling empty cells,
                # instead of silently discarding the values
                self._widen_header(new_keys)
            with open(self.csv_path, "a", encoding="utf-8", newline="") as f:
                csv.DictWriter(
                    f, self._fieldnames, extrasaction="ignore"
                ).writerow(row)
        if self._tb is not None:
            for k, v in metrics.items():
                if isinstance(v, (int, float)):
                    self._tb.add_scalar(k, v, step)

    def _widen_header(self, new_keys: list) -> None:
        """Rewrite the CSV under a header widened by ``new_keys`` (atomic
        tmp + rename); existing rows get empty cells for the new columns."""
        with open(self.csv_path, "r", encoding="utf-8", newline="") as f:
            rows = list(csv.DictReader(f, fieldnames=self._fieldnames))
        if rows and list(rows[0].values())[: len(self._fieldnames)] == list(
            self._fieldnames
        ):
            rows = rows[1:]  # drop the header row DictReader re-parsed
        self._fieldnames = self._fieldnames + new_keys
        tmp = f"{self.csv_path}.tmp.{os.getpid()}"
        with open(tmp, "w", encoding="utf-8", newline="") as f:
            w = csv.DictWriter(f, self._fieldnames, extrasaction="ignore")
            w.writeheader()
            for r in rows:
                w.writerow({k: (v if v is not None else "") for k, v in r.items()})
        os.replace(tmp, self.csv_path)

    def close(self) -> None:
        if self._tb is not None:
            self._tb.close()
