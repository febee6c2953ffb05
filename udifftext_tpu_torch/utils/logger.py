"""Training-metrics logger, CSV + JSONL (port of `udifftext_tpu/utils/logger.py`).

One CSV (spreadsheet-friendly) and one JSONL (machine-friendly) stream under
the run's log dir, one row per logged step with every loss component; the
caller prints to stdout.
"""

from __future__ import annotations

import csv
import json
import os
import time
from typing import Dict, Optional


class MetricsLogger:
    def __init__(self, log_dir: str, name: str = "train"):
        os.makedirs(log_dir, exist_ok=True)
        self.csv_path = os.path.join(log_dir, f"{name}_metrics.csv")
        self.jsonl_path = os.path.join(log_dir, f"{name}_metrics.jsonl")
        self._csv_file = None
        self._csv_writer = None

    def log(self, step: int, metrics: Dict[str, float], epoch: Optional[int] = None) -> None:
        row = {"step": step, "time": round(time.time(), 3)}
        if epoch is not None:
            row["epoch"] = epoch
        row.update({k: float(v) for k, v in metrics.items()})

        if self._csv_writer is None:
            self._csv_file = open(self.csv_path, "a", newline="")
            self._csv_writer = csv.DictWriter(self._csv_file, fieldnames=list(row),
                                              extrasaction="ignore")
            if self._csv_file.tell() == 0:
                self._csv_writer.writeheader()
        self._csv_writer.writerow(row)
        self._csv_file.flush()

        with open(self.jsonl_path, "a") as f:
            f.write(json.dumps(row) + "\n")

    def close(self) -> None:
        if self._csv_file is not None:
            self._csv_file.close()
            self._csv_file = self._csv_writer = None
