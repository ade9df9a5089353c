"""Training observability: metric history, a JSONL log and stdout
summaries (port of utils/logging.py, pure Python)."""

from __future__ import annotations

import json
import os
import time
from collections import defaultdict
from typing import Dict, List, Optional


class MetricLogger:
    """Keeps every logged metric's history; with `log_dir`, also appends
    one JSON record per `log` call to `<log_dir>/<name>.jsonl`."""

    def __init__(self, log_dir: Optional[str] = None, name: str = "metrics"):
        self.history: Dict[str, List[float]] = defaultdict(list)
        self._path = None
        if log_dir:
            os.makedirs(log_dir, exist_ok=True)
            self._path = os.path.join(log_dir, f"{name}.jsonl")

    def log(self, step: int, **metrics: float):
        rec = {"step": step, "time": time.time()}
        for k, v in metrics.items():
            v = float(v)
            self.history[k].append(v)
            rec[k] = v
        if self._path:
            with open(self._path, "a") as f:
                f.write(json.dumps(rec) + "\n")

    def summary(self, step: int, prefix: str = "") -> str:
        parts = [f"{k}={v[-1]:.4f}" for k, v in sorted(self.history.items()) if v]
        return f"{prefix}[{step}] " + " ".join(parts)
