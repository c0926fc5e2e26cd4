"""Training statistics with median smoothing and JSON-line output.

A copy of sad_tpu/utils/stats.py. Capability-equivalent to
detectron/lib/utils/training_stats.py:37-115: per-loss median filtering over
a 20-iter window, total-loss tracking, ETA, data-queue depth and device
memory stats, emitted as one JSON line every LOG_PERIOD iters
(utils/logging.py log_json_stats)."""

from __future__ import annotations

import datetime
import json
from collections import deque
from typing import Dict, Optional

import numpy as np

from .logging import log_json_stats
from .timer import Timer

LOG_PERIOD = 20
WIN_SZ = 20


class SmoothedValue:
    def __init__(self, window_size: int = WIN_SZ):
        self.deque = deque(maxlen=window_size)
        self.total = 0.0
        self.count = 0

    def add_value(self, value: float):
        self.deque.append(value)
        self.count += 1
        self.total += value

    def get_median_value(self) -> float:
        return float(np.median(self.deque)) if self.deque else 0.0

    def get_global_avg(self) -> float:
        return self.total / max(self.count, 1)


class TrainingStats:
    def __init__(
        self,
        max_iter: int,
        log_period: int = LOG_PERIOD,
        log_file: Optional[str] = None,
    ):
        """log_file: optional path; every logged stats dict is also appended
        there as one JSON line."""
        self.max_iter = max_iter
        self.log_period = log_period
        self.log_file = log_file
        self.iter_timer = Timer()
        self.smoothed: Dict[str, SmoothedValue] = {}
        self.smoothed_total_loss = SmoothedValue()
        self.cur_iter = 0

    def iter_tic(self):
        self.iter_timer.tic()

    def iter_toc(self):
        return self.iter_timer.toc(average=False)

    def update_iter_stats(self, cur_iter: int, metrics: Dict[str, float]):
        self.cur_iter = cur_iter
        for k, v in metrics.items():
            if k == "loss":
                self.smoothed_total_loss.add_value(float(v))
            self.smoothed.setdefault(k, SmoothedValue()).add_value(float(v))

    def get_stats(self, cur_iter: int, lr: float, extra: Optional[dict] = None):
        eta_seconds = self.iter_timer.average_time * (self.max_iter - cur_iter)
        stats = {
            "iter": cur_iter,
            "time": round(self.iter_timer.average_time, 6),
            "eta": str(datetime.timedelta(seconds=int(eta_seconds))),
            "lr": round(float(lr), 8),
            "loss": round(self.smoothed_total_loss.get_median_value(), 6),
        }
        for k, v in sorted(self.smoothed.items()):
            if k != "loss":
                stats[k] = round(v.get_median_value(), 6)
        if extra:
            stats.update(extra)
        return stats

    def log_iter_stats(self, cur_iter: int, lr: float, extra: Optional[dict] = None):
        if (cur_iter % self.log_period == 0) or (cur_iter == self.max_iter - 1):
            stats = self.get_stats(cur_iter, lr, extra)
            log_json_stats(stats)
            if self.log_file:
                with open(self.log_file, "a") as f:
                    f.write(json.dumps(stats, sort_keys=True) + "\n")
