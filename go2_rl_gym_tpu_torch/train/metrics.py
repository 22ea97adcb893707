"""Metrics sink (copy of go2_rl_gym_tpu/train/metrics.py): a TensorBoard
writer where torch's SummaryWriter can be made, always a JSONL mirror.

Counterpart of the reference's SummaryWriter usage
(rsl_rl/runners/on_policy_runner.py:116) with identical scalar tags, so
existing tooling (reference tools/logs_merge.py analogue) keeps working.
"""
from __future__ import annotations

import json
import os
import time
from typing import Dict


class MetricsWriter:
    def __init__(self, log_dir: str):
        self.log_dir = log_dir
        os.makedirs(log_dir, exist_ok=True)
        self._jsonl = open(os.path.join(log_dir, "metrics.jsonl"), "a")
        self._tb = None
        try:
            from torch.utils.tensorboard import SummaryWriter
            self._tb = SummaryWriter(log_dir=log_dir, flush_secs=10)
        except Exception:
            pass

    def add_scalar(self, tag: str, value, step: int):
        value = float(value)
        if self._tb is not None:
            self._tb.add_scalar(tag, value, step)
        self._jsonl.write(json.dumps(
            {"tag": tag, "value": value, "step": int(step), "t": time.time()}) + "\n")

    def add_scalars(self, scalars: Dict[str, float], step: int):
        for tag, v in scalars.items():
            self.add_scalar(tag, v, step)

    def flush(self):
        if self._tb is not None:
            self._tb.flush()
        self._jsonl.flush()

    def close(self):
        self.flush()
        if self._tb is not None:
            self._tb.close()
        self._jsonl.close()
