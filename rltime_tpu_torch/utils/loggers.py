"""Logging/observability (SURVEY.md §5.5).

Same scalar surface as the reference (episode reward mean/median,
loss, eps, priorities, acting fps) — needed for learning-curve parity
comparison — plus steps/s per chip, the [BJ] headline metric.
Sinks: stdout summary lines, JSONL (always), tensorboardX (if
available). A run directory holds config.json, scalars.jsonl,
checkpoints/.
"""
from __future__ import annotations

import json
import os
import time
from typing import Dict, Optional

try:
    from tensorboardX import SummaryWriter
    _HAS_TBX = True
except ImportError:  # pragma: no cover
    _HAS_TBX = False


class RunLogger:
    def __init__(self, result_dir: str, config: Optional[dict] = None,
                 use_tensorboard: bool = True):
        self.dir = result_dir
        os.makedirs(result_dir, exist_ok=True)
        if config is not None:
            with open(os.path.join(result_dir, "config.json"), "w") as f:
                json.dump(config, f, indent=2, default=str)
        self._jsonl = open(os.path.join(result_dir, "scalars.jsonl"), "a")
        self._tb = (SummaryWriter(os.path.join(result_dir, "tb"))
                    if (_HAS_TBX and use_tensorboard) else None)
        self._t0 = time.time()

    def log_scalars(self, step: int, scalars: Dict[str, float]):
        rec = {"step": int(step), "time": time.time() - self._t0}
        rec.update({k: float(v) for k, v in scalars.items()})
        self._jsonl.write(json.dumps(rec) + "\n")
        self._jsonl.flush()
        if self._tb is not None:
            for k, v in scalars.items():
                self._tb.add_scalar(k, float(v), step)

    def summary(self, step: int, scalars: Dict[str, float]):
        parts = " ".join(f"{k}={float(v):.4g}" for k, v in scalars.items())
        print(f"[{time.time() - self._t0:8.1f}s] step={step:>10} {parts}",
              flush=True)

    def close(self):
        self._jsonl.close()
        if self._tb is not None:
            self._tb.close()
