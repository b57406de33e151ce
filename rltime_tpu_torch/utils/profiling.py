"""Phase timers (port of `rltime_tpu/utils/profiling.py:PhaseTimers`).

Cheap wall-clock accounting of the trainer phases (act / insert /
insert+update), logged as scalars per log interval. CUDA work is
asynchronous, so a phase that launches device work passes `sync` (its
device) to end the phase only when the device has finished it.
"""
from __future__ import annotations

import contextlib
import time
from collections import defaultdict
from typing import Dict, Optional

import torch


class PhaseTimers:
    """Accumulate per-phase seconds between logs."""

    def __init__(self):
        self._acc: Dict[str, float] = defaultdict(float)

    @contextlib.contextmanager
    def phase(self, name: str, sync: Optional[torch.device] = None):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            if sync is not None and sync.type == "cuda":
                torch.cuda.synchronize(sync)
            self._acc[name] += time.perf_counter() - t0

    def pop(self) -> Dict[str, float]:
        out = dict(self._acc)
        self._acc.clear()
        return out
