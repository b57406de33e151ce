"""Exact-numerics transcript harness.

A copy of `rltime_tpu/utils/transcript.py` (numpy, hashlib, json only)
that also takes tensors. A fixed-seed training run emits one record per
chunk:
  {env_steps, actions_digest, leaves, td_digest}
— the actor's chosen actions, the learner's sampled priority leaves,
and the per-sample |TD| magnitudes. Two runs (same seed, same draws,
any backend) must produce identical transcripts up to float tolerance;
the format is the JAX version's, so a transcript of the port can be
held against one of the JAX package.
"""
from __future__ import annotations

import hashlib
import json
from typing import Any, Dict, List

import numpy as np


def _to_numpy(a) -> np.ndarray:
    """numpy view of an array or of a tensor on any device."""
    if hasattr(a, "detach"):
        a = a.detach().cpu().numpy()
    return np.asarray(a)


def digest_array(a, decimals: int = 5) -> str:
    """Stable content hash; floats rounded to `decimals` so benign
    last-ulp differences across backends don't flip the digest."""
    a = _to_numpy(a)
    if np.issubdtype(a.dtype, np.floating):
        a = np.round(a.astype(np.float64), decimals)
    return hashlib.sha256(a.tobytes()).hexdigest()[:16]


class Transcript:
    def __init__(self, decimals: int = 5):
        self.records: List[Dict[str, Any]] = []
        self.decimals = decimals

    def record_chunk(self, env_steps: int, actions, metrics: Dict):
        rec: Dict[str, Any] = {
            "env_steps": int(env_steps),
            "actions": digest_array(actions),
        }
        if "debug_leaf" in metrics:
            rec["leaves"] = _to_numpy(metrics["debug_leaf"]).tolist()
            rec["td"] = digest_array(metrics["debug_td"], self.decimals)
        self.records.append(rec)

    def dump(self, path: str):
        with open(path, "w") as f:
            for r in self.records:
                f.write(json.dumps(r) + "\n")

    def digest(self) -> str:
        return hashlib.sha256(
            "\n".join(json.dumps(r) for r in self.records).encode()
        ).hexdigest()

    @staticmethod
    def load(path: str) -> "Transcript":
        t = Transcript()
        with open(path) as f:
            t.records = [json.loads(l) for l in f if l.strip()]
        return t
