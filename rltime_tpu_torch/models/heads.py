"""Q-value heads: linear and dueling (port of `models/heads.py`).

Dueling: Q = V + A - mean_a A. The IQN head is a ROADMAP.md item.
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from rltime_tpu_torch.models.torso import dense, linear


class LinearQHead(nn.Module):
    def __init__(self, in_dim: int, num_actions: int,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.out = dense(in_dim, num_actions, generator)

    def forward(self, feat):
        return self.out(feat.to(torch.float32))


class DuelingQHead(nn.Module):
    """Hidden layers compute in `compute_dtype`; the value and advantage
    outputs in float32 (flax's `Dense(..., dtype=float32)`). Parameter
    creation follows flax's call order: V hidden, V out, A hidden,
    A out (`Dense_0..3`)."""

    def __init__(self, in_dim: int, num_actions: int, hidden: int = 256,
                 compute_dtype: torch.dtype = torch.float32,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.compute_dtype = compute_dtype
        self.v_hidden = dense(in_dim, hidden, generator)
        self.v_out = dense(hidden, 1, generator)
        self.a_hidden = dense(in_dim, hidden, generator)
        self.a_out = dense(hidden, num_actions, generator)

    def forward(self, feat):
        dt = self.compute_dtype
        v = F.relu(linear(feat, self.v_hidden, dt))
        v = self.v_out(v.to(torch.float32))
        a = F.relu(linear(feat, self.a_hidden, dt))
        a = self.a_out(a.to(torch.float32))
        return v + a - torch.mean(a, dim=-1, keepdim=True)
