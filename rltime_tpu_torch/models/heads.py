"""Q-value heads: linear, dueling, IQN (port of `models/heads.py`).

Dueling: Q = V + A - mean_a A. IQN: cosine tau embedding, elementwise
product with the torso features, shared head over the taus.
"""
from __future__ import annotations

import math
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


class IQNHead(nn.Module):
    """Implicit-quantile head.

    phi(tau) = relu(Dense(cos(pi * i * tau), i = 0..embed_dim-1));
    quantile features = feat * phi(tau); the head maps them to per-action
    quantile values, with the dueling aggregation per tau when
    `dueling`. Parameter creation follows flax's call order: `tau_embed`,
    then `Dense_0..1` (hidden, out) or, dueling, `Dense_0..3` (V hidden,
    V out, A hidden, A out)."""

    def __init__(self, in_dim: int, num_actions: int, embed_dim: int = 64,
                 dueling: bool = False, hidden: int = 256,
                 compute_dtype: torch.dtype = torch.float32,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.compute_dtype = compute_dtype
        self.embed_dim = embed_dim
        self.dueling = dueling
        self.tau_embed = dense(embed_dim, in_dim, generator)
        if dueling:
            self.v_hidden = dense(in_dim, hidden, generator)
            self.v_out = dense(hidden, 1, generator)
            self.a_hidden = dense(in_dim, hidden, generator)
            self.a_out = dense(hidden, num_actions, generator)
        else:
            self.hidden = dense(in_dim, hidden, generator)
            self.out = dense(hidden, num_actions, generator)

    def forward(self, feat, taus):
        """feat (B, D); taus (B, N) -> quantile values (B, N, A)."""
        dt = self.compute_dtype
        i = torch.arange(self.embed_dim, dtype=torch.float32,
                         device=taus.device)
        cos = torch.cos(math.pi * taus[..., None] * i)       # (B, N, E)
        phi = F.relu(linear(cos, self.tau_embed, dt))        # (B, N, D)
        h = feat[:, None, :].to(dt) * phi
        if not self.dueling:
            q = F.relu(linear(h, self.hidden, dt))
            return self.out(q.to(torch.float32))
        v = F.relu(linear(h, self.v_hidden, dt))
        v = self.v_out(v.to(torch.float32))
        a = F.relu(linear(h, self.a_hidden, dt))
        a = self.a_out(a.to(torch.float32))
        return v + a - torch.mean(a, dim=-1, keepdim=True)
