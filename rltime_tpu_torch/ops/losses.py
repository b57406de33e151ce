"""Huber / double-DQN target / weighted TD loss / sequence priority.

Port of the `rltime_tpu/ops/losses.py` functions the DQN and R2D2
updates call; the IQN quantile-Huber loss is a ROADMAP.md item.
Per-sample |TD| is returned for PER.
"""
from __future__ import annotations

import torch


def huber(x: torch.Tensor, kappa: float = 1.0) -> torch.Tensor:
    """Elementwise Huber loss of a residual x."""
    ax = torch.abs(x)
    quad = torch.clamp(ax, max=kappa)
    return 0.5 * quad * quad + kappa * (ax - quad)


def double_q_target(q_next_online: torch.Tensor,
                    q_next_target: torch.Tensor,
                    rewards: torch.Tensor, discounts: torch.Tensor):
    """Double-DQN n-step target: a* = argmax_a Q_online(s'),
    y = R_n + discount * Q_target(s', a*). `discounts` already folds in
    gamma^n and termination (see ops.returns.nstep_return)."""
    a_star = torch.argmax(q_next_online, dim=-1)
    q_boot = torch.gather(q_next_target, -1, a_star[..., None]).squeeze(-1)
    return rewards + discounts * q_boot


def q_learning_loss(q, actions, targets, weights=None, kappa: float = 1.0):
    """Weighted Huber TD loss; returns (scalar_loss, |td| per sample)."""
    q_sa = torch.gather(q, -1, actions.long()[..., None]).squeeze(-1)
    td = targets - q_sa
    per_sample = huber(td, kappa)
    if weights is not None:
        per_sample = per_sample * weights
    return torch.mean(per_sample), torch.abs(td)


def sequence_priority(td_abs: torch.Tensor, mask: torch.Tensor,
                      eta: float = 0.9) -> torch.Tensor:
    """R2D2 sequence priority: eta*max + (1-eta)*mean over valid steps.

    td_abs: (B, T) per-step |TD|; mask: (B, T) 1.0 for steps that
    contribute to the loss. Returns (B,)."""
    m = mask.to(td_abs.dtype)
    masked = td_abs * m
    mx = torch.max(masked, dim=-1).values
    mean = torch.sum(masked, dim=-1) / torch.clamp(torch.sum(m, dim=-1),
                                                   min=1.0)
    return eta * mx + (1.0 - eta) * mean
