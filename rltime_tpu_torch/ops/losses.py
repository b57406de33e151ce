"""Huber / double-DQN target / weighted TD loss / IQN quantile-Huber /
sequence priority (port of `rltime_tpu/ops/losses.py`).
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


def quantile_huber_loss(quantiles: torch.Tensor, taus: torch.Tensor,
                        target_quantiles: torch.Tensor, weights=None,
                        kappa: float = 1.0):
    """IQN pairwise quantile-Huber (pinball) loss.

    quantiles (B, N): predicted quantile values of the taken action at
    fractions taus (B, N); target_quantiles (B, N'): target samples (no
    gradient flows into them); weights: optional (B,) importance
    weights. Returns (scalar_loss, per-sample mean |pairwise TD| (B,),
    the priority signal)."""
    target = target_quantiles.detach()
    # pairwise residuals: u[b, j, i] = target[b, j] - pred[b, i]
    u = target[:, :, None] - quantiles[:, None, :]
    indicator = (u < 0.0).to(quantiles.dtype)
    rho = torch.abs(taus[:, None, :] - indicator) * huber(u, kappa) / kappa
    # sum over prediction quantiles i, mean over target samples j
    loss = torch.sum(torch.mean(rho, dim=1), dim=-1)
    if weights is not None:
        loss = loss * weights
    return torch.mean(loss), torch.mean(torch.abs(u), dim=(1, 2))


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
