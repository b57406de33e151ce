"""n-step returns and the exact-truncation mask.

Port of the two `rltime_tpu/ops/returns.py` functions the feed-forward
DQN update calls; the rest (lambda returns, the suffix mask, value
rescaling) are ROADMAP.md items. Same conventions: window arrays are
time-major on the trailing axis, index i is transition t+i.
"""
from __future__ import annotations

import torch


def nstep_return(rewards: torch.Tensor, terminated: torch.Tensor,
                 gamma: float):
    """n-step discounted reward sum with early termination.

    Args:
      rewards: (..., n) float, r_{t+i}.
      terminated: (..., n) bool/float, episode terminated at step t+i.
      gamma: discount.

    Returns (R, discount):
      R: (...,) = sum_i gamma^i * r_i * prod_{j<i}(1 - term_j)
      discount: (...,) = gamma^n * prod_i (1 - term_i).
    """
    term = terminated.to(rewards.dtype)
    n = rewards.shape[-1]
    alive = torch.cumprod(1.0 - term, dim=-1)   # alive[i] = prod_{j<=i}
    mask = torch.cat([torch.ones_like(alive[..., :1]), alive[..., :-1]],
                     dim=-1)
    gammas = gamma ** torch.arange(n, dtype=rewards.dtype,
                                   device=rewards.device)
    ret = torch.sum(rewards * mask * gammas, dim=-1)
    discount = (gamma ** n) * alive[..., -1]
    return ret, discount


def truncation_mask(terminated: torch.Tensor,
                    done: torch.Tensor) -> torch.Tensor:
    """1.0 where an n-step window's target is exact, 0.0 where biased.

    A window whose FIRST episode boundary is a truncation has no valid
    bootstrap obs (auto-reset discarded it): zero loss weight and zero
    priority write-back (see training/learner.py).

    Args: terminated, done: (..., n) window flags. Returns (...,) f32.
    """
    d = done.to(torch.bool)
    any_d = d.any(dim=-1)
    first = d.to(torch.int32).argmax(dim=-1)    # first True (0 if none)
    first_term = torch.gather(terminated.to(torch.bool), -1,
                              first[..., None]).squeeze(-1)
    bad = any_d & ~first_term
    return 1.0 - bad.to(torch.float32)
