"""n-step and lambda returns, truncation masks, value rescaling.

Port of `rltime_tpu/ops/returns.py`. Same conventions: window arrays
are time-major on the trailing axis, index i is transition t+i. The
JAX version's backward `lax.scan`s are Python loops over the window.
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


def truncation_suffix_mask(terminated: torch.Tensor,
                           done: torch.Tensor) -> torch.Tensor:
    """Per-step exactness mask for lambda returns over a window.

    Step t is biased iff the episode segment containing t ends in a
    truncation INSIDE the window: `bad` is carried backwards, set at a
    truncation, cleared at a termination.

    Args: terminated, done: (..., L). Returns (..., L) f32 (1 = exact).
    """
    term = terminated.to(torch.bool)
    trunc = done.to(torch.bool) & ~term
    bad = torch.zeros(trunc.shape[:-1], dtype=torch.bool,
                      device=trunc.device)
    bads = []
    for i in range(trunc.shape[-1] - 1, -1, -1):
        bad = torch.where(trunc[..., i], True,
                          torch.where(term[..., i], False, bad))
        bads.append(bad)
    return 1.0 - torch.stack(bads[::-1], dim=-1).to(torch.float32)


def lambda_returns(rewards: torch.Tensor, terminated: torch.Tensor,
                   values: torch.Tensor, gamma: float, lam: float):
    """Peng-style lambda returns over a window.

    Args:
      rewards: (..., n) r_{t+i}
      terminated: (..., n)
      values: (..., n) bootstrap values V(s_{t+i+1}).
    Returns G (..., n):
    G_i = r_i + gamma*(1-term_i) * ((1-lam) * V_{i+1} + lam * G_{i+1}),
    with G_{n-1} closing on V_n (values[..., n-1]).
    """
    cont = 1.0 - terminated.to(rewards.dtype)
    g = values[..., -1]
    gs = []
    for i in range(rewards.shape[-1] - 1, -1, -1):
        g = rewards[..., i] + gamma * cont[..., i] * (
            (1.0 - lam) * values[..., i] + lam * g)
        gs.append(g)
    return torch.stack(gs[::-1], dim=-1)


def _sqrt(x: torch.Tensor) -> torch.Tensor:
    """The correctly rounded square root, as XLA and CUDA compute it.

    torch's vectorised CPU sqrt is one ulp off on a fraction of float32
    inputs, and `value_rescale_inv` magnifies one ulp of its sqrt about
    a hundredfold through the cancellation in `a - 1`. A float64 sqrt
    rounded back to float32 is the correctly rounded result."""
    return torch.sqrt(x.double()).to(x.dtype)


def value_rescale(x: torch.Tensor, eps: float = 1e-3) -> torch.Tensor:
    """R2D2 invertible value rescaling h(x)."""
    return torch.sign(x) * (_sqrt(torch.abs(x) + 1.0) - 1.0) + eps * x


def value_rescale_inv(x: torch.Tensor, eps: float = 1e-3) -> torch.Tensor:
    """Inverse of `value_rescale` (closed form)."""
    a = _sqrt(1.0 + 4.0 * eps * (torch.abs(x) + 1.0 + eps))
    return torch.sign(x) * ((((a - 1.0) / (2.0 * eps)) ** 2) - 1.0)
