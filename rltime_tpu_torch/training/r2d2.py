"""R2D2: recurrent sequence replay with burn-in + stored LSTM state.

Port of `rltime_tpu/training/r2d2.py`. A sampled column `s` starts the
burn-in window; the replay ring serves the whole [s, s+burn+len+n)
window in ONE launch of the window-gather kernel (K1,
`history/replay.py:sequence_stack_gather`): the frame sequence of
total + F - 1 rows per sample, the done strip (stack masks, `done_prev`
and the boundary flags), the action/reward/terminated strips and the
stored carry at `s`.

The unroll starts from the carry the actor stored at `s`. Burn-in warms
it with the ONLINE net under `no_grad` (so its gradient is exactly
zero); both nets warm from the same stored carry. Targets are per-step
n-step (or Peng Q(lambda)) double-Q targets through the value rescaling
h / h^-1, the Huber loss is masked where a target is truncation-biased,
and the sequence priority is the eta-mix of max and mean |TD|.

Where the JAX version `lax.scan`s the whole model per step, the port
runs each net's torso once over all B*total frames and its head once
over the stacked LSTM outputs, and loops only the cell
(`models/policy.py:unroll_features`): the same math.
"""
from __future__ import annotations

from typing import Optional

import torch

from rltime_tpu_torch.history.replay import (
    ReplayConfig, ReplayState, replay_update_priorities,
    sequence_stack_gather,
)
from rltime_tpu_torch.models.policy import (
    ModelConfig, head_seq, unroll_features,
)
from rltime_tpu_torch.ops import losses, returns
from rltime_tpu_torch.training.learner import (
    AlgoConfig, TrainState, apply_gradients, sample_indices,
)


def r2d2_horizon(algo_cfg: AlgoConfig) -> int:
    return algo_cfg.burn_in + algo_cfg.seq_len + algo_cfg.n_step


def _take(q: torch.Tensor, a: torch.Tensor) -> torch.Tensor:
    """q[..., a] along the last axis."""
    return torch.gather(q, -1, a.long()[..., None]).squeeze(-1)


def make_r2d2_update_step(model_cfg: ModelConfig, algo_cfg: AlgoConfig,
                          replay_cfg: ReplayConfig, frame_stack: int,
                          flatten: bool, mesh=None):
    """Build the R2D2 update (same signature as the FF one; `mesh`
    averages the gradients over its ranks, `learner.apply_gradients`).

    Returns fn(train_state, replay_state, beta, u=None) ->
    (train_state, replay_state, metrics). `u` (B,) injects the PER
    uniforms (tests); otherwise they come from train_state.generator."""
    if not model_cfg.recurrent:
        raise ValueError("r2d2 requires lstm_size > 0")
    if model_cfg.channels_last:
        raise ValueError(
            "channels_last is an FF-learner option (the r2d2 sequence "
            "unroll feeds (B, F, H, W) per step)")
    cfg = algo_cfg
    B = cfg.batch_size
    burn, L, n = cfg.burn_in, cfg.seq_len, cfg.n_step
    total = burn + L + n
    D = max(frame_stack - 1, 1)     # done-strip lead (sequence_stack_gather)

    def h(x):
        return returns.value_rescale(x) if cfg.value_rescale else x

    def h_inv(x):
        return returns.value_rescale_inv(x) if cfg.value_rescale else x

    def targets(q_on: torch.Tensor, q_tg: torch.Tensor, r_full, b_full,
                t_full):
        """(target, tmask), each (B, L), from the (B, L+n) strips."""
        if cfg.use_lambda:
            # Peng's Q(lambda) over the training window, V from the
            # (double-Q) target net
            q_tg_nx = q_tg[:, 1:1 + L]
            a_star = torch.argmax(q_on[:, 1:1 + L] if cfg.double_q
                                  else q_tg_nx, dim=-1)
            v_next = h_inv(_take(q_tg_nx, a_star))
            target = h(returns.lambda_returns(
                r_full[:, :L], b_full[:, :L], v_next, cfg.gamma,
                cfg.lambda_))
            # steps whose segment ends in a truncation inside the
            # window have biased lambda returns
            tmask = returns.truncation_suffix_mask(t_full[:, :L],
                                                   b_full[:, :L])
            return target, tmask
        # per-step n-step windows (B, L, n) from the (B, L+n) strips
        idx = (torch.arange(L, device=r_full.device)[:, None]
               + torch.arange(n, device=r_full.device)[None, :])
        rew_n, disc_n = returns.nstep_return(r_full[:, idx], b_full[:, idx],
                                             cfg.gamma)
        q_tg_next = q_tg[:, n:n + L]
        a_star = torch.argmax(q_on[:, n:n + L] if cfg.double_q
                              else q_tg_next, dim=-1)
        target = h(rew_n + disc_n * h_inv(_take(q_tg_next, a_star)))
        # windows whose first boundary is a truncation are biased
        tmask = returns.truncation_mask(t_full[:, idx], b_full[:, idx])
        return target, tmask

    def update_step(state: TrainState, rstate: ReplayState, beta,
                    u: Optional[torch.Tensor] = None):
        idx = sample_indices(replay_cfg, rstate, B, beta, state.generator, u)
        env, col = idx["env"], idx["col"]
        # the strips over the window and the stored carry at col (if col
        # starts an episode, the unroll resets it anyway) ride with the
        # frames and the done strip
        stacks, dones, (action, reward, terminated, rnn_c, rnn_h) = (
            sequence_stack_gather(
                replay_cfg, rstate, env, col, total, frame_stack,
                extra=[("action", 0, total), ("reward", 0, total),
                       ("terminated", 0, total), ("rnn_c", 0, 1),
                       ("rnn_h", 0, 1)]))
        obs = stacks.reshape(B, total, -1) if flatten else stacks
        # done_prev[t] = done at col+t-1 (the episode ended before t)
        done_prev = dones[:, D - 1:D - 1 + total]
        boundary = dones[:, D:D + total]
        state0 = (rnn_c[:, 0], rnn_h[:, 0])

        model, target = state.model, state.target
        warm = state0
        if burn > 0:
            with torch.no_grad():     # burn-in: warm the carry, no gradient
                _, warm = unroll_features(model, obs[:, :burn],
                                          done_prev[:, :burn], state0)
        h_on, _ = unroll_features(model, obs[:, burn:], done_prev[:, burn:],
                                  warm)
        q_on = head_seq(model, h_on)                   # (B, L+n, A)
        with torch.no_grad():
            # the target net warms from the same stored carry: one
            # unroll over burn-in and the train+target region
            h_tg, _ = unroll_features(target, obs, done_prev, state0)
            q_tg = head_seq(target, h_tg[:, burn:])
            target_q, tmask = targets(q_on.detach(), q_tg,
                                      reward[:, burn:],
                                      boundary[:, burn:],
                                      terminated[:, burn:])

        q_sa = _take(q_on[:, :L], action[:, burn:burn + L])
        td = target_q - q_sa                             # (B, L)
        per_step = losses.huber(td, cfg.huber_kappa)
        mask = tmask if cfg.exact_truncation else torch.ones_like(td)
        loss = torch.mean(torch.sum(per_step * mask, dim=-1)
                          / torch.clamp(torch.sum(mask, dim=-1), min=1.0)
                          * idx["weight"])
        prio = losses.sequence_priority(torch.abs(td.detach()), mask,
                                        cfg.eta)
        g_norm = apply_gradients(cfg, state, loss, mesh)

        replay_update_priorities(replay_cfg, rstate, idx["leaf"], prio)
        metrics = dict(loss=loss.detach(), q=torch.mean(q_sa.detach()),
                       td_abs=torch.mean(prio), grad_norm=g_norm,
                       mean_weight=torch.mean(idx["weight"]))
        if cfg.debug_outputs:
            metrics["debug_leaf"] = idx["leaf"]
            metrics["debug_td"] = prio
        return state, rstate, metrics

    return update_step
