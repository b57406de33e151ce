"""Learner: the feed-forward DQN/IQN update step (port of
`training/learner.py`).

One update: PER sample -> both frame stacks with their done-mask
validity (one launch of the union-gather CUDA kernel) -> the n-step
strips and the action (one launch of the window-gather kernel, which at
frame_stack=1 also carries the two single frames) -> n-step double-Q
Huber loss, or the IQN quantile-Huber loss
over freshly drawn taus -> backward -> optax-rule global-norm clip ->
Adam -> periodic target sync -> priority write-back. Every tensor stays
on the device; metrics come back as device scalars, read only when the
trainer logs.

PyTorch runs eagerly, so JAX's `lax.scan` over K updates is a plain
loop (`make_insert_and_update_step`). The update mutates the model,
optimizer and replay state in place and returns them for symmetry with
the JAX API.
"""
from __future__ import annotations

import copy
import dataclasses
from typing import Dict, Optional, Sequence

import torch

from rltime_tpu_torch import not_ported
from rltime_tpu_torch.history.replay import (
    ReplayConfig, ReplayState, frame_stack_union_gather,
    replay_gather_segments, replay_insert, replay_sample_indices,
    replay_update_priorities,
)
from rltime_tpu_torch.models.policy import ModelConfig, QPolicy
from rltime_tpu_torch.ops import losses, returns
from rltime_tpu_torch.utils.prng import make_generator


@dataclasses.dataclass(frozen=True)
class AlgoConfig:
    """Training hyperparameters (same fields as the JAX version)."""
    algo: str = "dqn"
    batch_size: int = 32
    gamma: float = 0.99
    n_step: int = 1
    double_q: bool = True
    huber_kappa: float = 1.0
    lr: float = 1e-4
    lr_end: float = 0.0
    lr_decay_updates: int = 0     # linear LR decay (0 = constant)
    adam_eps: float = 1e-8
    optimizer: str = "adam"
    rmsprop_decay: float = 0.95
    grad_clip: float = 10.0
    target_update_freq: int = 500  # in learner updates
    per_beta_start: float = 0.4
    per_beta_end: float = 1.0
    exact_truncation: bool = True
    # The JAX version's fused online+target next-obs forward; here the
    # two no_grad forwards run either way (the same math).
    batched_next_forward: bool = False
    gather_barrier: bool = False
    num_tau: int = 64
    num_tau_prime: int = 64
    burn_in: int = 40
    seq_len: int = 80
    eta: float = 0.9
    value_rescale: bool = True
    use_lambda: bool = False
    lambda_: float = 0.7
    debug_outputs: bool = False   # sampled leaves + per-sample TD in metrics

    def __post_init__(self):
        if self.algo not in ("dqn", "iqn", "r2d2"):
            raise ValueError(f"unknown algo {self.algo!r}")
        if self.use_lambda and self.algo == "dqn":
            raise not_ported("algo.use_lambda with algo='dqn' (FF Q(lambda))",
                             "remaining options")
        if self.optimizer == "rmsprop":
            raise not_ported("algo.optimizer='rmsprop'",
                             "remaining options")
        if self.optimizer != "adam":
            raise ValueError(f"unknown optimizer {self.optimizer!r}")
        if self.gather_barrier:
            raise ValueError("algo.gather_barrier is an XLA scheduling knob "
                             "with no PyTorch meaning (ROADMAP.md: not to "
                             "port)")


@dataclasses.dataclass
class TrainState:
    model: QPolicy                 # online network
    target: QPolicy                # target network (no grad)
    optimizer: torch.optim.Adam
    generator: torch.Generator     # PER sampling uniforms, IQN taus
    updates: int = 0               # learner update counter


def make_optimizer(cfg: AlgoConfig, params) -> torch.optim.Adam:
    """Adam with optax.adam's formula (the clip is applied by hand in
    the update step, with optax's rule)."""
    return torch.optim.Adam(params, lr=cfg.lr, betas=(0.9, 0.999),
                            eps=cfg.adam_eps)


def learning_rate(cfg: AlgoConfig, count: int) -> float:
    """optax.linear_schedule(lr, lr_end, lr_decay_updates) at `count`
    updates already applied."""
    if cfg.lr_decay_updates <= 0:
        return cfg.lr
    frac = min(count, cfg.lr_decay_updates) / cfg.lr_decay_updates
    return cfg.lr + (cfg.lr_end - cfg.lr) * frac


def make_train_state(model_cfg: ModelConfig, algo_cfg: AlgoConfig,
                     in_shape: Sequence[int], seed: int,
                     device: torch.device) -> TrainState:
    """Init params on the CPU from a generator named after `seed` (so
    every device starts from the same weights), then move them."""
    model = QPolicy(model_cfg, in_shape,
                    make_generator(seed, "init")).to(device)
    target = copy.deepcopy(model).requires_grad_(False)
    return TrainState(
        model=model, target=target,
        optimizer=make_optimizer(algo_cfg, model.parameters()),
        generator=make_generator(seed, "sample", device))


def _gather_batch(replay_cfg: ReplayConfig, rstate: ReplayState,
                  env, col, frame_stack: int, n_step: int, flatten: bool):
    """Everything one FF update needs from the ring storage: the frame
    stacks (K2), and the n-step strips with the action in one K1
    launch, which at frame_stack=1 also carries the two single frames."""
    segments = [("reward", 0, n_step), ("done", 0, n_step),
                ("terminated", 0, n_step), ("action", 0, 1)]
    if frame_stack == 1:
        # a stack of one frame has no validity mask: the frames at col
        # and col + n_step are two more windows of one row
        segments += [("obs", 0, 1), ("obs", -n_step, 1)]
    reward, done, terminated, action, *frames = replay_gather_segments(
        replay_cfg, rstate, env, col, segments)
    # at frame_stack > 1 one union-window gather serves both stacks (F+n
    # rows vs 2F)
    obs_t, obs_tn = frames or frame_stack_union_gather(
        replay_cfg, rstate, env, col, frame_stack, n_step)
    if flatten:
        obs_t = obs_t.reshape(obs_t.shape[0], -1)
        obs_tn = obs_tn.reshape(obs_tn.shape[0], -1)
    # Windows whose first boundary is a TRUNCATION have no stored
    # bootstrap obs: excluded via trunc_ok (zero loss weight, zero
    # priority write-back; ops/returns.truncation_mask).
    trunc_ok = returns.truncation_mask(terminated, done)
    return dict(obs=obs_t, next_obs=obs_tn, action=action[:, 0],
                rewards=reward, boundary=done, trunc_ok=trunc_ok)


def _global_norm(tensors) -> torch.Tensor:
    """optax.global_norm: sqrt of the sum of all squared entries."""
    return torch.sqrt(sum(torch.sum(t * t) for t in tensors))


def apply_gradients(cfg: AlgoConfig, state: TrainState,
                    loss: torch.Tensor) -> torch.Tensor:
    """Backward of `loss` through the online net, optax-rule global-norm
    clip, Adam, the update count and the periodic target sync, in
    place. Returns the pre-clip gradient norm (as the JAX version
    reports it)."""
    params = list(state.model.parameters())
    grads = torch.autograd.grad(loss, params)
    g_norm = _global_norm(grads)
    if cfg.grad_clip > 0:
        # optax.clip_by_global_norm: scale only when g_norm >= max
        # (clip_grad_norm_'s max/(norm+1e-6) is a different rule)
        keep = g_norm < cfg.grad_clip
        grads = [torch.where(keep, g, (g / g_norm) * cfg.grad_clip)
                 for g in grads]
    for p, g in zip(params, grads):
        p.grad = g
    if cfg.lr_decay_updates > 0:
        for group in state.optimizer.param_groups:
            group["lr"] = learning_rate(cfg, state.updates)
    state.optimizer.step()
    state.optimizer.zero_grad(set_to_none=True)

    state.updates += 1
    if state.updates % cfg.target_update_freq == 0:
        with torch.no_grad():
            for tp, p in zip(state.target.parameters(), params):
                tp.copy_(p)
    return g_norm


def make_update_step(algo_cfg: AlgoConfig, replay_cfg: ReplayConfig,
                     frame_stack: int, flatten: bool):
    """Build the learner update.

    Returns fn(train_state, replay_state, beta, u=None, taus=None) ->
    (train_state, replay_state, metrics). `u` (B,) injects the PER
    uniforms and, for IQN, `taus` the three tau sets
    dict(taus (B, num_tau), taus_prime (B, num_tau_prime), taus_policy
    (B, num_tau_policy)) (tests); otherwise both come from
    train_state.generator, the PER uniforms first."""
    cfg = algo_cfg
    B = cfg.batch_size

    def dqn_loss(state: TrainState, batch, weight):
        model, target = state.model, state.target
        q_t = model(batch["obs"])
        with torch.no_grad():
            q_tn_target = target(batch["next_obs"])
            q_tn_online = (model(batch["next_obs"]) if cfg.double_q
                           else q_tn_target)
            rew, disc = returns.nstep_return(batch["rewards"],
                                             batch["boundary"], cfg.gamma)
            y = losses.double_q_target(q_tn_online, q_tn_target, rew, disc)
        loss, td_abs = losses.q_learning_loss(
            q_t, batch["action"], y, weights=weight, kappa=cfg.huber_kappa)
        return loss, td_abs, torch.mean(torch.max(q_t.detach(),
                                                  dim=-1).values)

    def iqn_loss(state: TrainState, batch, weight,
                 taus: Optional[Dict[str, torch.Tensor]]):
        model, target = state.model, state.target
        if taus is None:
            dev, gen = weight.device, state.generator
            taus = {name: torch.rand((B, n), generator=gen, device=dev)
                    for name, n in (
                        ("taus", cfg.num_tau),
                        ("taus_prime", cfg.num_tau_prime),
                        ("taus_policy", model.cfg.num_tau_policy))}
        quant_t = model(batch["obs"], taus=taus["taus"])     # (B, N, A)
        action = batch["action"].long()[:, None, None]
        q_sa = torch.gather(
            quant_t, 2, action.expand(-1, quant_t.shape[1], -1))[..., 0]
        with torch.no_grad():
            # a* from the online net's mean over policy taus (double-IQN)
            src = model if cfg.double_q else target
            quant_pol = src(batch["next_obs"], taus=taus["taus_policy"])
            a_star = torch.argmax(torch.mean(quant_pol, dim=1), dim=-1)
            quant_tn = target(batch["next_obs"], taus=taus["taus_prime"])
            q_next = torch.gather(
                quant_tn, 2, a_star[:, None, None].expand(
                    -1, quant_tn.shape[1], -1))[..., 0]
            rew, disc = returns.nstep_return(batch["rewards"],
                                             batch["boundary"], cfg.gamma)
            target_quant = rew[:, None] + disc[:, None] * q_next
        loss, td_abs = losses.quantile_huber_loss(
            q_sa, taus["taus"], target_quant, weights=weight,
            kappa=cfg.huber_kappa)
        return loss, td_abs, torch.mean(q_sa.detach())

    def update_step(state: TrainState, rstate: ReplayState, beta,
                    u: Optional[torch.Tensor] = None,
                    taus: Optional[Dict[str, torch.Tensor]] = None):
        idx = replay_sample_indices(replay_cfg, rstate, B, beta,
                                    generator=state.generator, u=u)
        batch = _gather_batch(replay_cfg, rstate, idx["env"], idx["col"],
                              frame_stack, cfg.n_step, flatten)
        trunc_ok = batch["trunc_ok"]
        if not cfg.exact_truncation:
            trunc_ok = torch.ones_like(trunc_ok)
        weight = idx["weight"] * trunc_ok

        if cfg.algo == "iqn":
            loss, td_abs, q_metric = iqn_loss(state, batch, weight, taus)
        else:
            loss, td_abs, q_metric = dqn_loss(state, batch, weight)
        g_norm = apply_gradients(cfg, state, loss)

        td_abs = td_abs.detach()
        replay_update_priorities(replay_cfg, rstate, idx["leaf"], td_abs,
                                 keep=trunc_ok)
        metrics = dict(loss=loss.detach(), q=q_metric,
                       td_abs=torch.mean(td_abs * trunc_ok),
                       grad_norm=g_norm,
                       mean_weight=torch.mean(idx["weight"]))
        if cfg.debug_outputs:
            metrics["debug_leaf"] = idx["leaf"]
            metrics["debug_td"] = td_abs
            metrics["debug_action"] = batch["action"]
        return state, rstate, metrics

    return update_step


def make_insert_and_update_step(replay_cfg: ReplayConfig, update_step,
                                num_updates: int):
    """{chunk insert + K update steps}; returns the LAST step's metrics.

    `draws`, a list of K keyword dicts (`u`, `taus`), injects each
    update's random draws (tests)."""

    def fused(state, rstate, chunk, beta, draws=None):
        rstate = replay_insert(replay_cfg, rstate, chunk)
        metrics = {}
        for k in range(num_updates):
            state, rstate, metrics = update_step(
                state, rstate, beta, **(draws[k] if draws else {}))
        return state, rstate, metrics

    return fused

