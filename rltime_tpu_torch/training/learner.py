"""Learner: the feed-forward DQN/IQN update step (port of
`training/learner.py`).

One update: PER (or uniform) sample -> both frame stacks with their
done-mask validity (one launch of the union-gather CUDA kernel) -> the
n-step strips and the action (one launch of the window-gather kernel,
which at frame_stack=1 also carries the two single frames) -> n-step
double-Q Huber loss, Peng's Q(lambda) over the n-step window
(`use_lambda`: the frames of all n+1 stacks ride in the window-gather
launch instead), or the IQN quantile-Huber loss over freshly drawn taus
-> backward -> optax-rule global-norm clip -> Adam or centered RMSProp
-> periodic target sync -> priority write-back. Every tensor stays on
the device; metrics come back as device scalars, read only when the
trainer logs.

PyTorch runs eagerly, so JAX's `lax.scan` over K updates is a plain
loop (`make_insert_and_update_step`, `make_multi_update_step`). The
update splits into `sample_phase` and `apply_phase`, as the JAX
version's does, for the pipelined step
(`make_pipelined_insert_and_update_step`), which on the card samples
and gathers the next batch on a side stream while the current one
trains. The update mutates the model,
optimizer and replay state in place and returns them for symmetry with
the JAX API. The same update can be captured into a CUDA graph
(`utils/benchprog.py`, the trainers): with a device counter
(`TrainState.counter`, `use_device_counter`) and a device cursor
(`ReplayState.cursor`) it reads no host value that changes between
updates, the linear lr schedule included, and there Adam is
`capturable`.
"""
from __future__ import annotations

import copy
import dataclasses
from typing import Dict, Optional, Sequence

import torch

from rltime_tpu_torch.history.replay import (
    ReplayConfig, ReplayState, frame_stack_union_gather,
    frame_stack_union_gather_nhwc, replay_gather_segments,
    replay_insert_at_cursor, replay_sample_indices,
    replay_sample_indices_device,
    replay_update_priorities, sequence_stack_gather,
)
from rltime_tpu_torch.models.policy import ModelConfig, QPolicy
from rltime_tpu_torch.ops import losses, returns
from rltime_tpu_torch.utils.graphs import SideStream
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
    # The JAX version vmaps the online and target next-obs forwards over
    # the two stacked param trees (one batched program for XLA). The
    # port accepts the flag and runs the two no_grad forwards either
    # way: the same values (tests/test_torch_benchprog.py holds the
    # loss and targets with the flag on against the JAX package's).
    batched_next_forward: bool = False
    # The JAX version puts an optimization_barrier between the obs
    # gather and the convs, so that XLA keeps the gather a kernel of its
    # own. Here the gathers are kernels of their own and finish, in
    # stream order, before the convs read them: the flag changes no
    # value and no launch.
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
        if self.optimizer not in ("adam", "rmsprop"):
            raise ValueError(f"unknown optimizer {self.optimizer!r}")


@dataclasses.dataclass
class TrainState:
    model: QPolicy                 # online network
    target: QPolicy                # target network (no grad)
    optimizer: torch.optim.Optimizer   # Adam or CenteredRMSProp
    generator: torch.Generator     # PER sampling uniforms, IQN taus
    updates: int = 0               # learner update counter
    # the update counter as a 0-d int64 tensor on the device, for a
    # captured step: `apply_gradients` then counts and syncs the target
    # there and leaves `updates` to its caller. None: the host count.
    counter: Optional[torch.Tensor] = None


class CenteredRMSProp(torch.optim.Optimizer):
    """optax.rmsprop(lr, decay, eps, centered=True), by hand.

        mu <- decay mu + (1 - decay) g
        nu <- decay nu + (1 - decay) g^2
        p  <- p - lr g / sqrt(nu - mu^2 + eps)

    with zero initial `mu` and `nu` and eps INSIDE the root;
    `torch.optim.RMSprop` puts eps outside it. `mu` and `nu` live in the
    optimizer's per-parameter state, so checkpoints carry them. The lr
    may be a 0-d tensor (the device-counter route's schedule): the step
    then reads it on the device."""

    def __init__(self, params, lr: float, decay: float, eps: float):
        super().__init__(params, dict(lr=lr, decay=decay, eps=eps))

    @torch.no_grad()
    def step(self):
        for group in self.param_groups:
            params = [p for p in group["params"] if p.grad is not None]
            if not params:
                continue
            grads = [p.grad for p in params]
            for p in params:
                if not self.state[p]:
                    self.state[p] = dict(mu=torch.zeros_like(p),
                                         nu=torch.zeros_like(p))
            mus = [self.state[p]["mu"] for p in params]
            nus = [self.state[p]["nu"] for p in params]
            decay = group["decay"]
            torch._foreach_mul_(mus, decay)
            torch._foreach_add_(mus, grads, alpha=1.0 - decay)
            torch._foreach_mul_(nus, decay)
            torch._foreach_addcmul_(nus, grads, grads, value=1.0 - decay)
            var = torch._foreach_mul(mus, mus)
            torch._foreach_sub_(var, nus)           # mu^2 - nu
            torch._foreach_neg_(var)
            torch._foreach_add_(var, group["eps"])
            torch._foreach_sqrt_(var)
            lr = group["lr"]
            if isinstance(lr, torch.Tensor):
                # p - (lr g) / var, in addcdiv's order, the lr read on
                # the device
                step = torch._foreach_mul(grads, lr)
                torch._foreach_div_(step, var)
                torch._foreach_sub_(params, step)
            else:
                torch._foreach_addcdiv_(params, grads, var, value=-lr)


def make_optimizer(cfg: AlgoConfig, params,
                   capturable: bool = False) -> torch.optim.Optimizer:
    """Adam with optax.adam's formula, or optax's centered RMSProp (the
    clip is applied by hand in the update step, with optax's rule).

    `capturable` (a step that a CUDA graph holds; torch allows it on the
    card only): Adam's step count lives on the device and its bias
    corrections are device ops. An eager step keeps torch's host-scalar
    Adam, which launches less (PERF.md §6). `CenteredRMSProp` has
    no step count and reads nothing from the host either way."""
    if cfg.optimizer == "rmsprop":
        return CenteredRMSProp(params, lr=cfg.lr, decay=cfg.rmsprop_decay,
                               eps=cfg.adam_eps)
    return torch.optim.Adam(params, lr=cfg.lr, betas=(0.9, 0.999),
                            eps=cfg.adam_eps, capturable=capturable)


def learning_rate(cfg: AlgoConfig, count: int) -> float:
    """optax.linear_schedule(lr, lr_end, lr_decay_updates) at `count`
    updates already applied."""
    if cfg.lr_decay_updates <= 0:
        return cfg.lr
    frac = min(count, cfg.lr_decay_updates) / cfg.lr_decay_updates
    return cfg.lr + (cfg.lr_end - cfg.lr) * frac


def device_learning_rate(cfg: AlgoConfig, count: torch.Tensor
                         ) -> torch.Tensor:
    """`learning_rate` at a 0-d int64 count on the device, as a 0-d
    float32 tensor: optax.linear_schedule's own float32 formula,
    (lr - lr_end) * (1 - min(count, N) / N) + lr_end."""
    n = cfg.lr_decay_updates
    frac = 1 - torch.clamp(count, 0, n).to(torch.float32) / n
    return (cfg.lr - cfg.lr_end) * frac + cfg.lr_end


def use_device_counter(state: TrainState, cfg: AlgoConfig) -> TrainState:
    """Put the update count on the device, for a step that a CUDA graph
    holds or its eager body: `state.counter`, from `state.updates`. With
    a linear lr decay every param group's lr becomes a 0-d float32
    tensor beside the parameters, which `apply_gradients` writes from
    the counter before each step. torch's Adam takes a tensor lr without
    reading it back only where it is capturable, which torch allows on
    the card alone: there an Adam made without `capturable` becomes
    capturable (the eager body of a captured step), and on the CPU it
    steps parameter by parameter (`foreach=False`, the CPU's default),
    which reads the lr as a number. Call it before the first step."""
    device = next(state.model.parameters()).device
    state.counter = torch.tensor(state.updates, dtype=torch.int64,
                                 device=device)
    if cfg.lr_decay_updates > 0:
        lr = device_learning_rate(cfg, state.counter)
        for group in state.optimizer.param_groups:
            group["lr"] = lr.clone()
            if group.get("capturable") is False:
                if device.type == "cpu":
                    group["foreach"] = False
                else:
                    group["capturable"] = True
    return state


def make_train_state(model_cfg: ModelConfig, algo_cfg: AlgoConfig,
                     in_shape: Sequence[int], seed: int,
                     device: torch.device,
                     capturable: bool = False) -> TrainState:
    """Init params on the CPU from a generator named after `seed` (so
    every device starts from the same weights), then move them.
    `capturable`: see `make_optimizer`."""
    model = QPolicy(model_cfg, in_shape,
                    make_generator(seed, "init")).to(device)
    target = copy.deepcopy(model).requires_grad_(False)
    return TrainState(
        model=model, target=target,
        optimizer=make_optimizer(algo_cfg, model.parameters(), capturable),
        generator=make_generator(seed, "sample", device))


def _gather_batch(replay_cfg: ReplayConfig, rstate: ReplayState,
                  env, col, frame_stack: int, n_step: int, flatten: bool,
                  lambda_mode: bool = False, channels_last: bool = False):
    """Everything one FF update needs from the ring storage: the frame
    stacks (K2), and the n-step strips with the action in one K1
    launch, which at frame_stack=1 also carries the two single frames.

    `lambda_mode` (algo.use_lambda on the FF path): instead of ONE
    bootstrap stack at col+n, the per-step bootstrap stacks at
    col+1..col+n come back flattened to (B*n, ...) for one batched
    forward. The n+1 stacks at col..col+n overlap in all but n rows, so
    one F+n-row window serves them (`sequence_stack_gather`, as the R2D2
    sequence): frames, dones, strips and the action are ONE K1 launch
    and K2 is not launched. Exactness masking then uses the per-step
    suffix rule (a sample is biased iff the segment that holds step 0
    ends in a truncation inside the window)."""
    segments = [("reward", 0, n_step), ("done", 0, n_step),
                ("terminated", 0, n_step), ("action", 0, 1)]
    if lambda_mode:
        stacks, _, (reward, done, terminated, action) = (
            sequence_stack_gather(replay_cfg, rstate, env, col, n_step + 1,
                                  frame_stack, extra=segments))
        obs_t = stacks[:, 0]
        obs_tn = stacks[:, 1:].reshape((-1,) + tuple(stacks.shape[2:]))
    else:
        if frame_stack == 1:
            # a stack of one frame has no validity mask: the frames at
            # col and col + n_step are two more windows of one row
            segments += [("obs", 0, 1), ("obs", -n_step, 1)]
        reward, done, terminated, action, *frames = replay_gather_segments(
            replay_cfg, rstate, env, col, segments)
        if frames:
            obs_t, obs_tn = frames
        elif channels_last:
            # K2, then the layout change to NHWC
            obs_t, obs_tn = frame_stack_union_gather_nhwc(
                replay_cfg, rstate, env, col, frame_stack, n_step)
        else:
            # one union-window gather serves both stacks (F+n rows vs 2F)
            obs_t, obs_tn = frame_stack_union_gather(
                replay_cfg, rstate, env, col, frame_stack, n_step)
    if channels_last and (lambda_mode or frame_stack == 1):
        obs_t = torch.movedim(obs_t, 1, -1).contiguous()
        obs_tn = torch.movedim(obs_tn, 1, -1).contiguous()
    if flatten:
        obs_t = obs_t.reshape(obs_t.shape[0], -1)
        obs_tn = obs_tn.reshape(obs_tn.shape[0], -1)
    if lambda_mode:
        trunc_ok = returns.truncation_suffix_mask(terminated, done)[..., 0]
    else:
        # Windows whose first boundary is a TRUNCATION have no stored
        # bootstrap obs: excluded via trunc_ok (zero loss weight, zero
        # priority write-back; ops/returns.truncation_mask).
        trunc_ok = returns.truncation_mask(terminated, done)
    return dict(obs=obs_t, next_obs=obs_tn, action=action[:, 0],
                rewards=reward, boundary=done, trunc_ok=trunc_ok)


def _global_norm(tensors) -> torch.Tensor:
    """optax.global_norm: sqrt of the sum of all squared entries, as
    the norm of one copy of the entries in logical order. A reduction
    adds in memory order (and on the card reads an unaligned view by
    another path), and gradients come in more than one layout: autograd
    hands some weight gradients back transposed, a mesh hands them back
    as views of one flat buffer. Over the copy the norm depends on the
    values only."""
    return torch.linalg.vector_norm(
        torch.cat([t.reshape(-1) for t in tensors]))


def apply_gradients(cfg: AlgoConfig, state: TrainState,
                    loss: torch.Tensor, mesh=None) -> torch.Tensor:
    """Backward of `loss` through the online net, optax-rule global-norm
    clip, the optimizer's step (Adam or centered RMSProp), the update
    count and the periodic target sync, in place. Returns the pre-clip
    gradient norm (as the JAX version reports it).

    With a device counter (`state.counter`) the count is a device add
    and the sync a `torch.where` into each target tensor on
    counter % target_update_freq == 0, as the JAX version's `jnp.where`,
    and a linear lr decay writes each group's lr tensor in place from
    the count of updates before this one (`device_learning_rate`, as
    optax reads its own count): nothing is read back, so a CUDA graph
    can hold it.

    `mesh` (`parallel/mesh.py`): the gradients are averaged over its
    ranks in one all-reduce BEFORE the norm and the clip, where JAX's
    `pmean` sits ahead of optax's clip. (JAX averages the loss there
    too; the port's loss is only reported, and the sharded update
    averages it with the other metrics.)"""
    params = list(state.model.parameters())
    grads = torch.autograd.grad(loss, params)
    if mesh is not None:
        grads = mesh.mean_grads(grads)
    g_norm = _global_norm(grads)
    if cfg.grad_clip > 0:
        # optax.clip_by_global_norm: scale only when g_norm >= max
        # (clip_grad_norm_'s max/(norm+1e-6) is a different rule)
        keep = g_norm < cfg.grad_clip
        grads = [torch.where(keep, g, (g / g_norm) * cfg.grad_clip)
                 for g in grads]
    for p, g in zip(params, grads):
        p.grad = g
    if cfg.lr_decay_updates > 0 and state.counter is not None:
        lr = device_learning_rate(cfg, state.counter)
        for group in state.optimizer.param_groups:
            group["lr"].copy_(lr)
    elif cfg.lr_decay_updates > 0:
        for group in state.optimizer.param_groups:
            group["lr"] = learning_rate(cfg, state.updates)
    state.optimizer.step()
    state.optimizer.zero_grad(set_to_none=True)

    if state.counter is not None:
        state.counter.add_(1)
        sync = torch.remainder(state.counter, cfg.target_update_freq) == 0
        with torch.no_grad():
            for tp, p in zip(state.target.parameters(), params):
                torch.where(sync, p, tp, out=tp)
        return g_norm
    state.updates += 1
    if state.updates % cfg.target_update_freq == 0:
        with torch.no_grad():
            for tp, p in zip(state.target.parameters(), params):
                tp.copy_(p)
    return g_norm


def sample_indices(replay_cfg: ReplayConfig, rstate: ReplayState, batch: int,
                   beta, generator: torch.Generator,
                   u: Optional[torch.Tensor] = None):
    """The update's sample: at the device cursor where the replay keeps
    one (`replay_sample_indices_device`), else at the host int."""
    sample = (replay_sample_indices if rstate.cursor is None
              else replay_sample_indices_device)
    return sample(replay_cfg, rstate, batch, beta, generator=generator, u=u)


def make_update_step(algo_cfg: AlgoConfig, replay_cfg: ReplayConfig,
                     frame_stack: int, flatten: bool,
                     channels_last: bool = False, mesh=None):
    """Build the learner update. `channels_last`: the model takes
    (B, H, W, F) stacks (`model.channels_last`). `mesh`: average the
    gradients over its ranks (`apply_gradients`).

    Returns fn(train_state, replay_state, beta, u=None, taus=None) ->
    (train_state, replay_state, metrics). `u` injects the sampler's
    draws ((B,) PER uniforms, or uniform replay's pair of integer draws:
    `replay_sample_indices`) and, for IQN, `taus` the three tau sets
    dict(taus (B, num_tau), taus_prime (B, num_tau_prime), taus_policy
    (B, num_tau_policy)) (tests); otherwise both come from
    train_state.generator, the sampler's draws first. The update is
    `sample_phase` then `apply_phase`, attached to it as attributes."""
    cfg = algo_cfg
    B = cfg.batch_size
    if cfg.use_lambda and cfg.algo == "iqn":
        raise ValueError(
            "use_lambda is supported for algo='dqn' (FF Q-lambda) and "
            "'r2d2' (sequence Q-lambda), not 'iqn' — matching the "
            "reference's Q-learning-flavored lambda usage")
    lambda_mode = cfg.use_lambda and cfg.algo == "dqn"

    def dqn_loss(state: TrainState, batch, weight):
        model, target = state.model, state.target
        q_t = model(batch["obs"])
        with torch.no_grad():
            q_tn_target = target(batch["next_obs"])
            q_tn_online = (model(batch["next_obs"]) if cfg.double_q
                           else q_tn_target)
            if lambda_mode:
                # Peng's Q(lambda) over the n-window: next_obs holds the
                # B*n per-step bootstrap stacks; per-step double-Q V
                # estimates feed the backward lambda recursion, G[:, 0]
                # is the target. n_step=1 (any lambda) and lambda=1.0
                # both reduce exactly to the n-step path.
                n, A = cfg.n_step, q_t.shape[-1]
                q_tg_n = q_tn_target.reshape(-1, n, A)
                a_star = torch.argmax(q_tn_online.reshape(-1, n, A), dim=-1)
                v_next = torch.gather(q_tg_n, -1, a_star[..., None])[..., 0]
                y = returns.lambda_returns(
                    batch["rewards"], batch["boundary"], v_next, cfg.gamma,
                    cfg.lambda_)[..., 0]
            else:
                rew, disc = returns.nstep_return(
                    batch["rewards"], batch["boundary"], cfg.gamma)
                y = losses.double_q_target(q_tn_online, q_tn_target, rew,
                                           disc)
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

    def sample_phase(generator: torch.Generator, rstate: ReplayState,
                     beta, u: Optional[torch.Tensor] = None):
        """Everything of an update that only READS the replay state: the
        PER (or uniform) sample with its IS weights from `generator` (or
        `u`), both frame stacks (K2), the strips and the action (K1) and
        the truncation mask. Returns (idx, batch); batch["weight"] is the
        IS weight times batch["trunc_ok"]. Split out so that a pipelined
        caller can gather the next batch while this one trains
        (`make_pipelined_insert_and_update_step`). No cuBLAS call: the
        pipelined step runs it on a side stream."""
        idx = sample_indices(replay_cfg, rstate, B, beta, generator, u)
        batch = _gather_batch(replay_cfg, rstate, idx["env"], idx["col"],
                              frame_stack, cfg.n_step, flatten,
                              lambda_mode=lambda_mode,
                              channels_last=channels_last)
        if not cfg.exact_truncation:
            batch["trunc_ok"] = torch.ones_like(batch["trunc_ok"])
        batch["weight"] = idx["weight"] * batch["trunc_ok"]
        return idx, batch

    def apply_phase(state: TrainState, rstate: ReplayState, idx, batch,
                    taus: Optional[Dict[str, torch.Tensor]] = None,
                    join=None):
        """The loss on an already-gathered batch, backward, clip, the
        optimizer step, the count and target sync, and the priority
        write-back, in place. `taus` injects IQN's draws (else from
        state.generator). `join()`, where given, runs just before the
        write-back (the pipelined step's join: the side stream's sample
        reads the tree that the write-back replaces)."""
        trunc_ok = batch["trunc_ok"]
        if cfg.algo == "iqn":
            loss, td_abs, q_metric = iqn_loss(state, batch, batch["weight"],
                                              taus)
        else:
            loss, td_abs, q_metric = dqn_loss(state, batch, batch["weight"])
        g_norm = apply_gradients(cfg, state, loss, mesh)

        td_abs = td_abs.detach()
        if join is not None:
            join()
        replay_update_priorities(replay_cfg, rstate, idx["leaf"], td_abs,
                                 keep=trunc_ok)
        metrics = dict(loss=loss.detach(), q=q_metric,
                       td_abs=torch.mean(td_abs * trunc_ok),
                       grad_norm=g_norm,
                       mean_weight=torch.mean(idx["weight"]))
        if cfg.debug_outputs:
            # copies: a pipelined step's batch buffers are written again
            # two updates later
            metrics["debug_leaf"] = idx["leaf"].clone()
            metrics["debug_td"] = td_abs
            metrics["debug_action"] = batch["action"].clone()
        return state, rstate, metrics

    def update_step(state: TrainState, rstate: ReplayState, beta,
                    u: Optional[torch.Tensor] = None,
                    taus: Optional[Dict[str, torch.Tensor]] = None):
        idx, batch = sample_phase(state.generator, rstate, beta, u)
        return apply_phase(state, rstate, idx, batch, taus)

    update_step.sample_phase = sample_phase
    update_step.apply_phase = apply_phase
    return update_step


def _default_insert(replay_cfg: ReplayConfig):
    def insert(rstate, chunk):
        return replay_insert_at_cursor(replay_cfg, rstate, chunk)
    return insert


def make_insert_and_update_step(replay_cfg: ReplayConfig, update_step,
                                num_updates: int, insert=None):
    """{chunk insert + K update steps}; returns the LAST step's metrics.

    The insert is at the device cursor where the replay keeps one (the
    body a CUDA graph holds), else at the host int
    (`replay_insert_at_cursor`). `draws`, a list of K keyword dicts (`u`,
    `taus`), injects each update's random draws (tests). `insert(state,
    chunk)` replaces that insert (the sharded insert of
    `parallel/mesh.py`)."""
    insert = insert or _default_insert(replay_cfg)
    multi = make_multi_update_step(update_step, num_updates)

    def fused(state, rstate, chunk, beta, draws=None):
        return multi(state, insert(rstate, chunk), beta, draws)

    return fused


def make_pipelined_insert_and_update_step(replay_cfg: ReplayConfig,
                                          update_step, num_updates: int,
                                          insert=None):
    """{chunk insert + K updates} with software-pipelined sampling: each
    update trains on the batch sampled and gathered during the previous
    update, and samples and gathers the next one from the current state.

    Not a schedule of the same values but another algorithm, as in the
    JAX version: update k+1's PER sample reads the tree BEFORE update
    k's priority write-back (priorities one update stale, the async-PER
    relaxation of Ape-X), and the batch pending across a chunk boundary
    was sampled and gathered before that chunk's insert (a valid
    snapshot; write-backs to leaves the insert killed are dropped by
    `replay_update_priorities`, the reference's rule). Needs an update
    with `sample_phase` and `apply_phase` (the feed-forward learner's;
    the R2D2 update has none).

    The pending batch lives in two buffers that the step owns, made at
    its first sample and alternating by update parity. On the card each
    update forks the next batch's `sample_phase` onto one side stream
    (`utils/graphs.py:SideStream`, made once) into the free buffer,
    while the current stream runs `apply_phase`'s forward, backward and
    optimizer step on the other; the current stream joins the side
    stream before the priority write-back (it replaces the tree the
    sample reads), so every fork is joined before the next update and
    before the next chunk's insert (it writes the rings the gathers
    read). A CUDA graph that captures the step records both branches.
    On the CPU the same body runs in program order.

    Returns (prime, fused):
      prime(state, rstate, beta, u=None) -> (state, pending)
      fused(state, rstate, pending, chunk, beta, draws=None)
          -> (state, rstate, pending, metrics of the LAST update)
    `u` injects the first sample's draws; `draws`, K keyword dicts,
    injects each update's: `u` for the batch it samples, `taus` for the
    one it trains on (the JAX version's key order: prime splits
    (key, skey, tkey); update k splits (key, skey, tkey') and trains
    under the previous tkey). Without them every draw comes from
    state.generator in program order: a sample's uniforms, then the
    update's taus."""
    sample = getattr(update_step, "sample_phase", None)
    if sample is None:
        raise ValueError("pipelined sampling needs an update with "
                         "sample_phase and apply_phase (the feed-forward "
                         "DQN/IQN update); the R2D2 update has none")
    apply = update_step.apply_phase
    insert = insert or _default_insert(replay_cfg)
    slots = [None, None]        # the two pending-batch buffers
    side = SideStream()

    def sample_into(i, state, rstate, beta, u):
        idx, batch = sample(state.generator, rstate, beta, u)
        if slots[i] is None:
            slots[i] = tuple({k: torch.empty_like(v) if torch.is_tensor(v)
                              else v for k, v in d.items()}
                             for d in (idx, batch))
        for buf, d in zip(slots[i], (idx, batch)):
            for k, v in d.items():
                if torch.is_tensor(v):
                    buf[k].copy_(v)
                else:
                    buf[k] = v
        return slots[i]

    def prime(state, rstate, beta, u=None):
        return state, sample_into(0, state, rstate, beta, u)

    def fused(state, rstate, pending, chunk, beta, draws=None):
        rstate = insert(rstate, chunk)
        metrics = {}
        for k in range(num_updates):
            d = draws[k] if draws else {}
            free = 1 if pending is slots[0] else 0
            with side.fork(rstate.tree.device):
                nxt = sample_into(free, state, rstate, beta, d.get("u"))
            state, rstate, metrics = apply(state, rstate, *pending,
                                           taus=d.get("taus"),
                                           join=side.join)
            pending = nxt
        return state, rstate, pending, metrics

    return prime, fused


def make_multi_update_step(update_step, num_updates: int):
    """K update steps with no insert; returns the LAST step's metrics
    (the JAX version's `lax.scan` over K updates is a plain loop).
    `draws`, a list of K keyword dicts (`u`, `taus`), injects each
    update's random draws (tests)."""
    def multi(state, rstate, beta, draws=None):
        metrics = {}
        for k in range(num_updates):
            state, rstate, metrics = update_step(
                state, rstate, beta, **(draws[k] if draws else {}))
        return state, rstate, metrics

    return multi
