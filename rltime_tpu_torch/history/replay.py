"""Device-resident replay: time-major per-env rings + dense PER.

Port of `rltime_tpu/history/replay.py`. Storage lives on the device as
fixed-shape `(E, T, ...)` tensors (env-major, time-minor); envs step in
lockstep, so one acting chunk writes the same column range for every
env. Raw per-step transitions are stored once and frame stacks and
n-step windows are gathered at sample time. A leaf's priority turns on
`horizon` columns behind the write cursor, so the priority array only
holds sampleable entries.

Differences from the JAX version, by design:
  * `replay_insert` writes the ring IN PLACE (`T % L == 0` makes the
    chunk one contiguous column slice) and mutates the state it is
    given; the JAX version donates and returns a new state.
  * The write cursor `t` is a host int: the insert slices the ring at
    it, and a device scalar would cost a host sync per insert.
  * Window gathers run on the CUDA kernels of `ops.gather`: all the
    strips, single columns and the R2D2 frame sequence of one update in
    one `window_gather_multi` launch (K1, `replay_gather_segments`), the
    FF learner's two frame stacks with their done-mask validity in one
    `union_stack_gather` launch (K2).

Invariants (held against the JAX version in tests/test_torch_replay.py):
  * leaf(e, c) > 0 implies column c has `horizon` successors stored;
  * an insert zeroes the overwritten columns' leaves first;
  * duplicate sampled indices get last-write-wins priority updates,
    and updates to since-overwritten leaves are dropped.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

from rltime_tpu_torch import not_ported
from rltime_tpu_torch.ops import dense_tree, gather


@dataclasses.dataclass(frozen=True)
class ReplayConfig:
    """Static replay geometry."""
    num_envs: int            # E: lockstep env lanes
    steps_per_env: int       # T: ring length per env (capacity = E*T)
    horizon: int             # gather window beyond the sampled column
    chunk_len: int           # L: acting chunk columns per insert
    lookback: int = 0        # backward gather reach (frame_stack - 1)
    prioritized: bool = True
    alpha: float = 0.6       # PER exponent (priorities stored ^alpha)
    min_priority: float = 1e-6
    sampler: str = "dense"
    use_inserted_priorities: bool = False

    def __post_init__(self):
        if self.sampler not in ("dense", "tree"):
            raise ValueError(
                f"sampler must be 'dense' or 'tree', got "
                f"{self.sampler!r}")
        if self.sampler == "tree":
            raise not_ported("replay.sampler='tree'", "sum_tree")
        if not self.prioritized:
            raise not_ported("replay.prioritized=false (uniform replay)",
                             "remaining options")
        if self.use_inserted_priorities:
            raise not_ported("replay.use_inserted_priorities",
                             "mesh, apex, pool")
        if self.steps_per_env % self.chunk_len != 0:
            raise ValueError("steps_per_env must be a multiple of "
                             "chunk_len (keeps ring inserts unsplit)")
        if self.steps_per_env < 2 * (self.chunk_len + self.horizon
                                     + self.lookback):
            raise ValueError(
                "steps_per_env too small: need >= 2*(chunk_len + "
                "horizon + lookback) so live/dead leaf windows "
                "cannot collide")

    @property
    def capacity(self) -> int:
        return self.num_envs * self.steps_per_env


@dataclasses.dataclass
class ReplayState:
    """Replay contents; the insert and the priority write-back update it
    in place."""
    storage: Dict[str, torch.Tensor]   # each (E, T, ...)
    t: int                             # unwrapped write cursor (columns)
    tree: torch.Tensor                 # (N,) dense PER priorities
    max_priority: torch.Tensor         # f32 scalar, already ^alpha


def replay_init(cfg: ReplayConfig,
                field_specs: Dict[str, Tuple[Tuple[int, ...], Any]],
                device: torch.device) -> ReplayState:
    """Allocate storage. field_specs: name -> (per-step shape, dtype)."""
    E, T = cfg.num_envs, cfg.steps_per_env
    storage = {
        name: torch.zeros((E, T) + tuple(shape), dtype=dtype,
                          device=device)
        for name, (shape, dtype) in field_specs.items()
    }
    return ReplayState(
        storage=storage, t=0,
        tree=dense_tree.init(cfg.capacity, device=device),
        max_priority=torch.ones((), dtype=torch.float32, device=device))


def _flat_leaf(cfg: ReplayConfig, env: torch.Tensor, col: torch.Tensor):
    """(env, ring column) -> priority leaf index."""
    return env * cfg.steps_per_env + col


def _as_tensor(x, device: torch.device) -> torch.Tensor:
    if isinstance(x, np.ndarray):
        x = torch.from_numpy(np.ascontiguousarray(x))
    return x.to(device)


def replay_insert(cfg: ReplayConfig, state: ReplayState,
                  chunk: Dict[str, Any]) -> ReplayState:
    """Insert an acting chunk (each field (E, L, ...), numpy or tensor).

    Writes columns [t, t+L) (mod T) for all envs in place, zeroes the
    overwritten columns' priorities (and the columns `lookback` ahead,
    whose stack frames were clobbered), and activates columns
    [t-horizon, t+L-horizon) at max priority."""
    E, T, L = cfg.num_envs, cfg.steps_per_env, cfg.chunk_len
    col = state.t % T
    device = state.tree.device
    for name, arr in chunk.items():
        state.storage[name][:, col:col + L].copy_(_as_tensor(arr, device))

    env_ids = torch.arange(E, device=device).repeat_interleave(L)
    offs = torch.arange(L, device=device).repeat(E)
    tree = state.tree
    dead = _flat_leaf(cfg, env_ids, torch.remainder(col + offs, T))
    tree = dense_tree.set_priorities(
        tree, dead, torch.zeros_like(dead, dtype=tree.dtype), unique=True)
    if cfg.lookback > 0:
        dead2 = _flat_leaf(cfg, env_ids,
                           torch.remainder(col + offs + cfg.lookback, T))
        tree = dense_tree.set_priorities(
            tree, dead2, torch.zeros_like(dead2, dtype=tree.dtype),
            unique=True)
    act_u = state.t + offs - cfg.horizon      # unwrapped times
    live = _flat_leaf(cfg, env_ids, torch.remainder(act_u, T))
    prio = torch.where(act_u >= 0, state.max_priority,
                       torch.zeros((), dtype=tree.dtype, device=device))
    state.tree = dense_tree.set_priorities(tree, live, prio, unique=True)
    state.t += L
    return state


def valid_range(cfg: ReplayConfig, t: int) -> Tuple[int, int]:
    """Unwrapped sampleable columns [lo, hi): full horizon stored
    ahead AND full lookback (stack frames) still un-overwritten."""
    lo = max(t - cfg.steps_per_env + cfg.lookback, 0)
    hi = max(t - cfg.horizon, lo)
    return lo, hi


def replay_sample_indices(cfg: ReplayConfig, state: ReplayState,
                          batch: int, beta,
                          generator: Optional[torch.Generator] = None,
                          u: Optional[torch.Tensor] = None):
    """PER sample of (env, col) pairs + normalized importance weights.

    Stratified dense-tree draw with uniforms `u` (B,), or fresh ones
    from `generator`; weights (N*P)^-beta / max. Returns
    dict(env int32, col int32, leaf int64, weight f32, num_valid)."""
    T = cfg.steps_per_env
    lo, hi = valid_range(cfg, state.t)
    num_valid = (hi - lo) * cfg.num_envs
    tree = state.tree
    if u is None:
        u = torch.rand((batch,), generator=generator, dtype=tree.dtype,
                       device=tree.device)
    leaf, prio = dense_tree.sample(tree, u)
    env = leaf // T
    col = leaf - env * T
    p = prio / torch.clamp(dense_tree.total(tree), min=1e-30)
    w = (float(num_valid) * p) ** (-beta)
    # a zero weight (not inf/NaN) is the safe failure on a zero leaf
    w = torch.where(prio > 0, w, torch.zeros_like(w))
    w = w / torch.clamp(torch.max(w), min=1e-30)
    return dict(env=env.to(torch.int32), col=col.to(torch.int32),
                leaf=leaf, weight=w.to(torch.float32),
                num_valid=num_valid)


def replay_update_priorities(cfg: ReplayConfig, state: ReplayState,
                             leaf: torch.Tensor, td_abs: torch.Tensor,
                             keep: Optional[torch.Tensor] = None
                             ) -> ReplayState:
    """Write |TD|-derived priorities p = (|td| + min_priority)^alpha.

    Updates to leaves zeroed since sampling (overwritten by inserts)
    are dropped so dead entries cannot be resurrected; `keep` (B,) 0/1
    writes priority 0 instead (drains truncation-biased windows)."""
    p = (td_abs + cfg.min_priority) ** cfg.alpha
    if keep is not None:
        p = p * keep.to(p.dtype)
    cur = dense_tree.get(state.tree, leaf)
    p = torch.where(cur > 0, p, torch.zeros_like(p))
    state.tree = dense_tree.set_priorities(state.tree, leaf, p)
    state.max_priority = torch.maximum(state.max_priority, torch.max(p))
    return state


def replay_gather_segments(cfg: ReplayConfig, state: ReplayState,
                           env: torch.Tensor, col: torch.Tensor,
                           segments) -> list:
    """Gather several windows at the same sampled (env, col) in ONE
    `window_gather_multi` (K1) launch (one per 8 segments).

    segments: (field, lead, window) triples; the result holds, in their
    order, field[env, col-lead : col-lead+window] (mod T) as
    (B, window, ...) tensors."""
    env, col = env.to(torch.int32), col.to(torch.int32)
    names, leads, windows = zip(*segments)
    return gather.window_gather_multi(
        [state.storage[name] for name in names], env, col, leads, windows)


def replay_gather_window(cfg: ReplayConfig, state: ReplayState,
                         env: torch.Tensor, col: torch.Tensor,
                         length: int, fields=None) -> Dict[str, torch.Tensor]:
    """Gather [col, col+length) (mod T) per sample: field -> (B, length, ...).

    All the fields are one K1 launch."""
    names = list(fields if fields is not None else state.storage)
    return dict(zip(names, replay_gather_segments(
        cfg, state, env, col, [(name, 0, length) for name in names])))


def frame_stack_gather(cfg: ReplayConfig, state: ReplayState,
                       env: torch.Tensor, col: torch.Tensor,
                       num_frames: int, obs_field: str = "obs",
                       done_field: str = "done") -> torch.Tensor:
    """Stacked observations (B, num_frames, ...), index 0 the OLDEST;
    frames from a previous episode are zeroed, as the actor's stacker
    does.

    The plain statement of the stacking rule (advanced indexing, no
    kernel). No learner path calls it: the updates take their stacks
    from `frame_stack_union_gather`, `sequence_stack_gather` or, at
    frame_stack 1, a window-1 segment. It stays as the reference the
    tests hold those against, and the JAX package's counterpart."""
    T = cfg.steps_per_env
    env = env.long()
    offs = torch.arange(num_frames - 1, -1, -1, device=col.device)
    cols = torch.remainder(col.long()[:, None] - offs[None, :], T)
    frames = state.storage[obs_field][env[:, None], cols]
    if num_frames == 1:
        return frames
    # done[c-j] for j in [1, F): the boundary between c-j and c-j+1
    dcols = torch.remainder(col.long()[:, None] - offs[None, :-1], T)
    dones = state.storage[done_field][env[:, None], dcols]  # (B, F-1)
    valid = gather.stack_validity(dones, frames.dtype)
    return frames * valid.reshape(valid.shape + (1,) * (frames.ndim - 2))


def frame_stack_union_gather(cfg: ReplayConfig, state: ReplayState,
                             env: torch.Tensor, col: torch.Tensor,
                             num_frames: int, n_step: int,
                             obs_field: str = "obs",
                             done_field: str = "done"):
    """Both of the FF learner's frame stacks from ONE kernel launch.

    The stacks at `col` and `col + n_step` overlap in F - n rows; the
    union window [col-F+1, col+n] is F+n rows. `union_stack_gather` (K2)
    reads each once and writes both stacks with the done-mask validity
    of `frame_stack_gather` applied, so the result is bit-identical to
    two separate stacks. Returns (obs_t, obs_tn), each
    (B, num_frames, ...)."""
    if num_frames <= 1:
        raise ValueError("union gather needs frame_stack > 1")
    return gather.union_stack_gather(
        state.storage[obs_field], state.storage[done_field],
        env.to(torch.int32), col.to(torch.int32), num_frames, n_step)


def sequence_stack_gather(cfg: ReplayConfig, state: ReplayState,
                          env: torch.Tensor, col: torch.Tensor,
                          length: int, num_frames: int, extra=()):
    """Per-step frame stacks over [col, col+length) from ONE obs window.

    The R2D2 learner's sequence: the stack of step t (column col+t) is
    `frame_stack_gather` at col+t, bit for bit. Instead of length
    separate F-row stacks, one window of length + F - 1 rows from
    col - (F-1) serves them all: step t's stack is rows [t, t+F) (a
    strided view), masked with the `stack_validity` rule on a done
    window from col - D, D = max(F-1, 1). `extra` holds further
    (field, lead, window) segments of `replay_gather_segments` (the
    learner's strips and its stored carry); frames, dones and extras
    travel in one K1 launch.

    Returns (stacks (B, length, F, ...), dones (B, length + D), extras)
    with dones[:, j] = done at column col - D + j, so the caller reads
    done_prev (done at col+t-1) as dones[:, D-1:D-1+length] and the
    boundary strip (done at col+t) as dones[:, D:D+length]; extras is
    the list of `extra`'s gathered tensors."""
    F = num_frames
    D = max(F - 1, 1)
    rows, dones, *extras = replay_gather_segments(
        cfg, state, env, col,
        [("obs", F - 1, length + F - 1),       # (B, length+F-1, ...)
         ("done", D, length + D),              # (B, length+D)
         *extra])
    B = rows.shape[0]
    row_shape = tuple(rows.shape[2:])
    stacks = rows.as_strided((B, length, F) + row_shape,
                             (rows.stride(0), rows.stride(1),
                              rows.stride(1)) + rows.stride()[2:])
    if F == 1:
        return stacks, dones, extras
    # done flags of step t's stack, old..new: done[col+t-j], j = F-1..1
    sd = dones[:, D - (F - 1):D - 1 + length]            # (B, length+F-2)
    sd = sd.unfold(1, F - 1, 1)                          # (B, length, F-1)
    valid = gather.stack_validity(sd.reshape(B * length, F - 1), rows.dtype)
    valid = valid.reshape((B, length, F) + (1,) * len(row_shape))
    return stacks * valid, dones, extras
