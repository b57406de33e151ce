"""Device-resident replay: time-major per-env rings + PER (dense
two-level sampler or binary sum tree) or uniform sampling.

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
    it, and a device scalar would cost a host sync per insert. A
    captured step (`utils/benchprog.py`) cannot read a host int that
    changes between replays, so it keeps the cursor as a device tensor
    too (`ReplayState.cursor`, the JAX version's `t` in the scan carry)
    and inserts and samples with `replay_insert_device` and
    `replay_sample_indices_device`: the same columns, leaves and
    weights, nothing read back to the host.
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

import contextlib
import dataclasses
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

from rltime_tpu_torch.ops import dense_tree, gather, sum_tree


def _tree_ops(cfg: "ReplayConfig"):
    """Priority-structure backend for this replay (see cfg.sampler)."""
    return dense_tree if cfg.sampler == "dense" else sum_tree


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
    # "dense" (ops/dense_tree.py: flat array + block sums, the default)
    # or "tree" (ops/sum_tree.py: the classic binary sum tree)
    sampler: str = "dense"
    # Ape-X actor-side initial priorities: when True and the chunk
    # carries a "priority" field (raw |TD| estimates from the actor),
    # activation uses (p + min_priority)^alpha instead of max-priority
    use_inserted_priorities: bool = False

    def __post_init__(self):
        if self.sampler not in ("dense", "tree"):
            raise ValueError(
                f"sampler must be 'dense' or 'tree', got "
                f"{self.sampler!r}")
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
    tree: torch.Tensor                 # dense (N,) priorities, (2N,) sum
                                       # tree, or a (1,) dummy if uniform
    max_priority: torch.Tensor         # f32 scalar, already ^alpha
    # the write cursor as a 0-d int64 tensor on the replay's device, for
    # the device-cursor functions; None where only `t` is kept. Those
    # functions leave `t` alone: their caller adds what they inserted.
    cursor: Optional[torch.Tensor] = None


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
    tree = (_tree_ops(cfg).init(cfg.capacity, device=device)
            if cfg.prioritized
            else torch.zeros((1,), dtype=torch.float32, device=device))
    return ReplayState(
        storage=storage, t=0, tree=tree,
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

    Writes columns [t, t+L) (mod T) for all envs in place and, when
    prioritized, zeroes the overwritten columns' priorities (and the
    columns `lookback` ahead, whose stack frames were clobbered) and
    activates columns [t-horizon, t+L-horizon): at max priority, or with
    `use_inserted_priorities` and a stored "priority" field at the
    actor's (p + min_priority)^alpha, which also raises max_priority."""
    T, L = cfg.steps_per_env, cfg.chunk_len
    col = state.t % T
    device = state.tree.device
    for name, arr in chunk.items():
        state.storage[name][:, col:col + L].copy_(_as_tensor(arr, device))
    if cfg.prioritized:
        _activate(cfg, state, col, state.t)
    state.t += L
    return state


def replay_insert_device(cfg: ReplayConfig, state: ReplayState,
                         chunk: Dict[str, Any]) -> ReplayState:
    """`replay_insert` at the device cursor `state.cursor`, for a step
    captured into a CUDA graph: the columns (t + arange(L)) mod T are
    written with one `index_copy_` per field, the dead and live leaves
    and their `act_u >= 0` rule are computed from the cursor on the
    device, and the cursor advances by L in place. The same bytes and
    leaves as `replay_insert` at the same cursor; `state.t` is not
    touched."""
    L, T = cfg.chunk_len, cfg.steps_per_env
    device = state.tree.device
    t = state.cursor
    col = torch.remainder(t, T)
    cols = torch.remainder(col + torch.arange(L, device=device), T)
    for name, arr in chunk.items():
        state.storage[name].index_copy_(1, cols, _as_tensor(arr, device))
    if cfg.prioritized:
        _activate(cfg, state, col, t)
    state.cursor.add_(L)
    return state


def replay_insert_at_cursor(cfg: ReplayConfig, state: ReplayState,
                            chunk: Dict[str, Any]) -> ReplayState:
    """`replay_insert_device` where the replay keeps a device cursor
    (`state.cursor`), else `replay_insert`."""
    insert = replay_insert if state.cursor is None else replay_insert_device
    return insert(cfg, state, chunk)


@contextlib.contextmanager
def replay_in_place(state: ReplayState):
    """Inserts and priority writes rebind `state.tree` (and, raising it,
    `state.max_priority`) to new tensors. On leaving the block, their
    values are copied into the tensors the state held on entering it and
    the state is rebound to those: a CUDA graph that captured the block
    reads and writes the same tensors on every replay."""
    tree, max_p = state.tree, state.max_priority
    yield state
    tree.copy_(state.tree)
    max_p.copy_(state.max_priority)
    state.tree, state.max_priority = tree, max_p


def _activate(cfg: ReplayConfig, state: ReplayState, col, t) -> None:
    """The leaf bookkeeping of an insert at cursor `t` (column `col` =
    t mod T), host ints or 0-d device tensors: zero the overwritten
    columns' leaves and those `lookback` ahead, then activate the columns
    `horizon` behind."""
    E, T, L = cfg.num_envs, cfg.steps_per_env, cfg.chunk_len
    device = state.tree.device
    st = _tree_ops(cfg)
    env_ids = torch.arange(E, device=device).repeat_interleave(L)
    offs = torch.arange(L, device=device).repeat(E)
    tree = state.tree
    dead = _flat_leaf(cfg, env_ids, torch.remainder(col + offs, T))
    tree = st.set_priorities(
        tree, dead, torch.zeros_like(dead, dtype=tree.dtype), unique=True)
    if cfg.lookback > 0:
        dead2 = _flat_leaf(cfg, env_ids,
                           torch.remainder(col + offs + cfg.lookback, T))
        tree = st.set_priorities(
            tree, dead2, torch.zeros_like(dead2, dtype=tree.dtype),
            unique=True)
    act_u = t + offs - cfg.horizon      # unwrapped times
    act_cols = torch.remainder(act_u, T)
    live = _flat_leaf(cfg, env_ids, act_cols)
    inserted = cfg.use_inserted_priorities and "priority" in state.storage
    if inserted:
        raw = state.storage["priority"][env_ids, act_cols]
        base = (raw + cfg.min_priority) ** cfg.alpha
    else:
        base = state.max_priority
    prio = torch.where(act_u >= 0, base,
                       torch.zeros((), dtype=tree.dtype, device=device))
    state.tree = st.set_priorities(tree, live, prio.to(tree.dtype),
                                   unique=True)
    if inserted:
        state.max_priority = torch.maximum(state.max_priority,
                                           torch.max(prio))


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
    """Sample (env, col) pairs + normalized importance weights.

    PER: a stratified draw from the priority structure with uniforms `u`
    (B,), or fresh ones from `generator`; weights (N*P)^-beta / max.
    Uniform (`prioritized=False`): iid over the valid unwrapped range,
    all weights 1; `u` is then the pair of integer draws (column offsets
    (B,) in [0, max(hi-lo, 1)), envs (B,) in [0, E)), the offsets drawn
    first. Returns dict(env int32, col int32, leaf int64, weight f32,
    num_valid)."""
    E, T = cfg.num_envs, cfg.steps_per_env
    lo, hi = valid_range(cfg, state.t)
    num_valid = (hi - lo) * E
    tree = state.tree
    if not cfg.prioritized:
        if u is None:
            u = (torch.randint(0, max(hi - lo, 1), (batch,),
                               generator=generator, device=tree.device),
                 torch.randint(0, E, (batch,), generator=generator,
                               device=tree.device))
        offset, env = (x.long() for x in u)
        col = torch.remainder(lo + offset, T)
        return dict(env=env.to(torch.int32), col=col.to(torch.int32),
                    leaf=_flat_leaf(cfg, env, col),
                    weight=torch.ones((batch,), dtype=torch.float32,
                                      device=tree.device),
                    num_valid=num_valid)
    return _per_sample(cfg, tree, batch, beta, num_valid, generator, u)


def replay_sample_indices_device(cfg: ReplayConfig, state: ReplayState,
                                 batch: int, beta,
                                 generator: Optional[torch.Generator] = None,
                                 u: Optional[torch.Tensor] = None):
    """`replay_sample_indices` at the device cursor `state.cursor`: the
    valid range and `num_valid` (a 0-d int64 tensor here) are computed on
    the device, so nothing is read back to the host and a captured step
    samples from the cursor of each replay. PER only: the uniform
    sampler's column bound is a host int (`torch.randint`)."""
    if not cfg.prioritized:
        raise ValueError("the device-cursor sampler is the PER sampler; "
                         "uniform replay draws its columns below a host "
                         "bound (ROADMAP.md queue 1 item 3)")
    t = state.cursor
    lo = torch.clamp(t - cfg.steps_per_env + cfg.lookback, min=0)
    hi = torch.maximum(t - cfg.horizon, lo)
    num_valid = (hi - lo) * cfg.num_envs
    return _per_sample(cfg, state.tree, batch, beta, num_valid, generator, u)


def _per_sample(cfg: ReplayConfig, tree: torch.Tensor, batch: int, beta,
                num_valid, generator, u):
    """The PER draw of both samplers. `num_valid` is a host int or a 0-d
    int64 tensor; either way N * P is one float32 product."""
    T = cfg.steps_per_env
    st = _tree_ops(cfg)
    if u is None:
        u = torch.rand((batch,), generator=generator, dtype=tree.dtype,
                       device=tree.device)
    leaf, prio = st.sample(tree, u)
    env = leaf // T
    col = leaf - env * T
    p = prio / torch.clamp(st.total(tree), min=1e-30)
    w = (num_valid * p) ** (-beta)
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
    writes priority 0 instead (drains truncation-biased windows).
    Uniform replay has no priorities: the state comes back as it is."""
    if not cfg.prioritized:
        return state
    p = (td_abs + cfg.min_priority) ** cfg.alpha
    if keep is not None:
        p = p * keep.to(p.dtype)
    st = _tree_ops(cfg)
    cur = st.get(state.tree, leaf)
    p = torch.where(cur > 0, p, torch.zeros_like(p))
    state.tree = st.set_priorities(state.tree, leaf, p)
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


def frame_stack_union_gather_nhwc(cfg: ReplayConfig, state: ReplayState,
                                  env: torch.Tensor, col: torch.Tensor,
                                  num_frames: int, n_step: int,
                                  obs_field: str = "obs",
                                  done_field: str = "done"):
    """The union gather emitted CHANNELS-LAST: (B, H, W, F) stacks.

    The same bytes as `frame_stack_union_gather` modulo the axis order
    (the JAX version builds them from one row gather per union slot).
    Here it is the one K2 launch followed by a layout change: the frame
    axis moves last and the result is made contiguous, so a
    `channels_last` torso gets NHWC memory. Returns (obs_t, obs_tn),
    each (B, ..., num_frames)."""
    return tuple(
        torch.movedim(x, 1, -1).contiguous()
        for x in frame_stack_union_gather(cfg, state, env, col, num_frames,
                                          n_step, obs_field, done_field))


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
    return stacks_from_window(rows, dones, length, F), dones, extras


def stacks_from_window(rows: torch.Tensor, dones: torch.Tensor,
                       length: int, num_frames: int) -> torch.Tensor:
    """The PyTorch half of `sequence_stack_gather`: the gathered obs
    window (B, length + F - 1, ...) and done window (B, length + D) to
    the masked per-step stacks (B, length, F, ...). The strided view
    costs nothing; the validity product writes every stack out."""
    F = num_frames
    D = max(F - 1, 1)
    B = rows.shape[0]
    row_shape = tuple(rows.shape[2:])
    stacks = rows.as_strided((B, length, F) + row_shape,
                             (rows.stride(0), rows.stride(1),
                              rows.stride(1)) + rows.stride()[2:])
    if F == 1:
        return stacks
    # done flags of step t's stack, old..new: done[col+t-j], j = F-1..1
    sd = dones[:, D - (F - 1):D - 1 + length]            # (B, length+F-2)
    sd = sd.unfold(1, F - 1, 1)                          # (B, length, F-1)
    valid = gather.stack_validity(sd.reshape(B * length, F - 1), rows.dtype)
    valid = valid.reshape((B, length, F) + (1,) * len(row_shape))
    return stacks * valid
