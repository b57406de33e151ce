"""Replay window gathers: the CUDA kernels and their plain versions.

Both kernels gather consecutive ring columns per sample,

    out[b, w] = storage[env[b], (col[b] + w) mod T]     (B, window, *row)

from contiguous `(E, T, *row)` ring fields of any dtype:

  * `window_gather_multi` (K1, `csrc/window_gather.cu`) ports
    `rltime_tpu/ops/pallas_gather.py:window_gather`: each sample's window
    is one contiguous span of the ring (two at the seam), split over many
    blocks. ONE launch serves up to 8 fields that share `(env, col)`,
    each with its own window and its own lead behind `col`: every strip,
    single column and frame sequence of one learner update.
    `window_gather` is its one-field case.
  * `union_stack_gather` (K2, `csrc/union_gather.cu`) ports
    `fused_union_gather` and what followed it in
    `history/replay.py:frame_stack_union_gather`: one block per row of
    the F+n-row union window reads it once and writes it to both frame
    stacks, zeros where the window's done flags cut it off from its
    stack's newest frame. `union_gather` is the raw union window from
    the same kernel (one output, no done flags). Rows keep their true
    width: the 1024-byte `pad_rows` pad was a TPU tiling need.

`window_gather_reference` and `union_stack_gather_reference` are the
plain versions. On a CUDA tensor a wrapper launches its hand-written
kernel (built by `ops/_build.py`) or raises; on a CPU tensor it runs the
plain version. `LAUNCHES[name]` counts kernel launches and
`PLAIN_CALLS[name]` the calls the plain version served in their place
(one per launch the card would have made), so a run can show which path
it took.
"""
from __future__ import annotations

import ctypes
import math
from typing import List, Optional, Sequence, Tuple

import torch

KERNELS = ("union_gather", "window_gather")
LAUNCHES = {name: 0 for name in KERNELS}      # kernel launches
PLAIN_CALLS = {name: 0 for name in KERNELS}   # launches the plain version served
MAX_SEGMENTS = 8            # fields per window_gather_multi launch
MAX_UNION_ROWS = 32         # F + n of union_stack_gather (one ballot)
MAX_RING_LENGTH = 2 ** 30   # T: column arithmetic stays inside int32


def reset_counts() -> None:
    for name in KERNELS:
        LAUNCHES[name] = 0
        PLAIN_CALLS[name] = 0


class _Segment(ctypes.Structure):
    """`WindowGatherSegment` of csrc/window_gather.cu."""
    _fields_ = [("out", ctypes.c_void_p), ("storage", ctypes.c_void_p),
                ("row_bytes", ctypes.c_int64), ("T", ctypes.c_int64),
                ("window", ctypes.c_int64), ("lead", ctypes.c_int64)]


def window_gather_reference(storage: torch.Tensor, env: torch.Tensor,
                            col: torch.Tensor, window: int) -> torch.Tensor:
    """Plain torch advanced indexing (any device)."""
    T = storage.shape[1]
    offs = torch.arange(window, device=col.device, dtype=torch.int64)
    cols = torch.remainder(col.long()[:, None] + offs[None, :], T)
    return storage[env.long()[:, None], cols]


def stack_validity(dones: torch.Tensor, dtype) -> torch.Tensor:
    """(B, F-1) done flags old..new -> (B, F) frame validity: slot i is
    valid iff no done in (c-(F-1-i), c]."""
    dnf = dones.to(torch.float32)
    rev_cum = torch.flip(torch.cumprod(torch.flip(1.0 - dnf, [1]), dim=1),
                         [1])
    return torch.cat([rev_cum, torch.ones_like(rev_cum[:, :1])],
                     dim=1).to(dtype)


def union_stack_gather_reference(obs_storage: torch.Tensor,
                                 done_storage: torch.Tensor,
                                 env: torch.Tensor, col: torch.Tensor,
                                 num_frames: int, n_step: int
                                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain torch version of `union_stack_gather` (any device): the
    union rows and their done flags by advanced indexing, the validity
    by `stack_validity`, two multiplies."""
    F, n = num_frames, n_step
    W = F + n
    col0 = col - (F - 1)
    rows = window_gather_reference(obs_storage, env, col0, W)
    # done flag above union row j: done[col-F+1+j], j in [0, W-1)
    dones = window_gather_reference(done_storage, env, col0, W - 1)
    shape0 = (rows.shape[0], F) + (1,) * (rows.ndim - 2)
    v_t = stack_validity(dones[:, :F - 1], rows.dtype).reshape(shape0)
    v_tn = stack_validity(dones[:, n:n + F - 1], rows.dtype).reshape(shape0)
    return rows[:, :F] * v_t, rows[:, n:n + F] * v_tn


def _check(storage: torch.Tensor, env: torch.Tensor, col: torch.Tensor,
           window: int) -> None:
    if storage.ndim < 2 or not storage.is_contiguous():
        raise ValueError("storage must be a contiguous (E, T, *row) tensor, "
                         f"got shape {tuple(storage.shape)}")
    for name, t in (("env", env), ("col", col)):
        if t.dtype != torch.int32 or t.ndim != 1:
            raise ValueError(f"{name} must be int32 (B,), got {t.dtype} "
                             f"{tuple(t.shape)}")
        if t.device != storage.device:
            raise ValueError(f"{name} is on {t.device}, storage on "
                             f"{storage.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if env.shape != col.shape:
        raise ValueError("env and col must have the same shape")
    if window < 1:
        raise ValueError(f"window must be >= 1, got {window}")
    if storage.device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {storage.device}")
    if storage.shape[1] > MAX_RING_LENGTH:
        raise ValueError(f"ring length {storage.shape[1]} exceeds "
                         f"{MAX_RING_LENGTH} (the kernels wrap columns in "
                         "int32)")


def _row_bytes(storage: torch.Tensor) -> int:
    return math.prod(storage.shape[2:]) * storage.element_size()


def _stream(device: torch.device) -> int:
    return torch.cuda.current_stream(device).cuda_stream


def window_gather_multi(storages: Sequence[torch.Tensor], env: torch.Tensor,
                        col: torch.Tensor, leads: Sequence[int],
                        windows: Sequence[int]) -> List[torch.Tensor]:
    """Gather several ring fields at the same sampled (env, col):

        out[s][b, w] = storages[s][env[b], (col[b] - leads[s] + w) mod T_s]

    for w < windows[s]. Each storage (E_s, T_s, *row_s) contiguous, any
    dtype (a (E, T) scalar field too), all on one device; env, col
    int32 (B,) on that device, env[b] in [0, E_s), col any int32 (what
    falls below 0 wraps); leads any ints; windows[s] <= T_s. Returns
    one (B, windows[s], *row_s) tensor per field. On the card every 8
    fields are one kernel launch."""
    if not (len(storages) == len(leads) == len(windows) > 0):
        raise ValueError("storages, leads and windows must have the same "
                         "non-zero length")
    device = storages[0].device
    for storage, window in zip(storages, windows):
        _check(storage, env, col, window)
        if window > storage.shape[1]:
            raise ValueError(f"window {window} exceeds the ring length "
                             f"{storage.shape[1]}")
        if storage.device != device:
            raise ValueError("all storages must be on one device")
    groups = -(-len(storages) // MAX_SEGMENTS)
    if device.type == "cpu":
        PLAIN_CALLS["window_gather"] += groups
        return [window_gather_reference(s, env, col - lead if lead else col, w)
                for s, lead, w in zip(storages, leads, windows)]
    B = env.shape[0]
    outs = [torch.empty((B, w) + tuple(s.shape[2:]), dtype=s.dtype,
                        device=device) for s, w in zip(storages, windows)]
    if B == 0:
        return outs
    from rltime_tpu_torch.ops import _build
    fn = _build.load("window_gather").window_gather_multi
    with torch.cuda.device(device):
        stream = _stream(device)
        for g in range(groups):
            lo = g * MAX_SEGMENTS
            num = min(MAX_SEGMENTS, len(storages) - lo)
            segs = (_Segment * num)(*(
                _Segment(outs[i].data_ptr(), storages[i].data_ptr(),
                         _row_bytes(storages[i]), storages[i].shape[1],
                         windows[i], leads[i])
                for i in range(lo, lo + num)))
            err = fn(segs, num, env.data_ptr(), col.data_ptr(), B, stream)
            if err != 0:
                raise RuntimeError("window_gather kernel launch failed: "
                                   f"CUDA error {err}")
            LAUNCHES["window_gather"] += 1
    return outs


def window_gather(storage: torch.Tensor, env: torch.Tensor,
                  col: torch.Tensor, window: int) -> torch.Tensor:
    """Gather `window` consecutive ring columns from col[b] (wrapped).

    storage (E, T, *row) contiguous, any dtype (a (E, T) scalar field
    too); env, col int32 (B,) on the same device, env[b] in [0, E), col
    any int32 (negative wraps); window <= T. Returns (B, window, *row).
    The one-field case of `window_gather_multi`."""
    return window_gather_multi([storage], env, col, [0], [window])[0]


def _launch_union(out_t: torch.Tensor, out_tn: Optional[torch.Tensor],
                  storage: torch.Tensor, done: Optional[torch.Tensor],
                  env: torch.Tensor, col: torch.Tensor, F: int, n: int,
                  lead: int) -> None:
    if out_t.numel() == 0:
        return
    from rltime_tpu_torch.ops import _build
    fn = _build.load("union_gather").union_stack_gather
    with torch.cuda.device(storage.device):
        err = fn(out_t.data_ptr(),
                 None if out_tn is None else out_tn.data_ptr(),
                 storage.data_ptr(),
                 None if done is None else done.data_ptr(),
                 env.data_ptr(), col.data_ptr(), env.shape[0], F, n, lead,
                 storage.shape[1], _row_bytes(storage),
                 _stream(storage.device))
    if err != 0:
        raise RuntimeError(f"union_gather kernel launch failed: CUDA error "
                           f"{err}")
    LAUNCHES["union_gather"] += 1


def union_gather(storage: torch.Tensor, env: torch.Tensor,
                 col0: torch.Tensor, window: int) -> torch.Tensor:
    """The raw frame-stack union window: `window` consecutive ring
    columns from col0[b] (wrapped), as `window_gather` computes them.

    storage (E, T, *row) contiguous with at least one row axis, any
    dtype; env, col0 int32 (B,) on the same device, env[b] in [0, E).
    Returns (B, window, *row)."""
    _check(storage, env, col0, window)
    if storage.ndim < 3:
        raise ValueError("storage must be a contiguous (E, T, *row) tensor, "
                         f"got shape {tuple(storage.shape)}")
    if storage.device.type == "cpu":
        PLAIN_CALLS["union_gather"] += 1
        return window_gather_reference(storage, env, col0, window)
    out = torch.empty((env.shape[0], window) + tuple(storage.shape[2:]),
                      dtype=storage.dtype, device=storage.device)
    _launch_union(out, None, storage, None, env, col0, window, 0, 0)
    return out


def union_stack_gather(obs_storage: torch.Tensor, done_storage: torch.Tensor,
                       env: torch.Tensor, col: torch.Tensor,
                       num_frames: int, n_step: int
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Both frame stacks of a feed-forward update from one kernel.

    With col0 = col - (F-1), F = num_frames, n = n_step:

        obs_t [b, i] = obs[env[b], (col0[b] + i)     mod T] * v_t [b, i]
        obs_tn[b, i] = obs[env[b], (col0[b] + n + i) mod T] * v_tn[b, i]
        v_t [b, i] = 1 iff no done[env[b], (col0[b] + j)     mod T], j in [i, F-1)
        v_tn[b, i] = 1 iff no done[env[b], (col0[b] + n + j) mod T], j in [i, F-1)

    for i < F (index 0 the OLDEST frame; frames of a previous episode
    are zeroed). obs_storage (E, T, *row) contiguous with at least one
    row axis, any dtype; done_storage (E, T) bool, contiguous; env, col
    int32 (B,), all on one device; F >= 2, n >= 1, F + n <= 32. Returns
    (obs_t, obs_tn), each (B, F, *row). The kernel writes zero bytes
    (+0.0) where the plain version multiplies by 0, so on a float ring
    the two agree under `torch.equal` (it equates -0.0 and 0.0) for
    finite values."""
    F, n = num_frames, n_step
    _check(obs_storage, env, col, F)
    if obs_storage.ndim < 3:
        raise ValueError("obs_storage must be a contiguous (E, T, *row) "
                         f"tensor, got shape {tuple(obs_storage.shape)}")
    if F < 2 or n < 1 or F + n > MAX_UNION_ROWS:
        raise ValueError(f"need num_frames >= 2, n_step >= 1 and their sum "
                         f"<= {MAX_UNION_ROWS}, got {F} and {n}")
    if (done_storage.dtype != torch.bool
            or done_storage.shape != obs_storage.shape[:2]
            or not done_storage.is_contiguous()
            or done_storage.device != obs_storage.device):
        raise ValueError(
            "done_storage must be a contiguous bool (E, T) tensor beside "
            f"obs_storage, got {done_storage.dtype} "
            f"{tuple(done_storage.shape)} on {done_storage.device}")
    if obs_storage.device.type == "cpu":
        PLAIN_CALLS["union_gather"] += 1
        return union_stack_gather_reference(obs_storage, done_storage, env,
                                            col, F, n)
    shape = (env.shape[0], F) + tuple(obs_storage.shape[2:])
    out_t = torch.empty(shape, dtype=obs_storage.dtype,
                        device=obs_storage.device)
    out_tn = torch.empty_like(out_t)
    _launch_union(out_t, out_tn, obs_storage, done_storage, env, col, F, n,
                  F - 1)
    return out_t, out_tn
