"""Replay window gathers: the CUDA kernels and their plain versions.

Both kernels compute the same contract,

    out[b, w] = storage[env[b], (col[b] + w) mod T]     (B, window, *row)

on a contiguous `(E, T, *row)` ring field of any dtype:

  * `window_gather` ports `rltime_tpu/ops/pallas_gather.py:window_gather`
    (K1): each sample's window is one contiguous span of the ring (two
    at the seam), split over many blocks (`csrc/window_gather.cu`). It
    serves every `history/replay.py:replay_gather_window` strip, the
    done window of both learners' frame stacks and the R2D2 learner's
    frame sequence.
  * `union_gather` ports `fused_union_gather` (K2): one block per
    (b, w) row (`csrc/union_gather.cu`), the FF learner's frame-stack
    union window. Rows keep their true width: the 1024-byte `pad_rows`
    pad was a TPU tiling need.

`window_gather_reference` (the counterpart of `pallas_gather.py:
window_gather_reference`) is the plain version of both. On a CUDA
tensor a wrapper launches its hand-written kernel (built by
`ops/_build.py`) or raises; on a CPU tensor it runs the plain version.
`LAUNCHES[name]` and `PLAIN_CALLS[name]` count the two per kernel, so a
run can show which path it took.
"""
from __future__ import annotations

import math

import torch

KERNELS = ("union_gather", "window_gather")
LAUNCHES = {name: 0 for name in KERNELS}      # kernel launches
PLAIN_CALLS = {name: 0 for name in KERNELS}   # calls the plain version served


def reset_counts() -> None:
    for name in KERNELS:
        LAUNCHES[name] = 0
        PLAIN_CALLS[name] = 0


def window_gather_reference(storage: torch.Tensor, env: torch.Tensor,
                            col: torch.Tensor, window: int) -> torch.Tensor:
    """Plain torch advanced indexing (any device)."""
    T = storage.shape[1]
    offs = torch.arange(window, device=col.device, dtype=torch.int64)
    cols = torch.remainder(col.long()[:, None] + offs[None, :], T)
    return storage[env.long()[:, None], cols]


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
    if env.shape != col.shape:
        raise ValueError("env and col must have the same shape")
    if window < 1:
        raise ValueError(f"window must be >= 1, got {window}")


def _launch(name: str, storage: torch.Tensor, env: torch.Tensor,
            col: torch.Tensor, window: int) -> torch.Tensor:
    """Run kernel `name` on CUDA tensors, or the plain version on CPU."""
    if storage.device.type == "cpu":
        PLAIN_CALLS[name] += 1
        return window_gather_reference(storage, env, col, window)
    if storage.device.type != "cuda":
        raise ValueError(f"unsupported device {storage.device}")
    T = storage.shape[1]
    B = env.shape[0]
    out = torch.empty((B, window) + tuple(storage.shape[2:]),
                      dtype=storage.dtype, device=storage.device)
    if out.numel() == 0:
        return out
    row_bytes = math.prod(storage.shape[2:]) * storage.element_size()
    from rltime_tpu_torch.ops import _build
    fn = getattr(_build.load(name), name)
    with torch.cuda.device(storage.device):
        stream = torch.cuda.current_stream(storage.device).cuda_stream
        err = fn(out.data_ptr(), storage.data_ptr(), env.data_ptr(),
                 col.data_ptr(), B, window, T, row_bytes, stream)
    if err != 0:
        raise RuntimeError(f"{name} kernel launch failed: CUDA error {err}")
    LAUNCHES[name] += 1
    return out


def window_gather(storage: torch.Tensor, env: torch.Tensor,
                  col: torch.Tensor, window: int) -> torch.Tensor:
    """Gather `window` consecutive ring columns from col[b] (wrapped).

    storage (E, T, *row) contiguous, any dtype (a (E, T) scalar field
    too); env, col int32 (B,) on the same device, env[b] in [0, E), col
    any int32 (negative wraps); window <= T. Returns (B, window, *row).
    """
    _check(storage, env, col, window)
    if window > storage.shape[1]:
        raise ValueError(f"window {window} exceeds the ring length "
                         f"{storage.shape[1]}")
    return _launch("window_gather", storage, env, col, window)


def union_gather(storage: torch.Tensor, env: torch.Tensor,
                 col0: torch.Tensor, window: int) -> torch.Tensor:
    """The frame-stack union window: `window` consecutive ring columns
    from col0[b] (wrapped), as `window_gather` computes them.

    storage (E, T, *row) contiguous with at least one row axis, any
    dtype; env, col0 int32 (B,) on the same device, env[b] in [0, E).
    Returns (B, window, *row)."""
    _check(storage, env, col0, window)
    if storage.ndim < 3:
        raise ValueError("storage must be a contiguous (E, T, *row) tensor, "
                         f"got shape {tuple(storage.shape)}")
    return _launch("union_gather", storage, env, col0, window)
