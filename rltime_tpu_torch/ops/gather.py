"""Replay union-window gather: the CUDA kernel and its plain version.

    union_gather(storage, env, col0, window) -> (B, window, *row)
    out[b, w] = storage[env[b], (col0[b] + w) mod T]

Port of `rltime_tpu/ops/pallas_gather.py:fused_union_gather` (the TPU
kernel) with `window_gather_reference` as the plain version. Rows keep
their true width: the 1024-byte `pad_rows` pad was a TPU tiling need.

On a CUDA tensor `union_gather` launches the hand-written kernel in
`csrc/union_gather.cu` (built by `ops/_build.py`) or raises; on a CPU
tensor it runs `union_gather_reference`. `LAUNCHES` and `PLAIN_CALLS`
count the two, so a run can show which path it took.
"""
from __future__ import annotations

import math

import torch

LAUNCHES = 0       # kernel launches
PLAIN_CALLS = 0    # union_gather calls served by the plain version


def reset_counts() -> None:
    global LAUNCHES, PLAIN_CALLS
    LAUNCHES = 0
    PLAIN_CALLS = 0


def union_gather_reference(storage: torch.Tensor, env: torch.Tensor,
                           col0: torch.Tensor, window: int) -> torch.Tensor:
    """Plain torch advanced indexing (any device)."""
    T = storage.shape[1]
    offs = torch.arange(window, device=col0.device, dtype=torch.int64)
    cols = torch.remainder(col0.long()[:, None] + offs[None, :], T)
    return storage[env.long()[:, None], cols]


def _check(storage: torch.Tensor, env: torch.Tensor, col0: torch.Tensor,
           window: int) -> None:
    if storage.ndim < 3 or not storage.is_contiguous():
        raise ValueError("storage must be a contiguous (E, T, *row) tensor, "
                         f"got shape {tuple(storage.shape)}")
    for name, t in (("env", env), ("col0", col0)):
        if t.dtype != torch.int32 or t.ndim != 1:
            raise ValueError(f"{name} must be int32 (B,), got {t.dtype} "
                             f"{tuple(t.shape)}")
        if t.device != storage.device:
            raise ValueError(f"{name} is on {t.device}, storage on "
                             f"{storage.device}")
    if env.shape != col0.shape:
        raise ValueError("env and col0 must have the same shape")
    if window < 1:
        raise ValueError(f"window must be >= 1, got {window}")


def union_gather(storage: torch.Tensor, env: torch.Tensor,
                 col0: torch.Tensor, window: int) -> torch.Tensor:
    """Gather `window` consecutive ring columns from col0[b] (wrapped).

    storage (E, T, *row) contiguous, any dtype; env, col0 int32 (B,) on
    the same device, env[b] in [0, E). Returns (B, window, *row)."""
    global LAUNCHES, PLAIN_CALLS
    _check(storage, env, col0, window)
    if storage.device.type == "cpu":
        PLAIN_CALLS += 1
        return union_gather_reference(storage, env, col0, window)
    if storage.device.type != "cuda":
        raise ValueError(f"unsupported device {storage.device}")
    T = storage.shape[1]
    B = env.shape[0]
    out = torch.empty((B, window) + tuple(storage.shape[2:]),
                      dtype=storage.dtype, device=storage.device)
    row_bytes = math.prod(storage.shape[2:]) * storage.element_size()
    if out.numel() == 0:
        return out
    from rltime_tpu_torch.ops import _build
    lib = _build.load()
    with torch.cuda.device(storage.device):
        stream = torch.cuda.current_stream(storage.device).cuda_stream
        err = lib.union_gather(out.data_ptr(), storage.data_ptr(),
                               env.data_ptr(), col0.data_ptr(), B, window,
                               T, row_bytes, stream)
    if err != 0:
        raise RuntimeError(f"union_gather kernel launch failed: CUDA "
                           f"error {err}")
    LAUNCHES += 1
    return out
