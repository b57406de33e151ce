"""Embedding torsos: MLP, MinAtar CNN and Nature CNN (port of
`models/torso.py`).

Compute may run in bfloat16 while the parameters stay float32: each
layer casts its input and parameters to the compute dtype, as flax's
`dtype=` does, and the torso's output is cast back to float32.
Parameters are initialised as flax does (lecun_normal kernels, zero
biases) from an explicit generator.
"""
from __future__ import annotations

import math
from typing import Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn


def lecun_normal_(w: torch.Tensor, fan_in: int,
                  generator: Optional[torch.Generator]) -> None:
    """flax's default kernel init: truncated normal (+-2 std) with
    variance 1/fan_in, std corrected for the truncation."""
    std = math.sqrt(1.0 / fan_in) / 0.87962566103423978
    with torch.no_grad():
        nn.init.trunc_normal_(w, 0.0, std, -2.0 * std, 2.0 * std,
                              generator=generator)


def dense(in_dim: int, out_dim: int,
          generator: Optional[torch.Generator]) -> nn.Linear:
    lin = nn.Linear(in_dim, out_dim)
    lecun_normal_(lin.weight, in_dim, generator)
    nn.init.zeros_(lin.bias)
    return lin


def linear(x: torch.Tensor, lin: nn.Linear,
           dtype: torch.dtype) -> torch.Tensor:
    """`lin(x)` computed in `dtype` (flax Dense with dtype=)."""
    return F.linear(x.to(dtype), lin.weight.to(dtype), lin.bias.to(dtype))


class MLPTorso(nn.Module):
    def __init__(self, in_dim: int, hidden: Sequence[int] = (64, 64),
                 compute_dtype: torch.dtype = torch.float32,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.compute_dtype = compute_dtype
        dims = [in_dim] + list(hidden)
        self.layers = nn.ModuleList(
            dense(a, b, generator) for a, b in zip(dims[:-1], dims[1:]))
        self.out_dim = dims[-1]

    def forward(self, x):
        x = x.to(self.compute_dtype).reshape(x.shape[0], -1)
        for lin in self.layers:
            x = F.relu(linear(x, lin, self.compute_dtype))
        return x.to(torch.float32)


class MinAtarCNNTorso(nn.Module):
    """MinAtar conv torso (Young & Tian 2019): 3x3/1 conv(s) + FC.

    Input: (B, H, W, C) binary planes straight from a device env (uint8
    0/1: cast, NOT divided by 255), or (B, F, H, W, C) from the replay
    gather, whose frame axis merges into the channels frame-major (as
    the JAX version's `moveaxis(x, 1, -2).reshape(b, h, w, f * c)`;
    MinAtar uses F=1). `in_shape` is (F, H, W, C). The conv runs NCHW
    and its output is flattened in NHWC order, as flax's is, so the FC
    weight is the transposed flax kernel with no row permutation."""

    def __init__(self, in_shape: Sequence[int],
                 channels: Sequence[int] = (16,), fc: int = 128,
                 compute_dtype: torch.dtype = torch.float32,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.compute_dtype = compute_dtype
        f, h, w, c = in_shape
        c = f * c
        convs = []
        for ch in channels:
            conv = nn.Conv2d(c, ch, 3)
            lecun_normal_(conv.weight, 9 * c, generator)
            nn.init.zeros_(conv.bias)
            convs.append(conv)
            c, h, w = ch, h - 2, w - 2
        self.convs = nn.ModuleList(convs)
        self.fc = dense(c * h * w, fc, generator)
        self.out_dim = fc

    def forward(self, x):
        dt = self.compute_dtype
        if x.ndim == 5:
            b, f, h, w, c = x.shape
            x = x.permute(0, 1, 4, 2, 3).reshape(b, f * c, h, w)
        else:
            x = x.permute(0, 3, 1, 2)
        x = x.to(dt)
        for conv in self.convs:
            x = F.relu(F.conv2d(x, conv.weight.to(dt), conv.bias.to(dt)))
        x = x.permute(0, 2, 3, 1).reshape(x.shape[0], -1)   # NHWC flatten
        x = F.relu(linear(x, self.fc, dt))
        return x.to(torch.float32)


class NatureCNNTorso(nn.Module):
    """DeepMind Nature-DQN CNN: 8x8/4 -> 4x4/2 -> 3x3/1 -> FC.

    Input: (B, F, H, W) stacked frames (uint8 frames are scaled to
    [0, 1]); torch's NCHW takes F as channels directly. The conv output
    is flattened in NHWC order, as flax's is, so the FC weight is the
    transposed flax kernel with no row permutation."""

    KERNELS, STRIDES = (8, 4, 3), (4, 2, 1)

    def __init__(self, in_shape: Sequence[int],
                 channels: Sequence[int] = (32, 64, 64), fc: int = 512,
                 compute_dtype: torch.dtype = torch.bfloat16,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.compute_dtype = compute_dtype
        c, h, w = in_shape
        convs = []
        for ch, k, s in zip(channels, self.KERNELS, self.STRIDES):
            conv = nn.Conv2d(c, ch, k, stride=s)
            lecun_normal_(conv.weight, k * k * c, generator)
            nn.init.zeros_(conv.bias)
            convs.append(conv)
            c, h, w = ch, (h - k) // s + 1, (w - k) // s + 1
        self.convs = nn.ModuleList(convs)
        self.fc = dense(c * h * w, fc, generator)
        self.out_dim = fc

    def forward(self, x):
        dt = self.compute_dtype
        if x.dtype == torch.uint8:
            x = x.to(dt) / 255.0
        else:
            x = x.to(dt)
        for conv in self.convs:
            x = F.relu(F.conv2d(x, conv.weight.to(dt), conv.bias.to(dt),
                                stride=conv.stride))
        x = x.permute(0, 2, 3, 1).reshape(x.shape[0], -1)   # NHWC flatten
        x = F.relu(linear(x, self.fc, dt))
        return x.to(torch.float32)
