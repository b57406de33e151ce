"""QPolicy: torso + Q head, feed-forward (port of `models/policy.py`).

One module serves the acting side and the learner side; publishing
weights to the actor is handing it the same module.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Sequence, Tuple

import torch
from torch import nn

from rltime_tpu_torch import not_ported
from rltime_tpu_torch.models.heads import DuelingQHead, LinearQHead
from rltime_tpu_torch.models.torso import MLPTorso, NatureCNNTorso


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    """Static model hyperparameters (same fields as the JAX version)."""
    num_actions: int
    torso: str = "mlp"                  # "mlp" | "nature_cnn"
    mlp_hidden: Tuple[int, ...] = (64, 64)
    cnn_channels: Tuple[int, ...] = (32, 64, 64)
    cnn_fc: int = 512
    lstm_size: int = 0                  # 0 => feed-forward
    head: str = "linear"                # "linear" | "dueling"
    dueling_hidden: int = 256
    iqn_embed_dim: int = 64
    iqn_dueling: bool = False
    num_tau: int = 64
    num_tau_prime: int = 64
    num_tau_policy: int = 32
    compute_dtype: str = "float32"      # "float32" | "bfloat16"
    channels_last: bool = False
    space_to_depth: bool = False

    def __post_init__(self):
        if self.torso == "minatar_cnn":
            raise not_ported("model.torso='minatar_cnn'",
                             "IQN/LSTM/MinAtar models")
        if self.torso not in ("mlp", "nature_cnn"):
            raise ValueError(f"unknown torso {self.torso!r}")
        if self.head == "iqn":
            raise not_ported("model.head='iqn'", "IQN/LSTM/MinAtar models")
        if self.head not in ("linear", "dueling"):
            raise ValueError(f"unknown head {self.head!r}")
        if self.lstm_size > 0:
            raise not_ported("model.lstm_size>0", "IQN/LSTM/MinAtar models")
        if self.channels_last:
            raise not_ported("model.channels_last", "remaining options")
        if self.space_to_depth:
            raise not_ported("model.space_to_depth", "remaining options")
        if self.compute_dtype not in ("float32", "bfloat16"):
            raise ValueError(
                f"unknown compute_dtype {self.compute_dtype!r}")

    @property
    def dtype(self) -> torch.dtype:
        return (torch.bfloat16 if self.compute_dtype == "bfloat16"
                else torch.float32)


class QPolicy(nn.Module):
    """obs (B, *in_shape) -> q (B, A).

    `in_shape` is one sample's model input: (F, H, W) frames for the
    Nature CNN, (D,) for the MLP. Parameters are created on the CPU from
    `generator`; move the module with `.to(device)`."""

    def __init__(self, cfg: ModelConfig, in_shape: Sequence[int],
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.cfg = cfg
        if cfg.torso == "mlp":
            self.torso = MLPTorso(int(torch.Size(in_shape).numel()),
                                  cfg.mlp_hidden, cfg.dtype, generator)
        else:
            self.torso = NatureCNNTorso(in_shape, cfg.cnn_channels,
                                        cfg.cnn_fc, cfg.dtype, generator)
        feat = self.torso.out_dim
        if cfg.head == "linear":
            self.head = LinearQHead(feat, cfg.num_actions, generator)
        else:
            self.head = DuelingQHead(feat, cfg.num_actions,
                                     cfg.dueling_hidden, cfg.dtype,
                                     generator)

    def forward(self, obs: torch.Tensor) -> torch.Tensor:
        return self.head(self.torso(obs))


def q_values(cfg: ModelConfig, q: torch.Tensor) -> torch.Tensor:
    """Action values (the IQN tau mean is not ported: identity)."""
    return q
