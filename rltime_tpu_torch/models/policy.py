"""QPolicy: torso + optional LSTM + Q head (port of `models/policy.py`).

One module serves the acting side and the learner side; publishing
weights to the actor is handing it the same module.

The LSTM is flax's `nn.OptimizedLSTMCell`: gates i, f, g, o from
(h W_h + b_h) + x W_x, c' = sigma(f) c + sigma(i) tanh(g),
h' = sigma(o) tanh(c'), carry (c, h) in float32 whatever the compute
dtype. `unroll` is the JAX `lax.scan` unroll with per-step carry resets;
the torso and the head do not depend on the carry, so it runs each of
them once over the whole (B, T) sequence and loops only the cell.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from rltime_tpu_torch import not_ported
from rltime_tpu_torch.models.heads import (
    DuelingQHead, IQNHead, LinearQHead,
)
from rltime_tpu_torch.models.torso import (
    MLPTorso, MinAtarCNNTorso, NatureCNNTorso, lecun_normal_,
)

RnnState = Tuple[torch.Tensor, torch.Tensor]      # (c, h), each (B, H) f32


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    """Static model hyperparameters (same fields as the JAX version)."""
    num_actions: int
    torso: str = "mlp"                  # "mlp" | "nature_cnn" | "minatar_cnn"
    mlp_hidden: Tuple[int, ...] = (64, 64)
    cnn_channels: Tuple[int, ...] = (32, 64, 64)
    cnn_fc: int = 512
    lstm_size: int = 0                  # 0 => feed-forward
    head: str = "linear"                # "linear" | "dueling" | "iqn"
    dueling_hidden: int = 256
    iqn_embed_dim: int = 64
    iqn_dueling: bool = False
    num_tau: int = 64                   # training prediction taus
    num_tau_prime: int = 64             # training target taus
    num_tau_policy: int = 32            # acting taus (risk-neutral mean)
    compute_dtype: str = "float32"      # "float32" | "bfloat16"
    channels_last: bool = False
    space_to_depth: bool = False

    def __post_init__(self):
        if self.torso not in ("mlp", "nature_cnn", "minatar_cnn"):
            raise ValueError(f"unknown torso {self.torso!r}")
        if self.head not in ("linear", "dueling", "iqn"):
            raise ValueError(f"unknown head {self.head!r}")
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

    @property
    def is_iqn(self) -> bool:
        return self.head == "iqn"

    @property
    def recurrent(self) -> bool:
        return self.lstm_size > 0


class LSTMCell(nn.Module):
    """flax `nn.OptimizedLSTMCell` in float32.

    `weight_ih` (4H, in) and `weight_hh` (4H, H) stack the gate kernels
    in i, f, g, o order; only the hidden projection has a bias (flax's
    `ii..io` Dense blocks have none). Init as flax: lecun-normal input
    kernels, orthogonal recurrent kernels (one per gate), zero bias."""

    def __init__(self, in_dim: int, hidden: int,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.hidden = hidden
        self.weight_ih = nn.Parameter(torch.empty(4 * hidden, in_dim))
        self.weight_hh = nn.Parameter(torch.empty(4 * hidden, hidden))
        self.bias_hh = nn.Parameter(torch.zeros(4 * hidden))
        with torch.no_grad():
            for k in range(4):
                rows = slice(k * hidden, (k + 1) * hidden)
                lecun_normal_(self.weight_ih[rows], in_dim, generator)
                nn.init.orthogonal_(self.weight_hh[rows], generator=generator)

    def input_proj(self, x: torch.Tensor) -> torch.Tensor:
        """x W_x for every gate: (..., in) -> (..., 4H)."""
        return F.linear(x, self.weight_ih)

    def step(self, x_proj: torch.Tensor, state: RnnState) -> RnnState:
        """One step from the input projection `x_proj` (B, 4H)."""
        c, h = state
        z = F.linear(h, self.weight_hh, self.bias_hh) + x_proj
        i, f, g, o = torch.chunk(z, 4, dim=-1)
        c = torch.sigmoid(f) * c + torch.sigmoid(i) * torch.tanh(g)
        return c, torch.sigmoid(o) * torch.tanh(c)

    def unroll(self, feat_seq: torch.Tensor, done_prev_seq: torch.Tensor,
               state: RnnState) -> Tuple[torch.Tensor, RnnState]:
        """(B, T, in) features -> (B, T, H) outputs and the final carry.
        The carry is zeroed before step t where done_prev_seq[:, t]."""
        x_proj = self.input_proj(feat_seq)
        keep = (1.0 - done_prev_seq.to(torch.float32))[..., None]
        outs = []
        for t in range(feat_seq.shape[1]):
            m = keep[:, t]
            state = self.step(x_proj[:, t], (state[0] * m, state[1] * m))
            outs.append(state[1])
        return torch.stack(outs, dim=1), state


class QPolicy(nn.Module):
    """obs (B, *in_shape) -> q (B, A), or (q, new_rnn_state) when
    recurrent (`forward(obs, rnn_state)`). With the IQN head q is the
    (B, N, A) quantile values at `taus` (B, N), which it requires.

    `in_shape` is one sample's model input: (F, H, W) frames for the
    Nature CNN, (F, H, W, C) for the MinAtar CNN (which also takes a
    device env's raw (B, H, W, C) planes), (D,) for the MLP. Parameters
    are created on the CPU from `generator`; move the module with
    `.to(device)`."""

    def __init__(self, cfg: ModelConfig, in_shape: Sequence[int],
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.cfg = cfg
        if cfg.torso == "mlp":
            self.torso = MLPTorso(int(torch.Size(in_shape).numel()),
                                  cfg.mlp_hidden, cfg.dtype, generator)
        elif cfg.torso == "nature_cnn":
            self.torso = NatureCNNTorso(in_shape, cfg.cnn_channels,
                                        cfg.cnn_fc, cfg.dtype, generator)
        else:
            self.torso = MinAtarCNNTorso(in_shape, cfg.cnn_channels,
                                         cfg.cnn_fc, cfg.dtype, generator)
        feat = self.torso.out_dim
        if cfg.recurrent:
            self.lstm = LSTMCell(feat, cfg.lstm_size, generator)
            feat = cfg.lstm_size
        if cfg.head == "linear":
            self.head = LinearQHead(feat, cfg.num_actions, generator)
        elif cfg.head == "dueling":
            self.head = DuelingQHead(feat, cfg.num_actions,
                                     cfg.dueling_hidden, cfg.dtype,
                                     generator)
        else:
            self.head = IQNHead(feat, cfg.num_actions, cfg.iqn_embed_dim,
                                cfg.iqn_dueling, cfg.dueling_hidden,
                                cfg.dtype, generator)

    def forward(self, obs: torch.Tensor,
                rnn_state: Optional[RnnState] = None,
                taus: Optional[torch.Tensor] = None):
        feat = self.torso(obs)
        if self.cfg.recurrent:
            rnn_state = self.lstm.step(self.lstm.input_proj(feat), rnn_state)
            feat = rnn_state[1]
        if self.cfg.is_iqn:
            if taus is None:
                raise ValueError("IQN head requires taus")
            q = self.head(feat, taus)
        else:
            q = self.head(feat)
        return (q, rnn_state) if self.cfg.recurrent else q


def initial_rnn_state(cfg: ModelConfig, batch: int,
                      device: torch.device | str = "cpu"
                      ) -> Optional[RnnState]:
    """Zero LSTM carry (c, h), or None for feed-forward policies."""
    if not cfg.recurrent:
        return None
    return (torch.zeros((batch, cfg.lstm_size), device=device),
            torch.zeros((batch, cfg.lstm_size), device=device))


def unroll_features(model: QPolicy, obs_seq: torch.Tensor,
                    done_prev_seq: torch.Tensor, rnn_state: RnnState
                    ) -> Tuple[torch.Tensor, RnnState]:
    """The torso over all (B, T) steps at once, then the LSTM loop with
    per-step resets. Returns (LSTM outputs (B, T, H), final carry)."""
    B, T = obs_seq.shape[:2]
    feat = model.torso(obs_seq.reshape((B * T,) + obs_seq.shape[2:]))
    return model.lstm.unroll(feat.reshape(B, T, -1), done_prev_seq,
                             rnn_state)


def head_seq(model: QPolicy, h_seq: torch.Tensor) -> torch.Tensor:
    """The Q head over (B, T, H) LSTM outputs -> (B, T, A)."""
    B, T = h_seq.shape[:2]
    return model.head(h_seq.reshape(B * T, -1)).reshape(B, T, -1)


def unroll(model: QPolicy, obs_seq: torch.Tensor,
           done_prev_seq: torch.Tensor, rnn_state: RnnState
           ) -> Tuple[torch.Tensor, RnnState]:
    """Unroll over time with per-step recurrent reset.

    obs_seq (B, T, ...); done_prev_seq (B, T) True where the PREVIOUS
    step ended an episode (the carry is zeroed before consuming that
    step, as the actor does); rnn_state the carry at t=0. Returns
    (q_seq (B, T, A), final carry)."""
    h_seq, state = unroll_features(model, obs_seq, done_prev_seq, rnn_state)
    return head_seq(model, h_seq), state


def q_values(cfg: ModelConfig, q: torch.Tensor) -> torch.Tensor:
    """Risk-neutral action values: the mean over the tau axis for IQN."""
    return torch.mean(q, dim=1) if cfg.is_iqn else q
