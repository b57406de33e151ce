"""flax params <-> the port's `state_dict`.

The JAX package's `QPolicy` params (`{"params": {"torso_mod": ...,
"head_mod": ...}}`, leaves as numpy arrays) map onto the port's
`QPolicy.state_dict()` and back, exactly. Layout rules:
  * `Conv_i` kernels are HWIO in flax, OIHW in torch;
  * `Dense` kernels are (in, out) in flax, (out, in) in torch; the FC
    after the convs needs no row permutation because the port flattens
    its conv output in NHWC order too (models/torso.py);
  * the dueling head's `Dense_0..3` follow flax's call order: V hidden,
    V out, A hidden, A out; the IQN head has `tau_embed` and then
    `Dense_0..1` (hidden, out), or the dueling four when `iqn_dueling`;
  * the MinAtar CNN's `Conv_i` and `Dense_0` map as the Nature CNN's
    (its input channels are frame-major `f * C + c` on both sides);
  * the LSTM (`lstm`: flax `OptimizedLSTMCell`) keeps eight Dense
    blocks: `ii, if, ig, io` are (in, H) kernels with no bias, `hi, hf,
    hg, ho` (H, H) kernels with a bias. Their transposes stack, in
    i, f, g, o order, into the port's `lstm.weight_ih` (4H, in) and
    `lstm.weight_hh` (4H, H); the hidden biases into `lstm.bias_hh`.
  * with `model.space_to_depth` flax's `Conv_0` kernel is
    (2, 2, 16 C, out) over the patched input; the conv rule above carries
    it as it is, because the port's torso patches its input in the same
    `(r_h, r_w, c)` channel order as the JAX reshape (models/torso.py).
Whatever has the params' structure crosses the same way: optax's Adam
or RMSProp moments (`mu`, `nu`) go through `flax_to_state_dict` and land
under the names of `named_parameters()`. A JAX sum tree or dense tree
needs no bridge: the port keeps the `(2N,)` / `(N,)` layouts, so
`torch.from_numpy` of the array is the port's tree.
No jax import: callers convert params with `np.asarray` leaf-wise.
"""
from __future__ import annotations

from typing import Any, Dict, List, Tuple

import numpy as np
import torch

from rltime_tpu_torch.models.policy import ModelConfig

# (flax path under "params", port state_dict prefix, kind)
_Entry = Tuple[Tuple[str, str], str, str]


def _entries(cfg: ModelConfig) -> List[_Entry]:
    out: List[_Entry] = []
    if cfg.torso == "mlp":
        out += [(("torso_mod", f"Dense_{i}"), f"torso.layers.{i}", "dense")
                for i in range(len(cfg.mlp_hidden))]
    else:
        out += [(("torso_mod", f"Conv_{i}"), f"torso.convs.{i}", "conv")
                for i in range(len(cfg.cnn_channels))]
        out.append((("torso_mod", "Dense_0"), "torso.fc", "dense"))
    if cfg.head == "iqn":
        out.append((("head_mod", "tau_embed"), "head.tau_embed", "dense"))
    if cfg.head == "linear":
        names = ("out",)
    elif cfg.head == "dueling" or cfg.iqn_dueling:
        names = ("v_hidden", "v_out", "a_hidden", "a_out")
    else:
        names = ("hidden", "out")
    out += [(("head_mod", f"Dense_{i}"), f"head.{name}", "dense")
            for i, name in enumerate(names)]
    return out


def _kernel_to_torch(k: np.ndarray, kind: str) -> np.ndarray:
    return k.transpose(3, 2, 0, 1) if kind == "conv" else k.T


def _kernel_to_flax(w: np.ndarray, kind: str) -> np.ndarray:
    return w.transpose(2, 3, 1, 0) if kind == "conv" else w.T


_GATES = ("i", "f", "g", "o")


def flax_to_state_dict(cfg: ModelConfig,
                       variables: Dict[str, Any]) -> Dict[str, torch.Tensor]:
    """flax variables (numpy leaves) -> port `state_dict`."""
    params = variables["params"]
    sd: Dict[str, torch.Tensor] = {}
    for (mod, layer), prefix, kind in _entries(cfg):
        p = params[mod][layer]
        sd[f"{prefix}.weight"] = torch.tensor(np.ascontiguousarray(
            _kernel_to_torch(np.asarray(p["kernel"]), kind)))
        sd[f"{prefix}.bias"] = torch.tensor(np.asarray(p["bias"]))
    if cfg.recurrent:
        lstm = params["lstm"]
        for src, dst in (("i", "weight_ih"), ("h", "weight_hh")):
            sd[f"lstm.{dst}"] = torch.tensor(np.concatenate(
                [np.asarray(lstm[src + g]["kernel"]).T for g in _GATES]))
        sd["lstm.bias_hh"] = torch.tensor(np.concatenate(
            [np.asarray(lstm["h" + g]["bias"]) for g in _GATES]))
    return sd


def state_dict_to_flax(cfg: ModelConfig,
                       sd: Dict[str, torch.Tensor]) -> Dict[str, Any]:
    """Port `state_dict` -> flax variables: numpy leaves that share no
    memory with `sd` (a view of a (1, N) weight's transpose would alias
    the live parameter, and a JAX computation dispatched on it
    asynchronously would read what the next optimizer step writes)."""
    params: Dict[str, Dict[str, Dict[str, np.ndarray]]] = {}
    for (mod, layer), prefix, kind in _entries(cfg):
        w = sd[f"{prefix}.weight"].detach().cpu().numpy()
        params.setdefault(mod, {})[layer] = {
            "kernel": np.array(_kernel_to_flax(w, kind), order="C"),
            "bias": sd[f"{prefix}.bias"].detach().cpu().numpy().copy(),
        }
    if cfg.recurrent:
        H = cfg.lstm_size
        w_ih, w_hh, b_hh = (sd[f"lstm.{k}"].detach().cpu().numpy()
                            for k in ("weight_ih", "weight_hh", "bias_hh"))
        lstm: Dict[str, Dict[str, np.ndarray]] = {}
        for k, g in enumerate(_GATES):
            rows = slice(k * H, (k + 1) * H)
            lstm["i" + g] = {"kernel": np.array(w_ih[rows].T, order="C")}
            lstm["h" + g] = {"kernel": np.array(w_hh[rows].T, order="C"),
                             "bias": b_hh[rows].copy()}
        params["lstm"] = lstm
    return {"params": params}
