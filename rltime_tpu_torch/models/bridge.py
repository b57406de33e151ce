"""flax params <-> the port's `state_dict`.

The JAX package's `QPolicy` params (`{"params": {"torso_mod": ...,
"head_mod": ...}}`, leaves as numpy arrays) map onto the port's
`QPolicy.state_dict()` and back, exactly. Layout rules:
  * `Conv_i` kernels are HWIO in flax, OIHW in torch;
  * `Dense` kernels are (in, out) in flax, (out, in) in torch; the FC
    after the convs needs no row permutation because the port flattens
    its conv output in NHWC order too (models/torso.py);
  * the dueling head's `Dense_0..3` follow flax's call order: V hidden,
    V out, A hidden, A out.
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
    if cfg.head == "linear":
        out.append((("head_mod", "Dense_0"), "head.out", "dense"))
    else:
        for i, name in enumerate(("v_hidden", "v_out", "a_hidden", "a_out")):
            out.append((("head_mod", f"Dense_{i}"), f"head.{name}", "dense"))
    return out


def _kernel_to_torch(k: np.ndarray, kind: str) -> np.ndarray:
    return k.transpose(3, 2, 0, 1) if kind == "conv" else k.T


def _kernel_to_flax(w: np.ndarray, kind: str) -> np.ndarray:
    return w.transpose(2, 3, 1, 0) if kind == "conv" else w.T


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
    return sd


def state_dict_to_flax(cfg: ModelConfig,
                       sd: Dict[str, torch.Tensor]) -> Dict[str, Any]:
    """Port `state_dict` -> flax variables (numpy leaves)."""
    params: Dict[str, Dict[str, Dict[str, np.ndarray]]] = {}
    for (mod, layer), prefix, kind in _entries(cfg):
        w = sd[f"{prefix}.weight"].detach().cpu().numpy()
        params.setdefault(mod, {})[layer] = {
            "kernel": np.ascontiguousarray(_kernel_to_flax(w, kind)),
            "bias": sd[f"{prefix}.bias"].detach().cpu().numpy().copy(),
        }
    return {"params": params}
