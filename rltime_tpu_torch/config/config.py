"""JSON config loading, composition, and CLI overrides.

Config UX mirrors the reference (SURVEY.md §5.6): nested JSON presets;
`"base"` key composes/inherits another preset; `--key.subkey=value`
dotted CLI overrides; `"type"` strings resolved via the registry at
build time.
"""
from __future__ import annotations

import copy
import json
import os
from typing import Any, Dict, List

from rltime_tpu_torch.config.registry import lookup

PRESET_DIR = os.path.join(os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))), "configs")


def _deep_merge(base: Dict, override: Dict) -> Dict:
    out = copy.deepcopy(base)
    for k, v in override.items():
        if isinstance(v, dict) and isinstance(out.get(k), dict):
            out[k] = _deep_merge(out[k], v)
        else:
            out[k] = copy.deepcopy(v)
    return out


def _resolve_path(path: str) -> str:
    if os.path.exists(path):
        return path
    cand = os.path.join(PRESET_DIR, path)
    if os.path.exists(cand):
        return cand
    cand = cand + ".json"
    if os.path.exists(cand):
        return cand
    raise FileNotFoundError(f"config not found: {path!r}")


def load_config(path: str) -> Dict[str, Any]:
    """Load a JSON config, recursively composing its `"base"` chain."""
    path = _resolve_path(path)
    with open(path) as f:
        cfg = json.load(f)
    base = cfg.pop("base", None)
    if base is not None:
        base_cfg = load_config(
            base if os.path.isabs(base)
            else os.path.join(os.path.dirname(path), base))
        cfg = _deep_merge(base_cfg, cfg)
    return cfg


def _parse_value(s: str) -> Any:
    try:
        return json.loads(s)
    except (json.JSONDecodeError, ValueError):
        return s  # bare string


def apply_overrides(cfg: Dict[str, Any], overrides: List[str]) -> Dict[str, Any]:
    """Apply `key.subkey=value` overrides (values parsed as JSON when possible)."""
    cfg = copy.deepcopy(cfg)
    for ov in overrides:
        if "=" not in ov:
            raise ValueError(f"override must be key=value, got {ov!r}")
        dotted, _, raw = ov.partition("=")
        keys = dotted.lstrip("-").split(".")
        node = cfg
        for k in keys[:-1]:
            node = node.setdefault(k, {})
        node[keys[-1]] = _parse_value(raw)
    return cfg


def build(spec: Any, **extra_kwargs):
    """Instantiate `{"type": name, ...kwargs}` via the registry.

    Non-dict specs pass through unchanged; nested dicts are NOT
    auto-built (components decide what their sub-specs mean).
    """
    if not isinstance(spec, dict) or "type" not in spec:
        raise ValueError(f"cannot build from spec: {spec!r}")
    kwargs = {k: v for k, v in spec.items() if k != "type"}
    kwargs.update(extra_kwargs)
    return lookup(spec["type"])(**kwargs)
