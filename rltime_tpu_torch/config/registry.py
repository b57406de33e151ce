"""Type registry: `"type"` strings in JSON configs resolve to callables.

Mirrors the reference's config UX (SURVEY.md §1 L1: nested JSON whose
"type" fields resolve to registered classes), rebuilt as a flat
namespaced registry over plain callables/dataclasses.
"""
from __future__ import annotations

from typing import Any, Callable, Dict

_REGISTRY: Dict[str, Callable[..., Any]] = {}


def register(name: str):
    """Decorator: register a class/function under `name`."""

    def deco(obj):
        if name in _REGISTRY and _REGISTRY[name] is not obj:
            raise ValueError(f"duplicate registry name: {name!r}")
        _REGISTRY[name] = obj
        return obj

    return deco


def lookup(name: str) -> Callable[..., Any]:
    try:
        return _REGISTRY[name]
    except KeyError:
        raise KeyError(
            f"unknown type {name!r}; registered: {sorted(_REGISTRY)}"
        ) from None


def registered_names():
    return sorted(_REGISTRY)
