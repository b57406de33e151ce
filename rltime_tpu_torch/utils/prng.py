"""Seed discipline: one named, derived generator per component.

Counterpart of `rltime_tpu/utils/prng.py`. JAX threads keys; here each
stochastic component (init, exploration, PER sampling) owns an explicit
`torch.Generator` seeded from the config seed and the component's name.
Nothing draws from torch's global RNG. The numbers differ from JAX's
threefry streams, so the parity tests inject JAX's draws as tensors.
"""
from __future__ import annotations

import hashlib

import torch


def fold_in_str(seed: int, name: str) -> int:
    """Deterministically derive a named 63-bit seed (stable across runs).

    The name's sha256 tag (the first 4 bytes, as in the JAX version) is
    mixed with the parent seed through a second sha256."""
    tag = hashlib.sha256(name.encode()).digest()[:4]
    mixed = hashlib.sha256(
        int(seed).to_bytes(8, "little", signed=True) + tag).digest()
    return int.from_bytes(mixed[:8], "little") & ((1 << 63) - 1)


def make_generator(seed: int, name: str,
                   device: torch.device | str = "cpu") -> torch.Generator:
    """A generator on `device` seeded by `fold_in_str(seed, name)`."""
    gen = torch.Generator(device=device)
    gen.manual_seed(fold_in_str(seed, name))
    return gen


def derived_generator(generator: torch.Generator, name: str
                      ) -> torch.Generator:
    """A new generator on the same device, seeded from `generator`'s
    CURRENT state and `name`, without drawing from it (what
    `jax.random.fold_in(key, tag)` is to a key): the parent's stream is
    the same whether or not anything derives from it. Reading the state
    is host-side bookkeeping; it does not wait for the device."""
    tag = hashlib.sha256(name.encode()).digest()[:4]
    mixed = hashlib.sha256(
        generator.get_state().numpy().tobytes() + tag).digest()
    gen = torch.Generator(device=generator.device)
    gen.manual_seed(int.from_bytes(mixed[:8], "little") & ((1 << 63) - 1))
    return gen
