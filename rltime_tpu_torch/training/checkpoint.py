"""Checkpoint/resume (port of `training/checkpoint.py`).

`torch.save` of {online model, target model, optimizer, PER-sampling
generator, update counter} plus host-side counters, under
`<result_dir>/checkpoints/<env_step>/state.pt`, the same directory
layout as the JAX version's orbax checkpoints. Replay contents are
optionally included. The best-checkpoint rule (`maybe_record_best`, `best.json`) and its
bookkeeping of protected steps (`unmark_best_only`,
`derive_protected_steps`) are the JAX version's, unchanged. The
multi-rank trainers write per-rank sidecars under
`<result_dir>/checkpoints_aux/<env_step>/` beside the lead's learner
checkpoint; a reclaimed best step takes its sidecars with it.
"""
from __future__ import annotations

import json
import os
import shutil
from typing import Any, Dict, Optional

import torch

from rltime_tpu_torch.history.replay import ReplayState
from rltime_tpu_torch.training.learner import TrainState

_FILE = "state.pt"


def _step_dir(result_dir: str, step: int) -> str:
    return os.path.abspath(os.path.join(result_dir, "checkpoints",
                                        str(step)))


def replay_payload(replay_state: ReplayState) -> Dict[str, Any]:
    """A replay (or one rank's shard) as `load_replay_state` reads it
    back."""
    return {"storage": replay_state.storage, "t": replay_state.t,
            "tree": replay_state.tree,
            "max_priority": replay_state.max_priority}


def save(result_dir: str, step: int, train_state: TrainState,
         host_state: Dict[str, Any],
         replay_state: Optional[ReplayState] = None) -> str:
    path = _step_dir(result_dir, step)
    os.makedirs(path, exist_ok=True)
    ckpt = {
        "model": train_state.model.state_dict(),
        "target": train_state.target.state_dict(),
        "optimizer": train_state.optimizer.state_dict(),
        "generator": train_state.generator.get_state(),
        "updates": train_state.updates,
        "host_state": dict(host_state),
    }
    if replay_state is not None:
        ckpt["replay_state"] = replay_payload(replay_state)
    tmp = os.path.join(path, _FILE + ".tmp")
    torch.save(ckpt, tmp)
    os.replace(tmp, os.path.join(path, _FILE))
    return path


def latest_step(result_dir: str) -> Optional[int]:
    d = os.path.join(result_dir, "checkpoints")
    if not os.path.isdir(d):
        return None
    steps = [int(x) for x in os.listdir(d) if x.isdigit()]
    return max(steps) if steps else None


def restore(result_dir: str, step: Optional[int] = None) -> Dict[str, Any]:
    """Load a checkpoint's dict onto the CPU (`load_state_dict` moves
    tensors to the live modules' devices). Adds "step"."""
    if step is None:
        step = latest_step(result_dir)
        if step is None:
            raise FileNotFoundError(
                f"no checkpoints under {result_dir!r}")
    ckpt = torch.load(os.path.join(_step_dir(result_dir, step), _FILE),
                      map_location="cpu", weights_only=True)
    ckpt["step"] = step
    return ckpt


def load_train_state(train_state: TrainState, ckpt: Dict[str, Any]) -> None:
    """Copy a restored checkpoint into a live TrainState, in place: every
    tensor it held before (parameters, optimizer moments and step
    counts, the device update counter) holds the checkpoint's values
    after, at the same address, so a CUDA graph that captured them
    continues from the checkpoint."""
    train_state.model.load_state_dict(ckpt["model"])
    train_state.target.load_state_dict(ckpt["target"])
    load_optimizer_state(train_state.optimizer, ckpt["optimizer"])
    train_state.generator.set_state(ckpt["generator"])
    train_state.updates = int(ckpt["updates"])
    if train_state.counter is not None:
        train_state.counter.fill_(train_state.updates)


def load_optimizer_state(optimizer: torch.optim.Optimizer,
                         saved: Dict[str, Any]) -> None:
    """`optimizer.load_state_dict(saved)`, keeping the live optimizer's
    `capturable` and `foreach` flags (an Adam saved by an eager run loads
    into a captured one, and the reverse: torch then places the step
    counts where the live flag needs them), its state tensors and its
    lr's kind: where the optimizer already holds state, the loaded values
    are copied into those tensors, and a live lr tensor (the
    device-counter route's schedule) takes the saved value in place."""
    flags = [{k: g[k] for k in ("capturable", "foreach") if k in g}
             for g in optimizer.param_groups]
    lrs = [g["lr"] for g in optimizer.param_groups]
    saved = dict(saved, param_groups=[
        dict(g, **f) for g, f in zip(saved["param_groups"], flags)])
    live = {p: dict(st) for p, st in optimizer.state.items()}
    optimizer.load_state_dict(saved)
    for group, lr in zip(optimizer.param_groups, lrs):
        value = float(group["lr"])
        if isinstance(lr, torch.Tensor):
            lr.fill_(value)
            value = lr
        group["lr"] = value
    for p, old in live.items():
        new = optimizer.state[p]
        for k, v in new.items():
            mine = old.get(k)
            if isinstance(mine, torch.Tensor) and mine.shape == v.shape:
                mine.copy_(v)
                new[k] = mine


def load_replay_state(replay_state: ReplayState, saved: Dict[str, Any]
                      ) -> None:
    """Copy a restored checkpoint's replay into a live one, in place (the
    rings, the priority tree, max_priority and the device cursor keep
    their addresses)."""
    for name, arr in saved["storage"].items():
        replay_state.storage[name].copy_(arr)
    replay_state.t = int(saved["t"])
    replay_state.tree.copy_(saved["tree"])
    replay_state.max_priority.copy_(saved["max_priority"])
    if replay_state.cursor is not None:
        replay_state.cursor.fill_(replay_state.t)


def record_best(result_dir: str, step: int, score: float,
                best_only: bool = False) -> None:
    """Mark the checkpoint at `step` as the best-scoring one so far.
    `best_only`: the dir exists SOLELY for best tracking, so a newer
    best may reclaim it."""
    d = os.path.join(result_dir, "checkpoints")
    os.makedirs(d, exist_ok=True)
    # written aside and renamed: a reader never sees a half-written file
    tmp = os.path.join(d, "best.json.tmp")
    with open(tmp, "w") as f:
        json.dump({"step": int(step), "score": float(score),
                   "best_only": bool(best_only)}, f)
    os.replace(tmp, os.path.join(d, "best.json"))


def best_step(result_dir: str) -> Optional[Dict[str, Any]]:
    """{"step", "score", "best_only"} of the best checkpoint, or None."""
    p = os.path.join(result_dir, "checkpoints", "best.json")
    if not os.path.isfile(p):
        return None
    with open(p) as f:
        return json.load(f)


def maybe_record_best(result_dir: str, best_score: float,
                      mean_return: float, n_episodes: int,
                      min_episodes: int, env_steps: int, save_fn,
                      protected_steps=(), lead: bool = True) -> float:
    """Snapshot whenever the log-interval episode mean (over at least
    `min_episodes` episodes) makes a new high. Returns the updated best
    score. The PREVIOUS best dir (and its sidecars under
    `checkpoints_aux/`) is deleted iff it was created solely by best
    tracking and is not a protected (interval/final) step.

    Multi-rank: every rank calls this with IDENTICAL (pooled) stats; the
    decision and `save_fn` (each rank writes its sidecar) run everywhere,
    while best.json and the reclaim are the lead's (`lead=False` skips
    them; only the lead reads best.json)."""
    if n_episodes < min_episodes or mean_return <= best_score:
        return best_score
    prev = best_step(result_dir) if lead else None
    save_fn()
    if not lead:
        return mean_return
    protected = set(int(s) for s in protected_steps)
    record_best(result_dir, env_steps, mean_return,
                best_only=env_steps not in protected)
    if (prev is not None and prev.get("best_only")
            and int(prev["step"]) != int(env_steps)
            and int(prev["step"]) not in protected):
        shutil.rmtree(_step_dir(result_dir, int(prev["step"])),
                      ignore_errors=True)
        shutil.rmtree(aux_dir(result_dir, int(prev["step"])),
                      ignore_errors=True)
    return mean_return


def aux_dir(result_dir: str, step: int) -> str:
    """The per-rank sidecars of the checkpoint at `step`."""
    return os.path.abspath(os.path.join(result_dir, "checkpoints_aux",
                                        str(step)))


def unmark_best_only(result_dir: str, step: int) -> None:
    """An interval/final save at a step recorded as best_only makes it a
    protected checkpoint: clear the flag, so that a new best after a
    resume (whose protected set comes from `derive_protected_steps`)
    cannot reclaim it."""
    b = best_step(result_dir)
    if (b is not None and int(b["step"]) == int(step)
            and b.get("best_only")):
        record_best(result_dir, int(b["step"]), float(b["score"]),
                    best_only=False)


def derive_protected_steps(result_dir: str) -> set:
    """The interval/final checkpoint steps, rebuilt at resume: every
    checkpoint dir except the one best.json marks best_only."""
    ckdir = os.path.join(result_dir, "checkpoints")
    if not os.path.isdir(ckdir):
        return set()
    b = best_step(result_dir)
    bo = (int(b["step"]) if b is not None and b.get("best_only")
          else None)
    return {int(x) for x in os.listdir(ckdir)
            if x.isdigit() and int(x) != bo}
