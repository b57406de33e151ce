"""Mesh plane: sharded replay and the data-parallel learner over
`torch.distributed` (port of `rltime_tpu/parallel/mesh.py`).

The JAX version maps the replay and the learner onto a ('data', 'model')
device mesh with `shard_map`. Here each rank is one process with one
device, and the mesh is a `Mesh` object: the rank, the number of ranks
d, the rank's device, the collective group (NCCL on the card, gloo on
the CPU) and a gloo group for the host-side statistics. It is the only
place the port calls `torch.distributed`, and it counts every collective
it issues in `parallel/census.py`.

  * Replay is sharded by construction: each rank owns its E_local env
    lanes, their ring columns and its own priority tree, so sampling
    never crosses ranks and costs no collective.
  * An update samples the rank's `batch_size` from its own shard,
    averages the gradients over the ranks in ONE all-reduce (every
    gradient flattened into one buffer) before the global-norm clip, and
    applies the same optimizer step everywhere: parameters stay
    identical on every rank. The scalar metrics are averaged in a second
    small buffer; `max_priority` is kept coherent with a MAX.
  * `mean_` is a SUM followed by a division by d, as JAX's `pmean`; gloo
    has no AVG. A one-rank group is therefore bit-equal to no group.

`make_mesh()` without an initialised process group is the identity mesh
of one rank, whose operations issue nothing: the d = 1 case the JAX code
degenerates to. Asking for d > 1 without a group raises.
"""
from __future__ import annotations

import os
from typing import Any, Dict, Iterable, List, Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist

from rltime_tpu_torch.history.replay import (
    ReplayConfig, ReplayState, replay_insert_at_cursor,
)
from rltime_tpu_torch.parallel import census
from rltime_tpu_torch.training import checkpoint as ckpt_lib
from rltime_tpu_torch.utils.prng import derived_generator

_HOST_GROUPS: Dict[int, Any] = {}   # id(default group) -> its gloo twin


class Mesh:
    """d ranks, one device each. `group` None: the identity mesh (d = 1,
    nothing issued)."""

    def __init__(self, rank: int, size: int, device: torch.device,
                 group=None, host_group=None, backend: str = ""):
        self.rank, self.size = int(rank), int(size)
        self.device = torch.device(device)
        self.group, self.host_group = group, host_group
        self.backend = backend
        self._flat: Dict[Tuple, torch.Tensor] = {}

    @property
    def distributed(self) -> bool:
        return self.group is not None

    @property
    def is_lead(self) -> bool:
        return self.rank == 0

    def __repr__(self):
        return (f"Mesh(rank={self.rank}, size={self.size}, "
                f"device={self.device}, backend={self.backend or 'none'})")

    # ----- the four operations -----
    def _all_reduce(self, tensor: torch.Tensor, op, name: str, site: str):
        census.record(name, str(tensor.dtype).replace("torch.", ""),
                      tensor.numel() * tensor.element_size(), "device", site)
        dist.all_reduce(tensor, op=op, group=self.group)

    def mean_(self, tensor: torch.Tensor, site: str) -> torch.Tensor:
        """In place: the SUM over ranks, divided by d (JAX's pmean)."""
        if self.distributed:
            self._all_reduce(tensor, dist.ReduceOp.SUM, "all_reduce", site)
            tensor.div_(self.size)
        return tensor

    def max_(self, tensor: torch.Tensor, site: str) -> torch.Tensor:
        """In place: the MAX over ranks (JAX's pmax)."""
        if self.distributed:
            self._all_reduce(tensor, dist.ReduceOp.MAX, "all_reduce", site)
        return tensor

    def all_gather_host(self, array: np.ndarray,
                        site: str = "stats") -> List[np.ndarray]:
        """Every rank's `array` (same shape and dtype on all), rank order,
        over the host (gloo) group."""
        array = np.ascontiguousarray(array)
        if not self.distributed:
            return [array]
        t = torch.from_numpy(array)
        out = [torch.empty_like(t) for _ in range(self.size)]
        census.record("all_gather", str(t.dtype).replace("torch.", ""),
                      t.numel() * t.element_size(), "host", site)
        dist.all_gather(out, t, group=self.host_group)
        return [o.numpy() for o in out]

    def barrier(self) -> None:
        if self.distributed:
            census.record("barrier", "-", 0, "host", "barrier")
            dist.barrier(group=self.host_group)

    # ----- built on them -----
    def mean_grads(self, grads: List[torch.Tensor]) -> List[torch.Tensor]:
        """The gradients averaged over the ranks in ONE all-reduce: they
        are copied into one preallocated flat buffer (per dtype), reduced
        and handed back as views of it."""
        if not self.distributed:
            return list(grads)
        out: List[Optional[torch.Tensor]] = [None] * len(grads)
        by_dtype: Dict[torch.dtype, List[int]] = {}
        for i, g in enumerate(grads):
            by_dtype.setdefault(g.dtype, []).append(i)
        for dtype, idx in by_dtype.items():
            sizes = [grads[i].numel() for i in idx]
            key = (dtype, grads[idx[0]].device, sum(sizes))
            flat = self._flat.get(key)
            if flat is None:
                flat = self._flat[key] = torch.empty(
                    sum(sizes), dtype=dtype, device=grads[idx[0]].device)
            torch.cat([grads[i].reshape(-1) for i in idx], out=flat)
            self.mean_(flat, "grad")
            for i, part in zip(idx, flat.split(sizes)):
                out[i] = part.view_as(grads[i])
        return out

    def mean_metrics(self, metrics: Dict[str, torch.Tensor]
                     ) -> Dict[str, torch.Tensor]:
        """Scalar metrics averaged in one small buffer; per-shard
        `debug_*` leaves stay as they are."""
        if not self.distributed:
            return metrics
        keys = [k for k in metrics if not k.startswith("debug_")]
        buf = torch.stack([metrics[k].float() for k in keys])
        self.mean_(buf, "metrics")
        out = dict(metrics)
        out.update({k: buf[i] for i, k in enumerate(keys)})
        return out

    def shard_generator(self, generator: torch.Generator) -> torch.Generator:
        """This rank's sampling stream. Rank 0 keeps `generator` (so a
        one-rank mesh draws what the plain update draws); rank r > 0
        derives its own from it and the rank, as JAX folds the shard
        index into the learner key."""
        if self.rank == 0:
            return generator
        return derived_generator(generator, f"shard {self.rank}")

    def lead_value(self, value: Any, site: str = "resume") -> Any:
        """The lead's `value` (any picklable object: a score, a path), on
        every rank: a broadcast over the host group."""
        if not self.distributed:
            return value
        box = [value]
        census.record("broadcast", "object", 0, "host", site)
        dist.broadcast_object_list(box, src=0, group=self.host_group)
        return box[0]


def _host_group(backend: str):
    """A gloo group beside the default one (NCCL takes CUDA tensors only;
    the statistics are numpy). One per process group, built once."""
    world = dist.group.WORLD
    if backend == "gloo":
        return world
    key = id(world)
    if key not in _HOST_GROUPS:
        _HOST_GROUPS[key] = dist.new_group(backend="gloo")
    return _HOST_GROUPS[key]


def make_mesh(device: str | torch.device = "cpu",
              size: Optional[int] = None) -> Mesh:
    """The mesh over the default process group when one is initialised,
    else the identity mesh of one rank. `size` is what the caller
    expects d to be: d > 1 without a process group raises (there is no
    fallback to one rank), as does a group of another size."""
    device = torch.device(device)
    if dist.is_available() and dist.is_initialized():
        world, rank = dist.get_world_size(), dist.get_rank()
        if size is not None and size != world:
            raise ValueError(f"a mesh of {size} ranks was asked for; the "
                             f"process group has {world}")
        backend = str(dist.get_backend())
        if backend == "nccl" and device.type != "cuda":
            raise ValueError(f"the NCCL group needs a cuda device, got "
                             f"{device}")
        return Mesh(rank, world, device, dist.group.WORLD,
                    _host_group(backend), backend)
    if size is not None and size > 1:
        raise RuntimeError(
            f"a mesh of {size} ranks needs torch.distributed."
            "init_process_group first (python -m "
            "rltime_tpu_torch.train_distributed does it)")
    return identity_mesh(device)


def identity_mesh(device: str | torch.device = "cpu") -> Mesh:
    """One rank, no group: every operation is the identity."""
    return Mesh(0, 1, device)


# ----- sharded replay -----------------------------------------------------
# A rank's shard is `replay_init` of the rank's ReplayConfig (num_envs =
# E_local) on its device: its lanes, their ring columns and its own
# priority tree. The global replay is the d shards side by side; no rank
# holds another's, so sampling and insert cross no rank.

def make_sharded_insert(local_cfg: ReplayConfig, mesh: Mesh):
    """insert(state, chunk): the rank inserts its own lanes (at the
    device cursor where the shard keeps one, as the fused trainer's
    does), then `max_priority` (raised by actor-side priorities) is
    MAXed over the ranks. Every rank advances its write cursor by the
    same chunk_len, so JAX's MAX of it is the identity here and nothing
    is sent for it."""

    def insert(state: ReplayState, chunk: Dict[str, Any]) -> ReplayState:
        state = replay_insert_at_cursor(local_cfg, state, chunk)
        mesh.max_(state.max_priority, "max_priority")
        return state

    return insert


def shard_update(update_step, mesh: Mesh):
    """One local update (built with `mesh`, so it averages its gradients)
    -> the data-parallel update: scalar metrics averaged, `max_priority`
    MAXed. The identity mesh returns `update_step` itself."""
    if not mesh.distributed:
        return update_step

    def step(state, rstate, beta, **draws):
        state, rstate, metrics = update_step(state, rstate, beta, **draws)
        metrics = mesh.mean_metrics(metrics)
        mesh.max_(rstate.max_priority, "max_priority")
        return state, rstate, metrics

    return step


def make_sharded_update_step(model_cfg, algo_cfg, local_replay_cfg,
                             frame_stack: int, flatten: bool, mesh: Mesh,
                             num_updates: int = 1,
                             channels_last: bool = False):
    """The data-parallel learner update (JAX `make_sharded_update_step`).

    `algo_cfg.batch_size` is the PER-RANK batch; the global batch is
    batch_size * d. Returns fn(train_state, replay_state, beta,
    draws=None) -> (train_state, replay_state, last metrics) running
    `num_updates` updates; `draws`, a list of one keyword dict per
    update, injects this rank's draws (tests)."""
    from rltime_tpu_torch.training.learner import make_update_step
    from rltime_tpu_torch.training.r2d2 import make_r2d2_update_step
    if algo_cfg.algo == "r2d2":
        local = make_r2d2_update_step(model_cfg, algo_cfg, local_replay_cfg,
                                      frame_stack, flatten, mesh=mesh)
    else:
        local = make_update_step(algo_cfg, local_replay_cfg, frame_stack,
                                 flatten, channels_last, mesh=mesh)
    one = shard_update(local, mesh)

    def update(state, rstate, beta, draws=None):
        metrics = {}
        for k in range(num_updates):
            state, rstate, metrics = one(state, rstate, beta,
                                         **(draws[k] if draws else {}))
        return state, rstate, metrics

    return update


# ----- pooled statistics --------------------------------------------------

def pool_process_stats(values: Iterable[float], cap: int, mesh: Mesh):
    """Pool per-rank scalar stats across ALL ranks (a rendezvous: every
    rank calls it at the same point).

    Returns (pooled_values, global_sum, global_count): the pooled values
    are every rank's first `cap` values (a fixed-size NaN-padded gather,
    so order-invariant statistics are rank-count-invariant on it); the
    sum and count are EXACT, so means and episode counts stay unbiased
    when a rank held more than `cap`."""
    vals = np.asarray(list(values), np.float32).reshape(-1)
    if mesh.size == 1:
        return [float(v) for v in vals], float(vals.sum()), int(vals.size)
    buf = np.full((cap,), np.nan, np.float32)
    n = min(vals.size, cap)
    buf[:n] = vals[:n]
    meta = np.array([vals.sum(dtype=np.float64), vals.size], np.float64)
    pooled = [float(x) for b in mesh.all_gather_host(buf)
              for x in b if not np.isnan(x)]
    m = np.stack(mesh.all_gather_host(meta))
    return pooled, float(m[:, 0].sum()), int(m[:, 1].sum())


# ----- per-rank sidecars --------------------------------------------------

def sidecar_path(result_dir: str, step: int, rank: int) -> str:
    """`checkpoints_aux/<step>/proc<rank>.pt`: what one rank alone holds
    of the checkpoint at `step` (its actor, its replay shard, its
    sampling stream), beside the lead's learner checkpoint."""
    return os.path.join(ckpt_lib.aux_dir(result_dir, step), f"proc{rank}.pt")


def save_sidecar(result_dir: str, step: int, rank: int,
                 payload: Dict[str, Any]) -> str:
    path = sidecar_path(result_dir, step, rank)
    os.makedirs(os.path.dirname(path), exist_ok=True)
    tmp = path + ".tmp"
    torch.save(payload, tmp)
    os.replace(tmp, path)
    return path


def load_sidecar(result_dir: str, step: int, rank: int) -> Dict[str, Any]:
    path = sidecar_path(result_dir, step, rank)
    if not os.path.isfile(path):
        raise FileNotFoundError(
            f"resume: checkpoint {step} has no sidecar {path}: it was "
            "written by another number of ranks or an older layout. Delete "
            "the checkpoint or start without train.resume.")
    return torch.load(path, map_location="cpu", weights_only=True)
