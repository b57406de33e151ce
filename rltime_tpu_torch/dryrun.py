"""Compile-and-run checks of the port: the counterpart of the repository's root entry module.

    python -m rltime_tpu_torch.dryrun [--ranks N] [--device cuda|cpu]

`entry(device)` returns `(fn, args)`: the flagship Atari network (Nature
CNN + dueling head in bfloat16, config #2's shape) as a function of its
parameters, `fn(params, obs) -> q`, with `args = (params, obs)` for a
batch of 128 zero 4x84x84 uint8 stacks.

`dryrun_multichip(n, device)` starts n ranks, one process each on its
own device (NCCL on cards, `cuda:<rank>`; gloo on the CPU), meeting
through a `file://` rendezvous in a temporary directory (no TCP port).
Each rank joins the mesh of `parallel/mesh.py` and runs every training
leg once at tiny shapes, asserting what the reference asserts:

  1. a sharded FF-DQN step: sharded replay insert, then one PER n-step
     double-Q update with averaged gradients;
  2. a sharded R2D2 sequence update (stored LSTM carry, burn-in);
  3. the fused superstep: a warmup act+insert dispatch, then one that
     trains (2 updates);
  4. the fused superstep with the IQN head;
  5. the fused interleaved superstep (`train.interleave_updates`).

The lead prints one summary line of the five losses; a failing rank
fails the call with every rank's log. Both run on the card unless the
caller asks for the CPU.
"""
from __future__ import annotations

import argparse
import os
import subprocess
import sys
import tempfile
import time
from typing import Dict

import numpy as np
import torch

from rltime_tpu_torch.device import resolve_device
from rltime_tpu_torch.models.policy import ModelConfig, QPolicy
from rltime_tpu_torch.utils.prng import make_generator

_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def entry(device="cuda"):
    """(fn, (params, obs)): the bf16 Nature-CNN dueling forward at B=128."""
    device = resolve_device(device)
    cfg = ModelConfig(num_actions=6, torso="nature_cnn", head="dueling",
                      compute_dtype="bfloat16")
    model = QPolicy(cfg, (4, 84, 84), make_generator(0, "init"))
    model = model.to(device).requires_grad_(False)
    obs = torch.zeros((128, 4, 84, 84), dtype=torch.uint8, device=device)
    params = dict(model.state_dict())

    def fn(params, obs):
        return torch.func.functional_call(model, params, (obs,))

    return fn, (params, obs)


def _fused_cfg(seed, model, algo, train, replay=None):
    return {"seed": seed,
            "env": {"type": "cartpole_device", "num_envs": 2},
            "model": model,
            "replay": {"steps_per_env": 64, "prioritized": True,
                       **(replay or {})},
            "algo": {"algo": "dqn", "batch_size": 4, "n_step": 2,
                     "lr": 1e-3, "target_update_freq": 10, **algo},
            "train": {"total_env_steps": 10**9, "warmup_env_steps": 0,
                      "chunk_len": 8, "updates_per_chunk": 2,
                      "log_interval": 10**9, "trainer": "fused", **train}}


def _legs(mesh, workdir: str) -> Dict[str, float]:
    """Run the five legs on this rank; returns their losses."""
    from rltime_tpu_torch.history.replay import ReplayConfig, replay_init
    from rltime_tpu_torch.parallel.fused import FusedApexTrainer
    from rltime_tpu_torch.parallel.mesh import (
        make_sharded_insert, make_sharded_update_step,
    )
    from rltime_tpu_torch.training.learner import AlgoConfig, make_train_state
    d, dev = mesh.size, mesh.device
    E_local, T, L, n_step, F = 2, 64, 8, 3, 4
    lanes = slice(mesh.rank * E_local, (mesh.rank + 1) * E_local)
    E = d * E_local
    rng = np.random.default_rng(0)
    losses = {}

    # 1) sharded FF-DQN: insert on every rank, one averaged update
    rcfg = ReplayConfig(num_envs=E_local, steps_per_env=T, horizon=n_step,
                        chunk_len=L, lookback=F - 1, prioritized=True)
    mcfg = ModelConfig(num_actions=6, torso="nature_cnn",
                       cnn_channels=(8, 8, 8), cnn_fc=32, head="dueling",
                       dueling_hidden=16)
    acfg = AlgoConfig(algo="dqn", batch_size=4, n_step=n_step, double_q=True,
                      lr=1e-4, target_update_freq=10)
    rstate = replay_init(rcfg, {
        "obs": ((36, 36), torch.uint8), "action": ((), torch.int32),
        "reward": ((), torch.float32), "terminated": ((), torch.bool),
        "done": ((), torch.bool)}, dev)
    insert = make_sharded_insert(rcfg, mesh)
    for _ in range(3):
        chunk = dict(
            obs=rng.integers(0, 255, size=(E, L, 36, 36), dtype=np.uint8),
            action=rng.integers(0, 6, size=(E, L)).astype(np.int32),
            reward=rng.normal(size=(E, L)).astype(np.float32),
            terminated=rng.random((E, L)) < 0.05,
            done=rng.random((E, L)) < 0.05)
        rstate = insert(rstate, {k: v[lanes] for k, v in chunk.items()})
    tstate = make_train_state(mcfg, acfg, (F, 36, 36), 0, dev)
    update = make_sharded_update_step(mcfg, acfg, rcfg, F, False, mesh)
    tstate, rstate, metrics = update(tstate, rstate, 0.4)
    assert tstate.updates == 1
    losses["ff"] = float(metrics["loss"])

    # 2) sharded R2D2 sequence update on the same mesh
    r2_acfg = AlgoConfig(algo="r2d2", batch_size=2, n_step=1, burn_in=2,
                         seq_len=4, lr=1e-3, target_update_freq=10)
    r2_rcfg = ReplayConfig(num_envs=E_local, steps_per_env=T,
                           horizon=2 + 4 + 1, chunk_len=L, prioritized=True)
    r2_mcfg = ModelConfig(num_actions=4, torso="mlp", mlp_hidden=(8,),
                          lstm_size=8, head="linear")
    r2_state = replay_init(r2_rcfg, {
        "obs": ((6,), torch.float32), "action": ((), torch.int32),
        "reward": ((), torch.float32), "terminated": ((), torch.bool),
        "done": ((), torch.bool), "rnn_c": ((8,), torch.float32),
        "rnn_h": ((8,), torch.float32)}, dev)
    r2_insert = make_sharded_insert(r2_rcfg, mesh)
    for _ in range(3):
        chunk = dict(
            obs=rng.normal(size=(E, L, 6)).astype(np.float32),
            action=rng.integers(0, 4, size=(E, L)).astype(np.int32),
            reward=rng.normal(size=(E, L)).astype(np.float32),
            terminated=rng.random((E, L)) < 0.05,
            done=rng.random((E, L)) < 0.05,
            rnn_c=rng.normal(size=(E, L, 8)).astype(np.float32),
            rnn_h=rng.normal(size=(E, L, 8)).astype(np.float32))
        r2_state = r2_insert(r2_state,
                             {k: v[lanes] for k, v in chunk.items()})
    r2_tstate = make_train_state(r2_mcfg, r2_acfg, (6,), 1, dev)
    r2_update = make_sharded_update_step(r2_mcfg, r2_acfg, r2_rcfg, 1, True,
                                         mesh)
    r2_tstate, r2_state, m = r2_update(r2_tstate, r2_state, 0.4)
    assert r2_tstate.updates == 1
    losses["r2d2"] = float(m["loss"])

    # 3-5) the fused superstep: chunked (warmup dispatch first), IQN,
    # interleaved. Per dispatch 8 steps of 2*d lanes = 16d env steps; a
    # warmup of 20d makes the first dispatch act+insert only.
    mlp = {"torso": "mlp", "mlp_hidden": [8], "head": "linear"}
    iqn = {"torso": "mlp", "mlp_hidden": [8], "head": "iqn",
           "iqn_embed_dim": 8, "num_tau": 4, "num_tau_prime": 4,
           "num_tau_policy": 4}
    legs = [
        ("fused", _fused_cfg(0, mlp, {}, {"warmup_env_steps": 20 * d},
                             {"use_inserted_priorities": True}), 2),
        ("fused_iqn", _fused_cfg(2, iqn, {"algo": "iqn", "num_tau": 4,
                                          "num_tau_prime": 4}, {}), 2),
        ("fused_interleaved", _fused_cfg(
            3, mlp, {}, {"updates_per_chunk": 8,
                         "interleave_updates": True}), 8),
    ]
    for name, cfg, updates in legs:
        t = FusedApexTrainer(cfg, os.path.join(workdir, name), device=dev,
                             mesh=mesh)
        m = t.superstep()
        if name == "fused":
            assert m == {} and t.updates_done == 0   # the warmup dispatch
            m = t.superstep()
        assert t.updates_done == updates, (name, t.updates_done)
        losses[name] = float(m["loss"])
    for name, loss in losses.items():
        assert np.isfinite(loss), (name, loss)
    return losses


def _rank_main(rank: int, world: int, workdir: str, device: str) -> int:
    import torch.distributed as dist
    from rltime_tpu_torch.parallel.mesh import make_mesh
    dev = resolve_device(device)
    if dev.type == "cuda":
        dev = torch.device("cuda", rank)
        torch.cuda.set_device(dev)
    dist.init_process_group(
        backend="nccl" if dev.type == "cuda" else "gloo",
        init_method=f"file://{os.path.join(workdir, 'rendezvous')}",
        world_size=world, rank=rank,
        **({"device_id": dev} if dev.type == "cuda" else {}))
    try:
        mesh = make_mesh(dev, size=world)
        losses = _legs(mesh, workdir)
        mesh.barrier()
        if rank == 0:
            print(f"dryrun_multichip({world}) OK: ff_loss={losses['ff']:.5f} "
                  f"r2d2_loss={losses['r2d2']:.5f} "
                  f"fused_loss={losses['fused']:.5f} "
                  f"fused_iqn_loss={losses['fused_iqn']:.5f} "
                  f"fused_interleaved_loss={losses['fused_interleaved']:.5f} "
                  f"mesh={{'ranks': {world}, 'backend': "
                  f"'{dist.get_backend()}'}}", flush=True)
    finally:
        dist.destroy_process_group()
    return 0


def dryrun_multichip(n_devices: int, device="cuda",
                     timeout: float = 600.0) -> str:
    """Run the five legs on `n_devices` ranks (see the module doc);
    returns the lead's summary line. Raises with every rank's log when a
    rank fails or the call outlasts `timeout` seconds."""
    device = resolve_device(device)
    if device.type == "cuda" and n_devices > torch.cuda.device_count():
        raise ValueError(f"{n_devices} ranks need {n_devices} cards, this "
                         f"machine has {torch.cuda.device_count()}")
    env = dict(os.environ)
    env["PYTHONPATH"] = _ROOT + os.pathsep + env.get("PYTHONPATH", "")
    if device.type == "cpu":
        env["OMP_NUM_THREADS"] = "1"
    with tempfile.TemporaryDirectory(prefix="dryrun-") as workdir:
        logs = [os.path.join(workdir, f"rank{r}.log")
                for r in range(n_devices)]
        procs = []
        for r in range(n_devices):
            with open(logs[r], "w") as f:
                procs.append(subprocess.Popen(
                    [sys.executable, "-m", "rltime_tpu_torch.dryrun",
                     "--rank", str(r), "--world", str(n_devices),
                     "--workdir", workdir, "--device", device.type],
                    stdout=f, stderr=subprocess.STDOUT, env=env))
        deadline = time.monotonic() + timeout
        try:
            while any(p.poll() is None for p in procs):
                if (time.monotonic() > deadline
                        or any(p.poll() not in (None, 0) for p in procs)):
                    break
                time.sleep(0.05)
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                p.wait()
        texts = [open(path).read() for path in logs]
    if any(p.returncode != 0 for p in procs):
        raise RuntimeError(f"dryrun_multichip({n_devices}) failed:\n" + "\n".join(
            f"--- rank {r} (rc={p.returncode}):\n{texts[r][-4000:]}"
            for r, p in enumerate(procs)))
    line = next(x for x in texts[0].splitlines()
                if x.startswith("dryrun_multichip("))
    print(line)
    return line


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--ranks", type=int, default=1)
    p.add_argument("--device", default="cuda",
                   help="cuda (default: one card per rank) or cpu")
    p.add_argument("--rank", type=int, default=None, help=argparse.SUPPRESS)
    p.add_argument("--world", type=int, default=None, help=argparse.SUPPRESS)
    p.add_argument("--workdir", default=None, help=argparse.SUPPRESS)
    args = p.parse_args(argv)
    if args.rank is not None:
        return _rank_main(args.rank, args.world, args.workdir, args.device)
    fn, (params, obs) = entry(args.device)
    q = fn(params, obs)
    print(f"entry(): q {tuple(q.shape)} {q.dtype} on {q.device}, "
          f"finite {bool(torch.isfinite(q).all())}")
    dryrun_multichip(args.ranks, args.device)
    return 0


if __name__ == "__main__":
    sys.exit(main())
