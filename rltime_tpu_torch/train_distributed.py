"""Multi-rank train CLI of the PyTorch port (config #5 and the fused
trainer over a mesh).

Run the same command once per rank:

    python -m rltime_tpu_torch.train_distributed apex_multihost_counting \\
        --coordinator HOST:PORT --num-processes N --process-id I \\
        [--device cuda|cpu] [--result-dir DIR] [--key.sub=value ...]

or under torchrun, which sets RANK, WORLD_SIZE and LOCAL_RANK (and
MASTER_ADDR / MASTER_PORT):

    torchrun --nproc-per-node N -m rltime_tpu_torch.train_distributed \\
        apex_multihost_counting

It joins the process group (NCCL with one card per rank, `cuda:<local
rank>`; gloo with `--device cpu`) and runs `train.trainer`: "apex" (the
default here, host env shards) or "fused" (device envs). `env.num_envs`
and `algo.batch_size` are per rank. `--init-method` (for example
`file:///tmp/rendezvous`) replaces `--coordinator`. Every rank reads and
writes the same `--result-dir` (without one, the lead's default
`results/<config>-torch-<time>`): the lead the learner checkpoint and
best.json, each rank its own sidecar.
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import time


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("config", help="JSON config path or preset name")
    parser.add_argument("--result-dir", default=None)
    parser.add_argument("--coordinator", default=None, help="HOST:PORT")
    parser.add_argument("--init-method", default=None)
    parser.add_argument("--num-processes", type=int, default=None)
    parser.add_argument("--process-id", type=int, default=None)
    parser.add_argument("--device", default="cuda",
                        help="cuda (default: one card per rank) or cpu")
    parser.add_argument("--resume", action="store_true")
    args, overrides = parser.parse_known_args(argv)
    bad = [o for o in overrides if "=" not in o]
    if bad:
        parser.error(f"unrecognized arguments: {' '.join(bad)}")

    import torch
    import torch.distributed as dist
    from rltime_tpu_torch.config.config import apply_overrides, load_config
    from rltime_tpu_torch.device import resolve_device

    env = os.environ
    world = args.num_processes or int(env.get("WORLD_SIZE", 1))
    rank = (args.process_id if args.process_id is not None
            else int(env.get("RANK", 0)))
    local_rank = int(env.get("LOCAL_RANK", rank))
    if not 0 <= rank < world:
        parser.error(f"process id {rank} outside [0, {world})")
    device = resolve_device(args.device)
    if device.type == "cuda":
        device = torch.device("cuda", local_rank)
        torch.cuda.set_device(device)
    if args.init_method:
        init = args.init_method
    elif args.coordinator:
        init = f"tcp://{args.coordinator}"
    elif "MASTER_ADDR" in env:
        init = "env://"
    else:
        parser.error("give --coordinator HOST:PORT or --init-method, or run "
                     "under torchrun")
    dist.init_process_group(
        backend="nccl" if device.type == "cuda" else "gloo",
        init_method=init, world_size=world, rank=rank,
        **({"device_id": device} if device.type == "cuda" else {}))
    try:
        cfg = apply_overrides(load_config(args.config), overrides)
        if args.resume:
            cfg.setdefault("train", {})["resume"] = True
        from rltime_tpu_torch.parallel.mesh import make_mesh
        mesh = make_mesh(device, size=world)
        name = os.path.splitext(os.path.basename(args.config))[0]
        # one directory for every rank: the lead's (the ranks' clocks may
        # read different seconds)
        result_dir = mesh.lead_value(args.result_dir or os.path.join(
            "results", f"{name}-torch-{time.strftime('%Y%m%d-%H%M%S')}"),
            "result_dir")
        if rank == 0:
            print(f"result dir: {result_dir} | ranks: {world} | backend: "
                  f"{dist.get_backend()} | device: {device}")
            print(json.dumps(cfg, indent=2))
        if cfg.get("train", {}).get("trainer", "apex") == "fused":
            from rltime_tpu_torch.parallel.fused import FusedApexTrainer
            trainer = FusedApexTrainer(cfg, result_dir, device=device,
                                       mesh=mesh)
        else:
            from rltime_tpu_torch.parallel.apex import ApexTrainer
            trainer = ApexTrainer(cfg, result_dir, device=device, mesh=mesh)
        trainer.train()
        mesh.barrier()
        if rank == 0:
            print(f"done: {trainer.updates_done} updates on each of {world} "
                  "ranks")
    finally:
        dist.destroy_process_group()
    return 0


if __name__ == "__main__":
    sys.exit(main())
