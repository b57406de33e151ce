"""Train CLI of the PyTorch port.

    python -m rltime_tpu_torch.train <config-or-preset> [--key.sub=value ...]
        [--device cuda|cpu] [--result-dir DIR] [--resume]

`<config>` is a JSON path or a preset name under the repository's
shared `configs/` (e.g. `pong_dqn_counting`, `minatar_breakout_dqn`).
`train.trainer` picks the host `Trainer` (default), the fused
on-device `FusedApexTrainer` ("fused": every MinAtar preset) or the
Ape-X `ApexTrainer` ("apex": `apex_multihost_counting`), here on one
rank; `python -m rltime_tpu_torch.train_distributed` runs the last two
on several. Dotted overrides compose onto the loaded config. `--device` defaults to `cuda` and raises when
no card is present; the CPU runs only when asked for. On the card each
trainer runs its step as a CUDA-graph replay after two eager ones (the
host trainers: a chunk's insert + K updates; the fused trainer: a whole
superstep); the CPU runs the same steps op by op.
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import time

from rltime_tpu_torch.config.config import apply_overrides, load_config


def run(argv=None):
    """Parse `argv`, train, and return the finished Trainer."""
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("config", help="JSON config path or preset name")
    parser.add_argument("--result-dir", default=None)
    parser.add_argument("--device", default="cuda",
                        help="torch device: cuda (default), cuda:N or cpu")
    parser.add_argument("--resume", action="store_true")
    args, overrides = parser.parse_known_args(argv)
    bad = [o for o in overrides if "=" not in o]
    if bad:
        parser.error(f"unrecognized arguments: {' '.join(bad)}")

    cfg = load_config(args.config)
    cfg = apply_overrides(cfg, overrides)
    if args.resume:
        cfg.setdefault("train", {})["resume"] = True

    name = os.path.splitext(os.path.basename(args.config))[0]
    result_dir = args.result_dir or os.path.join(
        "results", f"{name}-torch-{time.strftime('%Y%m%d-%H%M%S')}")
    print(f"result dir: {result_dir}")
    print(json.dumps(cfg, indent=2))
    # {"train": {"trainer": "fused"}} selects the on-device superstep
    # (device envs), "apex" the Ape-X actor/learner split
    kind = cfg.get("train", {}).get("trainer", "default")
    if kind == "fused":
        from rltime_tpu_torch.parallel.fused import FusedApexTrainer
        return FusedApexTrainer(cfg, result_dir, device=args.device).train()
    if kind == "apex":
        from rltime_tpu_torch.parallel.apex import ApexTrainer
        return ApexTrainer(cfg, result_dir, device=args.device).train()
    from rltime_tpu_torch.training.trainer import Trainer
    return Trainer(cfg, result_dir, device=args.device).train()


def main(argv=None) -> int:
    run(argv)
    return 0


if __name__ == "__main__":
    sys.exit(main())
