"""Train MinAtar presets to their own horizon and score them (a script, not a test).

    python tests/torch_port_minatar_bands.py minatar_breakout_iqn:0 \
        minatar_breakout_r2d2:0 [--out results/minatar_bands.json]
        [--episodes 30] [--device cuda] [--override key.sub=value ...]

Each `preset:seed` runs `python -m rltime_tpu_torch.train <preset>
--seed=<seed>` at the preset's own `train.total_env_steps`, then
`python -m rltime_tpu_torch.eval <dir> --episodes N --best` and the same
without `--best` (the `STATUS.md` protocol: 30 episodes of the best
checkpoint). The runs go in parallel, one process each, on one card.
Prints one JSON line per run and writes all of them, with the card's
name and power limit, to `--out`.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _smi() -> str:
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30).stdout.strip()
    except (OSError, subprocess.SubprocessError):
        return "not available"


def _eval(rd: str, episodes: int, best: bool, device: str) -> dict:
    cmd = [sys.executable, "-m", "rltime_tpu_torch.eval", rd,
           "--episodes", str(episodes), "--device", device]
    if best:
        cmd.append("--best")
    r = subprocess.run(cmd, cwd=ROOT, capture_output=True, text=True)
    if r.returncode != 0:
        return {"error": r.stderr[-2000:]}
    return json.loads(r.stdout.strip().splitlines()[-1])


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("runs", nargs="+", help="preset:seed")
    p.add_argument("--out", default="results/minatar_bands.json")
    p.add_argument("--episodes", type=int, default=30)
    p.add_argument("--device", default="cuda")
    p.add_argument("--deadline", type=float, default=0.0,
                   help="seconds: stop the runs still training then and "
                        "score their best checkpoint so far (0 = none)")
    p.add_argument("--override", action="append", default=[],
                   help="key.sub=value passed to every run (a cut check)")
    args = p.parse_args(argv)
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    log_dir = os.path.join(os.path.dirname(os.path.abspath(args.out)),
                           "minatar_bands_logs")
    os.makedirs(log_dir, exist_ok=True)
    procs = []
    for spec in args.runs:
        preset, _, seed = spec.partition(":")
        seed = int(seed or 0)
        rd = os.path.join(ROOT, "results", f"band-{preset}-s{seed}")
        log = open(os.path.join(log_dir, f"{preset}-s{seed}.log"), "w")
        t0 = time.time()
        proc = subprocess.Popen(
            [sys.executable, "-m", "rltime_tpu_torch.train", preset,
             f"--seed={seed}", "--result-dir", rd, "--device", args.device]
            + [f"--{o}" for o in args.override],
            cwd=ROOT, stdout=log, stderr=subprocess.STDOUT,
            env=dict(os.environ, OMP_NUM_THREADS="2"))
        procs.append((preset, seed, rd, proc, t0, log))
    card = _smi()
    print(card, flush=True)
    start = time.time()
    results = []
    for preset, seed, rd, proc, t0, log in procs:
        try:
            left = (args.deadline - (time.time() - start)
                    if args.deadline else None)
            rc = proc.wait(timeout=max(left, 1.0) if left is not None
                           else None)
        except subprocess.TimeoutExpired:
            proc.terminate()
            rc = proc.wait()
            rc = f"stopped at the deadline ({rc})"
        log.close()
        rec = dict(preset=preset, seed=seed, train_rc=rc,
                   train_s=time.time() - t0)
        if os.path.isdir(os.path.join(rd, "checkpoints")):
            rec["best"] = _eval(rd, args.episodes, True, args.device)
            rec["latest"] = _eval(rd, args.episodes, False, args.device)
        print(json.dumps(rec), flush=True)
        results.append(rec)
        with open(args.out, "w") as f:
            json.dump({"card": card, "runs": results}, f, indent=1)
    return 0 if all(r["train_rc"] == 0 for r in results) else 1


if __name__ == "__main__":
    sys.exit(main())
