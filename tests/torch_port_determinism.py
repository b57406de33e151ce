"""Is a fused preset's run on the card a function of its seed? (A script,
not a test: it needs a card.)

    python tests/torch_port_determinism.py [preset] [--mode M] [--dispatches N]

Builds the preset's fused trainer twice from the same seed at its full
width, runs N trained dispatches on each (after the preset's warmup) and
prints whether the learner parameters, the replay rings and the
priorities came out bit-equal, with the first parameter that differs,
and the host-clock ms per trained dispatch of each run. `--mode`:
  default  PyTorch's defaults (cuDNN picks its algorithms by speed);
  cudnn    torch.backends.cudnn.deterministic = True, benchmark off;
  strict   torch.use_deterministic_algorithms(True) with
           CUBLAS_WORKSPACE_CONFIG=:4096:8: an op that has no
           deterministic implementation raises, and the error names it.
Run each mode in a process of its own (the cuBLAS setting is read when
cuBLAS starts). The last line is one JSON object.
"""
import argparse
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main():
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("preset", nargs="?", default="minatar_seaquest_dqn")
    ap.add_argument("--mode", default="default",
                    choices=("default", "cudnn", "strict"))
    ap.add_argument("--dispatches", type=int, default=3)
    args = ap.parse_args()
    if args.mode == "strict":
        os.environ["CUBLAS_WORKSPACE_CONFIG"] = ":4096:8"
    sys.path.insert(0, ROOT)
    import torch
    from rltime_tpu_torch.config.config import apply_overrides, load_config
    from rltime_tpu_torch.parallel.fused import FusedApexTrainer
    if args.mode in ("cudnn", "strict"):
        torch.backends.cudnn.deterministic = True
        torch.backends.cudnn.benchmark = False
    if args.mode == "strict":
        torch.use_deterministic_algorithms(True)
    cfg = apply_overrides(load_config(args.preset), [
        "train.total_env_steps=1000000000", "train.log_interval=1000000000"])
    runs, ms, error = [], [], None
    t0 = time.perf_counter()
    try:
        for i in range(2):
            t = FusedApexTrainer(cfg, os.path.join(
                ROOT, "results", f"determinism_{args.preset}_{i}"),
                device="cuda")
            while t.updates_done == 0:
                t.superstep()
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            for _ in range(args.dispatches):
                t.superstep()
            torch.cuda.synchronize()
            ms.append((time.perf_counter() - t1) / args.dispatches * 1e3)
            runs.append(t)
    except RuntimeError as e:       # strict: the op without a
        error = str(e).splitlines()[0]  # deterministic implementation
    out = dict(preset=args.preset, mode=args.mode, error=error,
               seconds=time.perf_counter() - t0, ms_per_dispatch=ms,
               device=torch.cuda.get_device_name(0))
    if len(runs) == 2:
        a, b = runs
        diff = [k for (k, x), y in zip(
            a.train_state.model.state_dict().items(),
            b.train_state.model.state_dict().values())
            if not torch.equal(x, y)]
        out.update(
            updates=a.updates_done, params_equal=not diff,
            first_param_differing=diff[0] if diff else None,
            max_abs_param_diff=max(
                (float((x.detach() - y.detach()).abs().max()) for x, y in zip(
                    a.train_state.model.parameters(),
                    b.train_state.model.parameters())), default=0.0),
            tree_equal=bool(torch.equal(a.replay_state.tree,
                                        b.replay_state.tree)),
            rings_equal=all(torch.equal(v, b.replay_state.storage[k])
                            for k, v in a.replay_state.storage.items()),
            loss=[float(a.last_metrics["loss"]),
                  float(b.last_metrics["loss"])])
    print(json.dumps(out), flush=True)


if __name__ == "__main__":
    main()
