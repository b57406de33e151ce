"""Benchmark of the port on one NVIDIA GPU (port of the root `bench.py`).

    python -m rltime_tpu_torch.bench [--device cuda]

1. LEARNER (the headline): the bench superstep of `utils/benchprog.py`,
   S x (chunk insert + K updates) of the config-#2 learner at its bench
   shapes (E=64, T=1024, L=32, F=4, n=3, batch 1024, K=1, S=64), one
   CUDA-graph replay per dispatch. Two warm-up dispatches and the
   capture come first; the chunks of every timed dispatch are staged on
   the card before the clock starts; each window of dispatches ends in
   a read of the last loss (a sync). The median and the spread of the
   windows are reported, beside the same superstep run op by op
   (`eager_superstep`) on the same card, and the device-busy share of
   one replayed dispatch from a `utils/profiling.trace` (with the
   kernels that took most of it), and the peak device memory.
2. FULL acting + learning loop: the fused trainer (`parallel/fused.py`)
   on MinAtar Breakout at the root bench's shapes (256 lanes, L=128,
   256 updates per chunk, one superstep per dispatch), each superstep
   one CUDA-graph replay after two eager supersteps and the capture;
   beside it the same trainer with capture off (`..._eager`: the same
   body op by op), and the device-busy share of one profiled replay.

FLOPs are the root bench's analytic count (Nature-CNN convs and FCs and
the dueling head, 5 forward-equivalents per sample); MFU is against the
H100 SXM's dense bf16 peak. The line names the card and its power
limit. No TPU number is printed or used as a bar. Prints ONE JSON line.
The bench measures the card: any other device raises.
"""
from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import tempfile
import time

H100_BF16_PEAK = 989e12     # FLOP/s, H100 SXM dense bf16 (data sheet)
WINDOWS = 5                 # timed windows per leg
DISPATCHES = 4              # staged dispatches per learner window
MINATAR_DISPATCHES = 2      # dispatches per fused window


def analytic_flops_per_dispatch(p) -> float:
    """The root bench's `_analytic_flops_per_dispatch`: Nature-CNN
    forward (conv and FC multiply-adds x 2) x batch x 3 forwards (online
    s, target s', online s') + ~2x forward for the backward of the one
    differentiated forward, per update."""
    convs = [(84, 8, 4, 4, 32), (20, 4, 2, 32, 64), (9, 3, 1, 64, 64)]
    f = 0.0
    for size, k, s, cin, cout in convs:
        out = (size - k) // s + 1
        f += 2.0 * out * out * cout * k * k * cin
    f += 2.0 * 7 * 7 * 64 * 512            # fc
    f += 2.0 * (512 * 256 * 2 + 256 * 7)   # dueling head (V+A)
    per_update = p.batch * f * (3 + 2)
    return per_update * p.S * p.K


def card() -> dict:
    """The card's name and count from torch, and `nvidia-smi`'s name and
    power limit."""
    import torch
    try:
        smi = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=60).stdout.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError):
        smi = "nvidia-smi not available"
    return {"kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count(), "nvidia_smi": smi}


def device_time(prof):
    """(busy ms, {name: ms}) of a torch.profiler run's CUDA activity
    (kernels, copies, sets; user annotations left out): busy is the
    union of the intervals, so overlapping work counts once."""
    from torch.autograd import DeviceType
    events = [e for e in prof.events() if e.device_type == DeviceType.CUDA
              and not e.is_user_annotation]
    per_name: dict = {}
    for e in events:
        per_name[e.name] = (per_name.get(e.name, 0.0)
                            + (e.time_range.end - e.time_range.start) / 1e3)
    busy_us, end = 0.0, float("-inf")
    for a, b in sorted((e.time_range.start, e.time_range.end)
                       for e in events):
        if b > end:
            busy_us += b - max(a, end)
            end = b
    return busy_us / 1e3, per_name


def _windows(step, p, beta, staged):
    """Seconds of each of WINDOWS windows: the staged dispatches in
    order, then a read of the last loss."""
    out = []
    for _ in range(WINDOWS):
        t0 = time.perf_counter()
        for chunks in staged:
            _, _, m = step(p.tstate, p.rstate, beta, chunks)
        m["loss"].item()
        out.append(time.perf_counter() - t0)
    return out


def _rates(seconds, units):
    rates = [units / s for s in seconds]
    return statistics.median(rates), rates


def bench_learner(device: str = "cuda") -> dict:
    """The learner leg (see the module doc)."""
    import torch

    from rltime_tpu_torch.utils import benchprog, profiling
    torch.cuda.reset_peak_memory_stats(device)
    p = benchprog.build(device=device)
    if p.graph is None:
        raise RuntimeError(f"the bench measures a CUDA device, got {device}")
    beta = torch.full((), 0.4, device=p.device)
    warm = p.stacked(50)
    for _ in range(p.graph.WARMUP + 1):   # eager warm-ups, then capture
        _, _, m = p.superstep(p.tstate, p.rstate, beta, warm)
    m["loss"].item()
    staged = [p.stacked(100 + p.S * i) for i in range(DISPATCHES)]
    torch.cuda.synchronize()
    updates = DISPATCHES * p.S * p.K
    tx, tx_windows = _rates(
        _windows(p.superstep, p, beta, staged),
        updates * p.tx_per_update)
    # op by op, one staged dispatch a window (~1 s each at these shapes)
    tx_eager, eager_windows = _rates(
        _windows(p.eager_superstep, p, beta, staged[:1]),
        p.S * p.K * p.tx_per_update)
    with tempfile.TemporaryDirectory() as log_dir:
        with profiling.trace(log_dir) as prof:
            t0 = time.perf_counter()
            _, _, m = p.superstep(p.tstate, p.rstate, beta, staged[0])
            m["loss"].item()
            wall_ms = (time.perf_counter() - t0) * 1e3
        busy, per_name = device_time(prof)
    top = sorted(per_name.items(), key=lambda kv: -kv[1])[:12]
    flops_per_s = (analytic_flops_per_dispatch(p) * tx / p.tx_per_update
                   / (p.S * p.K))
    return {
        "learner_transitions_per_s": tx,
        "learner_transitions_per_s_windows": tx_windows,
        "learner_transitions_per_s_eager": tx_eager,
        "learner_transitions_per_s_eager_windows": eager_windows,
        "ms_per_update": 1e3 * p.tx_per_update / tx,
        "ms_per_update_eager": 1e3 * p.tx_per_update / tx_eager,
        "update_tflops_per_s": flops_per_s / 1e12,
        "mfu_pct_h100_bf16": 100 * flops_per_s / H100_BF16_PEAK,
        "device_busy_ms_per_dispatch": busy,
        "profiled_dispatch_ms": wall_ms,
        "device_busy_share": busy / wall_ms,
        "top_kernels_ms_per_dispatch": [[n[:100], ms] for n, ms in top],
        "peak_memory_gb": torch.cuda.max_memory_allocated(device) / 1e9,
        "shape": {"E": p.E, "T": p.T, "L": p.L, "F": p.F,
                  "n_step": p.n_step, "batch": p.batch, "S": p.S,
                  "K": p.K, "algo": p.acfg.algo},
    }


def bench_minatar_fused(device: str = "cuda", capture: bool = True) -> dict:
    """The fused MinAtar Breakout loop at the root bench's shapes:
    warm dispatches (the graph's eager warm-ups and its capture, or 2
    op by op), then WINDOWS windows of MINATAR_DISPATCHES, then (when
    captured) one more dispatch profiled. `capture=False`: the same
    trainer op by op, its keys suffixed `_eager`."""
    import torch

    from rltime_tpu_torch.config.config import apply_overrides, load_config
    from rltime_tpu_torch.parallel.fused import FusedApexTrainer
    from rltime_tpu_torch.utils import profiling
    from rltime_tpu_torch.utils.graphs import GraphedStep
    # the preset holds the root bench's lanes, ring, model and algo
    cfg = apply_overrides(load_config("minatar_breakout_dqn"), [
        "train.chunk_len=128",
        "train.updates_per_chunk=256", "train.supersteps_per_dispatch=1",
        "train.warmup_env_steps=0", "train.total_env_steps=1000000000",
        "train.log_interval=1000000000"])
    out = {}
    suffix = "" if capture else "_eager"
    with tempfile.TemporaryDirectory() as result_dir:
        trainer = FusedApexTrainer(cfg, result_dir, device=device,
                                   capture=capture)
        if trainer.device.type != "cuda":
            raise RuntimeError("the bench measures a CUDA device, got "
                               f"{trainer.device}")
        # warm (fills the replay too); captured: the eager warm-ups and
        # the capture
        for _ in range(GraphedStep.WARMUP + 1 if capture else 2):
            m = trainer.superstep()
        m["loss"].item()
        rates = []
        for _ in range(WINDOWS):
            s0 = trainer.env_steps
            t0 = time.perf_counter()
            for _ in range(MINATAR_DISPATCHES):
                m = trainer.superstep()
            m["loss"].item()
            rates.append((trainer.env_steps - s0)
                         / (time.perf_counter() - t0))
        rate = statistics.median(rates)
        out[f"minatar_env_steps_per_s{suffix}"] = rate
        out[f"minatar_env_steps_per_s{suffix}_windows"] = rates
        # what the profiled dispatch below is held against: tracing
        # slows a replay of many small kernels on the host
        out[f"minatar_ms_per_dispatch{suffix}"] = (
            1e3 * trainer.loop_cfg.chunk_len * trainer.e_global / rate)
        if capture:
            with tempfile.TemporaryDirectory() as log_dir:
                torch.cuda.synchronize()
                with profiling.trace(log_dir) as prof:
                    t0 = time.perf_counter()
                    trainer.superstep()["loss"].item()
                    wall_ms = (time.perf_counter() - t0) * 1e3
                busy, _ = device_time(prof)
            out.update(minatar_device_busy_ms_per_dispatch=busy,
                       minatar_profiled_dispatch_ms=wall_ms,
                       minatar_device_busy_share=busy / wall_ms)
    return out


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", default="cuda",
                    help="the CUDA device to measure (default cuda)")
    args = ap.parse_args(argv)
    from rltime_tpu_torch.device import resolve_device
    if resolve_device(args.device).type != "cuda":
        raise SystemExit(f"the bench measures a CUDA device, got "
                         f"{args.device!r}")
    learner = bench_learner(args.device)
    minatar = bench_minatar_fused(args.device)
    minatar.update(bench_minatar_fused(args.device, capture=False))
    line = {"metric": "learner_transitions_per_s_single_gpu",
            "value": learner["learner_transitions_per_s"],
            "unit": "transitions/s", **learner, **minatar,
            "device": card()}
    print(json.dumps(line), flush=True)
    return line


if __name__ == "__main__":
    main()
