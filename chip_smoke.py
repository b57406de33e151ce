#!/usr/bin/env python3
"""Smoke run of the PyTorch port on one NVIDIA GPU.

    python3 chip_smoke.py          # from the repository root, one card

Phases (any failure exits non-zero and prints no result line):
  1. environment: torch/CUDA versions, the card's name and power limit
     (nvidia-smi), and the build of every CUDA kernel of the main path
     from the sources in this checkout;
  2. each kernel against its plain PyTorch version on the card at the
     main path's shapes and two odd ones (bit-exact), timed by
     torch.profiler (device time) and by CUDA events (including launch
     overhead), medians of 25 calls on fresh indices;
  3. the main path: `rltime_tpu_torch.train.run` (what `python -m
     rltime_tpu_torch.train` runs) on `pong_dqn_counting` at full width
     for 24,576 env steps with 8,192 of warmup: 9 chunks of {insert +
     K=2 updates}, 18 learner updates at batch 256. The kernels' launch
     counters are zeroed just before and read just after, and every
     kernel of the path must have launched;
     Then a few more chunks of the same trainer run under
     torch.profiler for the warm per-chunk time split and device-busy
     share;
  4. a small-input check that one learner update on the card agrees
     with the same update on the CPU (the CPU path is held to the JAX
     package by tests/test_torch_*.py).
The line before the last is the kernels' JSON record; the last line is
{"ok": true, "device": {...}}.
"""
from __future__ import annotations

import itertools
import json
import math
import shutil
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
MAIN_STEPS, WARMUP_STEPS = 24_576, 8_192
# a chunk is 64 envs x 32 steps = 2,048 env steps; chunks 4..12 (env
# steps 8,192..24,576 after their rollout) each run K=2 updates
EXPECTED_UPDATES = 18


def fail(msg: str) -> None:
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def check(cond: bool, msg: str) -> None:
    if not cond:
        fail(msg)


def median_ms(fn, runs: int = 25, warmup: int = 3) -> float:
    """Median device time of fn() in ms, by CUDA events around each run."""
    import torch
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(runs):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def device_profile(fn, runs: int = 1):
    """Run fn() `runs` times under torch.profiler. Returns (wall s,
    device-busy ms per run, {kernel name: device ms per run}) from the
    CUDA activity CUPTI recorded (kernels, copies, sets; user-annotation
    ranges left out). Busy time is the union of the activity intervals,
    so overlapping copies and kernels count once."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(runs):
            fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    per_name: dict = {}
    spans = []
    for evt in prof.events():
        if evt.device_type == DeviceType.CUDA and not evt.is_user_annotation:
            per_name[evt.name] = (per_name.get(evt.name, 0.0)
                                  + evt.device_time_total / 1e3 / runs)
            spans.append((evt.time_range.start, evt.time_range.end))
    busy_us, end = 0.0, float("-inf")
    for a, b in sorted(spans):
        if b > end:
            busy_us += b - max(a, end)
            end = b
    return wall, busy_us / 1e3 / runs, per_name


def device_ms_per_call(fn, runs: int) -> float:
    """Median over `runs` calls of each call's device-busy ms, each call
    profiled on its own."""
    return statistics.median(device_profile(fn)[1] for _ in range(runs))


def phase_environment():
    import torch
    from rltime_tpu_torch.ops import _build
    print(f"python {sys.version.split()[0]}  torch {torch.__version__}  "
          f"cuda {torch.version.cuda}  device {torch.cuda.get_device_name(0)}"
          f"  count {torch.cuda.device_count()}", flush=True)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    t0 = time.perf_counter()
    _build.load()
    print(f"kernel build+load: {time.perf_counter() - t0:.3f} s "
          f"({_build.library_path().name})", flush=True)
    return smi


def phase_kernels(smi: str):
    """union_gather vs union_gather_reference on the card."""
    import torch
    from rltime_tpu_torch.ops import gather
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(0)
    results = {}

    def compare(tag, storage, B, W=7, runs=25):
        """Bit-exact check on the first index set; timing cycles through
        `runs` fresh sets so rows come from device memory, not from the
        50 MB L2 that a repeated set would hit."""
        E, T = storage.shape[:2]
        sets = []
        for _ in range(runs):
            env = torch.randint(0, E, (B,), generator=g, device=dev,
                                dtype=torch.int32)
            col = torch.randint(0, T, (B,), generator=g, device=dev,
                                dtype=torch.int32)
            col[:6] = torch.tensor([0, 1, 2, T - 1, T - 2, T - 3],
                                   dtype=torch.int32, device=dev)
            sets.append((env, col - 3))      # F-1 = 3: col0 < 0 near 0
        env, col0 = sets[0]
        out = gather.union_gather(storage, env, col0, W)
        ref = gather.union_gather_reference(storage, env, col0, W)
        torch.cuda.synchronize()
        check(out.shape == ref.shape and out.dtype == ref.dtype,
              f"{tag}: shape/dtype {out.shape} {out.dtype}")
        err = (out.double() - ref.double()).abs().max().item()
        check(torch.equal(out, ref), f"{tag}: kernel != plain (max abs err "
              f"{err})")
        it = itertools.cycle(sets)

        def kern():
            gather.union_gather(storage, *next(it), W)

        def plain():
            gather.union_gather_reference(storage, *next(it), W)

        ev_ms, ev_plain = median_ms(kern, runs), median_ms(plain, runs)
        ms = device_ms_per_call(kern, runs)
        plain_ms = device_ms_per_call(plain, runs)
        check(ms > 0 and plain_ms > 0, f"{tag}: profiler saw no device time")
        moved = 2 * out.numel() * out.element_size()
        print(f"union_gather {tag}: bit-exact; device time per call "
              f"(profiler, median of {runs}): kernel {ms:.4f} ms "
              f"({moved / ms / 1e6:.1f} GB/s), plain {plain_ms:.4f} ms; "
              f"CUDA-event time per call incl. launch (median of {runs}): "
              f"kernel {ev_ms:.4f} ms, plain {ev_plain:.4f} ms  [{smi}]",
              flush=True)
        results[tag] = (err, ms, plain_ms)

    E, T = 64, 4096                      # config #2's obs ring: 1.85 GB
    ring = torch.randint(0, 256, (E, T, 84, 84), generator=g, device=dev,
                         dtype=torch.uint8)
    compare("B=256 W=7 84x84 u8", ring, 256)
    compare("B=1024 W=7 84x84 u8", ring, 1024)
    del ring
    compare("B=256 W=7 12x16 u8 (192 B rows)",
            torch.randint(0, 256, (8, 128, 12, 16), generator=g, device=dev,
                          dtype=torch.uint8), 256)
    compare("B=256 W=7 12x16 f32",
            torch.randn((8, 128, 12, 16), generator=g, device=dev), 256)
    compare("B=256 W=7 5x7 u8 (unaligned rows)",
            torch.randint(0, 256, (8, 128, 5, 7), generator=g, device=dev,
                          dtype=torch.uint8), 256)
    torch.cuda.empty_cache()
    return results


def phase_main_path():
    import torch
    from rltime_tpu_torch import train
    from rltime_tpu_torch.ops import gather
    from rltime_tpu_torch.training import checkpoint as ckpt_lib
    result_dir = ROOT / "results" / "chip_smoke"
    shutil.rmtree(result_dir, ignore_errors=True)
    argv = ["pong_dqn_counting", "--device", "cuda",
            "--result-dir", str(result_dir),
            f"--train.warmup_env_steps={WARMUP_STEPS}",
            f"--train.total_env_steps={MAIN_STEPS}"]
    gather.reset_counts()
    trainer = train.run(argv)
    torch.cuda.synchronize()
    launches, plain = gather.LAUNCHES, gather.PLAIN_CALLS
    phases = trainer.timers.pop()     # whole run: no log interval hit
    loop_s = sum(phases.values())

    check(trainer.device.type == "cuda", "trainer did not run on cuda")
    check(trainer.updates_done == EXPECTED_UPDATES,
          f"{trainer.updates_done} updates, expected {EXPECTED_UPDATES}")
    check(launches >= EXPECTED_UPDATES,
          f"union_gather launched {launches} times in {EXPECTED_UPDATES} "
          "updates")
    check(plain == 0, f"{plain} plain-gather calls on the CUDA path")
    m = trainer.last_metrics
    for k in ("loss", "grad_norm", "td_abs", "q"):
        check(math.isfinite(m[k].item()), f"last {k} = {m[k].item()}")
    rs = trainer.replay_state
    check(rs.t == MAIN_STEPS // 64, f"replay cursor {rs.t}")
    check(rs.storage["obs"].shape == (64, 4096, 84, 84)
          and rs.storage["obs"].is_cuda, "obs ring shape/device")
    check(bool(torch.isfinite(rs.tree).all()) and rs.tree.sum().item() > 0,
          "priorities not finite/positive")
    step = ckpt_lib.latest_step(str(result_dir))
    check(step == MAIN_STEPS
          and (result_dir / "checkpoints" / str(step) / "state.pt").is_file(),
          f"checkpoint missing (latest step {step})")
    upd_s = phases["insert+update"]
    print(f"main path: {MAIN_STEPS} env steps, {trainer.updates_done} "
          f"updates, union_gather launches {launches}, plain calls {plain}; "
          f"last loss {m['loss'].item():.6g} grad_norm "
          f"{m['grad_norm'].item():.6g}", flush=True)
    print(f"main path rates: {MAIN_STEPS / loop_s:.1f} env-steps/s over "
          f"the {loop_s:.3f} s training loop (act {phases['act']:.3f} s, "
          f"insert {phases['insert']:.3f} s, insert+update {upd_s:.3f} s); "
          f"{trainer.updates_done / upd_s:.2f} updates/s over the "
          "insert+update phase", flush=True)
    return trainer, launches


def phase_steady_state(trainer, smi: str, chunks: int = 4):
    """After the counted run: a few more chunks of the same trainer under
    the profiler, for the warm per-chunk split and the device-busy share.
    (Launches here are outside the main path's counted run.)"""
    trainer.timers.pop()
    wall, busy_ms, per_name = device_profile(trainer.train_chunk, chunks)
    phases = trainer.timers.pop()
    n_upd = chunks * trainer.loop_cfg.updates_per_chunk
    env_steps = chunks * trainer.loop_cfg.chunk_len * trainer.env.num_envs
    busy = busy_ms * chunks / 1e3 / wall      # busy_ms is per chunk
    print(f"steady state ({chunks} chunks after the run, profiled): "
          f"{env_steps / wall:.1f} env-steps/s, act "
          f"{phases['act'] / chunks * 1e3:.2f} ms/chunk, insert+update "
          f"{phases['insert+update'] / n_upd * 1e3:.2f} ms/update "
          f"({n_upd / phases['insert+update']:.1f} updates/s); device busy "
          f"{busy:.1%} of {wall:.3f} s  [{smi}]", flush=True)
    gather_ms = sum(ms for name, ms in per_name.items()
                    if "union_gather" in name)
    print(f"  union_gather kernel: {gather_ms:.4f} ms/chunk of "
          f"{busy_ms:.4f} ms/chunk device busy", flush=True)
    top = sorted(per_name.items(), key=lambda kv: -kv[1])[:10]
    for name, ms in top:
        print(f"  device {ms:9.4f} ms/chunk  {name[:110]}", flush=True)


def phase_small_parity(devices=("cpu", "cuda")):
    """One learner update on the card vs the same update on the CPU."""
    import numpy as np
    import torch
    from rltime_tpu_torch.history import replay
    from rltime_tpu_torch.models.policy import ModelConfig
    from rltime_tpu_torch.training import learner
    torch.backends.cudnn.allow_tf32 = False      # compare in full f32
    torch.backends.cuda.matmul.allow_tf32 = False
    E, T, L, F, n, B = 2, 64, 8, 4, 3, 16
    rcfg = replay.ReplayConfig(num_envs=E, steps_per_env=T, horizon=n,
                               chunk_len=L, lookback=F - 1)
    mcfg = ModelConfig(num_actions=6, torso="nature_cnn",
                       cnn_channels=(8, 8, 8), cnn_fc=32, head="dueling",
                       dueling_hidden=16)
    # adam_eps well above |grad| keeps Adam's step Lipschitz in the grad,
    # so last-ulp conv differences cannot flip an update's sign
    acfg = learner.AlgoConfig(batch_size=B, n_step=n, lr=1e-3,
                              adam_eps=1e-3, grad_clip=0.05,
                              target_update_freq=1, debug_outputs=True)
    rng = np.random.default_rng(0)
    chunks = []
    for _ in range(6):
        done = rng.random((E, L)) < 0.1
        chunks.append(dict(
            obs=rng.integers(0, 256, (E, L, 84, 84), dtype=np.uint8),
            action=rng.integers(0, 6, (E, L)).astype(np.int32),
            reward=rng.normal(size=(E, L)).astype(np.float32),
            terminated=done & (rng.random((E, L)) < 0.5), done=done))
    u = torch.from_numpy(rng.random(B).astype(np.float32))
    out = []
    for dev in map(torch.device, devices):
        rs = replay.replay_init(rcfg, {
            "obs": ((84, 84), torch.uint8), "action": ((), torch.int32),
            "reward": ((), torch.float32), "terminated": ((), torch.bool),
            "done": ((), torch.bool)}, dev)
        for c in chunks:
            replay.replay_insert(rcfg, rs, c)
        ts = learner.make_train_state(mcfg, acfg, (F, 84, 84), 0, dev)
        upd = learner.make_update_step(acfg, rcfg, F, flatten=False)
        ts, rs, m = upd(ts, rs, 0.5, u=u.to(dev))
        out.append((m, rs, ts))
    (mc, rc, tc), (mg, rg, tg) = out
    check(torch.equal(mc["debug_leaf"], mg["debug_leaf"].cpu()),
          "parity: sampled leaves differ")
    for k in ("loss", "grad_norm", "td_abs"):
        a, b = mc[k].item(), mg[k].item()
        check(math.isclose(a, b, rel_tol=1e-4), f"parity: {k} {a} vs {b}")
    check(torch.allclose(rc.tree, rg.tree.cpu(), rtol=1e-4, atol=1e-7),
          "parity: priorities differ")
    worst = max((p.detach().cpu() - q.detach()).abs().max().item()
                for p, q in zip(tg.model.parameters(),
                                tc.model.parameters()))
    check(worst <= 1e-5, f"parity: params after Adam differ by {worst}")
    print(f"small-input parity cuda vs cpu: leaves equal, loss "
          f"{mg['loss'].item():.6g} vs {mc['loss'].item():.6g}, max param "
          f"diff {worst:.3g} (f32, TF32 off)", flush=True)


def main() -> int:
    if not (ROOT / "rltime_tpu_torch" / "__init__.py").is_file():
        fail(f"no rltime_tpu_torch package beside {Path(__file__).name}")
    sys.path.insert(0, str(ROOT))
    import torch
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this smoke needs a GPU")
    smi = phase_environment()
    kern = phase_kernels(smi)
    trainer, launches = phase_main_path()
    phase_steady_state(trainer, smi)
    del trainer
    phase_small_parity()
    _, ms, plain_ms = kern["B=256 W=7 84x84 u8"]
    record = {"kernels": [{
        "name": "union_gather", "route": "cuda",
        "source": "rltime_tpu_torch/csrc/union_gather.cu",
        "replaces": "rltime_tpu/ops/pallas_gather.py:152",
        "launches": launches,
        "max_abs_err": max(err for err, _, _ in kern.values()),
        "ms": ms, "plain_ms": plain_ms}]}
    print(json.dumps(record), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
