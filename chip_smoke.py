#!/usr/bin/env python3
"""Smoke run of the PyTorch port on one NVIDIA GPU.

    python3 chip_smoke.py          # from the repository root, one card

Phases (any failure exits non-zero and prints no result line):
  1. environment: torch/CUDA versions, the card's name and power limit
     (nvidia-smi), and the build of every CUDA kernel (one nvcc per
     source, all at once) from the sources in this checkout;
  2. each kernel against its plain PyTorch version on the card at the
     main paths' shapes and a few odd ones (bit-exact), timed by
     torch.profiler (device time) and by CUDA events (including launch
     overhead), medians over fresh index sets;
  3. the config-#2 path: `rltime_tpu_torch.train.run` (what `python -m
     rltime_tpu_torch.train` runs) on `pong_dqn_counting` at full width
     for 24,576 env steps with 8,192 of warmup: 9 chunks of {insert +
     K=2 updates}, 18 learner updates at batch 256. The kernels' launch
     counters are zeroed just before and read just after: union_gather
     serves every update's frame stacks, window_gather their done window
     and the three n-step strips. Then 16 warm chunks timed by the host
     clock and a few more under torch.profiler for the warm per-chunk
     split and device-busy share;
  4. the config-#4 path: the same entry point on `atari_r2d2_counting`
     at full width (Nature CNN, LSTM 512, dueling, bf16, E=64, T=4096,
     batch 64, burn-in 40, seq 80, n=5) for 49,152 env steps with
     16,384 of warmup: 9 chunks of 64 steps, each with one R2D2 update.
     Counted as phase 3 is; window_gather serves the frame sequence and
     every strip. Then the warm windows, as in phase 3;
  5. small-input checks that one learner update of each path on the
     card agrees with the same update on the CPU (the CPU paths are held
     to the JAX package by tests/test_torch_*.py).
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
# config #2: a chunk is 64 envs x 32 steps = 2,048 env steps; chunks
# 4..12 (env steps 8,192..24,576 after their rollout) run K=2 updates
DQN_PATH = dict(preset="pong_dqn_counting", steps=24_576, warmup=8_192,
                updates=18)
# config #4: a chunk is 64 envs x 64 steps = 4,096 env steps; chunks
# 4..12 (env steps 16,384..49,152 after their rollout) run one update
R2D2_PATH = dict(preset="atari_r2d2_counting", steps=49_152, warmup=16_384,
                 updates=9)


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
    from rltime_tpu_torch.ops import _build, gather
    print(f"python {sys.version.split()[0]}  torch {torch.__version__}  "
          f"cuda {torch.version.cuda}  device {torch.cuda.get_device_name(0)}"
          f"  count {torch.cuda.device_count()}", flush=True)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    t0 = time.perf_counter()
    libs = _build.build()
    for name in gather.KERNELS:
        _build.load(name)
    check(set(libs) == set(gather.KERNELS),
          f"built {sorted(libs)}, kernels {sorted(gather.KERNELS)}")
    print(f"kernel build+load: {time.perf_counter() - t0:.3f} s "
          f"({', '.join(str(p.relative_to(ROOT)) for p in libs.values())})",
          flush=True)
    return smi


def phase_kernels(smi: str):
    """Each kernel against window_gather_reference on the card."""
    import torch
    from rltime_tpu_torch.ops import gather
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(0)
    results = {name: {} for name in gather.KERNELS}

    def index_sets(E, T, B, W, runs, lead, cross=False):
        """`runs` fresh (env, col) sets. Each starts `lead` columns
        behind the sampled one (negative near 0) and holds windows that
        cross the seam; `cross` makes every window cross it."""
        sets = []
        for _ in range(runs):
            env = torch.randint(0, E, (B,), generator=g, device=dev,
                                dtype=torch.int32)
            if cross:
                col = T - torch.randint(1, W, (B,), generator=g, device=dev,
                                        dtype=torch.int32)
            else:
                col = torch.randint(0, T, (B,), generator=g, device=dev,
                                    dtype=torch.int32)
            col[:6] = torch.tensor([0, 1, 2, T - 1, T - 2, T - W // 2],
                                   dtype=torch.int32, device=dev)
            sets.append((env, col - lead))
        return sets

    def compare(name, tag, storage, B, W, lead, runs=25, cross=False):
        """Bit-exact check on the first index set; timing cycles through
        `runs` fresh sets so rows come from device memory, not from the
        50 MB L2 that a repeated set would hit."""
        kernel = getattr(gather, name)
        E, T = storage.shape[:2]
        sets = index_sets(E, T, B, W, runs, lead, cross)
        env, col = sets[0]
        out = kernel(storage, env, col, W)
        ref = gather.window_gather_reference(storage, env, col, W)
        torch.cuda.synchronize()
        check(out.shape == ref.shape and out.dtype == ref.dtype,
              f"{name} {tag}: shape/dtype {out.shape} {out.dtype}")
        err = (out.double() - ref.double()).abs().max().item()
        check(torch.equal(out, ref), f"{name} {tag}: kernel != plain (max "
              f"abs err {err})")
        it = itertools.cycle(sets)

        def kern():
            kernel(storage, *next(it), W)

        def plain():
            gather.window_gather_reference(storage, *next(it), W)

        ev_ms, ev_plain = median_ms(kern, runs), median_ms(plain, runs)
        ms = device_ms_per_call(kern, runs)
        plain_ms = device_ms_per_call(plain, runs)
        check(ms > 0 and plain_ms > 0,
              f"{name} {tag}: profiler saw no device time")
        moved = 2 * out.numel() * out.element_size()
        print(f"{name} {tag}: bit-exact; device time per call "
              f"(profiler, median of {runs}): kernel {ms:.4f} ms "
              f"({moved / ms / 1e6:.1f} GB/s), plain {plain_ms:.4f} ms; "
              f"CUDA-event time per call incl. launch (median of {runs}): "
              f"kernel {ev_ms:.4f} ms, plain {ev_plain:.4f} ms  [{smi}]",
              flush=True)
        results[name][tag] = (err, ms, plain_ms)

    def rand(shape, dtype):
        r = torch.randint(0, 256, shape, generator=g, device=dev,
                          dtype=torch.uint8)
        return (r & 1).bool() if dtype == torch.bool else r.to(dtype)

    E, T = 64, 4096                      # both configs' obs ring: 1.85 GB
    ring = rand((E, T, 84, 84), torch.uint8)
    # K2 at config #2's union window (F + n = 7 rows from col - 3)
    compare("union_gather", "B=256 W=7 84x84 u8", ring, 256, 7, 3)
    compare("union_gather", "B=1024 W=7 84x84 u8", ring, 1024, 7, 3)
    # K1 at the R2D2 frame sequence (total + F - 1 = 128 rows from
    # col - 3), then with every window across the seam or from col < 0
    compare("window_gather", "B=64 W=128 84x84 u8", ring, 64, 128, 3)
    compare("window_gather", "B=64 W=128 84x84 u8 all across the seam",
            ring, 64, 128, 3, cross=True)
    del ring
    # K1 at every strip the two paths gather from the 64 x 4096 rings:
    # R2D2's 125 rows of 4 B (action, reward) and 1 B (terminated) from
    # col and its 128-row done window from col - 3; config #2's n = 3
    # strips (reward; done, terminated) from col and its stack done
    # window, F + n - 1 = 6 rows from col - 3
    strip_f32 = torch.randn((E, T), generator=g, device=dev)
    strip_bool = rand((E, T), torch.bool)
    compare("window_gather", "B=64 W=125 f32 (4 B rows)", strip_f32,
            64, 125, 0)
    compare("window_gather", "B=64 W=125 bool (1 B rows)", strip_bool,
            64, 125, 0)
    compare("window_gather", "B=64 W=128 bool from col-3 (R2D2 dones)",
            strip_bool, 64, 128, 3)
    compare("window_gather", "B=256 W=3 f32 (config-#2 reward)", strip_f32,
            256, 3, 0)
    compare("window_gather", "B=256 W=3 bool (config-#2 done, terminated)",
            strip_bool, 256, 3, 0)
    compare("window_gather", "B=256 W=6 bool from col-3 (config-#2 stack "
            "dones)", strip_bool, 256, 6, 3)
    del strip_f32, strip_bool
    compare("window_gather", "B=64 W=33 5x7 u8 (odd rows)",
            rand((8, 128, 5, 7), torch.uint8), 64, 33, 3)
    compare("union_gather", "B=256 W=7 12x16 f32",
            torch.randn((8, 128, 12, 16), generator=g, device=dev), 256, 7, 3)
    compare("union_gather", "B=256 W=7 5x7 u8 (unaligned rows)",
            rand((8, 128, 5, 7), torch.uint8), 256, 7, 3)
    torch.cuda.empty_cache()
    return results


def run_path(path: dict):
    """Drive one config through the CLI's entry point on the card with
    the launch counters zeroed just before and read just after; check
    what every path must show. Returns (trainer, launches, plain)."""
    import torch
    from rltime_tpu_torch import train
    from rltime_tpu_torch.ops import gather
    from rltime_tpu_torch.training import checkpoint as ckpt_lib
    result_dir = ROOT / "results" / f"chip_smoke_{path['preset']}"
    shutil.rmtree(result_dir, ignore_errors=True)
    argv = [path["preset"], "--device", "cuda",
            "--result-dir", str(result_dir),
            f"--train.warmup_env_steps={path['warmup']}",
            f"--train.total_env_steps={path['steps']}"]
    torch.cuda.reset_peak_memory_stats()
    gather.reset_counts()
    trainer = train.run(argv)
    torch.cuda.synchronize()
    launches, plain = dict(gather.LAUNCHES), dict(gather.PLAIN_CALLS)
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    phases = trainer.timers.pop()     # whole run: no log interval hit
    loop_s = sum(phases.values())

    tag = path["preset"]
    check(trainer.device.type == "cuda", f"{tag}: trainer not on cuda")
    check(trainer.updates_done == path["updates"],
          f"{tag}: {trainer.updates_done} updates, expected "
          f"{path['updates']}")
    check(not any(plain.values()), f"{tag}: plain calls on the CUDA path "
          f"{plain}")
    m = trainer.last_metrics
    for k in ("loss", "grad_norm", "td_abs", "q"):
        check(math.isfinite(m[k].item()), f"{tag}: last {k} = {m[k].item()}")
    rs = trainer.replay_state
    E = trainer.env.num_envs
    check(rs.t == path["steps"] // E, f"{tag}: replay cursor {rs.t}")
    check(rs.storage["obs"].shape == (E, 4096, 84, 84)
          and rs.storage["obs"].is_cuda, f"{tag}: obs ring shape/device")
    check(bool(torch.isfinite(rs.tree).all()) and rs.tree.sum().item() > 0,
          f"{tag}: priorities not finite/positive")
    step = ckpt_lib.latest_step(str(result_dir))
    check(step == path["steps"]
          and (result_dir / "checkpoints" / str(step) / "state.pt").is_file(),
          f"{tag}: checkpoint missing (latest step {step})")
    upd_s = phases["insert+update"]
    print(f"{tag}: {path['steps']} env steps, {trainer.updates_done} "
          f"updates, launches {launches}, plain calls {plain}; last loss "
          f"{m['loss'].item():.6g} grad_norm {m['grad_norm'].item():.6g} "
          f"td_abs {m['td_abs'].item():.6g} q {m['q'].item():.6g}",
          flush=True)
    print(f"{tag} rates: {path['steps'] / loop_s:.1f} env-steps/s over "
          f"the {loop_s:.3f} s training loop (act {phases['act']:.3f} s, "
          f"insert {phases['insert']:.3f} s, insert+update {upd_s:.3f} s); "
          f"{trainer.updates_done / upd_s:.2f} updates/s over the "
          "insert+update phase", flush=True)
    print(f"{tag} peak device memory allocated: {peak_gb:.3f} GB",
          flush=True)
    return trainer, launches


def phase_dqn_path():
    trainer, launches = run_path(DQN_PATH)
    n = DQN_PATH["updates"]
    check(launches["union_gather"] >= n,
          f"union_gather launched {launches['union_gather']} times in {n} "
          "updates")
    check(launches["window_gather"] >= 4 * n,
          f"window_gather launched {launches['window_gather']} times in "
          f"{n} updates (stack done window and reward, done and terminated "
          "strips: >= 4 each)")
    return trainer, launches


def phase_r2d2_path():
    import torch
    trainer, launches = run_path(R2D2_PATH)
    n = R2D2_PATH["updates"]
    check(launches["window_gather"] >= n,
          f"window_gather launched {launches['window_gather']} times in {n} "
          "updates")
    check(launches["union_gather"] == 0,
          f"union_gather launched {launches['union_gather']} times on the "
          "R2D2 path")
    mc = trainer.model_cfg
    check(mc.lstm_size == 512 and mc.torso == "nature_cnn"
          and mc.head == "dueling" and mc.compute_dtype == "bfloat16",
          f"not config #4's model: {mc}")
    ac = trainer.algo_cfg
    check((ac.batch_size, ac.burn_in, ac.seq_len, ac.n_step)
          == (64, 40, 80, 5), f"not config #4's algo: {ac}")
    rs = trainer.replay_state
    for name in ("rnn_c", "rnn_h"):
        ring = rs.storage[name]
        check(ring.shape == (64, 4096, 512) and ring.dtype == torch.float32
              and ring.is_cuda, f"{name} ring {ring.shape} {ring.dtype} "
              f"{ring.device}")
        check(bool(ring.abs().sum() > 0), f"{name} ring all zero")
    tree = rs.tree
    live = tree > 0
    moved = live & (tree != rs.max_priority)
    check(bool(torch.isfinite(tree).all()), "R2D2 priorities not finite")
    check(int(moved.sum()) > 0, "no R2D2 priority moved off max-priority")
    print(f"R2D2 rings: rnn_c/rnn_h (64, 4096, 512) float32 on the card; "
          f"{int(live.sum())} live leaves, {int(moved.sum())} moved off "
          f"max-priority {rs.max_priority.item():.6g}", flush=True)
    return trainer, launches


def phase_steady_state(trainer, smi: str, chunks: int, profiled: int):
    """After the counted run: `chunks` more chunks of the same trainer
    timed by the host clock (synchronised) for the warm rates and the
    per-chunk split, then `profiled` more under the profiler for the
    device-busy time and the kernels. The profiler's per-launch cost
    slows this host-bound loop, so the busy share is also given against
    the unprofiled chunk time. (Launches here are outside the main
    path's counted run.)"""
    import torch
    from rltime_tpu_torch.ops import gather
    algo = trainer.algo_cfg.algo
    n_upd = chunks * trainer.loop_cfg.updates_per_chunk
    env_steps = chunks * trainer.loop_cfg.chunk_len * trainer.env.num_envs
    trainer.timers.pop()
    t0 = time.perf_counter()
    for _ in range(chunks):
        trainer.train_chunk()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    phases = trainer.timers.pop()
    print(f"steady state {algo} ({chunks} warm chunks after the run): "
          f"{env_steps / wall:.1f} env-steps/s, act "
          f"{phases['act'] / chunks * 1e3:.2f} ms/chunk, insert+update "
          f"{phases['insert+update'] / n_upd * 1e3:.2f} ms/update "
          f"({n_upd / phases['insert+update']:.2f} updates/s)  [{smi}]",
          flush=True)
    p_wall, busy_ms, per_name = device_profile(trainer.train_chunk,
                                               profiled)
    trainer.timers.pop()
    print(f"  profiled ({profiled} more chunks): device busy "
          f"{busy_ms:.3f} ms/chunk, {busy_ms * chunks / 1e3 / wall:.1%} of "
          f"the unprofiled chunk time ({busy_ms * profiled / 1e3 / p_wall:.1%}"
          f" of the profiled {p_wall:.3f} s)", flush=True)
    for kernel in gather.KERNELS:
        ms = sum(v for name, v in per_name.items() if kernel in name)
        print(f"  {kernel} kernel: {ms:.4f} ms/chunk of {busy_ms:.4f} "
              "ms/chunk device busy", flush=True)
    top = sorted(per_name.items(), key=lambda kv: -kv[1])[:10]
    for name, ms in top:
        print(f"  device {ms:9.4f} ms/chunk  {name[:110]}", flush=True)


def _chunks(rng, E, L, obs_shape, num_actions, lstm_size=0, n=6):
    import numpy as np
    out = []
    for _ in range(n):
        done = rng.random((E, L)) < 0.1
        c = dict(obs=rng.integers(0, 256, (E, L) + obs_shape, dtype=np.uint8),
                 action=rng.integers(0, num_actions, (E, L)).astype(np.int32),
                 reward=rng.normal(size=(E, L)).astype(np.float32),
                 terminated=done & (rng.random((E, L)) < 0.5), done=done)
        if lstm_size:
            for k in ("rnn_c", "rnn_h"):
                c[k] = (rng.normal(size=(E, L, lstm_size)) * 0.1).astype(
                    np.float32)
        out.append(c)
    return out


def _fields(obs_shape, lstm_size=0):
    import torch
    f = {"obs": (obs_shape, torch.uint8), "action": ((), torch.int32),
         "reward": ((), torch.float32), "terminated": ((), torch.bool),
         "done": ((), torch.bool)}
    if lstm_size:
        f["rnn_c"] = f["rnn_h"] = ((lstm_size,), torch.float32)
    return f


def _compare_updates(tag, out, tol):
    """out: [(metrics, replay, train state)] from the cpu and the cuda
    run of the same update. Returns the largest param difference."""
    import torch
    (mc, rc, tc), (mg, rg, tg) = out
    check(torch.equal(mc["debug_leaf"], mg["debug_leaf"].cpu()),
          f"{tag} parity: sampled leaves differ")
    for k in ("loss", "grad_norm", "td_abs"):
        a, b = mc[k].item(), mg[k].item()
        check(math.isclose(a, b, rel_tol=tol), f"{tag} parity: {k} {a} vs "
              f"{b}")
    check(torch.allclose(mc["debug_td"], mg["debug_td"].cpu(), rtol=tol,
                         atol=1e-6), f"{tag} parity: per-sample td differs")
    check(torch.allclose(rc.tree, rg.tree.cpu(), rtol=tol, atol=1e-7),
          f"{tag} parity: priorities differ")
    worst = max((p.detach().cpu() - q.detach()).abs().max().item()
                for p, q in zip(tg.model.parameters(),
                                tc.model.parameters()))
    check(worst <= 1e-5, f"{tag} parity: params after Adam differ by "
          f"{worst}")
    print(f"small-input {tag} parity cuda vs cpu: leaves equal, loss "
          f"{mg['loss'].item():.6g} vs {mc['loss'].item():.6g}, max param "
          f"diff {worst:.3g} (f32, TF32 off)", flush=True)


def phase_small_parity(devices=("cpu", "cuda")):
    """One update of each path on the card vs the same update on the
    CPU, in float32 with TF32 off."""
    import numpy as np
    import torch
    from rltime_tpu_torch.history import replay
    from rltime_tpu_torch.models.policy import ModelConfig
    from rltime_tpu_torch.training import learner, r2d2
    torch.backends.cudnn.allow_tf32 = False      # compare in full f32
    torch.backends.cuda.matmul.allow_tf32 = False
    E, T, L, F, B = 2, 64, 8, 4, 16
    cnn = dict(num_actions=6, torso="nature_cnn", cnn_channels=(8, 8, 8),
               cnn_fc=32, head="dueling", dueling_hidden=16,
               compute_dtype="float32")
    # adam_eps well above |grad| keeps Adam's step Lipschitz in the grad,
    # so last-ulp conv differences cannot flip an update's sign
    cases = [
        ("dqn", ModelConfig(**cnn),
         learner.AlgoConfig(batch_size=B, n_step=3, lr=1e-3, adam_eps=1e-3,
                            grad_clip=0.05, target_update_freq=1,
                            debug_outputs=True)),
        ("r2d2", ModelConfig(lstm_size=16, **cnn),
         learner.AlgoConfig(algo="r2d2", batch_size=8, n_step=2, burn_in=4,
                            seq_len=8, gamma=0.997, lr=1e-3, adam_eps=1e-3,
                            grad_clip=0.05, target_update_freq=1,
                            debug_outputs=True)),
    ]
    for tag, mcfg, acfg in cases:
        rec = acfg.algo == "r2d2"
        horizon = r2d2.r2d2_horizon(acfg) if rec else acfg.n_step
        rcfg = replay.ReplayConfig(num_envs=E, steps_per_env=T,
                                   horizon=horizon, chunk_len=L,
                                   lookback=F - 1)
        rng = np.random.default_rng(0)
        chunks = _chunks(rng, E, L, (84, 84), 6, mcfg.lstm_size)
        u = torch.from_numpy(rng.random(acfg.batch_size).astype(np.float32))
        out = []
        for dev in map(torch.device, devices):
            rs = replay.replay_init(rcfg, _fields((84, 84), mcfg.lstm_size),
                                    dev)
            for c in chunks:
                replay.replay_insert(rcfg, rs, c)
            ts = learner.make_train_state(mcfg, acfg, (F, 84, 84), 0, dev)
            upd = (r2d2.make_r2d2_update_step(mcfg, acfg, rcfg, F, False)
                   if rec else learner.make_update_step(acfg, rcfg, F, False))
            ts, rs, m = upd(ts, rs, 0.5, u=u.to(dev))
            out.append((m, rs, ts))
        _compare_updates(tag, out, 1e-4)


def main() -> int:
    if not (ROOT / "rltime_tpu_torch" / "__init__.py").is_file():
        fail(f"no rltime_tpu_torch package beside {Path(__file__).name}")
    sys.path.insert(0, str(ROOT))
    import torch
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this smoke needs a GPU")
    smi = phase_environment()
    kern = phase_kernels(smi)
    trainer, dqn_launches = phase_dqn_path()
    phase_steady_state(trainer, smi, chunks=16, profiled=4)
    del trainer
    torch.cuda.empty_cache()
    trainer, r2d2_launches = phase_r2d2_path()
    phase_steady_state(trainer, smi, chunks=16, profiled=3)
    del trainer
    torch.cuda.empty_cache()
    phase_small_parity()

    def entry(name, source, replaces, launches, main_tag):
        _, ms, plain_ms = kern[name][main_tag]
        return {"name": name, "route": "cuda", "source": source,
                "replaces": replaces, "launches": launches,
                "max_abs_err": max(err for err, _, _ in kern[name].values()),
                "ms": ms, "plain_ms": plain_ms}

    record = {"kernels": [
        entry("union_gather", "rltime_tpu_torch/csrc/union_gather.cu",
              "rltime_tpu/ops/pallas_gather.py:152",
              dqn_launches["union_gather"], "B=256 W=7 84x84 u8"),
        entry("window_gather", "rltime_tpu_torch/csrc/window_gather.cu",
              "rltime_tpu/ops/pallas_gather.py:50",
              r2d2_launches["window_gather"], "B=64 W=128 84x84 u8"),
    ]}
    print(json.dumps(record), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
