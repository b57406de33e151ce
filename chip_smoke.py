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
     overhead), medians over fresh index sets: the raw union and window
     gathers beside one `index_select`, the fused frame-stack gather
     beside the composition it replaced, and the multi-field window
     gather at each path's segment set beside one launch per segment;
  3. the config-#2 path: `rltime_tpu_torch.train.run` (what `python -m
     rltime_tpu_torch.train` runs) on `pong_dqn_counting` at full width
     for 24,576 env steps with 8,192 of warmup: 9 chunks of {insert +
     K=2 updates}, 18 learner updates at batch 256. The kernels' launch
     counters are zeroed just before and read just after: one
     union_gather launch serves every update's two frame stacks, one
     window_gather launch its three n-step strips and the action. Then
     8 warm chunks timed by the host
     clock and a few more under torch.profiler for the warm per-chunk
     split and device-busy share;
  4. the config-#4 path: the same entry point on `atari_r2d2_counting`
     at full width (Nature CNN, LSTM 512, dueling, bf16, E=64, T=4096,
     batch 64, burn-in 40, seq 80, n=5) for 49,152 env steps with
     16,384 of warmup: 9 chunks of 64 steps, each with one R2D2 update.
     Counted as phase 3 is; one window_gather launch per update serves
     the frame sequence, every strip and the stored carry. Then the
     warm windows, as in phase 3;
  5. the fused on-device path: the same entry point on
     `minatar_breakout_dqn` at full width (E=256, T=512, MinAtar CNN,
     dueling, batch 256, n=3, L=32, 64 updates per chunk, S=4) for
     81,920 env steps: 2 warm chunks, then 2 dispatches of 4 supersteps,
     512 learner updates, the first two supersteps op by op, the third
     capturing one superstep into a CUDA graph and every later one a
     replay of it. Counted as phase 3 is, through the graph: the Python
     wrappers ran in the two eager supersteps and the capture only, and
     the graph holds one window_gather kernel node per update (64;
     counted from its Graphviz dump), so the run launched 2 x 64 + 64 x
     replays = one per update; it serves the three n-step strips, the
     action and the two frame_stack=1 observations. The device cursor and
     counter agree with the host's. The checkpoint is read back into a
     second trainer. Then one dispatch (4 replays) under
     torch.cuda.set_sync_debug_mode("error") (a host sync fails the
     run), 3 more timed by the host clock beside the same trainer op by
     op (`capture=False`), the act + insert program alone, and one
     replayed superstep under torch.profiler for the device-busy share;
  6. the same trainer at bench.py's fused shape (L=128, 256 updates per
     chunk, S=1, warmup 0) through `bench.bench_minatar_fused`: captured
     (5 windows of 2 replayed dispatches, a profiled replay) and op by
     op, env-steps/s and the device-busy share;
  7. the first full-width dispatches of `minatar_breakout_iqn`,
     `minatar_breakout_r2d2` (one window_gather node per update, 8 in
     its graph: the frame sequence, its done window, three strips, the
     carry) and `minatar_seaquest_dqn`, through the same entry point,
     captured and counted as phase 5 is;
 15. (run right after phase 7) the graph against the eager body under
     cudnn.deterministic, at the full width of `minatar_breakout_dqn`
     (chunked), `minatar_breakout_iqn` with actor-side priorities,
     `minatar_breakout_r2d2` and `minatar_breakout_dqn` interleaved:
     after the capture, one replayed superstep against the eager body
     run from clones of the same states on the same epsilons and beta:
     parameters, target, optimizer moments and steps, counter, rings,
     tree, max_priority, cursor, the actor's env state, carry and stat
     rings, the learner's, envs' and actor's generator states and the
     metrics, max abs difference 0;
  8. small-input checks that one learner update of each path and of
     each option (RMSProp, the sum tree, uniform replay, Q(lambda),
     NHWC + space-to-depth), one fused superstep on injected draws
     (chunked, and interleaved with actor-side priorities), the sum
     tree's `set_priorities` and `sample` on dyadic priorities (bit-equal)
     and every device env's dynamics agree on the card and on the CPU
     (the CPU paths are held to the JAX package by tests/test_torch_*.py);
  9. the options of the config-#2 path at full width, counted as phase 3
     is: `pong_dqn_counting` with NHWC stacks, the space-to-depth conv_0,
     centered RMSProp, the sum-tree sampler, actor-side initial
     priorities and a transcript (one union_gather and one window_gather
     launch per update, a `transcript.jsonl` record per chunk), then a
     few warm chunks timed; and the same preset with `algo.use_lambda`
     (Q(lambda): the n+1 frame stacks ride in the one window_gather
     launch, no union_gather);
 10. config #1: `cartpole_dqn` (host CartPole, uniform replay) and
     `cartpole_dqn_device` as written, cut to a few thousand steps, then
     `rltime_tpu_torch.eval.evaluate` on each result directory, latest
     and `--best`;
 11. the fused trainer with `train.interleave_updates` and actor-side
     priorities on `minatar_breakout_dqn`, and `minatar_breakout_iqn`
     with priorities on the sum tree, each captured (its graph counted
     as phase 5's): a replayed superstep of each under
     set_sync_debug_mode("error"), then timed replays of the first;
 12. distribution, on a one-rank NCCL group: both kernels held bit-exact
     against their plain versions at the shapes the config-#5 update
     gives them (one rank's 32 x 4096 ring of 84x84 uint8: K2's stacks at
     B=64, F=4, n=3; K1's 4-segment launch at B=64; these run right after
     phase 2, where torch.profiler times them reliably), then config #5
     (`apex_multihost_counting`, `train.trainer=apex`) through the same
     entry point at full width (Nature CNN, dueling, bf16, 32 lanes x
     4,096 columns of 84x84 uint8, batch 64, n=3, F=4) for 16 updates,
     counted as phase 3 is (one union_gather and one window_gather
     launch per update) and by the census of collectives (one gradient
     all-reduce of the parameters per update, one metrics buffer and the
     max_priority MAXes, nothing else); the same updates through the
     identity mesh, bit-equal, and warm windows of both meshes in turns
     (ABBA) with each one's device-busy time per chunk; the
     `minatar_breakout_dqn` fused trainer through the NCCL mesh,
     captured with its all-reduces: a replayed superstep under
     set_sync_debug_mode("error"), its collectives counted by the census
     (64 gradient all-reduces), bit-equal to the same replay without a
     mesh; `pong_dqn_counting` with `train.async_acting` beside the
     synchronous trainer; and `python -m rltime_tpu_torch.train_distributed`
     on one rank in a subprocess;
 14. (run right after phase 7) the captured route's capturable Adam
     against the eager paths' host-scalar Adam over 5 steps; the bench's
     learner superstep
     (`rltime_tpu_torch/utils/benchprog.py`, what `python -m
     rltime_tpu_torch.bench` times) at its full shapes: E=64 x T=1024 ring
     of 84x84 uint8 (0.46 GB), S=64 x (insert + K=1 update) per dispatch,
     batch 1024, Nature CNN bf16, captured into one CUDA graph (a 0.93
     GB static chunk buffer). Under cudnn.deterministic: 64 union_gather
     and 64 window_gather kernel nodes counted inside the graph (its
     Graphviz dump), no plain call; one replay equal to the eager body
     from a cloned state (tree, sampled leaves, cursor, counter, rings,
     metrics, params); a replay under set_sync_debug_mode("error"). Then
     `bench.bench_learner()` (default cuDNN): captured and eager
     transitions/s over 5 windows, ms per update, MFU, the device-busy
     share of a profiled replay; then the IQN (batch 1024, S=8) and R2D2
     (batch 64, S=4) legs: two eager dispatches, the capture, one replay,
     their kernel nodes counted;
 13. (run right after phase 4) the host Atari engine: the C++ lane
     pool's backend (synthetic where the library was built without ALE
     headers) and its own rate on 64 lanes, then configs #2, #4 and #5
     as written over `--env.type=atari_native` through the same entry
     point at full width, counted as phase 3 is: `pong_dqn` for 18
     updates (one union_gather and one window_gather launch per update,
     the true game scores in scalars.jsonl, the warm windows of phase 3,
     then 3 warm chunks under `utils/profiling.trace`, read back for the
     per-phase split and the device-busy share), `atari_r2d2` for 4
     updates (one window_gather each) and `apex_multihost` with
     `train.trainer=apex` for 8 updates (one of each kernel per update);
     then `rltime_tpu_torch.dryrun.entry()` on the card against the CPU
     and `dryrun_multichip(1)` on a one-rank NCCL group.
Phase 2 also times the NHWC layout change that follows the union gather
and the sum tree beside the dense tree at config #2's size, and holds
the fused frame-stack gather at F + n = 35, 33 and 65 rows (several
done-flag ballots per window).
The line before the last is the kernels' JSON record; the last line is
{"ok": true, "device": {...}}.
"""
from __future__ import annotations

import copy
import itertools
import json
import math
import os
import shutil
import statistics
import subprocess
import sys
import time
import types
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
# the fused presets: a chunk is 256 envs x L steps. Breakout DQN/IQN and
# Seaquest (L=32, warmup 20,000): chunks 1-2 warm, then dispatches of
# S=4 supersteps x 64 updates. Breakout R2D2 (L=16, warmup 40,000):
# chunks 1-9 warm, then dispatches of S=8 supersteps x 8 updates.
# `k1` = window_gather launches per update.
# config #2 with every option of the path: with actor-side priorities the
# actor runs one step ahead of what it has emitted, so after chunk k it
# has taken (32 k + 1) x 64 env steps: chunks 4..8 run K=2 updates
DQN_OPTIONS_PATH = dict(
    preset="pong_dqn_counting", tag="pong_dqn_counting+options",
    steps=16_384, warmup=8_192, updates=10, ckpt_step=16_448,
    overrides=["--model.channels_last=true", "--model.space_to_depth=true",
               "--algo.optimizer=rmsprop", "--replay.sampler=tree",
               "--replay.use_inserted_priorities=true",
               "--train.record_transcript=true"])
# ... and with FF Q(lambda): chunks 4..6 run K=2 updates
DQN_LAMBDA_PATH = dict(
    preset="pong_dqn_counting", tag="pong_dqn_counting+use_lambda",
    steps=12_288, warmup=8_192, updates=6,
    overrides=["--algo.use_lambda=true"])
FUSED_PATH = dict(preset="minatar_breakout_dqn", steps=81_920, updates=512,
                  k1=1)
FUSED_OTHERS = (
    dict(preset="minatar_breakout_iqn", steps=49_152, updates=256, k1=1),
    dict(preset="minatar_breakout_r2d2", steps=69_632, updates=64, k1=1),
    dict(preset="minatar_seaquest_dqn", steps=49_152, updates=256, k1=1),
)
# phase 13, the host Atari engine: configs #2, #4 and #5 as written on the
# C++ lane pool's `atari_native` lanes (synthetic where the library was
# built without ALE headers). Config #2 logs every 8,192 steps so that the
# games' true scores reach scalars.jsonl; config #4 (64 x 64-step chunks,
# warmup 16,384) runs chunks 4..7 with one update each; config #5 (32 x
# 32-step chunks, K=2, warmup 5,120) chunks 5..8
NATIVE_DQN_PATH = dict(
    preset="pong_dqn", tag="pong_dqn+atari_native", steps=24_576,
    warmup=8_192, updates=18,
    overrides=["--env.type=atari_native", "--train.log_interval=8192"])
NATIVE_R2D2_PATH = dict(
    preset="atari_r2d2", tag="atari_r2d2+atari_native", steps=28_672,
    warmup=16_384, updates=4, overrides=["--env.type=atari_native"])
NATIVE_APEX_PATH = dict(
    preset="apex_multihost", tag="apex_multihost+atari_native", steps=8_192,
    warmup=5_120, updates=8,
    overrides=["--env.type=atari_native", "--train.trainer=apex",
               "--train.log_interval=4096"])
# the shapes whose numbers head the kernels' record: what the config-#2
# update asks of K2 and what the config-#4 update asks of K1
K2_MAIN_TAG = "stacks B=256 F=4 n=3 84x84 u8"
K1_MAIN_TAG = "multi B=64 config-#4 update (7 segments, 84x84 u8 frames)"
# no single PyTorch call computes either of those, so the record also
# heads each kernel's raw one-field entry at the same frames, which one
# `index_select` does compute
K2_RAW_TAG = "B=256 W=7 84x84 u8"
K1_RAW_TAG = "B=64 W=128 84x84 u8"
HBM_BYTES_PER_S = 3.35e12       # H100 SXM data sheet


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


def kernel_checks(results: dict, g, smi: str):
    """The kernel comparisons, for any phase: each holds a kernel entry
    point bit-exact against its plain version on the card at one shape,
    times both (and what the entry point stands beside), and files the
    numbers under results[kernel][tag]. `g` (a CUDA generator) draws the
    inputs."""
    import torch
    from rltime_tpu_torch.ops import gather
    dev = torch.device("cuda")

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

        # the nearest single library call: one index_select over the
        # ring flattened to rows, its row numbers built beforehand
        flat = storage.view(E * T, -1)
        offs = torch.arange(W, device=dev)
        rowsets = [(e.long()[:, None] * T + torch.remainder(
            c.long()[:, None] + offs, T)).reshape(-1) for e, c in sets]
        check(torch.equal(flat.index_select(0, rowsets[0]).view_as(ref),
                          ref), f"{name} {tag}: index_select != plain")
        it_rows = itertools.cycle(rowsets)

        def lib():
            flat.index_select(0, next(it_rows))

        ev_ms, ev_plain = median_ms(kern, runs), median_ms(plain, runs)
        ms = device_ms_per_call(kern, runs)
        plain_ms = device_ms_per_call(plain, runs)
        lib_ms = device_ms_per_call(lib, min(runs, 9))
        check(ms > 0 and plain_ms > 0 and lib_ms > 0,
              f"{name} {tag}: profiler saw no device time")
        # least bytes: every output row read once and written once, and
        # the two int32 index vectors read
        moved = 2 * out.numel() * out.element_size() + 2 * 4 * B
        bound_ms = moved / HBM_BYTES_PER_S * 1e3
        report(name, tag, runs, ms, plain_ms, bound_ms, moved, ev_ms,
               ev_plain, f"index_select {lib_ms:.4f} ms")
        results[name][tag] = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms,
                                  library_ms=lib_ms, bound_ms=bound_ms)

    def report(name, tag, runs, ms, plain_ms, bound_ms, moved, ev_ms,
               ev_plain, beside):
        print(f"{name} {tag}: bit-exact; device time per call (profiler, "
              f"median of {runs}): kernel {ms:.4f} ms "
              f"({moved / ms / 1e6:.1f} GB/s), plain {plain_ms:.4f} ms, "
              f"{beside}; bound {bound_ms:.5f} ms ({moved} bytes at 3.35 "
              f"TB/s): {bound_ms / ms:.1%} reached; CUDA-event time per call "
              f"incl. launch (median of {runs}): kernel {ev_ms:.4f} ms, "
              f"plain {ev_plain:.4f} ms  [{smi}]", flush=True)

    def compare_stacks(tag, storage, done, B, F, n, every_cut=True, runs=15):
        """The fused frame-stack gather (K2's entry point on the config-#2
        path) against its plain version, bit-exact on the first index
        set, which holds col < F-1 and windows across the seam; timed
        beside the composition it replaced (one index_select
        for the union rows, one for their done flags, the validity
        chain, two multiplies). `every_cut`: the done ring is dense
        enough to cut, and to keep, every slot of both stacks."""
        name = "union_gather"
        E, T = storage.shape[:2]
        W = F + n
        sets = index_sets(E, T, B, W, runs, 0)
        env, col = sets[0]
        ref_t, ref_tn = gather.union_stack_gather_reference(
            storage, done, env, col, F, n)
        row_bytes = math.prod(storage.shape[2:]) * storage.element_size()
        err = 0.0
        out = gather.union_stack_gather(storage, done, env, col, F, n)
        torch.cuda.synchronize()
        for o, r in zip(out, (ref_t, ref_tn)):
            check(o.shape == r.shape and o.dtype == r.dtype,
                  f"{name} {tag}: shape/dtype {o.shape} {o.dtype}")
            err = max(err, (o.double() - r.double()).abs().max().item())
            check(torch.equal(o, r), f"{name} {tag}: kernel != plain "
                  f"(max abs err {err})")
        for r in (ref_t, ref_tn) if every_cut else ():
            cut = (r.flatten(2) == 0).all(2)[:, :F - 1]
            check(bool(cut.any(0).all()) and not bool(cut.all(0).any()),
                  f"{name} {tag}: a stack slot was never cut or never kept")
        # a call is one kernel and no other device work (5 calls in one
        # trace: the profiler now and then loses a lone short kernel)
        _, _, per_name = device_profile(
            lambda: gather.union_stack_gather(storage, done, env, col, F, n),
            runs=5)
        check(len(per_name) == 1 and "union_gather_kernel" in next(
            iter(per_name)), f"{name} {tag}: device work {sorted(per_name)}")

        it, it_plain = itertools.cycle(sets), itertools.cycle(sets)

        def kern():
            gather.union_stack_gather(storage, done, *next(it), F, n)

        def plain():
            gather.union_stack_gather_reference(storage, done,
                                                *next(it_plain), F, n)

        flat, dflat = storage.view(E * T, -1), done.view(E * T)
        offs = torch.arange(W, device=dev)
        rowsets = [(e.long()[:, None] * T + torch.remainder(
            c.long()[:, None] - (F - 1) + offs, T)) for e, c in sets]
        it_rows = itertools.cycle(rowsets)
        shape0 = (B, F) + (1,) * (storage.ndim - 2)

        def composition():
            rows_at = next(it_rows)
            rows = flat.index_select(0, rows_at.reshape(-1)).view(
                (B, W) + tuple(storage.shape[2:]))
            dones = dflat.index_select(0, rows_at[:, :-1].reshape(-1)).view(
                B, W - 1)
            v_t = gather.stack_validity(dones[:, :F - 1], rows.dtype)
            v_tn = gather.stack_validity(dones[:, n:n + F - 1], rows.dtype)
            return (rows[:, :F] * v_t.reshape(shape0),
                    rows[:, n:n + F] * v_tn.reshape(shape0))

        for o, r in zip(composition(), (ref_t, ref_tn)):
            check(torch.equal(o, r), f"{name} {tag}: composition != plain")
        it_rows = itertools.cycle(rowsets)
        ev_ms, ev_plain = median_ms(kern, runs), median_ms(plain, runs)
        ev_comp = median_ms(composition, runs)
        ms = device_ms_per_call(kern, runs)
        plain_ms = device_ms_per_call(plain, min(runs, 9))
        comp_ms = device_ms_per_call(composition, min(runs, 9))
        check(min(ms, plain_ms, comp_ms) > 0,
              f"{name} {tag}: profiler saw no device time")
        # least bytes, from these index sets' own done flags: each union
        # row that some stack keeps read once, every stack row written
        # once (zeros too), the window's done flags and the two int32
        # index vectors read
        kept = 0
        for e, c in sets:
            dn = gather.window_gather_reference(done, e, c - (F - 1), W - 1)
            need = torch.zeros((B, W), dtype=torch.bool, device=dev)
            need[:, :F] |= gather.stack_validity(dn[:, :F - 1], torch.bool)
            need[:, n:] |= gather.stack_validity(dn[:, n:n + F - 1],
                                                 torch.bool)
            kept += int(need.sum())
        moved = round(kept / len(sets) * row_bytes + 2 * B * F * row_bytes
                      + B * (W - 1) + 2 * 4 * B)
        bound_ms = moved / HBM_BYTES_PER_S * 1e3
        report(name, tag, runs, ms, plain_ms, bound_ms, moved, ev_ms,
               ev_plain, f"the composition it replaced "
               f"{comp_ms:.4f} ms ({ev_comp:.4f} ms by CUDA events incl. its "
               f"launches); {kept / len(sets) / (B * W):.1%} of the union "
               "rows kept")
        results[name][tag] = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms,
                                  library_ms=None, bound_ms=bound_ms,
                                  composition_ms=comp_ms)

    def compare_multi(tag, segments, B, runs=15):
        """One multi-field launch (K1's entry point on every path) at a
        path's real segment set, [(field, lead, window)], bit-exact per
        segment; timed beside one single-field launch per segment."""
        name = "window_gather"
        storages, leads, windows = (list(x) for x in zip(*segments))
        E, T = storages[0].shape[:2]
        sets = index_sets(E, T, B, max(windows), runs, 0)
        env, col = sets[0]
        before = gather.LAUNCHES[name]
        outs = gather.window_gather_multi(storages, env, col, leads, windows)
        torch.cuda.synchronize()
        check(gather.LAUNCHES[name] == before + 1,
              f"{name} {tag}: {gather.LAUNCHES[name] - before} launches")
        err = 0.0
        for out, st, lead, window in zip(outs, storages, leads, windows):
            ref = gather.window_gather_reference(st, env, col - lead, window)
            check(out.shape == ref.shape and out.dtype == ref.dtype,
                  f"{name} {tag}: shape/dtype {out.shape} {out.dtype}")
            err = max(err, (out.double() - ref.double()).abs().max().item())
            check(torch.equal(out, ref), f"{name} {tag}: segment "
                  f"{tuple(st.shape)} lead {lead} window {window} != plain")
        # the separate launches get their shifted columns ready-made
        shifted = [(e, [c - lead for lead in leads]) for e, c in sets]
        it, it_sep, it_plain = (itertools.cycle(sets),
                                itertools.cycle(shifted),
                                itertools.cycle(shifted))

        def kern():
            gather.window_gather_multi(storages, *next(it), leads, windows)

        def separate():
            e, cols = next(it_sep)
            for st, c, window in zip(storages, cols, windows):
                gather.window_gather(st, e, c, window)

        def plain():
            e, cols = next(it_plain)
            for st, c, window in zip(storages, cols, windows):
                gather.window_gather_reference(st, e, c, window)

        ev_ms, ev_sep = median_ms(kern, runs), median_ms(separate, runs)
        ev_plain = median_ms(plain, runs)
        ms = device_ms_per_call(kern, runs)
        sep_ms = device_ms_per_call(separate, runs)
        plain_ms = device_ms_per_call(plain, min(runs, 9))
        check(min(ms, sep_ms, plain_ms) > 0,
              f"{name} {tag}: profiler saw no device time")
        moved = sum(2 * o.numel() * o.element_size() for o in outs) + 2 * 4 * B
        bound_ms = moved / HBM_BYTES_PER_S * 1e3
        report(name, tag, runs, ms, plain_ms, bound_ms, moved, ev_ms,
               ev_plain, f"one launch per segment {sep_ms:.4f} ms "
               f"({ev_sep:.4f} ms by CUDA events incl. the "
               f"{len(segments)} launches)")
        results[name][tag] = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms,
                                  library_ms=None, bound_ms=bound_ms,
                                  separate_ms=sep_ms)

    def rand(shape, dtype):
        r = torch.randint(0, 256, shape, generator=g, device=dev,
                          dtype=torch.uint8)
        return (r & 1).bool() if dtype == torch.bool else r.to(dtype)

    def rand_done(E, T, rate):
        return torch.rand((E, T), generator=g, device=dev) < rate

    return types.SimpleNamespace(
        compare=compare, compare_stacks=compare_stacks,
        compare_multi=compare_multi, rand=rand, rand_done=rand_done, g=g)


def phase_kernels(smi: str):
    """Each kernel's entry points against their plain versions on the
    card."""
    import torch
    from rltime_tpu_torch.ops import gather
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(0)
    results = {name: {} for name in gather.KERNELS}
    k = kernel_checks(results, g, smi)
    compare, compare_stacks, compare_multi = (k.compare, k.compare_stacks,
                                              k.compare_multi)
    rand, rand_done = k.rand, k.rand_done

    E, T = 64, 4096                      # both configs' obs ring: 1.85 GB
    ring = rand((E, T, 84, 84), torch.uint8)
    # K2 at config #2's union window (F + n = 7 rows from col - 3)
    compare("union_gather", K2_RAW_TAG, ring, 256, 7, 3)
    compare("union_gather", "B=1024 W=7 84x84 u8", ring, 1024, 7, 3)
    # K1 at the R2D2 frame sequence (total + F - 1 = 128 rows from
    # col - 3), then with every window across the seam or from col < 0
    compare("window_gather", K1_RAW_TAG, ring, 64, 128, 3)
    compare("window_gather", "B=64 W=128 84x84 u8 all across the seam",
            ring, 64, 128, 3, cross=True)
    # K2's fused entry point at config #2 (F=4, n=3): first with episode
    # ends as rare as a game's (the shape the update launches it with),
    # then at a done rate that cuts every slot of both stacks
    compare_stacks(K2_MAIN_TAG, ring, rand_done(E, T, 0.004), 256, 4, 3,
                   every_cut=False)
    dense = rand_done(E, T, 0.25)
    compare_stacks("stacks B=256 F=4 n=3 84x84 u8, done rate 0.25", ring,
                   dense, 256, 4, 3)
    compare_stacks("stacks B=1024 F=4 n=3 84x84 u8, done rate 0.25", ring,
                   dense, 1024, 4, 3)
    # windows of F + n > 32 rows: the done flags take one ballot per 32
    # (at this done rate an old slot of a long stack is all but never kept)
    for F, n in ((30, 5), (4, 29), (2, 63)):
        compare_stacks(f"stacks B=256 F={F} n={n} 84x84 u8, done rate 0.25",
                       ring, dense, 256, F, n, every_cut=False)
    # K1's multi-field launch at the config-#4 update's segment set:
    # frames from col - 3, dones from col - 3, three 125-row strips and
    # the stored LSTM carry (two (64, 4096, 512) f32 rings, 0.54 GB each)
    fields = {"done": dense, "action": rand((E, T), torch.int32),
              "reward": torch.randn((E, T), generator=g, device=dev),
              "terminated": rand((E, T), torch.bool)}
    carry = [torch.randn((E, T, 512), generator=g, device=dev)
             for _ in range(2)]
    compare_multi(K1_MAIN_TAG,
                  [(ring, 3, 128), (fields["done"], 3, 128),
                   (fields["action"], 0, 125), (fields["reward"], 0, 125),
                   (fields["terminated"], 0, 125), (carry[0], 0, 1),
                   (carry[1], 0, 1)], 64)
    del carry
    # ... and at the config-#2 update's: three n = 3 strips and the action
    compare_multi("multi B=256 config-#2 update (4 segments)",
                  [(fields["reward"], 0, 3), (fields["done"], 0, 3),
                   (fields["terminated"], 0, 3), (fields["action"], 0, 1)],
                  256)
    # ... and at the bench superstep's (utils/benchprog.py, phase 14): the
    # same four strips at batch 1024
    compare_multi("multi B=1024 bench update (4 segments)",
                  [(fields["reward"], 0, 3), (fields["done"], 0, 3),
                   (fields["terminated"], 0, 3), (fields["action"], 0, 1)],
                  1024)
    # ... and at the config-#2 Q(lambda) update's: the F + n = 7 frames
    # and 7 dones from col - 3 that serve the n + 1 stacks, the three
    # n = 3 strips and the action
    compare_multi("multi B=256 config-#2 Q(lambda) update (6 segments)",
                  [(ring, 3, 7), (fields["done"], 3, 7),
                   (fields["reward"], 0, 3), (fields["done"], 0, 3),
                   (fields["terminated"], 0, 3), (fields["action"], 0, 1)],
                  256)
    del ring, fields, dense
    # ... and at the config-#1 update's (uniform replay, frame_stack 1,
    # n = 1) on its 32 x 2048 ring of 4-float observations: three one-row
    # strips, the action, the observations at col and col + 1
    E1, T1 = 32, 2048
    state = torch.randn((E1, T1, 4), generator=g, device=dev)
    fields = {"done": rand_done(E1, T1, 0.02),
              "action": rand((E1, T1), torch.int32),
              "reward": torch.randn((E1, T1), generator=g, device=dev),
              "terminated": rand((E1, T1), torch.bool)}
    compare_multi("multi B=128 config-#1 update (6 segments, 16 B rows)",
                  [(fields["reward"], 0, 1), (fields["done"], 0, 1),
                   (fields["terminated"], 0, 1), (fields["action"], 0, 1),
                   (state, 0, 1), (state, -1, 1)], 128)
    del state, fields
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
    # K1 at the fused MinAtar paths' shapes, 256 x 512 rings: the R2D2
    # preset's frame sequence (burn_in + seq_len + n = 65 rows of
    # 10x10x4 u8 = 400 B from col), its 66-row done window from col - 1
    # and its 65-row strips; the FF/IQN presets' n = 3 strips
    E2, T2 = 256, 512
    planes = rand((E2, T2, 10, 10, 4), torch.uint8)
    compare("window_gather", "B=64 W=65 10x10x4 u8 (fused R2D2 frames)",
            planes, 64, 65, 0, runs=15)
    compare("window_gather", "B=64 W=65 10x10x4 u8 all across the seam",
            planes, 64, 65, 0, runs=15, cross=True)
    # K1's multi-field launch at the fused updates' segment sets: FF/IQN
    # (three n = 3 strips, the action, the observations at col and
    # col + 3) and R2D2 (65 frames, 66 dones from col - 1, three 65-row
    # strips, the (256, 512, 128) f32 carry)
    fields = {"done": rand_done(E2, T2, 0.02),
              "action": rand((E2, T2), torch.int32),
              "reward": torch.randn((E2, T2), generator=g, device=dev),
              "terminated": rand((E2, T2), torch.bool)}
    compare_multi("multi B=256 fused FF/IQN update (6 segments)",
                  [(fields["reward"], 0, 3), (fields["done"], 0, 3),
                   (fields["terminated"], 0, 3), (fields["action"], 0, 1),
                   (planes, 0, 1), (planes, -3, 1)], 256)
    carry = [torch.randn((E2, T2, 128), generator=g, device=dev)
             for _ in range(2)]
    compare_multi("multi B=64 fused R2D2 update (7 segments, 400 B rows)",
                  [(planes, 0, 65), (fields["done"], 1, 66),
                   (fields["action"], 0, 65), (fields["reward"], 0, 65),
                   (fields["terminated"], 0, 65), (carry[0], 0, 1),
                   (carry[1], 0, 1)], 64)
    del planes, fields, carry
    strip_f32 = torch.randn((E2, T2), generator=g, device=dev)
    strip_bool = rand((E2, T2), torch.bool)
    compare("window_gather", "B=64 W=66 bool from col-1 (fused R2D2 dones)",
            strip_bool, 64, 66, 1, runs=15)
    compare("window_gather", "B=64 W=65 f32 (fused R2D2 strips)", strip_f32,
            64, 65, 0, runs=15)
    compare("window_gather", "B=256 W=3 f32 (fused reward)", strip_f32,
            256, 3, 0, runs=15)
    compare("window_gather", "B=256 W=3 bool (fused done, terminated)",
            strip_bool, 256, 3, 0, runs=15)
    del strip_f32, strip_bool
    compare("window_gather", "B=64 W=33 5x7 u8 (odd rows)",
            rand((8, 128, 5, 7), torch.uint8), 64, 33, 3)
    compare("union_gather", "B=256 W=7 12x16 f32",
            torch.randn((8, 128, 12, 16), generator=g, device=dev), 256, 7, 3)
    compare("union_gather", "B=256 W=7 5x7 u8 (unaligned rows)",
            rand((8, 128, 5, 7), torch.uint8), 256, 7, 3)
    compare_stacks("stacks B=256 F=4 n=3 12x16 f32, done rate 0.25",
                   torch.randn((8, 128, 12, 16), generator=g, device=dev),
                   rand_done(8, 128, 0.25), 256, 4, 3)
    compare_stacks("stacks B=256 F=4 n=3 5x7 u8 (unaligned rows), done rate "
                   "0.25", rand((8, 128, 5, 7), torch.uint8),
                   rand_done(8, 128, 0.25), 256, 4, 3)
    torch.cuda.empty_cache()
    return results


def phase_option_timings(smi: str):
    """Phase 2, continued: what the new options of the config-#2 path
    cost beside what they stand next to, at its size. (a) The NHWC
    layout change that follows the union gather under
    `model.channels_last` (both (256, 4, 84, 84) uint8 stacks to
    contiguous (256, 84, 84, 4)), beside the gather itself. (b) The sum
    tree's sample + priority write-back beside the dense tree's at
    262,144 leaves, B = 256, equal leaves on dyadic priorities. (c) The
    done-mask validity product that builds Q(lambda)'s n + 1 stacks per
    sample from one K1 window, beside that K1 launch."""
    import torch
    from rltime_tpu_torch.history import replay as replay_lib
    from rltime_tpu_torch.ops import dense_tree, gather, sum_tree
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(1)
    E, T, B, F, n = 64, 4096, 256, 4, 3
    ring = torch.randint(0, 256, (E, T, 84, 84), generator=g, device=dev,
                         dtype=torch.uint8)
    done = torch.rand((E, T), generator=g, device=dev) < 0.004
    sets = [(torch.randint(0, E, (B,), generator=g, device=dev,
                           dtype=torch.int32),
             torch.randint(0, T, (B,), generator=g, device=dev,
                           dtype=torch.int32)) for _ in range(15)]
    stacks = [gather.union_stack_gather(ring, done, e, c, F, n)
              for e, c in sets]
    it, it_g = itertools.cycle(stacks), itertools.cycle(sets)

    def layout():
        a, b = next(it)
        return (torch.movedim(a, 1, -1).contiguous(),
                torch.movedim(b, 1, -1).contiguous())

    def gather_only():
        gather.union_stack_gather(ring, done, *next(it_g), F, n)

    out = layout()
    check(out[0].shape == (B, 84, 84, F) and out[0].is_contiguous()
          and torch.equal(out[0].permute(0, 3, 1, 2), stacks[0][0]),
          "layout change: wrong result")
    ev, ev_g = median_ms(layout, 15), median_ms(gather_only, 15)
    ms = device_ms_per_call(layout, 15)
    ms_g = device_ms_per_call(gather_only, 15)
    moved = 2 * 2 * stacks[0][0].numel()
    bound = moved / HBM_BYTES_PER_S * 1e3
    print(f"NHWC layout change after union_gather (both stacks, B={B} F={F} "
          f"84x84 u8): device time {ms:.4f} ms ({ev:.4f} ms by CUDA events "
          f"incl. its 2 launches), bound {bound:.5f} ms ({moved} bytes): "
          f"{bound / ms:.1%} reached; the gather before it {ms_g:.4f} ms "
          f"({ev_g:.4f} ms by CUDA events)  [{smi}]", flush=True)
    del stacks
    # (c) under algo.use_lambda the n + 1 stacks come from one K1 window
    # and their done-mask validity is PyTorch: the masking product beside
    # the K1 launch that feeds it
    segs = [ring, done, torch.randn((E, T), generator=g, device=dev), done,
            done, torch.zeros((E, T), dtype=torch.int32, device=dev)]
    leads, wins = (F - 1, F - 1, 0, 0, 0, 0), (F + n, F + n, n, n, n, 1)
    windows = [gather.window_gather_multi(segs, e, c, leads, wins)[:2]
               for e, c in sets]
    it_w, it_g = itertools.cycle(windows), itertools.cycle(sets)

    def masking():
        return replay_lib.stacks_from_window(*next(it_w), n + 1, F)

    def k1_only():
        gather.window_gather_multi(segs, *next(it_g), leads, wins)

    e, c = sets[0]
    cols = c.long()[:, None] + torch.arange(n + 1, device=dev)
    ref = torch.stack([gather.union_stack_gather_reference(
        ring, done, e, torch.remainder(cols[:, t], T).int(), F, n)[0]
        for t in range(n + 1)], 1)
    check(torch.equal(masking(), ref), "Q(lambda) stacks: wrong result")
    it_w = itertools.cycle(windows)
    ev, ev_g = median_ms(masking, 15), median_ms(k1_only, 15)
    ms = device_ms_per_call(masking, 15)
    ms_g = device_ms_per_call(k1_only, 15)
    moved = windows[0][0].numel() + ref.numel()
    bound = moved / HBM_BYTES_PER_S * 1e3
    print(f"Q(lambda) stack masking after window_gather (B={B} F={F} n={n} "
          f"84x84 u8, {n + 1} stacks per sample): device time {ms:.4f} ms "
          f"({ev:.4f} ms by CUDA events incl. its launches), bound "
          f"{bound:.5f} ms ({moved} bytes): {bound / ms:.1%} reached; the K1 "
          f"launch before it {ms_g:.4f} ms ({ev_g:.4f} ms by CUDA events)  "
          f"[{smi}]", flush=True)
    del ring, windows, segs, ref
    torch.cuda.empty_cache()

    N = E * T
    prio = torch.randint(0, 64, (N,), generator=g, device=dev).float() / 8.0
    idx_all = torch.arange(N, device=dev)
    dense = dense_tree.set_priorities(dense_tree.init(N, dev), idx_all, prio,
                                      unique=True)
    tree = sum_tree.set_priorities(sum_tree.init(N, dev), idx_all, prio,
                                   unique=True)
    us = [torch.rand((B,), generator=g, device=dev) for _ in range(15)]
    tds = [torch.randint(0, 64, (B,), generator=g, device=dev).float() / 8.0
           for _ in range(15)]
    for u in us[:3]:
        leaf_d, p_d = dense_tree.sample(dense, u)
        leaf_t, p_t = sum_tree.sample(tree, u)
        check(torch.equal(leaf_d, leaf_t) and torch.equal(p_d, p_t),
              "sum tree and dense tree sampled different leaves")
    it_d, it_t = (itertools.cycle(zip(us, tds)) for _ in range(2))

    def dense_cycle():
        u, td = next(it_d)
        leaf, _ = dense_tree.sample(dense, u)
        return dense_tree.set_priorities(dense, leaf, td)

    def tree_cycle():
        u, td = next(it_t)
        leaf, _ = sum_tree.sample(tree, u)
        return sum_tree.set_priorities(tree, leaf, td)

    check(torch.equal(dense_cycle()[:N], sum_tree.get(tree_cycle(), idx_all)),
          "sum tree and dense tree wrote different leaves")
    ev_d, ev_t = median_ms(dense_cycle, 15), median_ms(tree_cycle, 15)
    ms_d = device_ms_per_call(dense_cycle, 9)
    ms_t = device_ms_per_call(tree_cycle, 9)
    print(f"PER sample + priority write-back at {N} leaves, B={B}: dense tree "
          f"{ev_d:.3f} ms by CUDA events incl. launches ({ms_d:.4f} ms of "
          f"device time), sum tree {ev_t:.3f} ms ({ms_t:.4f} ms of device "
          f"time); same leaves on dyadic priorities  [{smi}]", flush=True)


def _run_phases(trainer, result_dir: Path) -> dict:
    """Seconds per phase over a whole run: what the trainer's timers hold
    since its last log, plus each logged interval's time/<phase>_s."""
    phases = trainer.timers.pop()
    log = result_dir / "scalars.jsonl"
    for line in (log.read_text().splitlines() if log.is_file() else ()):
        for k, v in json.loads(line).items():
            if k.startswith("time/"):
                phases[k[5:-2]] = phases.get(k[5:-2], 0.0) + v
    return phases


def run_path(path: dict):
    """Drive one config through the CLI's entry point on the card with
    the launch counters zeroed just before and read just after; check
    what every path must show. Returns (trainer, launches, plain)."""
    import torch
    from rltime_tpu_torch import train
    from rltime_tpu_torch.ops import gather
    from rltime_tpu_torch.training import checkpoint as ckpt_lib
    tag = path.get("tag", path["preset"])
    result_dir = ROOT / "results" / f"chip_smoke_{tag}"
    shutil.rmtree(result_dir, ignore_errors=True)
    argv = [path["preset"], "--device", "cuda",
            "--result-dir", str(result_dir),
            f"--train.warmup_env_steps={path['warmup']}",
            f"--train.total_env_steps={path['steps']}",
            *path.get("overrides", [])]
    torch.cuda.reset_peak_memory_stats()
    gather.reset_counts()
    trainer = train.run(argv)
    torch.cuda.synchronize()
    launches, plain = dict(gather.LAUNCHES), dict(gather.PLAIN_CALLS)
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    phases = _run_phases(trainer, result_dir)
    loop_s = sum(phases.values())

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
    check(step == path.get("ckpt_step", path["steps"])
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
    check(launches == {"union_gather": n, "window_gather": n},
          f"launches {launches} in {n} updates, expected one union_gather "
          "(both frame stacks) and one window_gather (reward, done and "
          "terminated strips and the action) per update")
    return trainer, launches


def phase_r2d2_path():
    import torch
    trainer, launches = run_path(R2D2_PATH)
    n = R2D2_PATH["updates"]
    check(launches == {"union_gather": 0, "window_gather": n},
          f"launches {launches} in {n} R2D2 updates, expected one "
          "window_gather per update and no union_gather")
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


def graph_launches(trainer, tag: str, wrapper: dict) -> dict:
    """The gather kernels a captured fused trainer launched since the
    counters were zeroed before its first superstep: the Python
    wrappers' counts (`wrapper`) cover the eager warm-up supersteps and
    the capturing pass, which records the kernels into the graph
    without launching them; each replay launches the graph's kernel
    nodes (counted from its Graphviz dump). Checks one window_gather node
    per update of a superstep, no union_gather, and that the wrappers ran
    in the warm-ups and the capture only. Returns (launches, nodes)."""
    from rltime_tpu_torch.utils.graphs import GraphedStep
    g = trainer.graph
    check(g is not None and g.graph is not None,
          f"{tag}: the fused trainer on the card has no captured graph")
    dot = ROOT / "results" / f"chip_smoke_graph_fused_{tag}.dot"
    dot.parent.mkdir(parents=True, exist_ok=True)
    counts = g.kernel_counts(BENCH_KERNELS, str(dot))
    nodes = {"union_gather": counts["union_gather_kernel"],
             "window_gather": counts["window_gather_kernel"]}
    k = trainer.loop_cfg.updates_per_chunk
    check(nodes == {"union_gather": 0, "window_gather": k},
          f"{tag}: graph kernel nodes {nodes}, expected {k} window_gather "
          "(one per update of a superstep) and no union_gather")
    passes = GraphedStep.WARMUP + 1
    check(wrapper == {"union_gather": 0, "window_gather": passes * k},
          f"{tag}: wrapper launches {wrapper}, expected {passes} x {k} "
          "(the eager warm-ups and the capture; none in a replay)")
    # the capturing pass ran the wrappers once per node, launching nothing
    launches = {name: wrapper[name] - n + n * g.replays
                for name, n in nodes.items()}
    return launches, nodes


def run_fused_path(path: dict):
    """Drive one fused preset through the CLI's entry point on the card
    at full width, the launch counters zeroed just before and read just
    after, every trained superstep after the eager warm-ups a replay of
    the captured graph (`GraphedStep.debug` on, to count its kernel
    nodes); check what every fused path must show. Returns (trainer,
    launches: the kernels' launches in the run, eager and replayed,
    nodes: the graph's kernel nodes)."""
    import torch
    from rltime_tpu_torch import train
    from rltime_tpu_torch.ops import gather
    from rltime_tpu_torch.parallel.fused import FusedApexTrainer
    from rltime_tpu_torch.training import checkpoint as ckpt_lib
    from rltime_tpu_torch.utils.graphs import GraphedStep
    tag = path["preset"]
    result_dir = ROOT / "results" / f"chip_smoke_{tag}"
    shutil.rmtree(result_dir, ignore_errors=True)
    argv = [tag, "--device", "cuda", "--result-dir", str(result_dir),
            f"--train.total_env_steps={path['steps']}"]
    torch.cuda.reset_peak_memory_stats()
    GraphedStep.debug = True            # keep the graph to count its nodes
    gather.reset_counts()
    t0 = time.perf_counter()
    try:
        trainer = train.run(argv)
        torch.cuda.synchronize()
    finally:
        GraphedStep.debug = False
    wall = time.perf_counter() - t0
    wrapper, plain = dict(gather.LAUNCHES), dict(gather.PLAIN_CALLS)
    peak_gb = torch.cuda.max_memory_allocated() / 1e9

    check(isinstance(trainer, FusedApexTrainer)
          and trainer.device.type == "cuda", f"{tag}: not the fused trainer "
          "on cuda")
    E, n_upd = trainer.num_envs, path["updates"]
    check(E == 256 and trainer.env_steps == path["steps"],
          f"{tag}: {E} lanes, {trainer.env_steps} env steps")
    check(trainer.updates_done == n_upd,
          f"{tag}: {trainer.updates_done} updates, expected {n_upd}")
    check(not any(plain.values()), f"{tag}: plain calls on the CUDA path "
          f"{plain}")
    launches, nodes = graph_launches(trainer, tag, wrapper)
    check(launches == {"window_gather": path["k1"] * n_upd,
                       "union_gather": 0},
          f"{tag}: launches {launches} (eager warm-ups + {nodes} nodes x "
          f"{trainer.graph.replays} replays), expected {path['k1']} "
          f"window_gather per update x {n_upd} updates and no union_gather")
    check(trainer.replay_state.cursor.item() == trainer.replay_state.t
          and trainer.train_state.counter.item() == n_upd,
          f"{tag}: device cursor {trainer.replay_state.cursor.item()} / "
          f"counter {trainer.train_state.counter.item()} against the host's "
          f"{trainer.replay_state.t} / {n_upd}")
    m = trainer.last_metrics
    for k in ("loss", "grad_norm", "td_abs", "q"):
        check(math.isfinite(m[k].item()), f"{tag}: last {k} = {m[k].item()}")
    rs = trainer.replay_state
    obs = rs.storage["obs"]
    check(rs.t == path["steps"] // E, f"{tag}: replay cursor {rs.t}")
    check(obs.shape == (E, 512) + tuple(trainer.env.obs_shape)
          and obs.dtype == torch.uint8 and obs.is_cuda,
          f"{tag}: obs ring {obs.shape} {obs.dtype} {obs.device}")
    written = obs[:, :rs.t]
    check(int(written.max()) == 1 and 0 < float(written.float().mean()) < 1,
          f"{tag}: obs ring is not binary planes with both values")
    check(rs.storage["action"][:, :rs.t].unique().numel()
          == trainer.env.num_actions, f"{tag}: not every action was taken")
    check(bool(rs.storage["done"][:, :rs.t].any()), f"{tag}: no done flag")
    tree = rs.tree
    live = tree > 0
    moved = live & (tree != rs.max_priority)
    check(bool(torch.isfinite(tree).all()) and int(moved.sum()) > 0,
          f"{tag}: priorities not finite, or none moved off max-priority")
    # (the run's own log line has popped the fresh episodes: read the
    # ring itself)
    n_eps = int(trainer.actor_state.ring_cursor)
    rets = trainer.actor_state.ret_ring[:min(n_eps, 256)].tolist()
    check(n_eps > 0 and all(math.isfinite(r) for r in rets),
          f"{tag}: no completed episode in the stat ring")
    step = ckpt_lib.latest_step(str(result_dir))
    check(step == path["steps"]
          and (result_dir / "checkpoints" / str(step) / "state.pt").is_file(),
          f"{tag}: checkpoint missing (latest step {step})")
    print(f"{tag}: {path['steps']} env steps, {n_upd} updates in "
          f"{wall:.2f} s (setup, warmup, the capture and the checkpoint "
          f"included), launches {launches} ({GraphedStep.WARMUP} eager "
          f"supersteps, then graph kernel nodes {nodes} x "
          f"{trainer.graph.replays} replays), plain calls {plain}; last loss "
          f"{m['loss'].item():.6g} grad_norm {m['grad_norm'].item():.6g} "
          f"td_abs {m['td_abs'].item():.6g} q {m['q'].item():.6g}; "
          f"{n_eps} episodes completed, mean return of the last "
          f"{len(rets)} {sum(rets) / len(rets):.3f}; {int(live.sum())} live "
          f"leaves, "
          f"{int(moved.sum())} off max-priority; peak device memory "
          f"{peak_gb:.3f} GB", flush=True)
    return trainer, launches, nodes


def phase_fused_path(smi: str):
    """Phase 5: the counted run (captured), the checkpoint read back, the
    no-sync replayed dispatch, the warm rates captured and op by op, and
    the profiled replay. Returns (launches, graph nodes)."""
    import torch
    from rltime_tpu_torch.acting.device_actor import eps_schedule
    from rltime_tpu_torch.config.config import apply_overrides, load_config
    from rltime_tpu_torch.parallel.fused import FusedApexTrainer
    trainer, launches, nodes = run_fused_path(FUSED_PATH)
    mc, ac, lc = trainer.model_cfg, trainer.algo_cfg, trainer.loop_cfg
    check(mc.torso == "minatar_cnn" and mc.head == "dueling"
          and (ac.batch_size, ac.n_step) == (256, 3)
          and (lc.chunk_len, lc.updates_per_chunk,
               lc.supersteps_per_dispatch) == (32, 64, 4),
          f"not the preset's shapes: {mc} {ac} {lc}")

    # the checkpoint is reloadable: a second trainer resumes from it
    cfg = copy.deepcopy(trainer.config)
    cfg["train"]["resume"] = True
    again = FusedApexTrainer(cfg, trainer.result_dir, device="cuda")
    check(again.env_steps == trainer.env_steps
          and again.updates_done == trainer.updates_done
          and again.train_state.counter.item() == trainer.updates_done,
          "resumed trainer's counters differ")
    for (k, a), b in zip(trainer.train_state.model.state_dict().items(),
                         again.train_state.model.state_dict().values()):
        check(torch.equal(a, b), f"resumed param {k} differs")
    check(torch.equal(again.actor_state.ret_ring, trainer.actor_state.ret_ring)
          and all(torch.equal(v, trainer.actor_state.env_state[k])
                  for k, v in again.actor_state.env_state.items()),
          "resumed actor state differs")
    del again
    print("checkpoint read back: learner, counters and actor state equal",
          flush=True)

    # one warm dispatch (4 replays) during which any host sync raises
    replays = trainer.graph.replays
    torch.cuda.set_sync_debug_mode("error")
    try:
        trainer.superstep()
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    check(trainer.graph.replays == replays + trainer.supersteps,
          "the no-sync dispatch was not 4 replays")
    print("no-sync check: one warm dispatch (4 graph replays) ran under "
          "set_sync_debug_mode('error')", flush=True)

    S, L, E = trainer.supersteps, lc.chunk_len, trainer.num_envs
    rates = fused_rates(trainer, dispatches=3)
    super_ms = rates["ms_per_superstep"]
    # the same trainer op by op: its own warm chunks, one dispatch to
    # warm, two timed
    eager_dir = ROOT / "results" / "chip_smoke_fused_eager"
    shutil.rmtree(eager_dir, ignore_errors=True)
    cfg = apply_overrides(load_config(FUSED_PATH["preset"]), [
        "train.total_env_steps=1000000000", "train.log_interval=1000000000"])
    eager = FusedApexTrainer(cfg, str(eager_dir), device="cuda",
                             capture=False)
    while eager.updates_done == 0:
        eager.superstep()
    eager_rates = fused_rates(eager, dispatches=2)
    eager.logger.close()
    del eager
    print(f"steady state fused, captured ({rates['dispatches']} warm "
          f"dispatches of {S} supersteps): {rates['env_steps_per_s']:.1f} "
          f"env-steps/s, {rates['updates_per_s']:.2f} updates/s, "
          f"{super_ms:.2f} ms/superstep; op by op (capture=False, "
          f"{eager_rates['dispatches']} dispatches): "
          f"{eager_rates['env_steps_per_s']:.1f} env-steps/s, "
          f"{eager_rates['ms_per_superstep']:.2f} ms/superstep; "
          f"{eager_rates['ms_per_superstep'] / super_ms:.2f}x  [{smi}]",
          flush=True)
    # the act phase alone: warm act + insert chunks (no updates, op by
    # op), so the superstep's time splits into acting and the 64 updates
    chunks = 4
    t0 = time.perf_counter()
    for _ in range(chunks):
        eps = eps_schedule(trainer.exploration, E, trainer.env_steps, L,
                           trainer.device)
        trainer._warm_super(trainer.train_state.model, trainer.actor_state,
                            trainer.replay_state, eps)
        trainer.replay_state.t += L
        trainer.env_steps += L * E
    torch.cuda.synchronize()
    act_ms = (time.perf_counter() - t0) / chunks * 1e3
    print(f"  act + insert alone, op by op ({chunks} chunks of {L} steps): "
          f"{act_ms:.2f} ms/chunk ({act_ms / L:.3f} ms/step)", flush=True)
    check(trainer.replay_state.cursor.item() == trainer.replay_state.t,
          "the warm program's cursor and the host's differ")
    trainer.supersteps = 1              # profile ONE superstep (a replay)
    p_wall, busy_ms, per_name = device_profile(trainer.superstep)
    trainer.supersteps = S
    print(f"  profiled (1 more superstep, one replay): device busy "
          f"{busy_ms:.3f} ms/superstep, {busy_ms / super_ms:.1%} of the "
          f"unprofiled superstep time ({busy_ms / 1e3 / p_wall:.1%} of the "
          f"profiled {p_wall * 1e3:.3f} ms)  [{smi}]", flush=True)
    k1_ms = sum(v for name, v in per_name.items() if "window_gather" in name)
    print(f"  window_gather kernel: {k1_ms:.4f} ms/superstep of "
          f"{busy_ms:.4f} ms/superstep device busy", flush=True)
    for name, ms in sorted(per_name.items(), key=lambda kv: -kv[1])[:10]:
        print(f"  device {ms:9.4f} ms/superstep  {name[:110]}", flush=True)
    return launches, nodes


def fused_rates(trainer, dispatches: int) -> dict:
    """Host-clock rates of `dispatches` warm dispatches ending in a
    synchronise."""
    import torch
    lc = trainer.loop_cfg
    torch.cuda.synchronize()
    s0, u0 = trainer.env_steps, trainer.updates_done
    t0 = time.perf_counter()
    for _ in range(dispatches):
        trainer.superstep()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    n = dispatches * trainer.supersteps
    check(trainer.env_steps - s0 == n * lc.chunk_len * trainer.e_global,
          "fused_rates: the dispatches were warmup chunks")
    return {"dispatches": dispatches,
            "env_steps_per_s": (trainer.env_steps - s0) / wall,
            "updates_per_s": (trainer.updates_done - u0) / wall,
            "ms_per_superstep": wall / n * 1e3}


def phase_fused_bench_shape(smi: str):
    """Phase 6: the fused trainer at bench.py's shape (the JAX package's
    `_bench_minatar_fused`: L=128, 256 updates a chunk, S=1, warmup 0)
    through `bench.bench_minatar_fused`, captured (the eager warm-ups and
    the capture, then 5 windows of 2 replayed dispatches and a profiled
    one) and op by op."""
    from rltime_tpu_torch import bench
    from rltime_tpu_torch.ops import gather
    from rltime_tpu_torch.utils.graphs import GraphedStep
    gather.reset_counts()
    res = bench.bench_minatar_fused()
    passes = GraphedStep.WARMUP + 1
    check(gather.LAUNCHES == {"union_gather": 0, "window_gather": 256 * passes}
          and not any(gather.PLAIN_CALLS.values()),
          f"bench shape: wrapper launches {gather.LAUNCHES} (expected the "
          f"{passes} passes before the replays), plain {gather.PLAIN_CALLS}")
    res.update(bench.bench_minatar_fused(capture=False))
    for k in ("minatar_env_steps_per_s", "minatar_env_steps_per_s_eager"):
        check(res[k] > 0, f"bench shape: {k} = {res[k]}")
    print(f"fused bench shape (L=128, 256 updates per chunk, S=1, batch 256, "
          f"256 lanes; {bench.WINDOWS} windows of {bench.MINATAR_DISPATCHES} "
          f"dispatches): captured {res['minatar_env_steps_per_s']:.1f} "
          f"env-steps/s (windows "
          f"{[round(x, 1) for x in res['minatar_env_steps_per_s_windows']]}), "
          f"op by op {res['minatar_env_steps_per_s_eager']:.1f} (windows "
          f"{[round(x, 1) for x in res['minatar_env_steps_per_s_eager_windows']]}"
          f"); a profiled replay: device busy "
          f"{res['minatar_device_busy_ms_per_dispatch']:.3f} of "
          f"{res['minatar_profiled_dispatch_ms']:.3f} ms "
          f"({res['minatar_device_busy_share']:.1%}; an unprofiled dispatch "
          f"{res['minatar_ms_per_dispatch']:.3f} ms)  [{smi}]", flush=True)


# phase 14's other legs: the JAX bench's IQN (iqn_b1024_k1) and R2D2
# (r2d2_b64_k1) learner legs of tools/bench_algo_legs.py at the bench's
# widths, S cut from 64 (8 and 4 there) so each captures in seconds
BENCH_LEGS = (dict(algo="iqn", supersteps=8),
              dict(algo="r2d2", batch=64, supersteps=4))
BENCH_KERNELS = ("union_gather_kernel", "window_gather_kernel")


def _graph_launches(p, tag: str) -> dict:
    """Kernel nodes of each gather inside `p`'s captured superstep, from
    the graph's Graphviz dump; checks one K1 (and for dqn/IQN one K2)
    node per update and none of the plain versions."""
    from rltime_tpu_torch.ops import gather
    dot = ROOT / "results" / f"chip_smoke_graph_{tag}.dot"
    dot.parent.mkdir(parents=True, exist_ok=True)
    counts = p.graph.kernel_counts(BENCH_KERNELS, str(dot))
    n = p.S * p.K
    want = {"union_gather_kernel": 0 if p.acfg.algo == "r2d2" else n,
            "window_gather_kernel": n}
    check(counts == want, f"{tag}: kernel nodes in the graph {counts}, "
          f"expected {want} for {n} updates")
    check(not any(gather.PLAIN_CALLS.values()),
          f"{tag}: plain calls {gather.PLAIN_CALLS}")
    return {"union_gather": counts["union_gather_kernel"],
            "window_gather": counts["window_gather_kernel"]}


def _check_capturable_adam(smi: str) -> None:
    """The captured route's Adam (`make_optimizer(..., capturable=True)`:
    its step count and bias corrections on the device) against the
    eager paths' (torch's host-scalar Adam) over five steps on the same
    gradients, at the Nature CNN dueling net's 16 tensors and lr 1e-4.
    Both round the same formula differently in its last bits, so the
    params are held to 1e-6, 1% of one step's move. Then the wall time
    of one step of each (CUDA events)."""
    import torch
    from rltime_tpu_torch.training.learner import AlgoConfig, make_optimizer
    cfg = AlgoConfig(lr=1e-4)
    g = torch.Generator(device="cuda").manual_seed(0)
    shapes = [(32, 4, 8, 8), (32,), (64, 32, 4, 4), (64,), (64, 64, 3, 3),
              (64,), (512, 3136), (512,), (256, 512), (256,), (1, 256),
              (1,), (256, 512), (256,), (6, 256), (6,)]
    cap = [torch.nn.Parameter(0.05 * torch.randn(s, generator=g,
                                                 device="cuda"))
           for s in shapes]
    host = [torch.nn.Parameter(x.detach().clone()) for x in cap]
    opt_cap = make_optimizer(cfg, cap, capturable=True)
    opt_host = make_optimizer(cfg, host)
    check(opt_cap.defaults["capturable"]
          and not opt_host.defaults["capturable"],
          "make_optimizer: capturable Adam only where asked for")
    for _ in range(5):
        for a, b in zip(cap, host):
            a.grad = torch.randn(a.shape, generator=g, device="cuda")
            b.grad = a.grad.clone()
        opt_cap.step()
        opt_host.step()
    diff = max((a - b).abs().max().item() for a, b in zip(host, cap))
    check(diff <= 1e-6, f"capturable Adam vs host Adam: {diff}")
    cap_ms, host_ms = median_ms(opt_cap.step), median_ms(opt_host.step)
    print(f"capturable Adam (the captured route) vs host-scalar Adam (the "
          f"eager paths), 5 steps on the same gradients: max abs param "
          f"difference {diff:.3g} (tolerance 1e-6); one step {cap_ms:.4f} "
          f"ms capturable, {host_ms:.4f} ms host-scalar  [{smi}]",
          flush=True)


def phase_bench_superstep(smi: str) -> dict:
    """Phase 14: `utils/benchprog.py` at the full bench shapes (64 x
    1024 ring of 84x84 uint8, 0.46 GB; S=64 x (insert + 1 update) at
    batch 1024, Nature CNN bf16; a 0.93 GB static chunk buffer): the dqn
    superstep captured into one CUDA graph under cudnn.deterministic,
    its kernel nodes counted in the graph, one replay held against the
    eager body from a cloned state, a replay under
    set_sync_debug_mode("error"), then `bench.bench_learner` (default
    cuDNN) for the rates, and the IQN and R2D2 legs for one replay each.
    Returns the kernel nodes of each graph (one dispatch's launches)."""
    import torch
    from rltime_tpu_torch import bench
    from rltime_tpu_torch.ops import gather
    from rltime_tpu_torch.utils import benchprog
    t_phase = time.perf_counter()
    _check_capturable_adam(smi)
    by_path = {}
    cudnn = torch.backends.cudnn
    deterministic = cudnn.deterministic
    cudnn.deterministic = True
    try:
        p = benchprog.build(device="cuda", debug_outputs=True)
        p.graph.debug = True                  # keep the graph to count
        beta = torch.full((), 0.4, device="cuda")
        gather.reset_counts()
        chunks = p.stacked(50)
        for _ in range(p.graph.WARMUP + 1):   # eager warm-ups, capture
            p.superstep(p.tstate, p.rstate, beta, chunks)
        torch.cuda.synchronize()
        check(p.graph.graph is not None, "bench superstep not captured")
        # two eager dispatches and the capture ran the Python wrappers
        passes = p.graph.WARMUP + 1
        check(gather.LAUNCHES == {"union_gather": passes * p.S,
                                  "window_gather": passes * p.S},
              f"bench superstep: wrapper launches {gather.LAUNCHES}")
        by_path["benchprog dqn (one replay)"] = _graph_launches(p, "dqn")
        chunks = p.stacked(50 + p.S)
        ts, rs = benchprog.clone_states(p.tstate, p.rstate)
        gather.reset_counts()
        _, _, mg = p.superstep(p.tstate, p.rstate, beta, chunks)
        check(not any(gather.LAUNCHES.values()),
              f"a replay ran a wrapper: {gather.LAUNCHES}")
        _, _, me = p.eager_superstep(ts, rs, beta, chunks)
        torch.cuda.synchronize()
        for name, a, b in (
                [("tree", p.rstate.tree, rs.tree),
                 ("cursor", p.rstate.cursor, rs.cursor),
                 ("counter", p.tstate.counter, ts.counter),
                 ("max_priority", p.rstate.max_priority, rs.max_priority),
                 ("sampled leaves", mg["debug_leaf"], me["debug_leaf"])]
                + [(f"ring {n}", x, rs.storage[n])
                   for n, x in p.rstate.storage.items()]):
            check(torch.equal(a, b), f"graph vs eager: {name} differs")
        diffs = {k: (mg[k].float() - me[k].float()).abs().max().item()
                 for k in mg}
        for net, other in ((p.tstate.model, ts.model),
                           (p.tstate.target, ts.target)):
            for (name, a), b in zip(net.state_dict().items(),
                                    other.state_dict().values()):
                diffs[name] = max(diffs.get(name, 0.0), (a.float() - b.float()
                                                          ).abs().max().item())
        worst = max(diffs.values())
        # tolerance 0: under cudnn.deterministic the graph replays the
        # eager body's kernels on the same inputs
        check(worst == 0.0, f"graph vs eager: max abs difference {worst} "
              f"({ {k: v for k, v in diffs.items() if v} })")
        print(f"bench superstep (E=64, T=1024, L=32, batch 1024, S=64, K=1, "
              f"Nature CNN bf16): one replay == the eager body from a clone "
              f"(tree, {p.S * p.K} updates' last sampled leaves, cursor "
              f"{p.rstate.cursor.item()}, counter {p.tstate.counter.item()}, "
              f"rings, metrics, params: max abs difference {worst}); graph "
              f"kernel nodes {by_path['benchprog dqn (one replay)']}, "
              "0 plain calls", flush=True)
        torch.cuda.set_sync_debug_mode("error")
        try:
            _, _, m = p.superstep(p.tstate, p.rstate, beta, chunks)
        finally:
            torch.cuda.set_sync_debug_mode(0)
        check(math.isfinite(m["loss"].item()), "bench superstep: loss")
        print("bench superstep: a replay (input copies included) under "
              "set_sync_debug_mode('error'): 0 host syncs", flush=True)
    finally:
        cudnn.deterministic = deterministic
    del p, ts, rs, mg, me, m, chunks
    torch.cuda.empty_cache()
    res = bench.bench_learner()
    print(f"bench learner (default cuDNN; {bench.WINDOWS} windows of "
          f"{bench.DISPATCHES} staged dispatches): captured "
          f"{res['learner_transitions_per_s']:.1f} transitions/s "
          f"(windows {[round(x, 1) for x in res['learner_transitions_per_s_windows']]}), "
          f"{res['ms_per_update']:.4f} ms/update; eager "
          f"{res['learner_transitions_per_s_eager']:.1f} transitions/s "
          f"({res['ms_per_update_eager']:.4f} ms/update); "
          f"{res['update_tflops_per_s']:.3f} TFLOP/s, MFU "
          f"{res['mfu_pct_h100_bf16']:.3f}% of the bf16 peak; a profiled "
          f"replay: device busy {res['device_busy_ms_per_dispatch']:.3f} of "
          f"{res['profiled_dispatch_ms']:.3f} ms "
          f"({res['device_busy_share']:.1%}); peak device memory "
          f"{res['peak_memory_gb']:.3f} GB  [{smi}]", flush=True)
    for name, ms in res["top_kernels_ms_per_dispatch"]:
        print(f"  device {ms:9.4f} ms/dispatch  {name}", flush=True)
    for leg in BENCH_LEGS:
        tag = leg["algo"]
        t0 = time.perf_counter()
        p = benchprog.build(device="cuda", **leg)
        p.graph.debug = True
        beta = torch.full((), 0.4, device="cuda")
        chunks = p.stacked(50)
        gather.reset_counts()
        for _ in range(p.graph.WARMUP + 1):
            p.superstep(p.tstate, p.rstate, beta, chunks)
        chunks = p.stacked(50 + p.S)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        _, _, m = p.superstep(p.tstate, p.rstate, beta, chunks)
        loss = m["loss"].item()
        replay_ms = (time.perf_counter() - t1) * 1e3
        check(math.isfinite(loss) and p.tstate.updates == 4 * p.S * p.K,
              f"{tag} leg: loss {loss}, {p.tstate.updates} updates")
        by_path[f"benchprog {tag} (one replay)"] = _graph_launches(p, tag)
        print(f"bench {tag} leg (batch {p.batch}, S={p.S}, K={p.K}): one "
              f"replay {replay_ms:.2f} ms, "
              f"{p.S * p.K * p.tx_per_update / replay_ms * 1e3:.1f} "
              f"transitions/s, loss {loss:.6g}; graph kernel nodes "
              f"{by_path[f'benchprog {tag} (one replay)']}; build, 2 eager "
              f"dispatches and the capture {t1 - t0:.1f} s  [{smi}]",
              flush=True)
        del p, m, chunks
        torch.cuda.empty_cache()
    print(f"phase 14 took {time.perf_counter() - t_phase:.1f} s", flush=True)
    return by_path


def phase_fused_others() -> dict:
    """Phase 7: the first full-width dispatches of the other fused paths,
    captured. Returns each path's (launches, graph nodes)."""
    out = {}
    for path in FUSED_OTHERS:
        trainer, launches, nodes = run_fused_path(path)
        out[path["preset"]] = (launches, nodes)
        mc, ac = trainer.model_cfg, trainer.algo_cfg
        if path["preset"].endswith("iqn"):
            check(mc.is_iqn and ac.algo == "iqn", f"not IQN: {mc} {ac}")
        if path["preset"].endswith("r2d2"):
            check(mc.lstm_size == 128 and (ac.burn_in, ac.seq_len, ac.n_step)
                  == (20, 40, 5), f"not the R2D2 preset: {mc} {ac}")
            ring = trainer.replay_state.storage["rnn_h"]
            check(ring.shape == (256, 512, 128) and bool(ring.abs().sum() > 0),
                  f"rnn_h ring {ring.shape} empty")
        del trainer
    return out


# phase 15: the graph against the eager body, at each preset's full width
FUSED_GRAPH_CASES = (
    ("minatar_breakout_dqn", "chunked DQN", []),
    ("minatar_breakout_iqn", "IQN + actor-side priorities",
     ["replay.use_inserted_priorities=true"]),
    ("minatar_breakout_r2d2", "R2D2", []),
    ("minatar_breakout_dqn", "interleaved", ["train.interleave_updates=true"]),
)


def phase_fused_graph_parity(smi: str):
    """Phase 15: for chunked DQN, IQN (with actor-side priorities, so the
    post-chunk forward draws its taus), R2D2 and the interleaved
    superstep at their presets' full width, under cudnn.deterministic:
    the trainer captures its graph (two eager supersteps, then the
    capture), then one more superstep, a replay, is held against the
    eager body run from clones of the same states on the same epsilons
    and beta: parameters, target, optimizer moments and step counts,
    the update counter, rings, tree, max_priority, cursor, the actor's
    env state, carry, stat rings and the learner's, envs' and actor's
    generator states, and the metrics. Tolerance 0."""
    import torch
    from rltime_tpu_torch.config.config import apply_overrides, load_config
    from rltime_tpu_torch.ops import gather
    from rltime_tpu_torch.parallel.fused import FusedApexTrainer, state_diffs
    from rltime_tpu_torch.utils import benchprog
    t_phase = time.perf_counter()
    cudnn = torch.backends.cudnn
    deterministic = cudnn.deterministic
    cudnn.deterministic = True
    try:
        for preset, what, extra in FUSED_GRAPH_CASES:
            cfg = apply_overrides(load_config(preset), extra + [
                "train.supersteps_per_dispatch=1",
                "train.total_env_steps=1000000000",
                "train.log_interval=1000000000"])
            d = ROOT / "results" / f"chip_smoke_graph_parity_{preset}"
            shutil.rmtree(d, ignore_errors=True)
            t = FusedApexTrainer(cfg, str(d), device="cuda")
            while t.graph.graph is None:
                t.superstep()
            eps, beta = t._eps(t.loop_cfg.chunk_len), t._betas(1)[0]
            ts, rs = benchprog.clone_states(t.train_state, t.replay_state)
            clone = (ts, t.actor_state.clone(), rs)
            gather.reset_counts()
            m = t.superstep()
            check(not any(gather.LAUNCHES.values()),
                  f"{what}: a replay ran a wrapper: {gather.LAUNCHES}")
            me = t.eager_superstep(*clone, eps, beta)
            torch.cuda.synchronize()
            diffs = state_diffs((t.train_state, t.actor_state,
                                 t.replay_state), clone)
            diffs.update({f"metric {k}": (v.double() - me[k].double())
                          .abs().max().item() for k, v in m.items()})
            worst = max(diffs.values())
            check(worst == 0.0, f"{what}: graph vs eager, max abs "
                  f"difference {worst} "
                  f"({ {k: v for k, v in diffs.items() if v} })")
            print(f"graph vs eager ({preset}, {what}, "
                  f"{t.loop_cfg.updates_per_chunk} updates a superstep): one "
                  f"replay == the eager body from clones over {len(diffs)} "
                  f"tensors and generator states (cursor "
                  f"{t.replay_state.cursor.item()}, counter "
                  f"{t.train_state.counter.item()}): max abs difference "
                  f"{worst}", flush=True)
            t.logger.close()
            del t, ts, rs, clone, m, me
            torch.cuda.empty_cache()
    finally:
        cudnn.deterministic = deterministic
    print(f"phase 15 took {time.perf_counter() - t_phase:.1f} s  [{smi}]",
          flush=True)


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
    for k in ("loss", "grad_norm", "td_abs"):
        a, b = mc[k].item(), mg[k].item()
        check(math.isclose(a, b, rel_tol=tol), f"{tag} parity: {k} {a} vs "
              f"{b}")
    if "debug_leaf" in mc:      # (not under interleave_updates)
        check(torch.equal(mc["debug_leaf"], mg["debug_leaf"].cpu()),
              f"{tag} parity: sampled leaves differ")
        check(torch.allclose(mc["debug_td"], mg["debug_td"].cpu(), rtol=tol,
                             atol=1e-6),
              f"{tag} parity: per-sample td differs")
    check(torch.allclose(rc.tree, rg.tree.cpu(), rtol=tol, atol=1e-7),
          f"{tag} parity: priorities differ")
    worst = max((p.detach().cpu() - q.detach()).abs().max().item()
                for p, q in zip(tg.model.parameters(),
                                tc.model.parameters()))
    check(worst <= 1e-5, f"{tag} parity: params after Adam differ by "
          f"{worst}")
    print(f"small-input {tag} parity cuda vs cpu: loss "
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
    base = dict(batch_size=B, n_step=3, lr=1e-3, adam_eps=1e-3,
                grad_clip=0.05, target_update_freq=1, debug_outputs=True)
    nhwc = dict(cnn, channels_last=True, space_to_depth=True)
    # (tag, model, algo, replay options)
    cases = [
        ("dqn", ModelConfig(**cnn), learner.AlgoConfig(**base), {}),
        ("r2d2", ModelConfig(lstm_size=16, **cnn),
         learner.AlgoConfig(**dict(base, algo="r2d2", batch_size=8, n_step=2,
                                   burn_in=4, seq_len=8, gamma=0.997)), {}),
        ("dqn rmsprop", ModelConfig(**cnn),
         learner.AlgoConfig(**dict(base, optimizer="rmsprop")), {}),
        ("dqn sum tree", ModelConfig(**cnn), learner.AlgoConfig(**base),
         dict(sampler="tree")),
        ("dqn uniform replay", ModelConfig(**cnn),
         learner.AlgoConfig(**base), dict(prioritized=False)),
        ("dqn Q(lambda)", ModelConfig(**cnn),
         learner.AlgoConfig(**dict(base, use_lambda=True)), {}),
        ("dqn NHWC + space-to-depth", ModelConfig(**nhwc),
         learner.AlgoConfig(**base), {}),
    ]
    for tag, mcfg, acfg, replay_kw in cases:
        rec = acfg.algo == "r2d2"
        horizon = r2d2.r2d2_horizon(acfg) if rec else acfg.n_step
        rcfg = replay.ReplayConfig(num_envs=E, steps_per_env=T,
                                   horizon=horizon, chunk_len=L,
                                   lookback=F - 1, **replay_kw)
        rng = np.random.default_rng(0)
        chunks = _chunks(rng, E, L, (84, 84), 6, mcfg.lstm_size)
        if rcfg.prioritized:
            u = torch.from_numpy(rng.random(acfg.batch_size).astype(
                np.float32))
        else:       # uniform replay's integer draws: offsets, then lanes
            lo, hi = replay.valid_range(rcfg, len(chunks) * L)
            u = (torch.from_numpy(rng.integers(0, hi - lo, B)),
                 torch.from_numpy(rng.integers(0, E, B)))
        in_shape = (84, 84, F) if mcfg.channels_last else (F, 84, 84)
        out = []
        for dev in map(torch.device, devices):
            rs = replay.replay_init(rcfg, _fields((84, 84), mcfg.lstm_size),
                                    dev)
            for c in chunks:
                replay.replay_insert(rcfg, rs, c)
            ts = learner.make_train_state(mcfg, acfg, in_shape, 0, dev)
            upd = (r2d2.make_r2d2_update_step(mcfg, acfg, rcfg, F, False)
                   if rec else learner.make_update_step(
                       acfg, rcfg, F, False, mcfg.channels_last))
            ts, rs, m = upd(ts, rs, 0.5, u=_to_device(u, dev))
            out.append((m, rs, ts))
        _compare_updates(tag, out, 1e-4)


def _to_device(x, dev):
    if isinstance(x, dict):
        return {k: _to_device(v, dev) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return type(x)(_to_device(v, dev) for v in x)
    return x.to(dev)


def phase_fused_parity(devices=("cpu", "cuda"), interleave=False):
    """One fused superstep (8 act steps, the insert, 2 updates) on the
    card vs the same on the CPU, on the same injected draws, in float32
    with TF32 off. Acting is at eps = 1, so the ring's bytes must be
    equal; the updates are compared as phase_small_parity's.
    `interleave`: the interleaved superstep instead (8 x {act, one-column
    insert, 1 update}) with actor-side priorities, whose ring (the
    actor's |TD|, float math) is compared to 1e-4."""
    import torch
    from rltime_tpu_torch.acting.device_actor import (
        act_draws, init_device_actor_state,
    )
    from rltime_tpu_torch.parallel.fused import FusedApexTrainer
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    E, L, B = 8, 8, 16
    K = 8 if interleave else 2
    cfg = {
        "seed": 0,
        "env": {"type": "minatar_breakout", "num_envs": E, "time_limit": 12},
        "model": {"torso": "minatar_cnn", "cnn_channels": [8], "cnn_fc": 32,
                  "head": "dueling", "dueling_hidden": 16},
        "replay": {"steps_per_env": 64,
                   "use_inserted_priorities": interleave},
        "algo": {"algo": "dqn", "batch_size": B, "n_step": 3, "lr": 1e-3,
                 "adam_eps": 1e-3, "grad_clip": 0.05,
                 "target_update_freq": 1, "debug_outputs": not interleave},
        "exploration": {"type": "epsilon_greedy", "eps_start": 1.0,
                        "eps_end": 1.0},
        "train": {"warmup_env_steps": 0, "chunk_len": L,
                  "updates_per_chunk": K, "trainer": "fused",
                  "interleave_updates": interleave},
    }
    g = torch.Generator().manual_seed(0)
    out, rings = [], []
    draws = None
    for dev in devices:
        result_dir = (ROOT / "results" / f"chip_smoke_fused_parity_{dev}"
                      f"{'_interleaved' if interleave else ''}")
        shutil.rmtree(result_dir, ignore_errors=True)
        # injected draws: the body op by op (a graph draws its own)
        t = FusedApexTrainer(cfg, str(result_dir), device=dev,
                             capture=False)
        if draws is None:       # drawn once, on the CPU
            reset = t.env.reset_draws(E, g, "cpu")
            draws = dict(
                act=[dict(act=act_draws(t.model_cfg, E, g, "cpu"),
                          env=t.env.step_draws(E, g, "cpu"))
                     for _ in range(L)],
                update=[dict(u=torch.rand(B, generator=g))
                        for _ in range(K)])
        t.actor_state = init_device_actor_state(
            t.env, t.model_cfg, E, 0, t.device,
            reset_draws=_to_device(reset, t.device))
        m = t.superstep([_to_device(draws, t.device)])
        out.append((m, t.replay_state, t.train_state))
        rings.append({k: v.cpu() for k, v in t.replay_state.storage.items()})
        t.logger.close()
    for name, ring in rings[0].items():
        same = (torch.allclose(ring, rings[1][name], rtol=1e-4, atol=1e-6)
                if name == "priority" else torch.equal(ring, rings[1][name]))
        check(same, f"fused parity: ring {name} differs")
    check(bool(rings[0]["done"].any()), "fused parity: no episode ended")
    check(not interleave or bool(rings[0]["priority"].sum() > 0),
          "fused parity: no actor-side priority stored")
    _compare_updates("interleaved fused superstep with priorities"
                     if interleave else "fused superstep", out, 1e-4)


def phase_env_parity(steps: int = 150, E: int = 64):
    """Every device env on the card vs on the CPU: the same actions and
    the same injected draws for `steps` steps with a short time limit;
    every state field, reward, flag and the final observation must be
    bit-equal (CartPole, float math: to 1e-5)."""
    import torch
    from rltime_tpu_torch.envs.device import DeviceCartPole
    from rltime_tpu_torch.envs.minatar import MINATAR_ENVS
    envs = dict(MINATAR_ENVS, cartpole=DeviceCartPole)
    g = torch.Generator().manual_seed(0)
    for name, cls in envs.items():
        env = cls(time_limit=40)
        reset = env.reset_draws(E, g, "cpu")
        states = {dev: env.reset(E, _to_device(reset, dev), dev)
                  for dev in ("cpu", "cuda")}
        n_done = 0
        for t in range(steps):
            draws = env.step_draws(E, g, "cpu")
            actions = torch.randint(0, env.num_actions, (E,), generator=g,
                                    dtype=torch.int32)
            outs = {}
            for dev in ("cpu", "cuda"):
                states[dev], *outs[dev] = env.step(
                    states[dev], actions.to(dev), _to_device(draws, dev))
            both = [dict(states[dev], reward=outs[dev][0],
                         terminated=outs[dev][1], truncated=outs[dev][2])
                    for dev in ("cpu", "cuda")]
            for k, v in both[0].items():
                w = both[1][k].cpu()
                same = (torch.allclose(v, w, rtol=1e-5, atol=1e-5)
                        if name == "cartpole" and v.is_floating_point()
                        else torch.equal(v, w))
                check(same, f"env parity: {name}.{k} differs at step {t}")
            n_done += int((outs["cpu"][1] | outs["cpu"][2]).sum())
        obs = [env.observe(states[dev]).cpu() for dev in ("cpu", "cuda")]
        check(torch.allclose(obs[0].float(), obs[1].float(), atol=1e-5),
              f"env parity: {name} observation differs")
        check(n_done > 0, f"env parity: {name} never reset")
        print(f"env parity cuda vs cpu: {name} equal over {steps} steps of "
              f"{E} lanes ({n_done} resets)", flush=True)


def phase_dqn_options(smi: str):
    """Phase 9: the config-#2 path with its options, then with
    Q(lambda)."""
    import torch
    from rltime_tpu_torch.training.learner import CenteredRMSProp
    from rltime_tpu_torch.utils.transcript import Transcript
    trainer, launches = run_path(DQN_OPTIONS_PATH)
    n = DQN_OPTIONS_PATH["updates"]
    check(launches == {"union_gather": n, "window_gather": n},
          f"options: launches {launches} in {n} updates, expected one "
          "union_gather and one window_gather per update")
    mc, rc = trainer.model_cfg, trainer.replay_cfg
    check(mc.channels_last and mc.space_to_depth and rc.sampler == "tree"
          and rc.use_inserted_priorities, f"options not set: {mc} {rc}")
    conv0 = trainer.train_state.model.torso.convs[0]
    check(tuple(conv0.weight.shape) == (32, 64, 2, 2)
          and conv0.stride == (1, 1), f"conv_0 {tuple(conv0.weight.shape)}")
    opt = trainer.train_state.optimizer
    check(isinstance(opt, CenteredRMSProp)
          and all(bool(st["nu"].sum() > 0) for st in opt.state.values()),
          "RMSProp state empty")
    rs = trainer.replay_state
    check(rs.tree.shape == (2 * 64 * 4096,) and math.isclose(
        rs.tree[1].item(), rs.tree[64 * 4096:].sum().item(), rel_tol=1e-4),
        "sum tree: root is not the sum of the leaves")
    check(bool(rs.storage["priority"][:, :rs.t].sum() > 0)
          and rs.max_priority.item() != 1.0,
          "actor-side priorities did not reach the replay")
    path = Path(trainer.result_dir) / "transcript.jsonl"
    records = Transcript.load(str(path)).records
    chunks = rs.t // trainer.loop_cfg.chunk_len
    check(len(records) == chunks and sum("leaves" in r for r in records)
          == n // trainer.loop_cfg.updates_per_chunk,
          f"transcript: {len(records)} records for {chunks} chunks")
    print(f"options run: conv_0 (32, 64, 2, 2) NHWC, RMSProp, sum tree of "
          f"{rs.tree.shape[0]} nodes, actor-side priorities (max_priority "
          f"{rs.max_priority.item():.6g}), {len(records)} transcript records",
          flush=True)
    phase_steady_state(trainer, smi, chunks=4, profiled=2)
    del trainer
    torch.cuda.empty_cache()
    option_launches = launches

    trainer, launches = run_path(DQN_LAMBDA_PATH)
    n = DQN_LAMBDA_PATH["updates"]
    check(trainer.algo_cfg.use_lambda
          and launches == {"union_gather": 0, "window_gather": n},
          f"Q(lambda): launches {launches} in {n} updates, expected one "
          "window_gather per update and no union_gather")
    phase_steady_state(trainer, smi, chunks=4, profiled=2)
    return option_launches, launches


def phase_cartpole():
    """Phase 10: config #1's two presets as written, cut in length, then
    the eval entry point on what each wrote."""
    import torch
    from rltime_tpu_torch import eval as eval_lib
    from rltime_tpu_torch import train
    from rltime_tpu_torch.ops import gather
    from rltime_tpu_torch.training import checkpoint as ckpt_lib
    keys = {"episodes", "return_mean", "return_median", "return_min",
            "return_max", "checkpoint_step"}
    for preset, steps in (("cartpole_dqn", 8_192),
                          ("cartpole_dqn_device", 8_192)):
        result_dir = ROOT / "results" / f"chip_smoke_{preset}"
        shutil.rmtree(result_dir, ignore_errors=True)
        gather.reset_counts()
        t0 = time.perf_counter()
        trainer = train.run([preset, "--device", "cuda", "--result-dir",
                             str(result_dir),
                             f"--train.total_env_steps={steps}",
                             "--train.log_interval=2048"])
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        n_upd = trainer.updates_done
        check(trainer.device.type == "cuda"
              and not trainer.replay_cfg.prioritized
              and trainer.replay_state.tree.shape == (1,),
              f"{preset}: not uniform replay on cuda")
        check(n_upd > 0 and gather.LAUNCHES == {
            "union_gather": 0, "window_gather": n_upd}
            and not any(gather.PLAIN_CALLS.values()),
            f"{preset}: {n_upd} updates, launches {gather.LAUNCHES}, plain "
            f"{gather.PLAIN_CALLS}")
        loss = trainer.last_metrics["loss"].item()
        check(math.isfinite(loss), f"{preset}: loss {loss}")
        latest = ckpt_lib.latest_step(str(result_dir))
        reports = {}
        for best in (False, True):
            rep = eval_lib.evaluate(str(result_dir), episodes=8, best=best,
                                    device="cuda")
            want = (ckpt_lib.best_step(str(result_dir)) or {}).get(
                "step", latest) if best else latest
            check(set(rep) == keys and rep["episodes"] == 8
                  and rep["checkpoint_step"] == want
                  and math.isfinite(rep["return_mean"])
                  and rep["return_min"] >= 1,
                  f"{preset}: eval report {rep} (best={best})")
            reports[best] = rep
        print(f"{preset}: {trainer.actor.env_steps} env steps, {n_upd} "
              f"updates in {wall:.2f} s (uniform replay, one window_gather "
              f"per update), last loss {loss:.6g}; eval latest "
              f"{json.dumps(reports[False])}; eval --best "
              f"{json.dumps(reports[True])}", flush=True)


def phase_fused_options(smi: str):
    """Phase 11: the fused trainer's options, each captured, with a
    replayed superstep during which any host sync raises."""
    import torch
    from rltime_tpu_torch.config.config import apply_overrides, load_config
    from rltime_tpu_torch.ops import gather
    from rltime_tpu_torch.parallel.fused import FusedApexTrainer
    from rltime_tpu_torch.utils.graphs import GraphedStep
    common = ["replay.use_inserted_priorities=true",
              "train.total_env_steps=1000000000",
              "train.log_interval=1000000000"]
    cases = (("minatar_breakout_dqn", "interleaved + priorities",
              ["train.interleave_updates=true",
               "train.supersteps_per_dispatch=1"], 3),
             ("minatar_breakout_iqn", "IQN + priorities + sum tree",
              ["replay.sampler=tree", "train.supersteps_per_dispatch=1"], 0))
    for preset, what, extra, timed in cases:
        cfg = apply_overrides(load_config(preset), common + extra)
        result_dir = ROOT / "results" / f"chip_smoke_fused_options_{preset}"
        shutil.rmtree(result_dir, ignore_errors=True)
        trainer = FusedApexTrainer(cfg, str(result_dir), device="cuda")
        lc = trainer.loop_cfg
        check(trainer.replay_cfg.chunk_len == (1 if lc.interleave_updates
                                               else lc.chunk_len),
              f"{what}: replay chunk_len {trainer.replay_cfg.chunk_len}")
        gather.reset_counts()
        GraphedStep.debug = True
        try:
            # warmup, the two eager supersteps, the capture
            while trainer.graph.graph is None:
                m = trainer.superstep()
        finally:
            GraphedStep.debug = False
        torch.cuda.set_sync_debug_mode("error")
        try:
            m = trainer.superstep()         # a replay
        finally:
            torch.cuda.set_sync_debug_mode("default")
        torch.cuda.synchronize()
        loss = m["loss"].item()
        check(math.isfinite(loss), f"{what}: loss {loss}")
        check(not any(gather.PLAIN_CALLS.values()),
              f"{what}: plain calls {gather.PLAIN_CALLS}")
        launches, nodes = graph_launches(trainer, f"{preset}_options",
                                         dict(gather.LAUNCHES))
        check(launches == {"union_gather": 0,
                           "window_gather": trainer.updates_done},
              f"{what}: launches {launches} in {trainer.updates_done} "
              "updates")
        rs = trainer.replay_state
        check(bool(rs.storage["priority"][:, :min(rs.t, 512)].sum() > 0)
              and rs.t == trainer.env_steps // trainer.num_envs,
              f"{what}: priorities or cursor wrong (t = {rs.t})")
        print(f"no-sync check ({preset}, {what}): one replayed superstep "
              f"ran under set_sync_debug_mode('error'); {trainer.updates_done} "
              f"updates, one window_gather each (graph kernel nodes "
              f"{nodes}); last loss {loss:.6g}", flush=True)
        if timed:
            L, E = lc.chunk_len, trainer.num_envs
            t0 = time.perf_counter()
            for _ in range(timed):
                trainer.superstep()
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            print(f"steady state fused, {what} ({timed} warm supersteps of "
                  f"{L} x {{act, insert, {lc.updates_per_chunk // L} "
                  f"updates}}): {timed * L * E / wall:.1f} env-steps/s, "
                  f"{timed * lc.updates_per_chunk / wall:.2f} updates/s, "
                  f"{wall / timed * 1e3:.2f} ms/superstep  [{smi}]",
                  flush=True)
        trainer.logger.close()
        del trainer
        torch.cuda.empty_cache()


def phase_sum_tree_parity():
    """The sum tree on the card vs on the CPU, bit-equal on dyadic
    priorities: writes with duplicates (last wins), with `unique`, an
    out-of-range index, then the leaves sampled on the same uniforms."""
    import torch
    from rltime_tpu_torch.ops import sum_tree
    g = torch.Generator().manual_seed(0)
    N, B = 5000, 256
    prio = torch.randint(0, 64, (N,), generator=g).float() / 8.0
    dup = torch.randint(0, 300, (B,), generator=g)
    dup[:3] = torch.tensor([N + 5000, -1, 8191])
    p_dup = torch.randint(0, 64, (B,), generator=g).float() / 8.0
    u = torch.rand((B,), generator=g)
    out = []
    for dev in ("cpu", "cuda"):
        t = sum_tree.set_priorities(sum_tree.init(N, dev),
                                    torch.arange(N, device=dev),
                                    prio.to(dev), unique=True)
        t = sum_tree.set_priorities(t, dup.to(dev), p_dup.to(dev))
        leaf, p = sum_tree.sample(t, u.to(dev))
        out.append((t.cpu(), leaf.cpu(), p.cpu()))
    for a, b, what in zip(*out, ("tree", "leaves", "priorities")):
        check(torch.equal(a, b), f"sum tree parity: {what} differ")
    check(bool((out[0][2] > 0).all()), "sum tree parity: a zero leaf sampled")
    print(f"sum tree parity cuda vs cpu: tree of {out[0][0].shape[0]} nodes "
          f"and {B} sampled leaves bit-equal (dyadic priorities)", flush=True)


# config #5 at full width (32 lanes x 4,096 columns of 84x84 uint8, batch
# 64, K=2): a chunk is 32 x 32 = 1,024 env steps; chunks 5..12 (env steps
# 5,120..12,288 after their rollout) run K=2 updates
APEX_PATH = dict(preset="apex_multihost_counting", steps=12_288,
                 warmup=5_120, updates=16, chunks=12)
# the shapes the config-#5 update gives the two kernels (one rank)
APEX_K2_TAG = "stacks B=64 F=4 n=3 84x84 u8 (32 x 4096 ring)"
APEX_K1_TAG = "multi B=64 config-#5 update (4 segments, 32 x 4096 rings)"


def _state_equal(a, b):
    import torch
    return all(torch.equal(x, y) for x, y in zip(a.values(), b.values()))


def _warm_chunks(trainer, chunks: int):
    """`chunks` more chunks of a host trainer (apex or default), timed by
    the host clock to a synchronise: (env-steps/s, act ms per chunk, ms
    per update of the update phase)."""
    import torch
    lc = trainer.loop_cfg
    steps = chunks * lc.chunk_len * trainer.env.num_envs
    trainer.timers.pop()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(chunks):
        trainer.train_chunk()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    ph = trainer.timers.pop()
    upd = ph.get("update", ph.get("insert+update", 0.0))
    return (steps / wall, ph["act"] / chunks * 1e3,
            upd / (chunks * lc.updates_per_chunk) * 1e3)


def phase_apex_kernels(smi: str, kern: dict):
    """Phase 12's kernel checks: both kernels at the shapes the config-#5
    update launches them with, filed into `kern`. They run right after
    phase 2, not in phase 12: there, late in the run, torch.profiler
    returned empty traces for a lone 3 µs kernel (two runs on an H100:
    every trace of 5 calls in one, half of the one-call traces in the
    other),
    and the times come from it."""
    import torch
    dev = torch.device("cuda", 0)
    # both kernels at the shapes the apex update launches them with,
    # on one rank's ring (32 lanes x 4,096 columns of 84x84 uint8): K2's
    # stacks at B=64, F=4, n=3 (the counting env's done rate, one episode
    # end in 27 steps, then one that cuts every slot), and K1's launch for
    # the update's 4 segments (three n = 3 strips and the action)
    k = kernel_checks(kern, torch.Generator(device=dev).manual_seed(5), smi)
    E, T = 32, 4096
    ring = k.rand((E, T, 84, 84), torch.uint8)
    done = k.rand_done(E, T, 1 / 27)
    k.compare_stacks(APEX_K2_TAG, ring, done, 64, 4, 3, every_cut=False)
    k.compare_stacks("stacks B=64 F=4 n=3 84x84 u8 (32 x 4096 ring), done "
                     "rate 0.25", ring, k.rand_done(E, T, 0.25), 64, 4, 3)
    del ring
    k.compare_multi(APEX_K1_TAG, [
        (torch.randn((E, T), generator=k.g, device=dev), 0, 3), (done, 0, 3),
        (k.rand((E, T), torch.bool), 0, 3),
        (k.rand((E, T), torch.int32), 0, 1)], 64)
    del done, k
    torch.cuda.empty_cache()


def phase_distribution(smi: str):
    """Phase 12: the distribution layer on a one-rank NCCL group."""
    import tempfile
    import torch
    import torch.distributed as dist
    from rltime_tpu_torch import train
    from rltime_tpu_torch.config.config import apply_overrides, load_config
    from rltime_tpu_torch.ops import gather
    from rltime_tpu_torch.parallel import census
    from rltime_tpu_torch.parallel.apex import ApexTrainer
    from rltime_tpu_torch.parallel.fused import FusedApexTrainer
    from rltime_tpu_torch.parallel.mesh import identity_mesh, make_mesh
    from rltime_tpu_torch.training.trainer import Trainer
    t_phase = time.perf_counter()
    dev = torch.device("cuda", 0)
    # bit-equality across runs needs deterministic cuDNN algorithms (the
    # default picks by speed, and some reduce in a varying order)
    det = torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark
    torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = (
        True, False)
    rdv = tempfile.mkdtemp(prefix="chip_smoke_rdv_")
    dist.init_process_group("nccl", init_method=f"file://{rdv}/f",
                            world_size=1, rank=0, device_id=dev)
    try:
        mesh = make_mesh(dev, size=1)
        check(mesh.distributed and mesh.backend == "nccl",
              f"not a one-rank NCCL mesh: {mesh}")
        # 1) config #5 through the CLI's entry point on the NCCL mesh
        p = APEX_PATH
        result_dir = ROOT / "results" / "chip_smoke_apex"
        shutil.rmtree(result_dir, ignore_errors=True)
        argv = [p["preset"], "--device", "cuda", "--result-dir",
                str(result_dir), f"--train.warmup_env_steps={p['warmup']}",
                f"--train.total_env_steps={p['steps']}"]
        gather.reset_counts()
        census.reset_counts()
        t0 = time.perf_counter()
        tr = train.run(argv)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches, plain = dict(gather.LAUNCHES), dict(gather.PLAIN_CALLS)
        ents = census.entries()
        phases = tr.timers.pop()
        n = p["updates"]
        check(isinstance(tr, ApexTrainer) and tr.mesh.backend == "nccl"
              and tr.updates_done == n and tr.global_env_steps == p["steps"],
              f"apex: {type(tr).__name__} on {tr.mesh}, {tr.updates_done} "
              "updates")
        check(launches == {"union_gather": n, "window_gather": n}
              and not any(plain.values()),
              f"apex: launches {launches} in {n} updates, plain {plain}")
        rs = tr.replay_state
        check(rs.storage["obs"].shape == (32, 4096, 84, 84)
              and rs.t == p["steps"] // 32, f"apex ring {rs.storage['obs'].shape}"
              f" t={rs.t}")
        mc, ac = tr.model_cfg, tr.algo_cfg
        check((mc.torso, mc.head, mc.compute_dtype, ac.batch_size, ac.n_step,
               tr.frame_stack) == ("nature_cnn", "dueling", "bfloat16", 64, 3,
                                   4), f"not config #5's shapes: {mc} {ac}")
        for k in ("loss", "grad_norm", "td_abs", "q"):
            v = tr.last_metrics[k].item()
            check(math.isfinite(v), f"apex: last {k} = {v}")
        n_params = sum(q.numel() for q in tr.train_state.model.parameters())
        sites = {(e["op"], e["site"], e["group"], e["bytes"]): e["count"]
                 for e in ents}
        want = {("all_reduce", "grad", "device", 4 * n_params): n,
                ("all_reduce", "metrics", "device", 20): n,
                ("all_reduce", "max_priority", "device", 4): n + p["chunks"]}
        check(sites == want, f"apex census {sites}, expected {want}:\n"
              + census.summarize(ents))
        print(f"{p['preset']} on a one-rank NCCL mesh: {p['steps']} env "
              f"steps, {n} updates, launches {launches}; census: "
              f"{n} gradient all-reduces of {4 * n_params} B, {n} metric "
              f"buffers of 20 B, {n + p['chunks']} max_priority MAXes of 4 B, "
              "nothing else; last loss "
              f"{tr.last_metrics['loss'].item():.6g}", flush=True)
        upd_s = phases["update"]
        print(f"{p['preset']} rates: {p['steps'] / wall:.1f} env-steps/s over "
              f"the {wall:.3f} s run (act {phases['act']:.3f} s, insert "
              f"{phases['insert']:.3f} s, update {upd_s:.3f} s); "
              f"{n / upd_s:.2f} updates/s over the update phase "
              f"({upd_s / n * 1e3:.2f} ms/update)  [{smi}]", flush=True)

        # 2) the same run through the identity mesh: the learner bit-equal
        cfg = copy.deepcopy(tr.config)
        again_dir = ROOT / "results" / "chip_smoke_apex_identity"
        shutil.rmtree(again_dir, ignore_errors=True)
        ref = ApexTrainer(cfg, str(again_dir), device=dev,
                          mesh=identity_mesh(dev)).train()
        check(ref.updates_done == n and _state_equal(
            tr.train_state.model.state_dict(),
            ref.train_state.model.state_dict())
            and torch.equal(tr.replay_state.tree, ref.replay_state.tree),
            "apex: the NCCL mesh and the identity mesh differ")
        print(f"apex: the same {n} updates through the identity mesh: "
              "learner parameters and priorities bit-equal", flush=True)
        # warm windows of 4 chunks (8 updates), in turns: 6 pairs in
        # ABBA order, so drift of the host favours neither mesh
        warm = {"nccl": [], "identity": []}
        order = (("nccl", tr), ("identity", ref))
        for i in range(6):
            for tag, t in (order if i % 2 == 0 else order[::-1]):
                warm[tag].append(_warm_chunks(t, 4))
        for tag, w in warm.items():
            print(f"apex warm, {tag} mesh ({len(w)} windows of 4 chunks, "
                  "ABBA): " + "; ".join(
                      f"{r:.1f} env-steps/s, act {a:.2f} ms/chunk, "
                      f"{u:.2f} ms/update" for r, a, u in w)
                  + f"; medians {statistics.median(x[0] for x in w):.1f} "
                  f"env-steps/s, act {statistics.median(x[1] for x in w):.2f}"
                  f" ms/chunk, {statistics.median(x[2] for x in w):.2f} "
                  f"ms/update  [{smi}]", flush=True)
        # the device's side of one chunk (act, insert, 2 updates) on each
        busy = {}
        for tag, t in order + order[::-1]:
            _, ms, per_name = device_profile(t.train_chunk, runs=2)
            nccl_ms = sum(v for kname, v in per_name.items()
                          if "nccl" in kname.lower())
            busy.setdefault(tag, []).append((ms, nccl_ms))
        print("apex device-busy ms per chunk (torch.profiler, 2 chunks, "
              "twice each): " + "; ".join(
                  f"{tag} " + ", ".join(f"{m:.3f} (NCCL kernels {c:.3f})"
                                        for m, c in v)
                  for tag, v in busy.items()) + f"  [{smi}]", flush=True)
        del tr, ref
        torch.cuda.empty_cache()

        # 3) the fused trainer through the NCCL mesh, captured with its
        # all-reduces: a replayed superstep with no host sync, counted by
        # the census, bit-equal to the same superstep without a mesh
        fcfg = apply_overrides(load_config(FUSED_PATH["preset"]), [
            "train.supersteps_per_dispatch=1", "train.warmup_env_steps=8193",
            "train.total_env_steps=1000000000",
            "train.log_interval=1000000000"])
        runs = []
        for tag, m in (("nccl", mesh), ("identity", identity_mesh(dev))):
            d = ROOT / "results" / f"chip_smoke_fused_{tag}"
            shutil.rmtree(d, ignore_errors=True)
            ft = FusedApexTrainer(fcfg, str(d), device=dev, mesh=m)
            # the warm chunk, two eager supersteps, the capture
            while ft.graph.graph is None:
                ft.superstep()
            torch.cuda.synchronize()
            census.reset_counts()
            if tag == "nccl":
                torch.cuda.set_sync_debug_mode("error")
            try:
                mm = ft.superstep()              # a replay
            finally:
                torch.cuda.set_sync_debug_mode("default")
            torch.cuda.synchronize()
            runs.append((ft, mm, census.entries()))
        (a, ma, ents), (b, mb, ents_b) = runs
        check(a.updates_done == b.updates_done == 4 * 64
              and a.graph.replays == b.graph.replays == 2
              and _state_equal(a.train_state.model.state_dict(),
                               b.train_state.model.state_dict())
              and torch.equal(a.replay_state.tree, b.replay_state.tree)
              and all(torch.equal(ma[k], mb[k]) for k in ma),
              "fused: the NCCL replay and the replay without a mesh differ")
        check(sum(e["count"] for e in ents if e["site"] == "grad") == 64
              and not ents_b, f"fused census {ents} / {ents_b}")
        print(f"fused on the NCCL mesh, captured: one replayed superstep (64 "
              f"updates, {sum(e['count'] for e in ents)} collectives by the "
              "census: " + "; ".join(f"{e['count']} x {e['op']} {e['site']}"
                                     for e in ents) + ") ran under "
              "set_sync_debug_mode('error'), bit-equal to the replay "
              "without a mesh", flush=True)
        for ft, _, _ in runs:
            ft.logger.close()
        del runs, a, b
        torch.cuda.empty_cache()
    finally:
        dist.destroy_process_group()
        shutil.rmtree(rdv, ignore_errors=True)
        torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = (
            det)

    # 4) config #2 with async acting beside the synchronous trainer:
    # warm windows of 8 chunks after the warmup and 2 trained chunks
    rates = {}
    for tag, extra in (("sync", []), ("async", ["train.async_acting=true"])):
        cfg = apply_overrides(load_config(DQN_PATH["preset"]), [
            "train.warmup_env_steps=8192", "train.total_env_steps=1000000000",
            "train.log_interval=1000000000", *extra])
        d = ROOT / "results" / f"chip_smoke_pong_{tag}"
        shutil.rmtree(d, ignore_errors=True)
        tr = Trainer(cfg, str(d), device="cuda")
        while tr.updates_done < 4:
            tr.train_chunk()
        if tr.pool is not None:
            tr.pool.depth_sum = tr.pool.gets = 0
        rates[tag] = _warm_chunks(tr, 8)
        check(math.isfinite(tr.last_metrics["loss"].item()),
              f"{tag}: loss {tr.last_metrics['loss'].item()}")
        if tr.pool is not None:
            pool = tr.pool
            pool.close()
            check(not pool.alive and pool.version >= 8,
                  f"async pool alive after close, or {pool.version} "
                  "publishes")
        tr.logger.close()
        del tr
        torch.cuda.empty_cache()
    print("pong_dqn_counting, 8 warm chunks: "
          + "; ".join(f"{tag} {r:.1f} env-steps/s (act {a:.2f} ms/chunk, "
                      f"{u:.2f} ms/update)" for tag, (r, a, u)
                      in rates.items())
          + f"; async queue depth {pool.mean_depth:.2f} of 2 on average "
          f"over {pool.gets} chunks, {pool.version} publishes  [{smi}]",
          flush=True)

    # 5) the multi-rank CLI on one rank, in a process of its own
    import socket
    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    d = ROOT / "results" / "chip_smoke_train_distributed"
    shutil.rmtree(d, ignore_errors=True)
    out = subprocess.run(
        [sys.executable, "-m", "rltime_tpu_torch.train_distributed",
         APEX_PATH["preset"], "--coordinator", f"localhost:{port}",
         "--num-processes", "1", "--process-id", "0", "--device", "cuda",
         "--result-dir", str(d), "--train.warmup_env_steps=2048",
         "--train.total_env_steps=4096"], cwd=ROOT, capture_output=True,
        text=True, timeout=300)
    check(out.returncode == 0 and "done: 6 updates on each of 1 ranks"
          in out.stdout, f"train_distributed: rc {out.returncode}\n"
          f"{out.stdout[-2000:]}\n{out.stderr[-2000:]}")
    print(f"train_distributed {APEX_PATH['preset']} on one NCCL rank (a "
          "subprocess): 4,096 env steps, 6 updates, checkpoint written",
          flush=True)
    print(f"phase 12 took {time.perf_counter() - t_phase:.1f} s", flush=True)
    return launches


def _trace_split(trace_dir: Path, chunks: int):
    """Read one torch.profiler trace of `chunks` trainer chunks: ms per
    chunk of each `phase/<name>` range, device-busy ms per chunk (union
    of kernels, copies and sets) and the traced wall ms per chunk."""
    files = sorted(trace_dir.glob("*.json"))
    check(len(files) == 1, f"trace: {len(files)} files in {trace_dir}")
    events = json.loads(files[0].read_text())["traceEvents"]
    phases: dict = {}
    spans, lo, hi = [], float("inf"), float("-inf")
    for e in events:
        if e.get("ph") != "X":
            continue
        a, b = float(e["ts"]), float(e["ts"]) + float(e.get("dur", 0))
        if e.get("cat") == "user_annotation" and e["name"].startswith(
                "phase/"):
            phases[e["name"][6:]] = phases.get(e["name"][6:], 0.0) + b - a
            lo, hi = min(lo, a), max(hi, b)
        elif e.get("cat") in ("kernel", "gpu_memcpy", "gpu_memset"):
            spans.append((a, b))
    check(bool(spans) and "act" in phases,
          f"trace: {len(spans)} device events, phase ranges {sorted(phases)}")
    busy, end = 0.0, float("-inf")
    for a, b in sorted(spans):
        if b > end:
            busy += b - max(a, end)
            end = b
    return ({k: v / 1e3 / chunks for k, v in phases.items()},
            busy / 1e3 / chunks, (hi - lo) / 1e3 / chunks, len(events))


def phase_atari_native(smi: str):
    """Phase 13: the host env engine under configs #2, #4 and #5, the
    torch.profiler trace, and the dryrun entry points."""
    import numpy as np
    import torch
    from rltime_tpu_torch import dryrun, train
    from rltime_tpu_torch.envs.native import bindings
    from rltime_tpu_torch.ops import gather
    from rltime_tpu_torch.parallel.apex import ApexTrainer
    from rltime_tpu_torch.utils import profiling
    t_phase = time.perf_counter()
    backend = bindings.atari_backend()
    print(f"atari_native backend: {backend}", flush=True)
    check(backend == "synthetic", "this machine has no ALE headers, yet the "
          f"native library reports {backend!r}")

    # the engine alone: 64 lanes, random actions, no policy
    rng = np.random.default_rng(0)
    for threads in (0, 1):
        env = bindings.NativeAtariVecEnv(64, rom="pong", seed=0,
                                         num_threads=threads)
        env.reset()
        steps = 400 if threads == 0 else 100
        acts = rng.integers(0, env.spec.num_actions, (steps + 20, 64))
        for a in acts[:20]:
            env.step(a)
        t0 = time.perf_counter()
        for a in acts[20:]:
            env.step(a)
        rate = steps * 64 / (time.perf_counter() - t0)
        used = threads or max(1, min(os.cpu_count() or 1, 64 // 8))
        print(f"atari_native engine alone: 64 lanes on {used} lane threads, "
              f"{rate:.1f} env-steps/s over {steps} steps ({len(env.pop_completed_scores())}"
              f" games ended; host of {os.cpu_count()} cores)  [{smi}]",
              flush=True)
        env.close()

    # config #2 over the native lanes, counted as phase 3 is
    p = NATIVE_DQN_PATH
    trainer, launches = run_path(p)
    n = p["updates"]
    check(launches == {"union_gather": n, "window_gather": n},
          f"{p['tag']}: launches {launches} in {n} updates, expected one "
          "union_gather and one window_gather per update")
    check(type(trainer.env).__name__ == "NativeAtariVecEnv"
          and trainer.env.num_envs == 64, f"{p['tag']}: env {trainer.env}")
    lines = [json.loads(x) for x in (
        ROOT / "results" / f"chip_smoke_{p['tag']}" / "scalars.jsonl"
    ).read_text().splitlines()]
    scores = [x["episode_score_mean"] for x in lines
              if "episode_score_mean" in x]
    check(bool(scores), f"{p['tag']}: no episode_score_mean in {len(lines)} "
          "log lines")
    print(f"{p['tag']}: episode_score_mean {scores} (true game scores) "
          f"beside episode_return_mean "
          f"{[x.get('episode_return_mean') for x in lines]} (per-life, "
          "clipped)", flush=True)
    phase_steady_state(trainer, smi, chunks=8, profiled=3)
    # the same warm chunks through utils/profiling.trace: a non-empty trace
    trace_dir = ROOT / "results" / "chip_smoke_trace"
    shutil.rmtree(trace_dir, ignore_errors=True)
    t0 = time.perf_counter()
    with profiling.trace(str(trace_dir)):
        for _ in range(3):
            trainer.train_chunk()
        torch.cuda.synchronize()
    wall = (time.perf_counter() - t0) / 3 * 1e3
    trainer.timers.pop()
    split, busy, traced, n_events = _trace_split(trace_dir, 3)
    print(f"{p['tag']} trace (utils/profiling.trace, 3 warm chunks, "
          f"{n_events} events): per chunk "
          + ", ".join(f"{k} {v:.2f} ms" for k, v in sorted(split.items()))
          + f"; device busy {busy:.3f} ms of {traced:.2f} ms traced "
          f"({busy / traced:.1%}); {wall:.2f} ms per traced chunk on the "
          f"host clock  [{smi}]", flush=True)
    del trainer
    torch.cuda.empty_cache()

    by_path = {p["tag"]: launches}
    # config #4 over the native lanes: one window_gather per update
    trainer, launches = run_path(NATIVE_R2D2_PATH)
    by_path[NATIVE_R2D2_PATH["tag"]] = launches
    n = NATIVE_R2D2_PATH["updates"]
    check(launches == {"union_gather": 0, "window_gather": n},
          f"{NATIVE_R2D2_PATH['tag']}: launches {launches} in {n} updates")
    check(trainer.model_cfg.lstm_size == 512
          and trainer.replay_state.storage["rnn_c"].shape == (64, 4096, 512),
          f"{NATIVE_R2D2_PATH['tag']}: not config #4's model or carry ring")
    del trainer
    torch.cuda.empty_cache()

    # config #5 over the native lanes on one rank (no process group)
    p = NATIVE_APEX_PATH
    result_dir = ROOT / "results" / f"chip_smoke_{p['tag']}"
    shutil.rmtree(result_dir, ignore_errors=True)
    gather.reset_counts()
    t0 = time.perf_counter()
    tr = train.run([p["preset"], "--device", "cuda", "--result-dir",
                    str(result_dir), f"--train.warmup_env_steps={p['warmup']}",
                    f"--train.total_env_steps={p['steps']}", *p["overrides"]])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches, plain = dict(gather.LAUNCHES), dict(gather.PLAIN_CALLS)
    n = p["updates"]
    check(isinstance(tr, ApexTrainer) and tr.updates_done == n
          and tr.global_env_steps == p["steps"]
          and type(tr.env).__name__ == "NativeAtariVecEnv",
          f"{p['tag']}: {type(tr).__name__}, {tr.updates_done} updates")
    check(launches == {"union_gather": n, "window_gather": n}
          and not any(plain.values()),
          f"{p['tag']}: launches {launches} in {n} updates, plain {plain}")
    check(tr.replay_state.storage["obs"].shape == (32, 4096, 84, 84)
          and tr.algo_cfg.batch_size == 64, f"{p['tag']}: not config #5")
    for k in ("loss", "grad_norm", "td_abs", "q"):
        v = tr.last_metrics[k].item()
        check(math.isfinite(v), f"{p['tag']}: last {k} = {v}")
    ph = _run_phases(tr, result_dir)
    print(f"{p['tag']}: {p['steps']} env steps, {n} updates, launches "
          f"{launches}, plain calls {plain}; {p['steps'] / wall:.1f} "
          f"env-steps/s over the {wall:.3f} s run (act {ph['act']:.3f} s, "
          f"update {ph['update']:.3f} s)  [{smi}]", flush=True)
    by_path[p["tag"]] = launches
    del tr
    torch.cuda.empty_cache()

    # the dryrun entry points: entry() on the card against the CPU, then
    # every training leg on a one-rank NCCL group
    fn, (params, obs) = dryrun.entry()
    cfn, (cparams, _) = dryrun.entry("cpu")
    check(all(torch.equal(params[k].cpu(), cparams[k]) for k in params),
          "entry(): the card's and the CPU's initial parameters differ")
    frames = torch.randint(0, 256, tuple(obs.shape), dtype=torch.uint8,
                           generator=torch.Generator().manual_seed(0))
    q = fn(params, frames.to(obs.device))
    q_cpu = cfn(cparams, frames)
    err = (q.cpu() - q_cpu).abs().max().item()
    check(q.shape == (128, 6) and bool(torch.isfinite(q).all())
          and err <= 1e-2, f"entry(): card vs CPU max abs err {err} (bf16 "
          "tolerance 1e-2)")
    ev = median_ms(lambda: fn(params, obs), runs=20)
    print(f"entry(): Nature-CNN dueling bf16 forward, B=128: card vs CPU max "
          f"abs err {err:.3g} (tolerance 1e-2, |q| <= "
          f"{q_cpu.abs().max().item():.3g}); {ev:.4f} ms per call by CUDA "
          f"events  [{smi}]", flush=True)
    line = dryrun.dryrun_multichip(1)
    check(line.startswith("dryrun_multichip(1) OK:")
          and "'backend': 'nccl'" in line, f"dryrun: {line}")
    print(f"phase 13 took {time.perf_counter() - t_phase:.1f} s", flush=True)
    return by_path


def main() -> int:
    if not (ROOT / "rltime_tpu_torch" / "__init__.py").is_file():
        fail(f"no rltime_tpu_torch package beside {Path(__file__).name}")
    sys.path.insert(0, str(ROOT))
    import torch
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this smoke needs a GPU")
    smi = phase_environment()
    kern = phase_kernels(smi)
    phase_option_timings(smi)
    phase_apex_kernels(smi, kern)
    trainer, dqn_launches = phase_dqn_path()
    phase_steady_state(trainer, smi, chunks=8, profiled=3)
    del trainer
    torch.cuda.empty_cache()
    trainer, r2d2_launches = phase_r2d2_path()
    phase_steady_state(trainer, smi, chunks=8, profiled=3)
    del trainer
    torch.cuda.empty_cache()
    native_launches = phase_atari_native(smi)
    fused_launches, fused_nodes = phase_fused_path(smi)
    phase_fused_bench_shape(smi)
    fused_others = phase_fused_others()
    phase_fused_graph_parity(smi)
    torch.cuda.empty_cache()
    bench_launches = phase_bench_superstep(smi)
    phase_small_parity()
    phase_fused_parity()
    phase_fused_parity(interleave=True)
    phase_sum_tree_parity()
    phase_env_parity()
    # back to PyTorch's defaults, which the parity phases switched off
    torch.backends.cudnn.allow_tf32 = True
    option_launches, lambda_launches = phase_dqn_options(smi)
    torch.cuda.empty_cache()
    phase_cartpole()
    phase_fused_options(smi)
    apex_launches = phase_distribution(smi)

    def entry(name, source, replaces, by_path, main_path, main_tag, raw_tag,
              beside):
        """`launches` is the count on `main_path`'s counted run; the
        times and the bound are the kernel's at `main_tag`, the shape
        that path launches it with, and `shapes` holds them for every
        shape checked. `library_ms` is null there: no single PyTorch
        call computes the fused function. The library figures to hold
        the kernel against are `beside` (the PyTorch calls, or the
        one-field launches, that the fused entry point replaced, on the
        same inputs) and `raw_ms` beside `raw_library_ms` (the kernel's
        one-field entry and one `index_select` at `raw_shape`)."""
        shapes = kern[name]
        return {"name": name, "route": "cuda", "source": source,
                "replaces": replaces, "launches": by_path[main_path],
                "launches_by_path": by_path,
                "max_abs_err": max(v["max_abs_err"] for v in shapes.values()),
                "ms": shapes[main_tag]["ms"],
                "plain_ms": shapes[main_tag]["plain_ms"],
                "bound_ms": shapes[main_tag]["bound_ms"],
                "bound_by": "bytes",
                "library_ms": shapes[main_tag]["library_ms"],
                beside: shapes[main_tag][beside],
                "raw_shape": raw_tag, "raw_ms": shapes[raw_tag]["ms"],
                "raw_library_ms": shapes[raw_tag]["library_ms"],
                "shape": main_tag, "shapes": shapes}

    def by_path(name):
        return {DQN_PATH["preset"]: dqn_launches[name],
                R2D2_PATH["preset"]: r2d2_launches[name],
                FUSED_PATH["preset"]: fused_launches[name],
                f"{FUSED_PATH['preset']} (graph nodes per replay)":
                    fused_nodes[name],
                **{tag: n[name] for tag, (n, _) in fused_others.items()},
                **{f"{tag} (graph nodes per replay)": n[name]
                   for tag, (_, n) in fused_others.items()},
                DQN_OPTIONS_PATH["tag"]: option_launches[name],
                DQN_LAMBDA_PATH["tag"]: lambda_launches[name],
                APEX_PATH["preset"]: apex_launches[name],
                **{tag: n[name] for tag, n in native_launches.items()},
                **{tag: n[name] for tag, n in bench_launches.items()}}

    # a gather does no arithmetic: each is bound by the bytes it moves
    record = {"kernels": [
        entry("union_gather", "rltime_tpu_torch/csrc/union_gather.cu",
              "rltime_tpu/ops/pallas_gather.py:152",
              by_path("union_gather"), NATIVE_DQN_PATH["tag"], K2_MAIN_TAG,
              K2_RAW_TAG, "composition_ms"),
        entry("window_gather", "rltime_tpu_torch/csrc/window_gather.cu",
              "rltime_tpu/ops/pallas_gather.py:50",
              by_path("window_gather"), R2D2_PATH["preset"], K1_MAIN_TAG,
              K1_RAW_TAG, "separate_ms"),
    ]}
    for k in record["kernels"]:
        check(k["launches"] > 0, f"{k['name']} was not launched on its path")
    print(json.dumps(record), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
