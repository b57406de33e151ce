"""The port's CUDA kernels against their plain versions, on a GPU.

Every test here is marked `cuda` and skips itself where no card is
present. This file imports neither jax nor rltime_tpu, so it also runs
on a GPU machine without them:

    python -m pytest tests/test_torch_cuda.py -m cuda --noconftest -q
"""
import pytest
import torch

from rltime_tpu_torch.ops import gather


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run on the GPU machine)")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("row_shape,dtype", [((84, 84), torch.uint8),
                                             ((12, 16), torch.float32),
                                             ((5, 7), torch.uint8)])
def test_union_gather_kernel_matches_plain(cuda_device, row_shape, dtype):
    """Bit-exact, incl. negative col0 and windows across the ring seam;
    the (5, 7) uint8 row (35 B) is copied by bytes."""
    g = torch.Generator().manual_seed(0)
    E, T, B, W = 8, 128, 64, 7
    storage = torch.randint(0, 256, (E, T) + row_shape, generator=g)
    storage = storage.to(dtype).to(cuda_device)
    env = torch.randint(0, E, (B,), generator=g, dtype=torch.int32)
    col0 = torch.randint(-3, T, (B,), generator=g, dtype=torch.int32)
    col0[:2] = torch.tensor([-3, T - 2], dtype=torch.int32)
    env, col0 = env.to(cuda_device), col0.to(cuda_device)
    before = gather.LAUNCHES["union_gather"]
    out = gather.union_gather(storage, env, col0, W)
    torch.cuda.synchronize()
    assert gather.LAUNCHES["union_gather"] == before + 1
    assert torch.equal(out, gather.window_gather_reference(storage, env,
                                                           col0, W))


@pytest.mark.cuda
@pytest.mark.parametrize("row_shape,dtype,window", [
    ((84, 84), torch.uint8, 128),     # the R2D2 frame sequence
    ((), torch.float32, 125),         # 4-byte strips
    ((), torch.bool, 125),            # 1-byte strips
    ((512,), torch.float32, 1),       # the stored LSTM carry
    ((5, 7), torch.uint8, 33),        # odd row width: byte path
    ((10, 10, 4), torch.uint8, 65),   # MinAtar planes: 400-byte rows
    ((10, 10, 4), torch.uint8, 1),
    ((), torch.bool, 66),             # the fused R2D2 done window
])
def test_window_gather_kernel_matches_plain(cuda_device, row_shape, dtype,
                                            window):
    """Bit-exact, incl. negative col and windows across the ring seam."""
    g = torch.Generator().manual_seed(1)
    E, T, B = 4, 256, 64
    storage = torch.randint(0, 256, (E, T) + row_shape, generator=g)
    storage = storage.to(dtype).to(cuda_device)
    env = torch.randint(0, E, (B,), generator=g, dtype=torch.int32)
    col = torch.randint(-8, T, (B,), generator=g, dtype=torch.int32)
    col[:3] = torch.tensor([-3, T - 2, T - window // 2], dtype=torch.int32)
    env, col = env.to(cuda_device), col.to(cuda_device)
    before = dict(gather.LAUNCHES)
    out = gather.window_gather(storage, env, col, window)
    torch.cuda.synchronize()
    assert gather.LAUNCHES["window_gather"] == before["window_gather"] + 1
    assert gather.LAUNCHES["union_gather"] == before["union_gather"]
    assert torch.equal(out, gather.window_gather_reference(storage, env,
                                                           col, window))


def _rand(shape, dtype, g):
    r = torch.randint(0, 256, shape, generator=g)
    return (r & 1).bool() if dtype == torch.bool else r.to(dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("row_shape,dtype,F,n", [
    ((84, 84), torch.uint8, 4, 3),     # config #2
    ((12, 16), torch.float32, 4, 3),
    ((5, 7), torch.uint8, 4, 3),       # 35-byte rows: copied by bytes
    ((84, 84), torch.uint8, 3, 5),     # n > F: stacks do not overlap
    ((84, 84), torch.uint8, 16, 16),   # 32 union rows
    ((160, 160), torch.uint8, 4, 6),   # 25,600-byte rows: several rounds
    ((84, 84), torch.uint8, 30, 5),    # 35 union rows: two ballots
    ((84, 84), torch.uint8, 4, 29),
    ((5, 7), torch.uint8, 2, 63),      # 65 union rows: three ballots
])
def test_union_stack_gather_kernel_matches_plain(cuda_device, row_shape,
                                                 dtype, F, n):
    """Bit-exact (for floats: torch.equal, which equates the kernel's
    +0.0 with the plain version's x * 0), incl. col < F-1, windows
    across the seam and done flags at every slot."""
    g = torch.Generator().manual_seed(2)
    E, T, B = 4, 128, 96
    storage = _rand((E, T) + row_shape, dtype, g).to(cuda_device)
    done = (torch.rand((E, T), generator=g) < 0.25).to(cuda_device)
    env = torch.randint(0, E, (B,), generator=g, dtype=torch.int32)
    col = torch.randint(0, T, (B,), generator=g, dtype=torch.int32)
    col[:5] = torch.tensor([0, 1, F - 2, T - 1, T - n], dtype=torch.int32)
    env, col = env.to(cuda_device), col.to(cuda_device)
    ref_t, ref_tn = gather.union_stack_gather_reference(storage, done, env,
                                                        col, F, n)
    assert (ref_t.flatten(2) == 0).all(2).any()       # some rows were cut
    before = dict(gather.LAUNCHES)
    out_t, out_tn = gather.union_stack_gather(storage, done, env, col, F, n)
    torch.cuda.synchronize()
    assert gather.LAUNCHES == {
        "union_gather": before["union_gather"] + 1,
        "window_gather": before["window_gather"]}
    assert out_t.dtype == ref_t.dtype and out_t.shape == ref_t.shape
    assert torch.equal(out_t, ref_t) and torch.equal(out_tn, ref_tn)


@pytest.mark.cuda
@pytest.mark.parametrize("num_segments,launches", [(1, 1), (7, 1), (8, 1),
                                                   (9, 2), (17, 3)])
def test_window_gather_multi_kernel_matches_plain(cuda_device, num_segments,
                                                  launches):
    """Every segment bit-exact: mixed leads, windows, dtypes, row widths
    and ring lengths; more than 8 segments make several launches."""
    g = torch.Generator().manual_seed(3)
    E, B = 4, 64
    kinds = [((84, 84), torch.uint8, 256, 3, 128), ((), torch.bool, 256, 3, 128),
             ((), torch.int32, 256, 0, 125), ((), torch.float32, 256, 0, 125),
             ((), torch.bool, 256, 0, 125), ((512,), torch.float32, 256, 0, 1),
             ((512,), torch.float32, 128, 0, 1), ((5, 7), torch.uint8, 64, -2, 33),
             ((10, 10, 4), torch.uint8, 512, 1, 65)]
    specs = [kinds[i % len(kinds)] for i in range(num_segments)]
    fields = [_rand((E, T) + row, dtype, g).to(cuda_device)
              for row, dtype, T, _, _ in specs]
    leads = [lead for *_, lead, _ in specs]
    windows = [window for *_, window in specs]
    env = torch.randint(0, E, (B,), generator=g, dtype=torch.int32)
    col = torch.randint(-8, 512, (B,), generator=g, dtype=torch.int32)
    col[:4] = torch.tensor([-3, 0, 63, 255], dtype=torch.int32)
    env, col = env.to(cuda_device), col.to(cuda_device)
    before = dict(gather.LAUNCHES)
    outs = gather.window_gather_multi(fields, env, col, leads, windows)
    torch.cuda.synchronize()
    assert gather.LAUNCHES == {
        "union_gather": before["union_gather"],
        "window_gather": before["window_gather"] + launches}
    for out, field, lead, window in zip(outs, fields, leads, windows):
        assert torch.equal(out, gather.window_gather_reference(
            field, env, col - lead, window))


@pytest.mark.cuda
def test_frame_stack_union_gather_is_one_launch(cuda_device):
    """On the card the replay's frame-stack gather is one kernel launch
    and no other device work."""
    from torch.profiler import ProfilerActivity, profile
    from rltime_tpu_torch.history import replay
    g = torch.Generator().manual_seed(4)
    E, T, B, F, n = 4, 128, 32, 4, 3
    cfg = replay.ReplayConfig(num_envs=E, steps_per_env=T, horizon=n,
                              chunk_len=8, lookback=F - 1)
    state = replay.ReplayState(
        storage={"obs": _rand((E, T, 84, 84), torch.uint8, g).to(cuda_device),
                 "done": (torch.rand((E, T), generator=g) < 0.2).to(
                     cuda_device)},
        t=0, tree=torch.zeros(1), max_priority=torch.ones(()))
    env = torch.randint(0, E, (B,), generator=g,
                        dtype=torch.int32).to(cuda_device)
    col = torch.randint(0, T, (B,), generator=g,
                        dtype=torch.int32).to(cuda_device)
    replay.frame_stack_union_gather(cfg, state, env, col, F, n)   # builds
    torch.cuda.synchronize()
    before = dict(gather.LAUNCHES)
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        obs_t, obs_tn = replay.frame_stack_union_gather(cfg, state, env, col,
                                                        F, n)
        torch.cuda.synchronize()
    assert gather.LAUNCHES == {"union_gather": before["union_gather"] + 1,
                               "window_gather": before["window_gather"]}
    names = [e.name for e in prof.events()
             if e.device_type == torch.autograd.DeviceType.CUDA]
    assert len(names) == 1 and "union_gather_kernel" in names[0], names
    ref_t, ref_tn = gather.union_stack_gather_reference(
        state.storage["obs"], state.storage["done"], env, col, F, n)
    assert torch.equal(obs_t, ref_t) and torch.equal(obs_tn, ref_tn)


@pytest.mark.cuda
def test_union_gather_rejects_mixed_devices(cuda_device):
    storage = torch.zeros((2, 8, 16), dtype=torch.uint8, device=cuda_device)
    idx = torch.zeros((4,), dtype=torch.int32)
    with pytest.raises(ValueError):
        gather.union_gather(storage, idx, idx, 3)


@pytest.mark.cuda
def test_window_gather_rejects_mixed_devices(cuda_device):
    storage = torch.zeros((2, 8), dtype=torch.bool, device=cuda_device)
    idx = torch.zeros((4,), dtype=torch.int32)
    with pytest.raises(ValueError):
        gather.window_gather(storage, idx, idx, 3)
