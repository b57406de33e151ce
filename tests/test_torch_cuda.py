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
    the (5, 7) uint8 row (35 B) takes the misaligned byte path."""
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
