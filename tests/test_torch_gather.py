"""Port parity: the union gather and the frame-stack union gather.

The port's plain `union_gather` (the CPU path of the CUDA kernel's
wrapper) against the Pallas TPU kernel `fused_union_gather` run in
interpret mode, and the port's `frame_stack_union_gather` against the
JAX one — all bit-exact. The CUDA kernel itself is compared with its
plain version on the card by tests/test_torch_cuda.py and chip_smoke.py.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rltime_tpu.history import replay as jreplay
from rltime_tpu.ops.pallas_gather import fused_union_gather, pad_rows
from rltime_tpu_torch.history import replay as treplay
from rltime_tpu_torch.ops import gather


def _inputs(seed, E, T, row_shape, B, dtype=np.uint8):
    rng = np.random.default_rng(seed)
    if dtype == np.uint8:
        storage = rng.integers(0, 256, (E, T) + row_shape, dtype=np.uint8)
    else:
        storage = rng.normal(size=(E, T) + row_shape).astype(dtype)
    env = rng.integers(0, E, B).astype(np.int32)
    col = rng.integers(0, T, B).astype(np.int32)
    col[:4] = [0, 1, T - 1, T - 2]       # windows across the ring seam
    return storage, env, col


@pytest.mark.parametrize("dtype", [np.uint8, np.float32])
def test_union_gather_matches_pallas_kernel(dtype):
    E, T, F, n, B = 4, 32, 4, 3, 16
    W = F + n
    storage, env, col = _inputs(0, E, T, (12, 16), B, dtype)
    col0 = col - (F - 1)                 # negative near the ring start
    assert (col0 < 0).any()
    row = 12 * 16
    ref = fused_union_gather(pad_rows(jnp.asarray(storage)),
                             jnp.asarray(env), jnp.asarray(col0), W,
                             group=4, interpret=True)[..., :row]
    before = gather.PLAIN_CALLS
    out = gather.union_gather(torch.from_numpy(storage),
                              torch.from_numpy(env),
                              torch.from_numpy(col0), W)
    assert gather.PLAIN_CALLS == before + 1
    assert out.shape == (B, W, 12, 16) and out.dtype == torch.from_numpy(
        storage).dtype
    np.testing.assert_array_equal(out.numpy().reshape(B, W, row),
                                  np.asarray(ref))


def test_union_gather_rejects_bad_inputs():
    s = torch.zeros((2, 8, 4), dtype=torch.uint8)
    i32 = torch.zeros((3,), dtype=torch.int32)
    with pytest.raises(ValueError):
        gather.union_gather(s, i32.long(), i32, 2)         # env not int32
    with pytest.raises(ValueError):
        gather.union_gather(s, i32, i32, 0)                # window < 1
    with pytest.raises(ValueError):
        gather.union_gather(s[:, :, :1].expand(2, 8, 4), i32, i32, 2)
    with pytest.raises(ValueError):
        gather.union_gather(s[0], i32, i32, 2)             # ndim < 3


def _storage_with_dones(seed, E, T):
    rng = np.random.default_rng(seed)
    obs = rng.integers(0, 256, (E, T, 6, 5), dtype=np.uint8)
    done = rng.random((E, T)) < 0.2      # several dones inside windows
    return obs, done


def test_frame_stack_union_gather_matches_jax():
    E, T, F, n, B = 3, 64, 4, 3, 32
    obs, done = _storage_with_dones(1, E, T)
    rng = np.random.default_rng(2)
    env = rng.integers(0, E, B).astype(np.int32)
    col = rng.integers(0, T, B).astype(np.int32)
    col[:3] = [0, 2, T - 1]
    jcfg = jreplay.ReplayConfig(num_envs=E, steps_per_env=T, horizon=n,
                                chunk_len=8, lookback=F - 1)
    jstate = jreplay.ReplayState(
        storage={"obs": jnp.asarray(obs), "done": jnp.asarray(done)},
        t=jnp.int32(0), tree=jnp.zeros((1,)), max_priority=jnp.ones(()))
    j_t, j_tn = jreplay.frame_stack_union_gather(
        jcfg, jstate, jnp.asarray(env), jnp.asarray(col), F, n)

    tcfg = treplay.ReplayConfig(num_envs=E, steps_per_env=T, horizon=n,
                                chunk_len=8, lookback=F - 1)
    tstate = treplay.ReplayState(
        storage={"obs": torch.from_numpy(obs),
                 "done": torch.from_numpy(done)},
        t=0, tree=torch.zeros(1), max_priority=torch.ones(()))
    t_t, t_tn = treplay.frame_stack_union_gather(
        tcfg, tstate, torch.from_numpy(env), torch.from_numpy(col), F, n)
    assert np.asarray(j_t).any() and (np.asarray(j_t) == 0).any()
    np.testing.assert_array_equal(t_t.numpy(), np.asarray(j_t))
    np.testing.assert_array_equal(t_tn.numpy(), np.asarray(j_tn))

    # and the single-stack gather the F=1 / act-side paths use
    j_s = jreplay.frame_stack_gather(jcfg, jstate, jnp.asarray(env),
                                     jnp.asarray(col), F)
    t_s = treplay.frame_stack_gather(tcfg, tstate, torch.from_numpy(env),
                                     torch.from_numpy(col), F)
    np.testing.assert_array_equal(t_s.numpy(), np.asarray(j_s))

