"""Port parity: the window and union gathers and what is built on them.

The port's plain `window_gather`, `window_gather_multi` and
`union_gather` (the CPU paths of the CUDA kernels' wrappers) against the
Pallas TPU kernels `window_gather` and `fused_union_gather` run in
interpret mode; the port's `union_stack_gather`,
`frame_stack_union_gather`, `replay_gather_window` and R2D2 sequence
stacks against the JAX ones — all bit-exact (tolerance 0: a gather is a
copy and the validity a 0/1 mask). The CUDA kernels themselves are
compared with their plain versions on the card by
tests/test_torch_cuda.py and chip_smoke.py.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rltime_tpu.history import replay as jreplay
from rltime_tpu.ops import pallas_gather
from rltime_tpu.ops.pallas_gather import fused_union_gather, pad_rows
from rltime_tpu.training.r2d2 import _gather_seq_frames
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
    before = gather.PLAIN_CALLS["union_gather"]
    out = gather.union_gather(torch.from_numpy(storage),
                              torch.from_numpy(env),
                              torch.from_numpy(col0), W)
    assert gather.PLAIN_CALLS["union_gather"] == before + 1
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
    before = dict(gather.PLAIN_CALLS)
    t_t, t_tn = treplay.frame_stack_union_gather(
        tcfg, tstate, torch.from_numpy(env), torch.from_numpy(col), F, n)
    # one launch: the union rows, their done flags and the validity
    assert {k: v - before[k] for k, v in gather.PLAIN_CALLS.items()} == {
        "union_gather": 1, "window_gather": 0}
    assert np.asarray(j_t).any() and (np.asarray(j_t) == 0).any()
    np.testing.assert_array_equal(t_t.numpy(), np.asarray(j_t))
    np.testing.assert_array_equal(t_tn.numpy(), np.asarray(j_tn))

    # and the single-stack gather the F=1 / act-side paths use
    j_s = jreplay.frame_stack_gather(jcfg, jstate, jnp.asarray(env),
                                     jnp.asarray(col), F)
    t_s = treplay.frame_stack_gather(tcfg, tstate, torch.from_numpy(env),
                                     torch.from_numpy(col), F)
    np.testing.assert_array_equal(t_s.numpy(), np.asarray(j_s))


def _jax_union_stacks(obs, done, env, col, F, n):
    E, T = done.shape
    jcfg = jreplay.ReplayConfig(num_envs=E, steps_per_env=T, horizon=n,
                                chunk_len=1, lookback=F - 1)
    jstate = jreplay.ReplayState(
        storage={"obs": jnp.asarray(obs), "done": jnp.asarray(done)},
        t=jnp.int32(0), tree=jnp.zeros((1,)), max_priority=jnp.ones(()))
    return jreplay.frame_stack_union_gather(
        jcfg, jstate, jnp.asarray(env), jnp.asarray(col), F, n)


@pytest.mark.parametrize("row_shape,dtype,F,n", [
    ((84, 84), np.uint8, 4, 3),      # config #2's frames
    ((5, 7), np.uint8, 4, 3),        # 35-byte rows: the unaligned path
    ((12, 16), np.float32, 4, 3),    # a float ring
    ((5, 7), np.uint8, 3, 5),        # n > F: the stacks do not overlap
    ((5, 7), np.uint8, 2, 1),
])
def test_union_stack_gather_matches_jax(row_shape, dtype, F, n):
    """The fused frame-stack gather against the JAX package's
    frame_stack_union_gather: windows across the seam, col < F-1
    (negative col0) and a done rate that cuts stacks at every slot."""
    E, T, B = 3, 32, 48
    storage, env, col = _inputs(3, E, T, row_shape, B, dtype)
    col[4:7] = [2, F - 2, T - n]
    done = np.random.default_rng(4).random((E, T)) < 0.25
    j_t, j_tn = _jax_union_stacks(storage, done, env, col, F, n)
    before = dict(gather.PLAIN_CALLS)
    t_t, t_tn = gather.union_stack_gather(
        torch.from_numpy(storage), torch.from_numpy(done),
        torch.from_numpy(env), torch.from_numpy(col), F, n)
    assert {k: v - before[k] for k, v in gather.PLAIN_CALLS.items()} == {
        "union_gather": 1, "window_gather": 0}
    assert t_t.shape == t_tn.shape == (B, F) + row_shape
    assert t_t.dtype == t_tn.dtype == torch.from_numpy(storage).dtype
    np.testing.assert_array_equal(t_t.numpy(), np.asarray(j_t))
    np.testing.assert_array_equal(t_tn.numpy(), np.asarray(j_tn))


def test_union_stack_gather_every_done_position():
    """One done flag at each position of the union window in turn (and
    none): every validity pattern a single episode end can give."""
    E, T, F, n = 1, 16, 4, 3
    W = F + n
    rng = np.random.default_rng(11)
    obs = rng.integers(1, 256, (E, T, 5, 7), dtype=np.uint8)   # no zero byte
    env = np.zeros(W, np.int32)
    for col in (5, 1, T - 2):            # plain, negative col0, seam
        cols = np.full(W, col, np.int32)
        for pos in range(W):             # pos == W-1: no done in the window
            done = np.zeros((E, T), bool)
            if pos < W - 1:
                done[0, (col - (F - 1) + pos) % T] = True
            j_t, j_tn = _jax_union_stacks(obs, done, env, cols, F, n)
            t_t, t_tn = gather.union_stack_gather(
                torch.from_numpy(obs), torch.from_numpy(done),
                torch.from_numpy(env), torch.from_numpy(cols), F, n)
            np.testing.assert_array_equal(t_t.numpy(), np.asarray(j_t))
            np.testing.assert_array_equal(t_tn.numpy(), np.asarray(j_tn))
            # rows up to the flag are cut off from their stack's newest
            want_t = [i > pos or pos >= F - 1 for i in range(F)]
            want_tn = [n + i > pos or pos >= W - 1 for i in range(F)]
            assert t_t[0].flatten(1).any(1).tolist() == want_t
            assert t_tn[0].flatten(1).any(1).tolist() == want_tn


def test_union_stack_gather_rejects_bad_inputs():
    obs = torch.zeros((2, 8, 4), dtype=torch.uint8)
    done = torch.zeros((2, 8), dtype=torch.bool)
    i32 = torch.zeros((3,), dtype=torch.int32)
    with pytest.raises(ValueError):
        gather.union_stack_gather(obs, done, i32, i32, 1, 3)       # F < 2
    with pytest.raises(ValueError):
        gather.union_stack_gather(obs, done, i32, i32, 4, 0)       # n < 1
    with pytest.raises(ValueError):
        gather.union_stack_gather(obs, done, i32, i32, 20, 13)     # F+n > 32
    with pytest.raises(ValueError):
        gather.union_stack_gather(obs, done.to(torch.uint8), i32, i32, 4, 3)
    with pytest.raises(ValueError):
        gather.union_stack_gather(obs, done[:, :4], i32, i32, 4, 3)
    with pytest.raises(ValueError):
        gather.union_stack_gather(obs, done, i32.long(), i32, 4, 3)
    with pytest.raises(ValueError):
        gather.union_stack_gather(obs[0], done, i32, i32, 4, 3)    # ndim < 3


# ----- K1: window_gather ---------------------------------------------------

def _field(rng, E, T, row_shape, dtype):
    if dtype == np.uint8:
        return rng.integers(0, 256, (E, T) + row_shape, dtype=np.uint8)
    if dtype == np.bool_:
        return rng.random((E, T) + row_shape) < 0.3
    return (rng.normal(size=(E, T) + row_shape) * 100).astype(dtype)


@pytest.mark.parametrize("row_shape,dtype,window", [
    ((84, 84), np.uint8, 11),      # frames
    ((), np.float32, 13),          # reward strip (4-byte rows)
    ((), np.int32, 13),            # action strip
    ((), np.bool_, 14),            # done/terminated strips (1-byte rows)
    ((3, 5), np.float32, 7),       # odd row width
    ((10, 10, 4), np.uint8, 17),   # MinAtar planes: 400-byte rows
    ((10, 10, 4), np.uint8, 1),    # ... one row (a frame_stack=1 obs)
])
def test_window_gather_matches_pallas_kernel(row_shape, dtype, window):
    E, T, B = 3, 32, 12
    rng = np.random.default_rng(5)
    storage = _field(rng, E, T, row_shape, dtype)
    env = rng.integers(0, E, B).astype(np.int32)
    col = rng.integers(-4, T, B).astype(np.int32)
    col[:4] = [-1, -3, T - 2, T - window + 1]   # negative and seam windows
    ref = pallas_gather.window_gather(jnp.asarray(storage), jnp.asarray(env),
                                      jnp.asarray(col), window,
                                      interpret=True)
    before = dict(gather.PLAIN_CALLS)
    out = gather.window_gather(torch.from_numpy(storage),
                               torch.from_numpy(env), torch.from_numpy(col),
                               window)
    assert gather.PLAIN_CALLS["window_gather"] == (
        before["window_gather"] + 1)
    assert gather.PLAIN_CALLS["union_gather"] == before["union_gather"]
    assert out.shape == (B, window) + row_shape
    assert out.dtype == torch.from_numpy(storage).dtype
    np.testing.assert_array_equal(out.numpy(), np.asarray(ref))


def test_window_gather_rejects_bad_inputs():
    s = torch.zeros((2, 8, 4), dtype=torch.uint8)
    i32 = torch.zeros((3,), dtype=torch.int32)
    with pytest.raises(ValueError):
        gather.window_gather(s, i32.long(), i32, 2)        # env not int32
    with pytest.raises(ValueError):
        gather.window_gather(s, i32, i32[:2], 2)           # B mismatch
    with pytest.raises(ValueError):
        gather.window_gather(s, i32, i32, 0)               # window < 1
    with pytest.raises(ValueError):
        gather.window_gather(s, i32, i32, 9)               # window > T
    with pytest.raises(ValueError):
        gather.window_gather(s.transpose(0, 1), i32, i32, 2)   # strided
    with pytest.raises(ValueError):
        gather.window_gather(s[0, 0], i32, i32, 2)         # ndim < 2


@pytest.mark.parametrize("num_segments,launches", [(1, 1), (5, 1), (8, 1),
                                                   (9, 2), (17, 3)])
def test_window_gather_multi_matches_pallas_kernel(num_segments, launches):
    """Every segment of one multi-field gather against the Pallas kernel
    on the same field with the segment's lead taken off col: mixed
    leads (negative too), windows, dtypes, row shapes and ring lengths;
    more than 8 segments make several launches."""
    E, B = 3, 12
    rng = np.random.default_rng(12)
    kinds = [((84, 84), np.uint8, 32, 3, 11), ((), np.float32, 32, 0, 13),
             ((), np.bool_, 32, 3, 16), ((), np.int32, 64, 0, 1),
             ((3, 5), np.float32, 16, -2, 7), ((10, 10, 4), np.uint8, 64, 1, 17),
             ((8,), np.float32, 32, 0, 1), ((), np.bool_, 16, -3, 16),
             ((6, 5), np.uint8, 32, 5, 32)]
    specs = [kinds[i % len(kinds)] for i in range(num_segments)]
    fields = [_field(rng, E, T, row, dtype) for row, dtype, T, _, _ in specs]
    leads = [lead for *_, lead, _ in specs]
    windows = [window for *_, window in specs]
    env = rng.integers(0, E, B).astype(np.int32)
    col = rng.integers(-4, 64, B).astype(np.int32)
    col[:4] = [-1, 0, 15, 31]
    before = dict(gather.PLAIN_CALLS)
    outs = gather.window_gather_multi(
        [torch.from_numpy(f) for f in fields], torch.from_numpy(env),
        torch.from_numpy(col), leads, windows)
    assert {k: v - before[k] for k, v in gather.PLAIN_CALLS.items()} == {
        "union_gather": 0, "window_gather": launches}
    assert len(outs) == num_segments
    for out, field, (row, _, _, lead, window) in zip(outs, fields, specs):
        ref = pallas_gather.window_gather(
            jnp.asarray(field), jnp.asarray(env), jnp.asarray(col - lead),
            window, interpret=True)
        assert out.shape == (B, window) + row
        assert out.dtype == torch.from_numpy(field).dtype
        np.testing.assert_array_equal(out.numpy(), np.asarray(ref))


def test_window_gather_multi_rejects_bad_inputs():
    s = torch.zeros((2, 8, 4), dtype=torch.uint8)
    i32 = torch.zeros((3,), dtype=torch.int32)
    with pytest.raises(ValueError):
        gather.window_gather_multi([], i32, i32, [], [])           # no field
    with pytest.raises(ValueError):
        gather.window_gather_multi([s, s], i32, i32, [0], [2, 2])  # lengths
    with pytest.raises(ValueError):
        gather.window_gather_multi([s, s], i32, i32, [0, 0], [2, 9])
    with pytest.raises(ValueError):
        gather.window_gather_multi([s, s.transpose(0, 1)], i32, i32,
                                   [0, 0], [2, 2])                 # strided


def _seq_replays(E, T, F, seed):
    """The same ring contents in both packages, with many episode ends."""
    rng = np.random.default_rng(seed)
    fields = dict(obs=rng.integers(0, 256, (E, T, 6, 5), dtype=np.uint8),
                  done=rng.random((E, T)) < 0.15,
                  reward=rng.normal(size=(E, T)).astype(np.float32),
                  action=rng.integers(0, 4, (E, T)).astype(np.int32))
    fields["terminated"] = fields["done"] & (rng.random((E, T)) < 0.5)
    kw = dict(num_envs=E, steps_per_env=T, horizon=1, chunk_len=8,
              lookback=F - 1)
    jst = jreplay.ReplayState(
        storage={k: jnp.asarray(v) for k, v in fields.items()},
        t=jnp.int32(0), tree=jnp.zeros((1,)), max_priority=jnp.ones(()))
    tst = treplay.ReplayState(
        storage={k: torch.from_numpy(v) for k, v in fields.items()},
        t=0, tree=torch.zeros(1), max_priority=torch.ones(()))
    return jreplay.ReplayConfig(**kw), jst, treplay.ReplayConfig(**kw), tst


@pytest.mark.parametrize("F", [1, 4])
def test_sequence_stacks_match_jax(F):
    """One window per sample equals B*length separate stacks, and the
    done strip from col - max(F-1, 1) is the ring's done column."""
    E, T, B, length = 3, 64, 10, 21
    jcfg, jst, tcfg, tst = _seq_replays(E, T, F, 6)
    rng = np.random.default_rng(7)
    env = rng.integers(0, E, B).astype(np.int32)
    col = rng.integers(0, T, B).astype(np.int32)
    col[:3] = [0, 1, T - 5]                 # lookback and seam windows
    ref = _gather_seq_frames(jcfg, jst, jnp.asarray(env), jnp.asarray(col),
                             length, F)
    before = dict(gather.PLAIN_CALLS)
    stacks, dones, (reward, action) = treplay.sequence_stack_gather(
        tcfg, tst, torch.from_numpy(env), torch.from_numpy(col), length, F,
        extra=[("reward", 0, length), ("action", 0, 1)])
    # frames, dones and the extra fields: one launch
    assert {k: v - before[k] for k, v in gather.PLAIN_CALLS.items()} == {
        "union_gather": 0, "window_gather": 1}
    assert stacks.shape == (B, length, F, 6, 5)
    if F > 1:
        assert (np.asarray(ref) == 0).all(axis=(3, 4)).any()  # masked frames
    np.testing.assert_array_equal(stacks.numpy(), np.asarray(ref))
    D = max(F - 1, 1)
    cols = (col[:, None] - D + np.arange(length + D)[None, :]) % T
    np.testing.assert_array_equal(
        dones.numpy(), tst.storage["done"].numpy()[env[:, None], cols])
    want = jreplay.replay_gather_window(jcfg, jst, jnp.asarray(env),
                                        jnp.asarray(col), length,
                                        fields=["reward"])
    np.testing.assert_array_equal(reward.numpy(), np.asarray(want["reward"]))
    want = jreplay.replay_gather_at(jcfg, jst, jnp.asarray(env),
                                    jnp.asarray(col), fields=["action"])
    np.testing.assert_array_equal(action[:, 0].numpy(),
                                  np.asarray(want["action"]))


def test_replay_gather_window_matches_jax():
    E, T, B, length = 3, 64, 16, 25
    jcfg, jst, tcfg, tst = _seq_replays(E, T, 4, 8)
    rng = np.random.default_rng(9)
    env = rng.integers(0, E, B).astype(np.int32)
    col = rng.integers(-2, T, B).astype(np.int32)
    col[:2] = [-1, T - 3]
    names = ["action", "reward", "done", "terminated", "obs"]
    before = gather.PLAIN_CALLS["window_gather"]
    got = treplay.replay_gather_window(tcfg, tst, torch.from_numpy(env),
                                       torch.from_numpy(col), length,
                                       fields=names)
    assert gather.PLAIN_CALLS["window_gather"] == before + 1   # all fields
    want = jreplay.replay_gather_window(jcfg, jst, jnp.asarray(env),
                                        jnp.asarray(col), length,
                                        fields=names)
    for name in names:
        np.testing.assert_array_equal(got[name].numpy(),
                                      np.asarray(want[name]), err_msg=name)
