"""Port parity: uniform replay at the device cursor.

`history/replay.py:replay_sample_indices_device` with
`prioritized=False`, the sampler a captured step runs (the trainers keep
the write cursor as a 0-d tensor on the device). Against the JAX
package's `replay_sample_indices` on the CPU and the port's host-int
route, over a ring that wraps twice (lookback 3, horizon 2): on the JAX
side's own integer draws (two `randint`s on two split keys) the env,
column and leaf planes are bit-equal across the three, the weights are
ones and `num_valid` is the same count (a 0-d int64 tensor on the
device route). Fresh draws land in the valid range [lo, hi) of the
unwrapped columns and in [0, E), cover it, and advance the generator.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_port_draws as draws_lib
from rltime_tpu.history import replay as jreplay
from rltime_tpu_torch.history import replay as treplay

E, T, L, F, N = 4, 32, 4, 4, 2
B = 64


def _replays():
    kw = dict(num_envs=E, steps_per_env=T, horizon=N, chunk_len=L,
              lookback=F - 1, prioritized=False)
    jcfg, tcfg = jreplay.ReplayConfig(**kw), treplay.ReplayConfig(**kw)
    js = jreplay.replay_init(jcfg, {"done": ((), jnp.bool_),
                                    "action": ((), jnp.int32)})
    fields = {"done": ((), torch.bool), "action": ((), torch.int32)}
    host = treplay.replay_init(tcfg, fields, torch.device("cpu"))
    dev = treplay.replay_init(tcfg, fields, torch.device("cpu"))
    dev.cursor = torch.zeros((), dtype=torch.int64)
    return jcfg, js, tcfg, host, dev


def test_device_uniform_draw_matches_jax_and_the_host_route():
    jcfg, js, tcfg, host, dev = _replays()
    rng = np.random.default_rng(0)
    key = jax.random.key(7)
    wrapped = 0
    for i in range(3 * T // L):
        chunk = dict(done=rng.random((E, L)) < 0.2,
                     action=rng.integers(0, 3, (E, L)).astype(np.int32))
        js = jreplay.replay_insert(
            jcfg, js, {k: jnp.asarray(v) for k, v in chunk.items()})
        treplay.replay_insert(tcfg, host, chunk)
        treplay.replay_insert_device(tcfg, dev, chunk)
        assert dev.cursor.item() == host.t == int(js.t)
        wrapped = max(wrapped, host.t // T)
        lo, hi = treplay.valid_range(tcfg, host.t)
        # JAX's draws: the sampler splits the key it is given
        # (history/replay.py:230-232); the port takes the pair
        key, skey = jax.random.split(key)
        want = jreplay.replay_sample_indices(jcfg, js, skey, B, 0.5)
        ukey, ekey = jax.random.split(skey)
        u = (torch.from_numpy(np.array(jax.random.randint(
                 ukey, (B,), 0, max(hi - lo, 1)))),
             torch.from_numpy(np.array(jax.random.randint(ekey, (B,), 0, E))))
        a = treplay.replay_sample_indices(tcfg, host, B, 0.5, u=u)
        b = treplay.replay_sample_indices_device(tcfg, dev, B, 0.5, u=u)
        assert b["num_valid"].dtype == torch.int64
        assert b["num_valid"].ndim == 0
        assert b["num_valid"].item() == a["num_valid"] == int(
            want["num_valid"])
        for k in ("env", "col", "leaf"):
            np.testing.assert_array_equal(b[k].numpy(), a[k].numpy(),
                                          err_msg=f"{k} at {i}")
            np.testing.assert_array_equal(
                b[k].numpy().astype(np.int64),
                np.asarray(want[k]).astype(np.int64), err_msg=f"{k} at {i}")
        assert b["env"].dtype == b["col"].dtype == torch.int32
        assert torch.equal(b["weight"], torch.ones(B))
        assert torch.equal(a["weight"], b["weight"])
    assert wrapped >= 2


@pytest.mark.parametrize("t", [L, T - L, 2 * T + L, 5 * T + 3 * L])
def test_fresh_device_draws_land_in_the_valid_range(t):
    """Fresh draws from the generator at cursor `t` (the first chunk, a
    full ring, wrapped rings): every sampled unwrapped column lies in
    [lo, hi) and every lane in [0, E), all of them are drawn, and the
    generator advances."""
    _, _, tcfg, _, dev = _replays()
    dev.cursor.fill_(t)
    lo, hi = treplay.valid_range(tcfg, t)
    g = torch.Generator().manual_seed(0)
    start = g.get_state().clone()
    cols, envs = set(), set()
    for _ in range(20):
        s = treplay.replay_sample_indices_device(tcfg, dev, B, 0.5,
                                                 generator=g)
        col = s["col"].long()
        # the unwrapped column of each sample: the one in [lo, lo + T)
        unwrapped = lo + torch.remainder(col - lo, T)
        assert bool(((unwrapped >= lo) & (unwrapped < max(hi, lo + 1))).all())
        assert bool(((s["env"] >= 0) & (s["env"] < E)).all())
        assert torch.equal(s["leaf"], s["env"].long() * T + col)
        cols.update(unwrapped.tolist())
        envs.update(s["env"].tolist())
    assert cols == set(range(lo, max(hi, lo + 1))) and envs == set(range(E))
    assert not torch.equal(g.get_state(), start)


def test_uniform_update_draws_helper_matches_the_sampler():
    """`torch_port_draws.uniform_update_draws` (what the trainer parity
    tests inject) is the pair JAX's update draws from its key."""
    _, js, tcfg, host, dev = _replays()
    jcfg = jreplay.ReplayConfig(num_envs=E, steps_per_env=T, horizon=N,
                                chunk_len=L, lookback=F - 1,
                                prioritized=False)
    rng = np.random.default_rng(1)
    for _ in range(3):
        chunk = dict(done=rng.random((E, L)) < 0.2,
                     action=rng.integers(0, 3, (E, L)).astype(np.int32))
        js = jreplay.replay_insert(
            jcfg, js, {k: jnp.asarray(v) for k, v in chunk.items()})
        treplay.replay_insert_device(tcfg, dev, chunk)
    lo, hi = treplay.valid_range(tcfg, dev.cursor.item())
    key = jax.random.key(3)
    _, skey, _ = jax.random.split(key, 3)
    want = jreplay.replay_sample_indices(jcfg, js, skey, B, 0.5)
    d = draws_lib.uniform_update_draws(key, B, max(hi - lo, 1), E)
    got = treplay.replay_sample_indices_device(tcfg, dev, B, 0.5, u=d["u"])
    np.testing.assert_array_equal(got["leaf"].numpy(),
                                  np.asarray(want["leaf"]))
