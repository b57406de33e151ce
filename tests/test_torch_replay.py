"""Port parity: the dense PER sampler and the replay ring.

Integer plane bit-exact against the JAX package (priority writes with
duplicates, sampled leaves on JAX's own uniforms, ring contents, cursor
and priorities after inserts over two ring wraps); float plane (IS
weights, priority write-back) to 1e-6 relative, since pow and the
priority total reduce in another order than XLA's.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rltime_tpu.history import replay as jreplay
from rltime_tpu.ops import dense_tree as jtree
from rltime_tpu_torch.history import replay as treplay
from rltime_tpu_torch.ops import dense_tree as ttree


@pytest.mark.parametrize("unique", [False, True])
def test_set_priorities_last_write_wins(unique):
    rng = np.random.default_rng(0)
    n = ttree.padded_size(300)
    assert n == jtree.padded_size(300)
    tree = rng.random(n).astype(np.float32)
    if unique:
        idx = rng.permutation(300)[:64].astype(np.int32)
    else:
        idx = rng.integers(0, 40, 64).astype(np.int32)   # many duplicates
    prio = rng.random(64).astype(np.float32)
    ref = jtree.set_priorities(jnp.asarray(tree), jnp.asarray(idx),
                               jnp.asarray(prio), unique=unique)
    out = ttree.set_priorities(torch.from_numpy(tree), torch.from_numpy(idx),
                               torch.from_numpy(prio), unique=unique)
    np.testing.assert_array_equal(out.numpy(), np.asarray(ref))
    if not unique:   # the last occurrence of each index won
        last = {int(i): p for i, p in zip(idx, prio)}
        for i, p in last.items():
            assert out[i].item() == p


@pytest.mark.parametrize("stratified", [True, False])
def test_sample_matches_jax_on_its_uniforms(stratified):
    """Dyadic priorities (k/8) make every cumsum exact in any order."""
    rng = np.random.default_rng(1)
    n = ttree.padded_size(5000)
    tree = np.zeros(n, np.float32)
    live = rng.random(5000) < 0.7
    tree[:5000][live] = rng.integers(1, 64, live.sum()) / 8.0
    key = jax.random.key(3)
    B = 64
    leaf_j, prio_j = jtree.sample(jnp.asarray(tree), key, B,
                                  stratified=stratified)
    u = np.array(jax.random.uniform(key, (B,)))
    leaf_t, prio_t = ttree.sample(torch.from_numpy(tree),
                                  torch.from_numpy(u), stratified=stratified)
    np.testing.assert_array_equal(leaf_t.numpy(), np.asarray(leaf_j))
    np.testing.assert_array_equal(prio_t.numpy(), np.asarray(prio_j))
    assert (prio_t > 0).all()


E, T, L, N_STEP, F = 3, 32, 8, 3, 4


def _configs():
    kw = dict(num_envs=E, steps_per_env=T, horizon=N_STEP, chunk_len=L,
              lookback=F - 1)
    return jreplay.ReplayConfig(**kw), treplay.ReplayConfig(**kw)


def _chunk(rng):
    done = rng.random((E, L)) < 0.15
    return dict(
        obs=rng.integers(0, 256, (E, L, 6, 5), dtype=np.uint8),
        action=rng.integers(0, 4, (E, L)).astype(np.int32),
        reward=rng.normal(size=(E, L)).astype(np.float32),
        terminated=done & (rng.random((E, L)) < 0.5),
        done=done)


def _fields_jax():
    return {"obs": ((6, 5), jnp.uint8), "action": ((), jnp.int32),
            "reward": ((), jnp.float32), "terminated": ((), jnp.bool_),
            "done": ((), jnp.bool_)}


def _fields_torch():
    return {"obs": ((6, 5), torch.uint8), "action": ((), torch.int32),
            "reward": ((), torch.float32), "terminated": ((), torch.bool),
            "done": ((), torch.bool)}


def _filled(num_chunks, seed=2):
    """The same chunks inserted into both replays."""
    jcfg, tcfg = _configs()
    jstate = jreplay.replay_init(jcfg, _fields_jax())
    tstate = treplay.replay_init(tcfg, _fields_torch(), torch.device("cpu"))
    rng = np.random.default_rng(seed)
    for _ in range(num_chunks):
        chunk = _chunk(rng)
        jstate = jreplay.replay_insert(
            jcfg, jstate, {k: jnp.asarray(v) for k, v in chunk.items()})
        treplay.replay_insert(tcfg, tstate, chunk)
    return jcfg, jstate, tcfg, tstate


def _assert_same_replay(jstate, tstate):
    assert tstate.t == int(jstate.t)
    for name, arr in jstate.storage.items():
        np.testing.assert_array_equal(tstate.storage[name].numpy(),
                                      np.asarray(arr), err_msg=name)
    np.testing.assert_array_equal(tstate.tree.numpy(),
                                  np.asarray(jstate.tree))
    assert tstate.max_priority.item() == float(jstate.max_priority)


def test_insert_over_two_ring_wraps_is_bit_exact():
    jcfg, tcfg = _configs()
    jstate = jreplay.replay_init(jcfg, _fields_jax())
    tstate = treplay.replay_init(tcfg, _fields_torch(), torch.device("cpu"))
    rng = np.random.default_rng(3)
    for _ in range(2 * T // L + 3):          # > 2 wraps of the ring
        chunk = _chunk(rng)
        jstate = jreplay.replay_insert(
            jcfg, jstate, {k: jnp.asarray(v) for k, v in chunk.items()})
        treplay.replay_insert(tcfg, tstate, chunk)
        _assert_same_replay(jstate, tstate)
    assert tstate.t > 2 * T
    assert treplay.valid_range(tcfg, tstate.t) == tuple(
        int(x) for x in jreplay.valid_range(jcfg, jstate.t))


def test_sample_weights_and_priority_writeback_match_jax():
    jcfg, jstate, tcfg, tstate = _filled(2 * T // L + 1)
    rng = np.random.default_rng(4)
    # dyadic live priorities so the sampled leaves are bit-exact
    tree = np.asarray(jstate.tree).copy()
    live = tree > 0
    tree[live] = rng.integers(1, 32, live.sum()) / 4.0
    jstate = jstate.replace(tree=jnp.asarray(tree))
    tstate.tree = torch.from_numpy(tree.copy())

    B, beta = 32, 0.55
    key = jax.random.key(5)
    jidx = jreplay.replay_sample_indices(jcfg, jstate, key, B,
                                         jnp.float32(beta))
    u = torch.from_numpy(np.array(jax.random.uniform(key, (B,))))
    tidx = treplay.replay_sample_indices(tcfg, tstate, B, beta, u=u)
    for k in ("env", "col", "leaf"):
        np.testing.assert_array_equal(tidx[k].numpy(), np.asarray(jidx[k]),
                                      err_msg=k)
    assert tidx["num_valid"] == int(jidx["num_valid"])
    np.testing.assert_allclose(tidx["weight"].numpy(),
                               np.asarray(jidx["weight"]), rtol=1e-6)
    assert len(np.unique(tidx["weight"].numpy())) > 1

    # write-back: duplicates, dead leaves (zeroed since sampling), keep
    leaf = tidx["leaf"].numpy().copy()
    leaf[1] = leaf[0]
    dead = np.flatnonzero(tree == 0)[:3]
    leaf[-3:] = dead
    td = np.abs(rng.normal(size=B)).astype(np.float32) * 3
    keep = (rng.random(B) < 0.8).astype(np.float32)
    jstate = jreplay.replay_update_priorities(
        jcfg, jstate, jnp.asarray(leaf), jnp.asarray(td),
        keep=jnp.asarray(keep))
    treplay.replay_update_priorities(
        tcfg, tstate, torch.from_numpy(leaf), torch.from_numpy(td),
        keep=torch.from_numpy(keep))
    np.testing.assert_allclose(tstate.tree.numpy(), np.asarray(jstate.tree),
                               rtol=1e-6)
    np.testing.assert_array_equal(tstate.tree.numpy()[dead], 0.0)
    np.testing.assert_allclose(tstate.max_priority.item(),
                               float(jstate.max_priority), rtol=1e-6)
