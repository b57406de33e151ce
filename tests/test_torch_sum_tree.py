"""Port parity: the binary sum tree and the replay's `sampler="tree"`.

Integer plane bit-exact against the JAX package: on dyadic priorities
(k/8, every float sum exact in any order) the whole tree after
`set_priorities` (duplicates with last-wins, `unique=True`, an
out-of-range index dropped) and the leaves `sample` picks on JAX's own
uniforms are equal bit for bit, a zero subtree at a float boundary
included. The port recomputes ancestors from their children where JAX
adds deltas, so on arbitrary floats the nodes agree to 1e-5 relative
(stated where used). The replay ring with `sampler="tree"` goes through
inserts over two ring wraps, sampling and a priority write-back.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rltime_tpu.history import replay as jreplay
from rltime_tpu.ops import sum_tree as jtree
from rltime_tpu_torch.history import replay as treplay
from rltime_tpu_torch.ops import sum_tree as ttree
from torch_port_draws import one_intra_op_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_intra_op_thread")


def _dyadic_tree(rng, num, frac=0.7):
    prio = np.zeros(num, np.float32)
    live = rng.random(num) < frac
    prio[live] = rng.integers(1, 64, live.sum()) / 8.0
    idx = np.arange(num, dtype=np.int32)
    jt = jtree.set_priorities(jtree.init(num), jnp.asarray(idx),
                              jnp.asarray(prio), unique=True)
    tt = ttree.set_priorities(ttree.init(num), torch.from_numpy(idx),
                              torch.from_numpy(prio), unique=True)
    return jt, tt


@pytest.mark.parametrize("num", [1, 8, 100, 5000])
def test_init_and_layout(num):
    assert ttree.tree_size(num) == jtree.tree_size(num)
    t = ttree.init(num)
    assert tuple(t.shape) == tuple(jtree.init(num).shape)
    assert ttree.capacity(t) == jtree.capacity(jtree.init(num))
    assert ttree.total(t).item() == 0.0


@pytest.mark.parametrize("unique", [False, True])
def test_set_priorities_matches_jax_bit_for_bit(unique):
    rng = np.random.default_rng(0)
    jt, tt = _dyadic_tree(rng, 300)
    np.testing.assert_array_equal(tt.numpy(), np.asarray(jt))
    if unique:
        idx = rng.permutation(300)[:64].astype(np.int32)
    else:
        idx = rng.integers(0, 40, 64).astype(np.int32)   # many duplicates
    prio = (rng.integers(0, 64, 64) / 8.0).astype(np.float32)
    jt2 = jtree.set_priorities(jt, jnp.asarray(idx), jnp.asarray(prio),
                               unique=unique)
    tt2 = ttree.set_priorities(tt, torch.from_numpy(idx),
                               torch.from_numpy(prio), unique=unique)
    np.testing.assert_array_equal(tt2.numpy(), np.asarray(jt2))
    np.testing.assert_array_equal(tt.numpy(), np.asarray(jt))  # not in place
    last = {int(i): p for i, p in zip(idx, prio)}   # last occurrence won
    for i, p in last.items():
        assert ttree.get(tt2, torch.tensor(i)).item() == p
    t = tt2.numpy()
    n = ttree.capacity(tt2)
    np.testing.assert_array_equal(t[1:n], t[2:2 * n:2] + t[3:2 * n:2])
    assert ttree.total(tt2).item() == t[n:].sum()


def test_duplicates_last_wins_small():
    idx = np.array([1, 4, 1, 9, 4, 4], np.int32)
    p = np.array([1.0, 2.0, 3.0, 4.0, 5.0, 6.0], np.float32)
    jt = jtree.set_priorities(jtree.init(16), jnp.asarray(idx),
                              jnp.asarray(p))
    tt = ttree.set_priorities(ttree.init(16), torch.from_numpy(idx),
                              torch.from_numpy(p))
    np.testing.assert_array_equal(tt.numpy(), np.asarray(jt))
    assert ttree.get(tt, torch.tensor([1, 4, 9])).tolist() == [3.0, 6.0, 4.0]
    assert ttree.total(tt).item() == 13.0


def test_out_of_range_index_is_dropped_not_wrapped():
    tt = ttree.set_priorities(ttree.init(8), torch.tensor([2, 8, -1, 100]),
                              torch.tensor([1.0, 5.0, 7.0, 9.0]))
    want = ttree.set_priorities(ttree.init(8), torch.tensor([2]),
                                torch.tensor([1.0]))
    assert torch.equal(tt, want) and ttree.total(tt).item() == 1.0


def test_float_priorities_agree_to_tolerance():
    """Arbitrary floats: JAX adds deltas to the old values (a rewritten
    leaf holds old + (new - old), not new), the port writes the leaf and
    re-sums children, so nodes differ in the last bits: rtol 1e-5."""
    rng = np.random.default_rng(5)
    idx = np.arange(200, dtype=np.int32)
    p = rng.random(200).astype(np.float32)
    jt = jtree.set_priorities(jtree.init(200), jnp.asarray(idx),
                              jnp.asarray(p), unique=True)
    tt = ttree.set_priorities(ttree.init(200), torch.from_numpy(idx),
                              torch.from_numpy(p), unique=True)
    for _ in range(3):
        i2 = rng.integers(0, 200, 32).astype(np.int32)
        p2 = rng.random(32).astype(np.float32)
        jt = jtree.set_priorities(jt, jnp.asarray(i2), jnp.asarray(p2))
        tt = ttree.set_priorities(tt, torch.from_numpy(i2),
                                  torch.from_numpy(p2))
    np.testing.assert_allclose(tt.numpy(), np.asarray(jt), rtol=1e-5,
                               atol=1e-6)
    # the port's leaves hold exactly what was last written to them
    last = {int(i): v for i, v in zip(i2, p2)}
    for i, v in last.items():
        assert ttree.get(tt, torch.tensor(i)).item() == v


@pytest.mark.parametrize("stratified", [True, False])
def test_sample_matches_jax_on_its_uniforms(stratified):
    rng = np.random.default_rng(1)
    jt, tt = _dyadic_tree(rng, 5000)
    key = jax.random.key(3)
    B = 64
    leaf_j, prio_j = jtree.sample(jt, key, B, stratified=stratified)
    u = torch.from_numpy(np.array(jax.random.uniform(key, (B,))))
    leaf_t, prio_t = ttree.sample(tt, u, stratified=stratified)
    assert leaf_t.dtype == torch.int64
    np.testing.assert_array_equal(leaf_t.numpy(), np.asarray(leaf_j))
    np.testing.assert_array_equal(prio_t.numpy(), np.asarray(prio_j))
    assert (prio_t > 0).all()


def test_zero_subtree_at_a_float_boundary():
    """Targets exactly on a subtree sum, beside empty subtrees, through
    `_descend` on both sides: never a zero-priority leaf."""
    p = np.zeros(16, np.float32)
    p[[2, 3, 12]] = [1.0, 2.0, 4.0]      # leaves 4..11 and 13..15 empty
    idx = np.arange(16, dtype=np.int32)
    jt = jtree.set_priorities(jtree.init(16), jnp.asarray(idx),
                              jnp.asarray(p), unique=True)
    tt = ttree.set_priorities(ttree.init(16), torch.from_numpy(idx),
                              torch.from_numpy(p), unique=True)
    targets = np.array([0.0, 1.0, 2.999, 3.0, 6.999,
                        np.nextafter(np.float32(7.0), np.float32(0.0))],
                       np.float32)
    leaf_j = jtree._descend(jt, jnp.asarray(targets))
    leaf_t = ttree._descend(tt, torch.from_numpy(targets))
    np.testing.assert_array_equal(leaf_t.numpy(), np.asarray(leaf_j))
    assert leaf_t.tolist() == [2, 3, 3, 12, 12, 12]
    # the nextafter clamp: u * total == total cannot fall off the edge
    leaf, prio = ttree.sample(tt, torch.tensor([1.0]), stratified=False)
    assert leaf.tolist() == [12] and prio.tolist() == [4.0]


# ----- the replay ring with sampler="tree" ----------------------------------

E, T, L, N_STEP, F = 3, 32, 4, 3, 2


def _fields(j):
    dt = (dict(obs=jnp.uint8, f=jnp.float32, b=jnp.bool_) if j else
          dict(obs=torch.uint8, f=torch.float32, b=torch.bool))
    return {"obs": ((5, 7), dt["obs"]), "reward": ((), dt["f"]),
            "done": ((), dt["b"])}


def _chunk(rng, prio=False):
    c = dict(obs=rng.integers(0, 256, (E, L, 5, 7), dtype=np.uint8),
             reward=(rng.integers(0, 64, (E, L)) / 8.0).astype(np.float32),
             done=rng.random((E, L)) < 0.2)
    if prio:
        c["priority"] = (rng.integers(0, 64, (E, L)) / 8.0).astype(
            np.float32)
    return c


@pytest.mark.parametrize("sampler", ["tree", "dense"])
def test_replay_ring_with_sum_tree_matches_jax(sampler):
    kw = dict(num_envs=E, steps_per_env=T, horizon=N_STEP, chunk_len=L,
              lookback=F - 1, sampler=sampler)
    jcfg, tcfg = jreplay.ReplayConfig(**kw), treplay.ReplayConfig(**kw)
    js = jreplay.replay_init(jcfg, _fields(True))
    ts = treplay.replay_init(tcfg, _fields(False), torch.device("cpu"))
    assert tuple(ts.tree.shape) == tuple(js.tree.shape)
    rng = np.random.default_rng(2)
    key = jax.random.key(11)
    for i in range(2 * T // L + 3):          # two ring wraps and a bit
        c = _chunk(rng)
        js = jreplay.replay_insert(jcfg, js,
                                   {k: jnp.asarray(v) for k, v in c.items()})
        treplay.replay_insert(tcfg, ts, c)
        # priorities are 0 or max_priority = 1: every sum is exact
        np.testing.assert_array_equal(ts.tree.numpy(), np.asarray(js.tree),
                                      err_msg=f"insert {i}")
        if i < 2:
            continue
        key, sk = jax.random.split(key)
        B = 8
        ji = jreplay.replay_sample_indices(jcfg, js, sk, B, 0.5)
        u = torch.from_numpy(np.array(jax.random.uniform(sk, (B,))))
        ti = treplay.replay_sample_indices(tcfg, ts, B, 0.5, u=u)
        for k in ("env", "col", "leaf"):
            np.testing.assert_array_equal(ti[k].numpy(), np.asarray(ji[k]),
                                          err_msg=f"{k} at insert {i}")
        assert ti["num_valid"] == int(ji["num_valid"])
        np.testing.assert_allclose(ti["weight"].numpy(),
                                   np.asarray(ji["weight"]), rtol=1e-6)
        # a write-back of dyadic |TD|s with alpha = 1 keeps sums exact
    kw1 = dict(kw, alpha=1.0, min_priority=0.0)
    jcfg, tcfg = jreplay.ReplayConfig(**kw1), treplay.ReplayConfig(**kw1)
    td = (rng.integers(0, 32, 8) / 8.0).astype(np.float32)
    keep = (rng.random(8) < 0.7).astype(np.float32)
    js = jreplay.replay_update_priorities(jcfg, js, ji["leaf"],
                                          jnp.asarray(td), jnp.asarray(keep))
    treplay.replay_update_priorities(tcfg, ts, ti["leaf"],
                                     torch.from_numpy(td),
                                     torch.from_numpy(keep))
    np.testing.assert_array_equal(ts.tree.numpy(), np.asarray(js.tree))
    assert ts.max_priority.item() == float(js.max_priority)


@pytest.mark.parametrize("sampler", ["tree", "dense"])
def test_inserted_priorities_activate_leaves_as_jax(sampler):
    """`use_inserted_priorities`: activation at (p + min_priority)^alpha
    from the stored "priority" field, max_priority raised; alpha = 1 and
    min_priority = 0 keep the tree exact, so it is bit-equal."""
    kw = dict(num_envs=E, steps_per_env=T, horizon=N_STEP, chunk_len=L,
              lookback=F - 1, sampler=sampler, alpha=1.0, min_priority=0.0,
              use_inserted_priorities=True)
    jcfg, tcfg = jreplay.ReplayConfig(**kw), treplay.ReplayConfig(**kw)
    jf, tf = _fields(True), _fields(False)
    jf["priority"], tf["priority"] = ((), jnp.float32), ((), torch.float32)
    js = jreplay.replay_init(jcfg, jf)
    ts = treplay.replay_init(tcfg, tf, torch.device("cpu"))
    rng = np.random.default_rng(3)
    for i in range(T // L + 3):
        c = _chunk(rng, prio=True)
        js = jreplay.replay_insert(jcfg, js,
                                   {k: jnp.asarray(v) for k, v in c.items()})
        treplay.replay_insert(tcfg, ts, c)
        np.testing.assert_array_equal(ts.tree.numpy(), np.asarray(js.tree),
                                      err_msg=f"insert {i}")
        assert ts.max_priority.item() == float(js.max_priority)
    assert ts.max_priority.item() > 1.0
    live = ttree.get(ts.tree, torch.arange(E * T)) if sampler == "tree" \
        else ts.tree[:E * T]
    assert len(set(live[live > 0].tolist())) > 3     # not all max-priority
