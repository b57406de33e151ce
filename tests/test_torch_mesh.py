"""Port parity: the mesh plane (`rltime_tpu_torch/parallel/mesh.py`).

  * One rank: the identity mesh and a real one-rank gloo group give the
    plain update step bit for bit (the JAX d=1 check,
    tests/test_parallel.py::test_one_shard_mesh_matches_local_exactly).
  * Two gloo ranks against JAX's `make_sharded_update_step` on a
    2-device mesh, from the same bridged weights and per-shard rings,
    with each shard's draws injected (`fold_in(key, shard)` per update):
    rings and trees bit-equal per shard after the inserts, the sampled
    updates' trees and parameters within 1e-5 after 3 updates, for PER
    and uniform replay; the parameters bit-identical across the ranks.
  * `pool_process_stats`: the pooled values truncate at `cap` per rank,
    the sum and the count stay exact.
"""
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist

import torch_port_draws as draws_lib
import torch_port_mp
from rltime_tpu.history.replay import ReplayConfig as JReplayConfig
from rltime_tpu.models.policy import ModelConfig as JModelConfig
from rltime_tpu.parallel.mesh import (
    make_mesh as jmake_mesh, make_sharded_insert as jmake_sharded_insert,
    make_sharded_update_step as jmake_sharded_update_step, shard_chunk,
    sharded_replay_init as jsharded_replay_init,
)
from rltime_tpu.training.learner import (
    AlgoConfig as JAlgoConfig, make_train_state as jmake_train_state,
)
from rltime_tpu_torch.history.replay import (
    ReplayConfig, replay_init, replay_insert,
)
from rltime_tpu_torch.models import bridge
from rltime_tpu_torch.models.policy import ModelConfig
from rltime_tpu_torch.parallel import census
from rltime_tpu_torch.parallel.mesh import (
    Mesh, make_mesh, make_sharded_insert, make_sharded_update_step,
    pool_process_stats,
)
from rltime_tpu_torch.training.learner import (
    AlgoConfig, make_train_state, make_update_step,
)
from torch_port_draws import one_intra_op_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_intra_op_thread")

E_LOCAL, T, L, N_STEP, B, D, UPDATES, CAP = 2, 64, 8, 3, 8, 2, 3, 5
JFIELDS = {"obs": ((4,), jnp.float32), "action": ((), jnp.int32),
           "reward": ((), jnp.float32), "terminated": ((), jnp.bool_),
           "done": ((), jnp.bool_)}
FIELDS = {"obs": ((4,), torch.float32), "action": ((), torch.int32),
          "reward": ((), torch.float32), "terminated": ((), torch.bool),
          "done": ((), torch.bool)}
MODEL = ModelConfig(num_actions=3, torso="mlp", mlp_hidden=(16,),
                    head="linear")
ALGO = dict(algo="dqn", batch_size=B, n_step=N_STEP, lr=1e-3,
            target_update_freq=5)


def _chunk(E, start):
    rng = np.random.default_rng(start)
    return dict(obs=rng.normal(size=(E, L, 4)).astype(np.float32),
                action=rng.integers(0, 3, size=(E, L)).astype(np.int32),
                reward=rng.normal(size=(E, L)).astype(np.float32),
                terminated=rng.random((E, L)) < 0.1,
                done=rng.random((E, L)) < 0.1)


# ----- one rank --------------------------------------------------------------

def _one_rank_run(mesh, prioritized):
    """4 inserts and 3 updates at seed 0; the plain update when `mesh` is
    None."""
    rcfg = ReplayConfig(num_envs=E_LOCAL, steps_per_env=T, horizon=N_STEP,
                        chunk_len=L, prioritized=prioritized)
    rstate = replay_init(rcfg, FIELDS, torch.device("cpu"))
    insert = (make_sharded_insert(rcfg, mesh) if mesh is not None
              else lambda s, c: replay_insert(rcfg, s, c))
    for k in range(4):
        rstate = insert(rstate, _chunk(E_LOCAL, k * L))
    ac = AlgoConfig(**ALGO)
    state = make_train_state(MODEL, ac, (4,), 0, torch.device("cpu"))
    if mesh is None:
        update = make_update_step(ac, rcfg, 1, True)
    else:
        state.generator = mesh.shard_generator(state.generator)
        update = make_sharded_update_step(MODEL, ac, rcfg, 1, True, mesh)
    for _ in range(UPDATES):
        state, rstate, m = update(state, rstate, 0.4)
    return state, rstate, m


@pytest.mark.parametrize("prioritized", [True, False])
def test_one_rank_group_equals_identity_and_plain_update(tmp_path,
                                                         prioritized):
    plain = _one_rank_run(None, prioritized)
    ident = _one_rank_run(make_mesh("cpu", size=1), prioritized)
    dist.init_process_group("gloo", init_method=f"file://{tmp_path}/rdv",
                            world_size=1, rank=0)
    try:
        mesh = make_mesh("cpu", size=1)
        assert mesh.distributed and mesh.size == 1
        census.reset_counts()
        group = _one_rank_run(mesh, prioritized)
        ents = census.entries()
    finally:
        dist.destroy_process_group()
    for other in (ident, group):
        for (k, a), b in zip(plain[0].model.state_dict().items(),
                             other[0].model.state_dict().values()):
            assert torch.equal(a, b), k
        assert torch.equal(plain[1].tree, other[1].tree)
        assert torch.equal(plain[1].max_priority, other[1].max_priority)
        for k in plain[2]:
            assert torch.equal(plain[2][k], other[2][k]), k
    # the one-rank group really issued: per update one gradient
    # all-reduce of the parameters, one metrics buffer, one MAX; per
    # insert one MAX
    n_params = sum(p.numel() for p in plain[0].model.parameters())
    sites = {(e["site"], e["bytes"]): e["count"] for e in ents}
    assert sites == {("grad", 4 * n_params): UPDATES,
                     ("metrics", 20): UPDATES,
                     ("max_priority", 4): UPDATES + 4}, ents


def test_d_above_one_needs_a_process_group():
    with pytest.raises(RuntimeError, match="init_process_group"):
        make_mesh("cpu", size=2)
    ident = make_mesh("cpu")
    assert not ident.distributed and ident.size == 1
    x = torch.arange(3.0)
    assert ident.mean_(x, "grad") is x and torch.equal(x, torch.arange(3.0))
    assert pool_process_stats([1.0, 2.0], 1, ident) == ([1.0, 2.0], 3.0, 2)


# ----- two ranks against the JAX 2-device mesh -------------------------------

@pytest.fixture(scope="module")
def two_ranks(tmp_path_factory):
    """JAX's sharded insert + 3 sharded updates on 2 devices (PER and
    uniform), and the port's on 2 gloo ranks from the same inputs."""
    work = tmp_path_factory.mktemp("mesh2")
    mesh = jmake_mesh(jax.devices()[:D])
    mcfg = JModelConfig(num_actions=3, torso="mlp", mlp_hidden=(16,),
                        head="linear")
    acfg = JAlgoConfig(**ALGO)
    chunks = [_chunk(D * E_LOCAL, k * L) for k in range(4)]
    jt0 = jmake_train_state(mcfg, acfg, jax.random.key(0), jnp.zeros((1, 4)))
    inp = dict(chunks=chunks, draws={}, model=bridge.flax_to_state_dict(
        MODEL, draws_lib.np_tree(jt0.params)),
        target=bridge.flax_to_state_dict(
            MODEL, draws_lib.np_tree(jt0.target_params)),
        stats=[np.arange(CAP + 3, dtype=np.float32),
               np.arange(2, dtype=np.float32) + 100.0])
    jax_out = {}
    for kind, prioritized in (("per", True), ("uni", False)):
        cfg = JReplayConfig(num_envs=E_LOCAL, steps_per_env=T,
                            horizon=N_STEP, chunk_len=L,
                            prioritized=prioritized)
        rstate = jsharded_replay_init(cfg, D, JFIELDS, mesh)
        insert = jmake_sharded_insert(cfg, mesh, rstate)
        for c in chunks:
            rstate = insert(rstate, shard_chunk(c, mesh))
        tree_insert = np.asarray(rstate.tree).reshape(D, -1)
        tstate = jmake_train_state(mcfg, acfg, jax.random.key(0),
                                   jnp.zeros((1, 4)))
        update = jmake_sharded_update_step(mcfg, acfg, cfg, 1, True, mesh,
                                           rstate)
        # each shard samples from fold_in(key, shard); the carried key
        # advances as split(key, 3)[0] (parallel/mesh.py:221-231)
        key, per_rank = tstate.key, [[] for _ in range(D)]
        span = 4 * L - N_STEP
        for _ in range(UPDATES):
            for s in range(D):
                k = jax.random.fold_in(key, s)
                d = (draws_lib.update_draws(k, B) if prioritized else
                     draws_lib.uniform_update_draws(k, B, span, E_LOCAL))
                per_rank[s].append({"u": [x.numpy() for x in d["u"]]
                                    if isinstance(d["u"], tuple)
                                    else d["u"].numpy()})
            key = jax.random.split(key, 3)[0]
            tstate, rstate, m = update(tstate, rstate, jnp.float32(0.4))
        inp["draws"][kind] = per_rank
        jax_out[kind] = dict(
            tree_insert=tree_insert,
            tree=np.asarray(rstate.tree).reshape(D, -1),
            obs=np.asarray(rstate.storage["obs"]).reshape(
                (D, E_LOCAL) + rstate.storage["obs"].shape[1:]),
            max_priority=float(rstate.max_priority), t=int(rstate.t),
            params=bridge.flax_to_state_dict(
                MODEL, draws_lib.np_tree(tstate.params)),
            metrics={k: float(v) for k, v in m.items()})
    torch_port_mp.save_tree(os.path.join(work, "in.npz"), inp)
    with open(os.path.join(work, "cfg.json"), "w") as f:
        json.dump(dict(E_local=E_LOCAL, T=T, L=L, n_step=N_STEP, B=B,
                       cap=CAP), f)
    return jax_out, torch_port_mp.run_ranks("sharded_update", D, str(work))


@pytest.mark.parametrize("kind", ["per", "uni"])
def test_two_ranks_match_the_jax_two_device_mesh(two_ranks, kind):
    jax_out, ranks = two_ranks
    j = jax_out[kind]
    for s, out in enumerate(ranks):
        o = out[kind]
        # the integer plane: per-shard rings and trees after the inserts
        np.testing.assert_array_equal(o["obs"], j["obs"][s])
        np.testing.assert_array_equal(o["tree_insert"], j["tree_insert"][s])
        assert int(o["t"]) == j["t"] and int(o["updates"]) == UPDATES
        # the float plane after 3 updates on each shard's own draws
        np.testing.assert_allclose(o["tree"], j["tree"][s], rtol=1e-5,
                                   atol=1e-6)
        np.testing.assert_allclose(float(o["max_priority"]),
                                   j["max_priority"], rtol=1e-5)
        for k, v in j["params"].items():
            np.testing.assert_allclose(o["params"][k], v, rtol=1e-5,
                                       atol=1e-6, err_msg=k)
        for k, v in j["metrics"].items():
            np.testing.assert_allclose(float(o["metrics"][k]), v, rtol=1e-5,
                                       err_msg=k)
    if kind == "per":
        # the shards sampled different leaves, so their trees differ
        assert not np.array_equal(ranks[0][kind]["tree"],
                                  ranks[1][kind]["tree"])


@pytest.mark.parametrize("kind", ["per", "uni"])
def test_parameters_are_bit_identical_across_ranks(two_ranks, kind):
    _, ranks = two_ranks
    for k, v in ranks[0][kind]["params"].items():
        np.testing.assert_array_equal(ranks[1][kind]["params"][k], v,
                                      err_msg=k)
    for k, v in ranks[0][kind]["metrics"].items():
        np.testing.assert_array_equal(ranks[1][kind]["metrics"][k], v)


def test_sharded_update_census_at_two_ranks(two_ranks):
    """One update at d=2: one gradient all-reduce of the parameters, one
    metrics buffer, one MAX: nothing on the sample or gather path."""
    _, ranks = two_ranks
    n_params = sum(v.size for v in ranks[0]["per"]["params"].values())
    for out in ranks:
        ents = json.loads(str(out["per"]["census"]))
        assert {(e["op"], e["site"], e["bytes"], e["count"]) for e in ents} \
            == {("all_reduce", "grad", 4 * n_params, 1),
                ("all_reduce", "metrics", 20, 1),
                ("all_reduce", "max_priority", 4, 1)}, ents


def test_pool_process_stats_truncates_the_pool_not_the_totals(two_ranks):
    _, ranks = two_ranks
    vals = [np.arange(CAP + 3, dtype=np.float32),
            np.arange(2, dtype=np.float32) + 100.0]
    want_pool = sorted(list(vals[0][:CAP]) + list(vals[1]))
    for out in ranks:
        st = out["stats"]
        assert sorted(st["pooled"].tolist()) == want_pool
        assert float(st["sum"]) == float(vals[0].sum() + vals[1].sum())
        assert int(st["n"]) == CAP + 3 + 2


def test_mesh_repr_and_lead():
    m = Mesh(1, 4, "cpu")
    assert not m.is_lead and "rank=1" in repr(m) and m.lead_value(3.0) == 3.0
