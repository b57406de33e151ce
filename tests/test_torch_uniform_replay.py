"""Port parity: uniform replay (`replay.prioritized = false`).

Against the JAX package on the CPU: the (1,) dummy tree, sampling under
the JAX side's own integer draws (two `randint`s on two split keys,
replayed by `torch_port_draws.uniform_update_draws`) with env, col and
leaf bit-equal and all weights 1, `replay_update_priorities` as the
identity, an insert that writes no tree, and a run of eight learner
updates of config #1's shape (MLP, frame_stack 1, 1-step double DQN,
Adam under a linear LR decay) from the JAX side's weights: sampled
leaves bit-equal in every update, loss / |TD| / grad norm to rtol 1e-5
(f32), params after the eight Adam steps to atol 1e-6.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_port_draws as draws_lib
from rltime_tpu.history import replay as jreplay
from rltime_tpu.models.policy import ModelConfig as JModelConfig
from rltime_tpu.training import learner as jlearner
from rltime_tpu_torch.history import replay as treplay
from rltime_tpu_torch.models import bridge
from rltime_tpu_torch.models.policy import ModelConfig
from rltime_tpu_torch.training import learner as tlearner
from torch_port_draws import one_intra_op_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_intra_op_thread")

E, T, L, D, A = 4, 64, 8, 4, 2
MLP = dict(num_actions=A, torso="mlp", mlp_hidden=(16, 16), head="linear")


def _replays(n_step=1, chunks=5, seed=0):
    kw = dict(num_envs=E, steps_per_env=T, horizon=n_step, chunk_len=L,
              prioritized=False)
    jcfg, tcfg = jreplay.ReplayConfig(**kw), treplay.ReplayConfig(**kw)
    js = jreplay.replay_init(jcfg, {
        "obs": ((D,), jnp.float32), "action": ((), jnp.int32),
        "reward": ((), jnp.float32), "terminated": ((), jnp.bool_),
        "done": ((), jnp.bool_)})
    ts = treplay.replay_init(tcfg, {
        "obs": ((D,), torch.float32), "action": ((), torch.int32),
        "reward": ((), torch.float32), "terminated": ((), torch.bool),
        "done": ((), torch.bool)}, torch.device("cpu"))
    rng = np.random.default_rng(seed)
    for _ in range(chunks):
        done = rng.random((E, L)) < 0.15
        chunk = dict(
            obs=rng.normal(size=(E, L, D)).astype(np.float32),
            action=rng.integers(0, A, (E, L)).astype(np.int32),
            reward=rng.normal(size=(E, L)).astype(np.float32),
            terminated=done & (rng.random((E, L)) < 0.6), done=done)
        js = jreplay.replay_insert(
            jcfg, js, {k: jnp.asarray(v) for k, v in chunk.items()})
        treplay.replay_insert(tcfg, ts, chunk)
    return jcfg, js, tcfg, ts


@pytest.mark.parametrize("chunks", [1, 5, 20])      # before and after a wrap
def test_uniform_sampling_under_replayed_jax_draws(chunks):
    jcfg, js, tcfg, ts = _replays(n_step=3, chunks=chunks)
    assert tuple(ts.tree.shape) == tuple(js.tree.shape) == (1,)
    assert ts.t == int(js.t) == chunks * L
    lo, hi = treplay.valid_range(tcfg, ts.t)
    jlo, jhi = jreplay.valid_range(jcfg, js.t)
    assert (lo, hi) == (int(jlo), int(jhi))
    B = 32
    key = jax.random.key(chunks)
    ji = jreplay.replay_sample_indices(jcfg, js, key, B, 0.4)
    ukey, ekey = jax.random.split(key)
    u = (torch.from_numpy(np.array(
            jax.random.randint(ukey, (B,), 0, max(hi - lo, 1)))),
         torch.from_numpy(np.array(jax.random.randint(ekey, (B,), 0, E))))
    ti = treplay.replay_sample_indices(tcfg, ts, B, 0.4, u=u)
    for k in ("env", "col", "leaf"):
        np.testing.assert_array_equal(ti[k].numpy(), np.asarray(ji[k]),
                                      err_msg=k)
    assert ti["env"].dtype == ti["col"].dtype == torch.int32
    assert ti["num_valid"] == int(ji["num_valid"])
    assert ti["weight"].tolist() == [1.0] * B
    # every sampled column lies in the valid range
    col_u = (ti["col"].long() - lo) % T + lo
    assert bool(((col_u >= lo) & (col_u < hi)).all())
    # the write-back is the identity
    before = ts.tree.clone()
    out = treplay.replay_update_priorities(tcfg, ts, ti["leaf"],
                                           torch.rand(B))
    assert out is ts and torch.equal(ts.tree, before)
    assert ts.max_priority.item() == 1.0


def test_uniform_sampling_from_the_generator():
    _, _, tcfg, ts = _replays(chunks=6)
    g = torch.Generator().manual_seed(0)
    a = treplay.replay_sample_indices(tcfg, ts, 512, 0.4, generator=g)
    lo, hi = treplay.valid_range(tcfg, ts.t)
    assert set(a["env"].tolist()) == set(range(E))
    assert set(a["col"].tolist()) == {c % T for c in range(lo, hi)}
    g2 = torch.Generator().manual_seed(0)
    off = torch.randint(0, hi - lo, (512,), generator=g2)   # offsets first
    env = torch.randint(0, E, (512,), generator=g2)
    assert torch.equal(a["col"].long(), (lo + off) % T)
    assert torch.equal(a["env"].long(), env)


def test_eight_updates_of_config_1_shape_match_jax():
    K, B = 8, 16
    algo_kw = dict(batch_size=B, n_step=1, gamma=0.99, lr=5e-3,
                   lr_decay_updates=6, target_update_freq=3,
                   debug_outputs=True)
    jcfg, jrs, tcfg, trs = _replays(chunks=6)
    jmc, tmc = JModelConfig(**MLP), ModelConfig(**MLP)
    jalgo, talgo = jlearner.AlgoConfig(**algo_kw), tlearner.AlgoConfig(
        **algo_kw)
    js = jlearner.make_train_state(jmc, jalgo, jax.random.key(7),
                                   jnp.zeros((1, D), jnp.float32))
    ts = tlearner.make_train_state(tmc, talgo, (D,), seed=0,
                                   device=torch.device("cpu"))
    for net in (ts.model, ts.target):
        net.load_state_dict(bridge.flax_to_state_dict(
            tmc, draws_lib.np_tree(js.params)))
    jupd = jax.jit(jlearner.make_update_step(jmc, jalgo, jcfg, 1,
                                             flatten=True))
    tupd = tlearner.make_update_step(talgo, tcfg, 1, flatten=True)
    lo, hi = treplay.valid_range(tcfg, trs.t)
    for k in range(K):
        d = draws_lib.uniform_update_draws(js.key, B, hi - lo, E)
        js, jrs, jm = jupd(js, jrs, jnp.float32(0.4))
        ts, trs, tm = tupd(ts, trs, 0.4, **d)
        np.testing.assert_array_equal(tm["debug_leaf"].numpy(),
                                      np.asarray(jm["debug_leaf"]),
                                      err_msg=f"update {k}")
        np.testing.assert_array_equal(tm["debug_action"].numpy(),
                                      np.asarray(jm["debug_action"]))
        for name in ("loss", "grad_norm", "td_abs", "q", "mean_weight"):
            np.testing.assert_allclose(tm[name].item(), float(jm[name]),
                                       rtol=1e-5, err_msg=f"{name} {k}")
    assert ts.updates == int(js.updates) == K
    for sd, jp in ((ts.model.state_dict(), js.params),
                   (ts.target.state_dict(), js.target_params)):
        back = bridge.state_dict_to_flax(tmc, sd)
        jax.tree.map(lambda a, b: np.testing.assert_allclose(
            a, np.asarray(b), rtol=0, atol=1e-6), back, draws_lib.np_tree(jp))
