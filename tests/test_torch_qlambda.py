"""Port parity: feed-forward Q(lambda) (`algo.use_lambda`, algo "dqn").

One learner update with Peng's Q(lambda) target over the n-step window
against the JAX update step on the same replay contents, weights and
PER uniforms: sampled leaves bit-equal, loss / |TD| / grad norm / new
priorities to rtol 1e-5 (f32), params after Adam to atol 1e-6; on the
image path (frame stack 4: the n+1 stacks come from one window-gather
launch, none of the union gather) and the vector path (frame stack 1).
Within the port, `n_step = 1` (any lambda) and `lambda_ = 1.0` reduce to
the n-step update (rtol 1e-6: the same target summed in another order),
an intermediate lambda does not, and IQN refuses `use_lambda` with the
reference's message.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rltime_tpu.models.policy import ModelConfig as JModelConfig
from rltime_tpu.models.policy import init_params
from rltime_tpu.training import learner as jlearner
from rltime_tpu_torch.models import bridge
from rltime_tpu_torch.models.policy import ModelConfig
from rltime_tpu_torch.ops import gather
from rltime_tpu_torch.training import learner as tlearner
from test_torch_learner import CNN, F, _np_tree, _replays
import test_torch_uniform_replay as vec
from torch_port_draws import one_intra_op_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_intra_op_thread")

B = 16


def _algo_kw(n_step, lam, use_lambda=True):
    return dict(batch_size=B, n_step=n_step, gamma=0.97, lr=1e-3,
                adam_eps=1e-6, grad_clip=0.05, target_update_freq=100,
                use_lambda=use_lambda, lambda_=lam, debug_outputs=True)


def _port_state(tmc, talgo, in_shape, params, target_params):
    ts = tlearner.make_train_state(tmc, talgo, in_shape, seed=0,
                                   device=torch.device("cpu"))
    ts.model.load_state_dict(bridge.flax_to_state_dict(tmc,
                                                       _np_tree(params)))
    ts.target.load_state_dict(bridge.flax_to_state_dict(
        tmc, _np_tree(target_params)))
    return ts


def _compare(tm, jm, trs, jrs, ts, js, tmc):
    np.testing.assert_array_equal(tm["debug_leaf"].numpy(),
                                  np.asarray(jm["debug_leaf"]))
    for k in ("loss", "grad_norm", "td_abs", "q", "mean_weight"):
        np.testing.assert_allclose(tm[k].item(), float(jm[k]), rtol=1e-5,
                                   err_msg=k)
    # atol: a per-sample |TD| near 0 has no meaningful relative error
    np.testing.assert_allclose(tm["debug_td"].numpy(),
                               np.asarray(jm["debug_td"]), rtol=1e-5,
                               atol=1e-6)
    np.testing.assert_allclose(trs.tree.numpy(), np.asarray(jrs.tree),
                               rtol=1e-5)
    back = bridge.state_dict_to_flax(tmc, ts.model.state_dict())
    jax.tree.map(lambda a, b: np.testing.assert_allclose(
        a, np.asarray(b), rtol=0, atol=1e-6), back, _np_tree(js.params))


@pytest.mark.parametrize("lam", [0.7, 0.0])
def test_image_update_matches_jax(lam):
    n = 3
    jcfg, jrs, tcfg, trs = _replays()       # horizon 3, frame stack 4
    jmc, tmc = JModelConfig(**CNN), ModelConfig(**CNN)
    jalgo = jlearner.AlgoConfig(**_algo_kw(n, lam))
    ex = jnp.zeros((1, F, 84, 84), jnp.uint8)
    js = jlearner.make_train_state(jmc, jalgo, jax.random.key(7), ex)
    js = js.replace(target_params=init_params(jmc, jax.random.key(8), ex))
    _, skey, _ = jax.random.split(js.key, 3)
    u = torch.from_numpy(np.array(jax.random.uniform(skey, (B,))))
    talgo = tlearner.AlgoConfig(**_algo_kw(n, lam))
    ts = _port_state(tmc, talgo, (F, 84, 84), js.params, js.target_params)
    js2, jrs2, jm = jax.jit(jlearner.make_update_step(
        jmc, jalgo, jcfg, F, flatten=False))(js, jrs, jnp.float32(0.6))
    before = dict(gather.PLAIN_CALLS)
    ts, trs, tm = tlearner.make_update_step(talgo, tcfg, F, False)(
        ts, trs, 0.6, u=u)
    # frames, dones, strips and the action: one K1 call, no K2
    calls = {k: v - before[k] for k, v in gather.PLAIN_CALLS.items()}
    assert calls == {"window_gather": 1, "union_gather": 0}
    _compare(tm, jm, trs, jrs2, ts, js2, tmc)


def test_vector_update_matches_jax():
    """Frame stack 1, MLP, uniform replay, n = 3, lambda 0.5."""
    n, lam = 3, 0.5
    jcfg, jrs, tcfg, trs = vec._replays(n_step=n, chunks=6)
    jmc, tmc = JModelConfig(**vec.MLP), ModelConfig(**vec.MLP)
    jalgo = jlearner.AlgoConfig(**_algo_kw(n, lam))
    ex = jnp.zeros((1, vec.D), jnp.float32)
    js = jlearner.make_train_state(jmc, jalgo, jax.random.key(3), ex)
    js = js.replace(target_params=init_params(jmc, jax.random.key(4), ex))
    import torch_port_draws as draws_lib
    from rltime_tpu_torch.history import replay as treplay
    lo, hi = treplay.valid_range(tcfg, trs.t)
    d = draws_lib.uniform_update_draws(js.key, B, hi - lo, vec.E)
    talgo = tlearner.AlgoConfig(**_algo_kw(n, lam))
    ts = _port_state(tmc, talgo, (vec.D,), js.params, js.target_params)
    js2, jrs2, jm = jax.jit(jlearner.make_update_step(
        jmc, jalgo, jcfg, 1, flatten=True))(js, jrs, jnp.float32(0.4))
    ts, trs, tm = tlearner.make_update_step(talgo, tcfg, 1, True)(
        ts, trs, 0.4, **d)
    _compare(tm, jm, trs, jrs2, ts, js2, tmc)


def _port_update(n_step, lam, use_lambda, seed=0):
    """One port update on fresh copies of the same state."""
    from rltime_tpu_torch.history import replay as treplay
    rng = np.random.default_rng(seed)
    E, T, L = 2, 64, 8
    tcfg = treplay.ReplayConfig(num_envs=E, steps_per_env=T,
                                horizon=n_step, chunk_len=L, lookback=F - 1)
    trs = treplay.replay_init(tcfg, {
        "obs": ((12, 12), torch.uint8), "action": ((), torch.int32),
        "reward": ((), torch.float32), "terminated": ((), torch.bool),
        "done": ((), torch.bool)}, torch.device("cpu"))
    for _ in range(6):
        done = rng.random((E, L)) < 0.15
        treplay.replay_insert(tcfg, trs, dict(
            obs=rng.integers(0, 256, (E, L, 12, 12), dtype=np.uint8),
            action=rng.integers(0, 3, (E, L)).astype(np.int32),
            reward=rng.normal(size=(E, L)).astype(np.float32),
            terminated=done & (rng.random((E, L)) < 0.5), done=done))
    tmc = ModelConfig(num_actions=3, torso="mlp", mlp_hidden=(16,),
                      head="linear")
    # adam_eps well above |grad| keeps Adam's first step lr*g/(|g|+eps)
    # Lipschitz in g, so a last-bit change in a gradient cannot move a
    # parameter by a whole lr
    talgo = tlearner.AlgoConfig(**dict(_algo_kw(n_step, lam, use_lambda),
                                       adam_eps=1e-3))
    ts = tlearner.make_train_state(tmc, talgo, (F * 144,), seed=1,
                                   device=torch.device("cpu"))
    with torch.no_grad():       # a target net that differs
        for p in ts.target.parameters():
            p.add_(0.05 * torch.randn(p.shape,
                                      generator=torch.Generator()
                                      .manual_seed(5)))
    u = torch.from_numpy(rng.random(B).astype(np.float32))
    ts, trs, m = tlearner.make_update_step(talgo, tcfg, F, True)(
        ts, trs, 0.5, u=u)
    return m, trs, ts


@pytest.mark.parametrize("n_step,lam", [(1, 0.3), (1, 0.9), (3, 1.0),
                                        (5, 1.0)])
def test_lambda_reduces_to_nstep(n_step, lam):
    m_a, rs_a, ts_a = _port_update(n_step, lam, False)
    m_b, rs_b, ts_b = _port_update(n_step, lam, True)
    assert torch.equal(m_a["debug_leaf"], m_b["debug_leaf"])
    for k in ("loss", "grad_norm", "td_abs"):
        np.testing.assert_allclose(m_b[k].item(), m_a[k].item(), rtol=1e-6)
    np.testing.assert_allclose(rs_b.tree.numpy(), rs_a.tree.numpy(),
                               rtol=1e-5)
    for a, b in zip(ts_a.model.parameters(), ts_b.model.parameters()):
        np.testing.assert_allclose(b.detach().numpy(), a.detach().numpy(),
                                   rtol=0, atol=1e-6)


def test_intermediate_lambda_differs():
    m_a, _, _ = _port_update(3, 0.5, False, seed=2)
    m_b, _, _ = _port_update(3, 0.5, True, seed=2)
    assert np.isfinite(m_b["loss"].item())
    assert abs(m_a["loss"].item() - m_b["loss"].item()) > 1e-6


def test_iqn_refuses_use_lambda():
    from rltime_tpu_torch.history import replay as treplay
    tcfg = treplay.ReplayConfig(num_envs=2, steps_per_env=64, horizon=3,
                                chunk_len=8)
    with pytest.raises(ValueError, match="not 'iqn'"):
        tlearner.make_update_step(
            tlearner.AlgoConfig(algo="iqn", use_lambda=True), tcfg, 1, True)
