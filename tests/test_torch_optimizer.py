"""Port parity: centered RMSProp (`algo.optimizer = "rmsprop"`).

`training/learner.py:CenteredRMSProp` against `optax.rmsprop(...,
centered=True)` as the JAX package builds it (eps INSIDE the root, zero
initial mu and nu), under the global-norm clip and the linear LR decay:
three steps from bridged parameters on the same gradients, params to
rtol 1e-5 / atol 1e-7 (f32; the moments are sums of products in another
order), mu and nu to rtol 1e-5 / atol 1e-7 (mu sums gradients of both
signs, so an entry near 0 has no meaningful relative error). Also one whole learner update with
RMSProp against the JAX update step, the optimizer state through a
checkpoint, and that `torch.optim.RMSprop`'s rule (eps outside the
root) is NOT what is computed.
"""
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from rltime_tpu.models.policy import ModelConfig as JModelConfig
from rltime_tpu.models.policy import init_params
from rltime_tpu.training import learner as jlearner
from rltime_tpu_torch.models import bridge
from rltime_tpu_torch.models.policy import ModelConfig, QPolicy
from rltime_tpu_torch.training import checkpoint as ckpt_lib
from rltime_tpu_torch.training import learner as tlearner
from torch_port_draws import one_intra_op_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_intra_op_thread")

MLP = dict(num_actions=3, torso="mlp", mlp_hidden=(16, 8), head="dueling",
           dueling_hidden=8)


def _np_tree(t):
    return jax.tree.map(np.asarray, t)


def _rmsprop_state(opt_state):
    """(mu, nu) of optax's rmsprop state inside the chain."""
    for s in jax.tree.leaves(opt_state, is_leaf=lambda x: hasattr(x, "mu")):
        if hasattr(s, "mu"):
            return s.mu, s.nu
    raise AssertionError("no rmsprop state")


@pytest.mark.parametrize("grad_clip,decay_updates", [(0.0, 0), (0.5, 2),
                                                     (10.0, 0)])
def test_three_rmsprop_steps_match_optax(grad_clip, decay_updates):
    kw = dict(optimizer="rmsprop", lr=1e-2, lr_end=1e-3,
              lr_decay_updates=decay_updates, rmsprop_decay=0.9,
              adam_eps=1e-6, grad_clip=grad_clip, target_update_freq=100)
    jcfg, tcfg = JModelConfig(**MLP), ModelConfig(**MLP)
    params = init_params(jcfg, jax.random.key(0), jnp.zeros((1, 5)))
    tx = jlearner.make_optimizer(jlearner.AlgoConfig(**kw))
    opt_state = tx.init(params)

    algo = tlearner.AlgoConfig(**kw)
    ts = tlearner.make_train_state(tcfg, algo, (5,), 0, torch.device("cpu"))
    assert isinstance(ts.optimizer, tlearner.CenteredRMSProp)
    ts.model.load_state_dict(bridge.flax_to_state_dict(tcfg,
                                                       _np_tree(params)))
    rng = np.random.default_rng(1)
    x = torch.from_numpy(rng.normal(size=(8, 5)).astype(np.float32))
    for step in range(3):
        # a loss whose gradient the two sides compute from the same
        # inputs: sum of squared Q on a fixed batch, scaled per step
        scale = float(step + 1)

        def jloss(p):
            from rltime_tpu.models.policy import make_model
            q, _ = make_model(jcfg).apply(p, jnp.asarray(x.numpy()), ())
            return scale * jnp.sum(q * q)
        grads = jax.grad(jloss)(params)
        upd, opt_state = tx.update(grads, opt_state, params)
        params = optax.apply_updates(params, upd)

        loss = scale * torch.sum(ts.model(x) ** 2)
        g_norm = tlearner.apply_gradients(algo, ts, loss)
        np.testing.assert_allclose(g_norm.item(),
                                   float(optax.global_norm(grads)),
                                   rtol=1e-5)
        back = bridge.state_dict_to_flax(tcfg, ts.model.state_dict())
        jax.tree.map(lambda a, b: np.testing.assert_allclose(
            a, np.asarray(b), rtol=1e-5, atol=1e-7), back, _np_tree(params))
    assert ts.updates == 3
    # the moments, carried across like parameters
    mu, nu = _rmsprop_state(opt_state)
    for name, tree in (("mu", mu), ("nu", nu)):
        want = bridge.flax_to_state_dict(tcfg, _np_tree(tree))
        for pname, p in ts.model.named_parameters():
            np.testing.assert_allclose(
                ts.optimizer.state[p][name].numpy(), want[pname].numpy(),
                rtol=1e-5, atol=1e-7, err_msg=f"{name} {pname}")


def test_eps_is_inside_the_root():
    """One step on one weight: g / sqrt(nu - mu^2 + eps), where torch's
    own RMSprop computes g / (sqrt(nu - mu^2) + eps)."""
    g, decay, eps, lr = 0.5, 0.9, 1e-2, 0.1
    w = torch.nn.Parameter(torch.zeros(1))
    opt = tlearner.CenteredRMSProp([w], lr=lr, decay=decay, eps=eps)
    w.grad = torch.tensor([g])
    opt.step()
    mu, nu = (1 - decay) * g, (1 - decay) * g * g
    inside = -lr * g / np.sqrt(nu - mu * mu + eps)
    outside = -lr * g / (np.sqrt(nu - mu * mu) + eps)
    np.testing.assert_allclose(w.item(), inside, rtol=1e-6)
    assert abs(inside - outside) > 1e-3 * abs(inside)
    tx = optax.rmsprop(lr, decay=decay, eps=eps, centered=True)
    upd, _ = tx.update({"w": jnp.array([g])}, tx.init({"w": jnp.zeros(1)}))
    np.testing.assert_allclose(w.item(), float(upd["w"][0]), rtol=1e-6)


def test_update_step_with_rmsprop_matches_jax():
    from test_torch_learner import CNN, F, N_STEP, _replays
    algo_kw = dict(batch_size=16, n_step=N_STEP, gamma=0.97, lr=1e-3,
                   adam_eps=1e-4, grad_clip=0.05, optimizer="rmsprop",
                   target_update_freq=1, debug_outputs=True)
    jcfg, jrs, tcfg, trs = _replays()
    jmc, tmc = JModelConfig(**CNN), ModelConfig(**CNN)
    jalgo = jlearner.AlgoConfig(**algo_kw)
    js = jlearner.make_train_state(jmc, jalgo, jax.random.key(7),
                                   jnp.zeros((1, F, 84, 84), jnp.uint8))
    _, skey, _ = jax.random.split(js.key, 3)
    u = torch.from_numpy(np.array(jax.random.uniform(skey, (16,))))
    talgo = tlearner.AlgoConfig(**algo_kw)
    ts = tlearner.make_train_state(tmc, talgo, (F, 84, 84), 0,
                                   torch.device("cpu"))
    for net in (ts.model, ts.target):
        net.load_state_dict(bridge.flax_to_state_dict(tmc,
                                                      _np_tree(js.params)))
    js2, _, jm = jax.jit(jlearner.make_update_step(
        jmc, jalgo, jcfg, F, flatten=False))(js, jrs, jnp.float32(0.6))
    ts, _, tm = tlearner.make_update_step(talgo, tcfg, F, False)(
        ts, trs, 0.6, u=u)
    np.testing.assert_array_equal(tm["debug_leaf"].numpy(),
                                  np.asarray(jm["debug_leaf"]))
    for k in ("loss", "grad_norm", "td_abs"):
        np.testing.assert_allclose(tm[k].item(), float(jm[k]), rtol=1e-5)
    # atol: the first centered step is lr * g / sqrt(decay (1 - decay)
    # g^2 + eps), about 4.6 lr wherever |g| is well above sqrt(eps): an
    # f32 difference in g moves it by far less than 1e-6
    back = bridge.state_dict_to_flax(tmc, ts.model.state_dict())
    jax.tree.map(lambda a, b: np.testing.assert_allclose(
        a, np.asarray(b), rtol=0, atol=2e-6), back, _np_tree(js2.params))


def test_checkpoint_carries_mu_and_nu(tmp_path):
    algo = tlearner.AlgoConfig(optimizer="rmsprop", lr=1e-2)
    tcfg = ModelConfig(**MLP)
    a = tlearner.make_train_state(tcfg, algo, (5,), 0, torch.device("cpu"))
    x = torch.randn(4, 5, generator=torch.Generator().manual_seed(0))
    for _ in range(2):
        tlearner.apply_gradients(algo, a, torch.sum(a.model(x) ** 2))
    ckpt_lib.save(str(tmp_path), 7, a, {"env_steps": 7, "updates": 2})
    b = tlearner.make_train_state(tcfg, algo, (5,), 1, torch.device("cpu"))
    ckpt_lib.load_train_state(b, ckpt_lib.restore(str(tmp_path)))
    for pa, pb in zip(a.model.parameters(), b.model.parameters()):
        assert torch.equal(pa, pb)
        for k in ("mu", "nu"):
            assert torch.equal(a.optimizer.state[pa][k],
                               b.optimizer.state[pb][k])
            assert a.optimizer.state[pa][k].abs().sum() > 0
    for t in (a, b):        # and the next step is the same
        tlearner.apply_gradients(algo, t, torch.sum(t.model(x) ** 2))
    for pa, pb in zip(a.model.parameters(), b.model.parameters()):
        assert torch.equal(pa, pb)


def test_unknown_optimizer_is_refused():
    with pytest.raises(ValueError, match="unknown optimizer"):
        tlearner.AlgoConfig(optimizer="sgd")
