"""Port parity: the recurrent policy and the returns and losses R2D2 adds.

The port's LSTM (flax `OptimizedLSTMCell`) through the weight bridge,
one recurrent step and `unroll` with mid-sequence resets, value
rescaling, lambda returns, the truncation suffix mask and the sequence
priority, against the JAX package on the CPU at float32 (conftest sets
JAX's matmul precision to "highest"). flax adds a gate's input and
hidden projections in another order than one fused matmul would, so
forwards compare to rtol 1e-5; returns and losses to rtol 1e-6. Also
the golden rule of burn-in: its gradient is exactly zero.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rltime_tpu.models import policy as jpolicy
from rltime_tpu.ops import losses as jlosses
from rltime_tpu.ops import returns as jreturns
from rltime_tpu_torch.models import bridge
from rltime_tpu_torch.models import policy as tpolicy
from rltime_tpu_torch.ops import losses as tlosses
from rltime_tpu_torch.ops import returns as treturns

MLP = dict(num_actions=3, torso="mlp", mlp_hidden=(12,), head="linear",
           lstm_size=8)
CNN = dict(num_actions=5, torso="nature_cnn", cnn_channels=(8, 8, 8),
           cnn_fc=32, head="dueling", dueling_hidden=8, lstm_size=16)


# jitted: one compile per model config, where eager flax init compiles
# op by op (about 14 s for the CNN + LSTM on a CPU)
_init_params = jax.jit(jpolicy.init_params, static_argnums=0)


def _np_tree(params):
    return jax.tree.map(np.asarray, params)


def _example(kw, batch, frame_stack=4):
    """A (batch, *in_shape) example input for the model config."""
    if kw["torso"] == "mlp":
        return np.zeros((batch, 4), np.float32)
    return np.zeros((batch, frame_stack, 84, 84), np.uint8)


def _port_model(kw, flax_params):
    cfg = tpolicy.ModelConfig(**kw)
    model = tpolicy.QPolicy(cfg, _example(kw, 1).shape[1:])
    model.load_state_dict(bridge.flax_to_state_dict(cfg, _np_tree(
        flax_params)))
    return model


def test_returns_and_sequence_priority_match_jax():
    rng = np.random.default_rng(0)
    B, L = 16, 9
    x = (rng.normal(size=(B, L)) * 30).astype(np.float32)
    for jf, tf in ((jreturns.value_rescale, treturns.value_rescale),
                   (jreturns.value_rescale_inv, treturns.value_rescale_inv)):
        np.testing.assert_allclose(tf(torch.from_numpy(x)).numpy(),
                                   np.asarray(jf(jnp.asarray(x))), rtol=1e-6)
    rew = rng.normal(size=(B, L)).astype(np.float32)
    values = rng.normal(size=(B, L)).astype(np.float32)
    done = rng.random((B, L)) < 0.25
    term = done & (rng.random((B, L)) < 0.5)
    g_j = jreturns.lambda_returns(jnp.asarray(rew), jnp.asarray(done),
                                  jnp.asarray(values), 0.97, 0.8)
    g_t = treturns.lambda_returns(torch.from_numpy(rew),
                                  torch.from_numpy(done),
                                  torch.from_numpy(values), 0.97, 0.8)
    np.testing.assert_allclose(g_t.numpy(), np.asarray(g_j), rtol=1e-6,
                               atol=1e-6)
    m_j = jreturns.truncation_suffix_mask(jnp.asarray(term),
                                          jnp.asarray(done))
    m_t = treturns.truncation_suffix_mask(torch.from_numpy(term),
                                          torch.from_numpy(done))
    np.testing.assert_array_equal(m_t.numpy(), np.asarray(m_j))
    assert 0 < m_t.sum() < B * L
    td = np.abs(rng.normal(size=(B, L))).astype(np.float32)
    p_j = jlosses.sequence_priority(jnp.asarray(td), m_j, 0.9)
    p_t = tlosses.sequence_priority(torch.from_numpy(td), m_t, 0.9)
    np.testing.assert_allclose(p_t.numpy(), np.asarray(p_j), rtol=1e-6)


@pytest.mark.parametrize("kw", [MLP, CNN], ids=["mlp", "cnn"])
def test_lstm_bridge_round_trip_is_exact(kw):
    cfg = tpolicy.ModelConfig(**kw)
    params = _np_tree(_init_params(jpolicy.ModelConfig(**kw),
                                   jax.random.key(1),
                                   jnp.asarray(_example(kw, 1))))
    model = tpolicy.QPolicy(cfg, _example(kw, 1).shape[1:])
    sd = bridge.flax_to_state_dict(cfg, params)
    assert set(sd) == set(model.state_dict())
    model.load_state_dict(sd)
    back = bridge.state_dict_to_flax(cfg, model.state_dict())
    jax.tree.map(np.testing.assert_array_equal, back, params)


@pytest.mark.parametrize("kw", [MLP, CNN], ids=["mlp", "cnn"])
def test_lstm_step_and_unroll_match_flax(kw):
    """One recurrent step, and a 7-step unroll with resets mid-sequence,
    from a nonzero carry."""
    rng = np.random.default_rng(2)
    B, T, H = 3, 7, kw["lstm_size"]
    if kw["torso"] == "mlp":
        obs = rng.normal(size=(B, T, 4)).astype(np.float32)
    else:
        obs = rng.integers(0, 256, (B, T, 4, 84, 84), dtype=np.uint8)
    done_prev = np.zeros((B, T), bool)
    done_prev[0, 3] = done_prev[2, 1] = done_prev[2, 5] = True
    c0, h0 = (rng.normal(size=(B, H)).astype(np.float32) * 0.5
              for _ in range(2))
    jcfg = jpolicy.ModelConfig(**kw)
    params = _init_params(jcfg, jax.random.key(3),
                          jnp.asarray(_example(kw, 1)))
    jmodel = jpolicy.make_model(jcfg)
    model = _port_model(kw, params)

    q_j, (c_j, h_j) = jmodel.apply(params, jnp.asarray(obs[:, 0]),
                                   (jnp.asarray(c0), jnp.asarray(h0)))
    with torch.no_grad():
        q_t, (c_t, h_t) = model(torch.from_numpy(obs[:, 0]),
                                (torch.from_numpy(c0), torch.from_numpy(h0)))
    for a, b in ((q_t, q_j), (c_t, c_j), (h_t, h_j)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-5,
                                   atol=1e-6)

    qs_j, (cf_j, hf_j) = jpolicy.unroll(
        jmodel, params, jnp.asarray(obs), jnp.asarray(done_prev),
        (jnp.asarray(c0), jnp.asarray(h0)))
    with torch.no_grad():
        qs_t, (cf_t, hf_t) = tpolicy.unroll(
            model, torch.from_numpy(obs), torch.from_numpy(done_prev),
            (torch.from_numpy(c0), torch.from_numpy(h0)))
    assert qs_t.shape == (B, T, kw["num_actions"])
    for a, b in ((qs_t, qs_j), (cf_t, cf_j), (hf_t, hf_j)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-5,
                                   atol=1e-6)


BURN, SEQ, N = 4, 8, 2


def test_burn_in_gradient_exactly_zero():
    """The gradient of the R2D2 loss w.r.t. the burn-in observations is
    exactly 0 (tests/test_r2d2.py's golden test, through the port's
    building blocks as `training/r2d2.py` composes them)."""
    kw = MLP
    cfg = tpolicy.ModelConfig(**kw)
    model = tpolicy.QPolicy(cfg, (4,), torch.Generator().manual_seed(0))
    B, total = 3, BURN + SEQ + N
    rng = np.random.default_rng(0)
    obs = torch.tensor(rng.normal(size=(B, total, 4)), dtype=torch.float32,
                       requires_grad=True)
    actions = torch.from_numpy(rng.integers(0, 3, (B, total)))
    rewards = torch.from_numpy(rng.normal(size=(B, total)).astype(
        np.float32))
    done_prev = torch.zeros((B, total), dtype=torch.bool)
    state0 = tpolicy.initial_rnn_state(cfg, B)
    with torch.no_grad():
        _, warm = tpolicy.unroll_features(model, obs[:, :BURN],
                                          done_prev[:, :BURN], state0)
    q_on, _ = tpolicy.unroll(model, obs[:, BURN:], done_prev[:, BURN:], warm)
    q_sa = torch.gather(q_on[:, :SEQ], -1,
                        actions[:, BURN:BURN + SEQ, None]).squeeze(-1)
    idx = torch.arange(SEQ)[:, None] + torch.arange(N)[None, :]
    rew_n, disc_n = treturns.nstep_return(rewards[:, BURN:][:, idx],
                                          torch.zeros((B, SEQ, N)), 0.99)
    boot = torch.max(q_on[:, N:N + SEQ], dim=-1).values
    target = (rew_n + disc_n * boot).detach()
    loss = torch.mean(tlosses.huber(target - q_sa))
    (g,) = torch.autograd.grad(loss, obs)
    assert torch.equal(g[:, :BURN], torch.zeros_like(g[:, :BURN]))
    assert g[:, BURN:].abs().max() > 0
