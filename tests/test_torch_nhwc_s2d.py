"""Port parity: `model.channels_last` and `model.space_to_depth`.

Against the JAX package on the CPU at float32:
  * `frame_stack_union_gather_nhwc` gives the JAX function's bytes, as
    contiguous (B, H, W, F) tensors, from one union-gather call;
  * the Nature CNN with either or both options gives the JAX net's Q
    from bridged parameters to rtol 1e-5 (atol 1e-6 near 0). With
    `space_to_depth` conv_0's flax kernel is (2, 2, 16 C, 32): the same
    bridge rule carries it, because the port patches its input in the
    JAX reshape's `(r_h, r_w, c)` order; a net that patched in another
    order would match every shape and fail here;
  * the plain net's conv_0, rewritten as the JAX tests rewrite it, gives
    the plain net's Q through the port's space-to-depth net (atol 2e-4,
    the JAX test's own bound: another summation order over 256 terms);
  * one learner update with both options matches the JAX update step
    (leaves bit-equal, floats to rtol 1e-5, params to atol 1e-6);
  * the host actor feeds a channels_last net the transposed stack, the
    trainer runs end to end with both options, and R2D2 goes on refusing
    `channels_last`.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rltime_tpu.history import replay as jreplay
from rltime_tpu.models.policy import ModelConfig as JModelConfig
from rltime_tpu.models.policy import init_params, make_model
from rltime_tpu.training import learner as jlearner
from rltime_tpu_torch.history import replay as treplay
from rltime_tpu_torch.models import bridge
from rltime_tpu_torch.models.policy import ModelConfig, QPolicy
from rltime_tpu_torch.ops import gather
from rltime_tpu_torch.training import learner as tlearner
from rltime_tpu_torch.training import r2d2 as tr2d2
from rltime_tpu_torch.training.trainer import Trainer
from test_torch_learner import CNN, F, N_STEP, _np_tree, _replays
from test_torch_trainer import _img_cfg
from torch_port_draws import one_intra_op_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_intra_op_thread")


def test_nhwc_stacks_equal_the_jax_function():
    jcfg, jrs, tcfg, trs = _replays()
    rng = np.random.default_rng(0)
    env = rng.integers(0, 2, 32).astype(np.int32)
    col = rng.integers(0, 40, 32).astype(np.int32)  # some below F - 1
    j_t, j_tn = jreplay.frame_stack_union_gather_nhwc(
        jcfg, jrs, jnp.asarray(env), jnp.asarray(col), F, N_STEP)
    before = dict(gather.PLAIN_CALLS)
    t_t, t_tn = treplay.frame_stack_union_gather_nhwc(
        tcfg, trs, torch.from_numpy(env), torch.from_numpy(col), F, N_STEP)
    assert gather.PLAIN_CALLS["union_gather"] == before["union_gather"] + 1
    for t, j in ((t_t, j_t), (t_tn, j_tn)):
        assert tuple(t.shape) == (32, 84, 84, F) and t.is_contiguous()
        assert t.dtype == torch.uint8
        np.testing.assert_array_equal(t.numpy(), np.asarray(j))
    assert bool((t_t[..., 0] == 0).all(dim=(1, 2)).any())   # a cut frame


@pytest.mark.parametrize("channels_last,space_to_depth",
                         [(True, False), (False, True), (True, True)])
def test_forward_matches_flax_from_bridged_params(channels_last,
                                                  space_to_depth):
    kw = dict(CNN, channels_last=channels_last,
              space_to_depth=space_to_depth)
    rng = np.random.default_rng(1)
    obs = rng.integers(0, 256, (5, F, 84, 84), dtype=np.uint8)
    if channels_last:
        obs = np.ascontiguousarray(np.moveaxis(obs, 1, -1))
    jcfg, tcfg = JModelConfig(**kw), ModelConfig(**kw)
    params = init_params(jcfg, jax.random.key(2), jnp.asarray(obs[:1]))
    k0 = params["params"]["torso_mod"]["Conv_0"]["kernel"]
    assert k0.shape == ((2, 2, 16 * F, 4) if space_to_depth
                        else (8, 8, F, 4))
    q_j, _ = make_model(jcfg).apply(params, jnp.asarray(obs), ())
    model = QPolicy(tcfg, obs.shape[1:])
    sd = bridge.flax_to_state_dict(tcfg, _np_tree(params))
    assert {k: tuple(v.shape) for k, v in sd.items()} == {
        k: tuple(v.shape) for k, v in model.state_dict().items()}
    model.load_state_dict(sd)
    with torch.no_grad():
        q_t = model(torch.from_numpy(obs))
    np.testing.assert_allclose(q_t.numpy(), np.asarray(q_j), rtol=1e-5,
                               atol=1e-6)
    back = bridge.state_dict_to_flax(tcfg, model.state_dict())
    jax.tree.map(np.testing.assert_array_equal, back, _np_tree(params))


def test_space_to_depth_is_an_exact_reparametrization():
    rng = np.random.default_rng(2)
    obs = torch.from_numpy(rng.integers(0, 256, (3, F, 84, 84),
                                        dtype=np.uint8))
    plain = QPolicy(ModelConfig(**CNN), (F, 84, 84),
                    torch.Generator().manual_seed(0))
    s2d = QPolicy(ModelConfig(**CNN, space_to_depth=True), (F, 84, 84))
    sd = dict(plain.state_dict())
    w = sd["torso.convs.0.weight"]                  # (O, C, 8, 8)
    o, c = w.shape[:2]
    # ki = 4 p_i + r_i; the patched input channel is (r_i, r_j, c)
    w = w.reshape(o, c, 2, 4, 2, 4).permute(0, 3, 5, 1, 2, 4)
    sd["torso.convs.0.weight"] = w.reshape(o, 16 * c, 2, 2)
    s2d.load_state_dict(sd)
    with torch.no_grad():
        np.testing.assert_allclose(s2d(obs).numpy(), plain(obs).numpy(),
                                   rtol=0, atol=2e-4)


def test_options_are_refused_off_the_nature_cnn():
    for opt in ("channels_last", "space_to_depth"):
        with pytest.raises(ValueError, match="Nature-CNN options"):
            ModelConfig(num_actions=3, torso="mlp", **{opt: True})
    with pytest.raises(ValueError, match="divisible"):
        QPolicy(ModelConfig(num_actions=3, torso="nature_cnn",
                            space_to_depth=True), (F, 42, 42))


@pytest.mark.parametrize("channels_last,space_to_depth",
                         [(True, True), (True, False)])
def test_update_step_matches_jax(channels_last, space_to_depth):
    kw = dict(CNN, channels_last=channels_last,
              space_to_depth=space_to_depth)
    algo_kw = dict(batch_size=16, n_step=N_STEP, gamma=0.97, lr=1e-3,
                   adam_eps=1e-6, grad_clip=0.05, target_update_freq=1,
                   debug_outputs=True)
    jcfg, jrs, tcfg, trs = _replays()
    jmc, tmc = JModelConfig(**kw), ModelConfig(**kw)
    jalgo, talgo = (jlearner.AlgoConfig(**algo_kw),
                    tlearner.AlgoConfig(**algo_kw))
    ex = jnp.zeros((1, 84, 84, F), jnp.uint8)
    js = jlearner.make_train_state(jmc, jalgo, jax.random.key(7), ex)
    js = js.replace(target_params=init_params(jmc, jax.random.key(8), ex))
    _, skey, _ = jax.random.split(js.key, 3)
    u = torch.from_numpy(np.array(jax.random.uniform(skey, (16,))))
    ts = tlearner.make_train_state(tmc, talgo, (84, 84, F), seed=0,
                                   device=torch.device("cpu"))
    ts.model.load_state_dict(bridge.flax_to_state_dict(
        tmc, _np_tree(js.params)))
    ts.target.load_state_dict(bridge.flax_to_state_dict(
        tmc, _np_tree(js.target_params)))
    js2, jrs2, jm = jax.jit(jlearner.make_update_step(
        jmc, jalgo, jcfg, F, flatten=False))(js, jrs, jnp.float32(0.6))
    before = dict(gather.PLAIN_CALLS)
    ts, trs, tm = tlearner.make_update_step(
        talgo, tcfg, F, False, channels_last=True)(ts, trs, 0.6, u=u)
    calls = {k: v - before[k] for k, v in gather.PLAIN_CALLS.items()}
    assert calls == {"union_gather": 1, "window_gather": 1}
    np.testing.assert_array_equal(tm["debug_leaf"].numpy(),
                                  np.asarray(jm["debug_leaf"]))
    for k in ("loss", "grad_norm", "td_abs", "q"):
        np.testing.assert_allclose(tm[k].item(), float(jm[k]), rtol=1e-5,
                                   err_msg=k)
    np.testing.assert_allclose(trs.tree.numpy(), np.asarray(jrs2.tree),
                               rtol=1e-5)
    back = bridge.state_dict_to_flax(tmc, ts.model.state_dict())
    jax.tree.map(lambda a, b: np.testing.assert_allclose(
        a, np.asarray(b), rtol=0, atol=1e-6), back, _np_tree(js2.params))


def test_actor_feeds_a_channels_last_net_the_transposed_stack():
    from rltime_tpu_torch.acting.actor import Actor
    from rltime_tpu_torch.envs.fake import CountingVecEnv
    from rltime_tpu_torch.exploration.epsilon import EpsilonGreedy
    seen = {}

    class Recorder(torch.nn.Module):
        def __init__(self, name):
            super().__init__()
            self.name = name

        def forward(self, x):
            seen.setdefault(self.name, []).append(x.clone())
            return torch.zeros((x.shape[0], 3))

    for name, cl in (("plain", False), ("nhwc", True)):
        actor = Actor(CountingVecEnv(2, episode_len=6, image_obs=True),
                      ModelConfig(num_actions=3, torso="nature_cnn",
                                  channels_last=cl), 4,
                      EpsilonGreedy(eps_start=0.5, eps_end=0.5),
                      torch.Generator().manual_seed(0), 8,
                      torch.device("cpu"))
        actor.rollout(Recorder(name))
    for a, b in zip(seen["plain"], seen["nhwc"]):
        assert tuple(b.shape) == (2, 84, 84, 4)
        assert torch.equal(torch.movedim(a, 1, -1), b)


@pytest.mark.parametrize("use_lambda", [False, True])
def test_trainer_runs_with_both_options(tmp_path, use_lambda):
    cfg = _img_cfg()
    cfg["model"].update(channels_last=True, space_to_depth=True)
    cfg["algo"]["use_lambda"] = use_lambda
    t = Trainer(cfg, str(tmp_path / "run"), device="cpu").train()
    assert t.updates_done > 0
    conv0 = t.train_state.model.torso.convs[0]
    assert tuple(conv0.weight.shape) == (4, 64, 2, 2)
    assert conv0.stride == (1, 1)
    for k in ("loss", "grad_norm", "td_abs"):
        assert np.isfinite(t.last_metrics[k].item()), k


def test_r2d2_goes_on_refusing_channels_last():
    mc = ModelConfig(num_actions=3, torso="nature_cnn", lstm_size=8,
                     channels_last=True)
    rc = treplay.ReplayConfig(num_envs=2, steps_per_env=64, horizon=8,
                              chunk_len=8)
    with pytest.raises(ValueError, match="FF-learner option"):
        tr2d2.make_r2d2_update_step(
            mc, tlearner.AlgoConfig(algo="r2d2", burn_in=2, seq_len=4,
                                    n_step=2), rc, 4, False)
