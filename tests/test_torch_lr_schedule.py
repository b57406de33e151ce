"""Port parity: the linear lr schedule on the device counter.

`training/learner.py`: on the device-counter route (a captured step and
its eager body) each param group's lr is a 0-d float32 tensor that
`apply_gradients` writes before every step from the count of updates
applied before it, with optax.linear_schedule's own float32 formula.
Held here at counts 0, 1, N-1, N and N+5: bit-equal to
`optax.linear_schedule`, and within one float32 rounding (rtol 2e-7) of
the host route's `learning_rate(cfg, count)`; for Adam and for the
port's centered RMSProp, through real updates of the two routes on the
same draws (the lr each step used read back from the optimizer, the
parameters after each step to atol 1e-7), with no capturable Adam on
the CPU's eager route.
"""
import numpy as np
import optax
import jax.numpy as jnp
import pytest
import torch

from rltime_tpu_torch.history import replay as treplay
from rltime_tpu_torch.models.policy import ModelConfig
from rltime_tpu_torch.training import learner as tlearner
from rltime_tpu_torch.utils.benchprog import clone_states
from torch_port_draws import one_intra_op_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_intra_op_thread")

N = 6
COUNTS = (0, 1, N - 1, N, N + 5)
MLP = dict(num_actions=3, torso="mlp", mlp_hidden=(16,), head="linear")


@pytest.mark.parametrize("lr,lr_end", [(5e-4, 0.0), (1e-3, 1e-5),
                                       (3e-4, 2e-5)])
def test_device_lr_equals_optax_and_the_host_route(lr, lr_end):
    cfg = tlearner.AlgoConfig(lr=lr, lr_end=lr_end, lr_decay_updates=N)
    sched = optax.linear_schedule(lr, lr_end, N)
    for c in COUNTS:
        got = tlearner.device_learning_rate(cfg, torch.tensor(c))
        assert got.dtype == torch.float32 and got.ndim == 0
        assert got.item() == float(np.float32(sched(jnp.asarray(c,
                                                                jnp.int32))))
        np.testing.assert_allclose(got.item(), tlearner.learning_rate(cfg, c),
                                   rtol=2e-7, atol=0)


def _replay(rng):
    rcfg = treplay.ReplayConfig(num_envs=4, steps_per_env=64, horizon=1,
                                chunk_len=8, prioritized=False)
    rs = treplay.replay_init(rcfg, {
        "obs": ((5,), torch.float32), "action": ((), torch.int32),
        "reward": ((), torch.float32), "terminated": ((), torch.bool),
        "done": ((), torch.bool)}, torch.device("cpu"))
    for _ in range(4):
        done = rng.random((4, 8)) < 0.2
        treplay.replay_insert(rcfg, rs, dict(
            obs=rng.normal(size=(4, 8, 5)).astype(np.float32),
            action=rng.integers(0, 3, (4, 8)).astype(np.int32),
            reward=rng.normal(size=(4, 8)).astype(np.float32),
            terminated=done & (rng.random((4, 8)) < 0.5), done=done))
    return rcfg, rs


@pytest.mark.parametrize("optimizer", ["adam", "rmsprop"])
def test_updates_on_the_device_counter_follow_the_schedule(optimizer):
    """N + 6 updates by the host route (host count, float lr) and by the
    device-counter route (its lr a tensor written in place) on the same
    draws: before each update the device route's lr tensor holds optax's
    value at the count of updates before it, the host route's lr is
    `learning_rate` at that count, and the parameters stay within 1e-7.
    The CPU's eager route steps Adam without `capturable`."""
    cfg = tlearner.AlgoConfig(batch_size=8, lr=1e-2, lr_end=1e-3,
                              lr_decay_updates=N, optimizer=optimizer,
                              target_update_freq=4)
    sched = optax.linear_schedule(cfg.lr, cfg.lr_end, N)
    rng = np.random.default_rng(0)
    rcfg, host_rs = _replay(rng)
    host = tlearner.make_train_state(ModelConfig(**MLP), cfg, (5,), 0,
                                     torch.device("cpu"))
    dev, dev_rs = clone_states(host, host_rs)
    dev_rs.cursor = torch.tensor(dev_rs.t)
    tlearner.use_device_counter(dev, cfg)
    group = dev.optimizer.param_groups[0]
    lr_t = group["lr"]
    assert isinstance(lr_t, torch.Tensor) and lr_t.dtype == torch.float32
    if optimizer == "adam":
        assert group["capturable"] is False and group["foreach"] is False
    update = tlearner.make_update_step(cfg, rcfg, 1, flatten=True)
    lo, hi = treplay.valid_range(rcfg, host_rs.t)
    for i in range(N + 6):
        u = (torch.from_numpy(rng.integers(0, hi - lo, 8)),
             torch.from_numpy(rng.integers(0, 4, 8)))
        update(host, host_rs, torch.tensor(0.4), u=u)
        update(dev, dev_rs, torch.tensor(0.4), u=u)
        # the lr the step just used: the schedule at i updates before it
        assert group["lr"] is lr_t
        assert lr_t.item() == float(np.float32(sched(jnp.asarray(
            i, jnp.int32))))
        assert host.optimizer.param_groups[0]["lr"] == \
            tlearner.learning_rate(cfg, i)
        assert dev.counter.item() == host.updates == i + 1
        for a, b in zip(host.model.parameters(), dev.model.parameters()):
            torch.testing.assert_close(a, b, rtol=0, atol=1e-7)
        for a, b in zip(host.target.parameters(), dev.target.parameters()):
            torch.testing.assert_close(a, b, rtol=0, atol=1e-7)
    assert lr_t.item() == float(np.float32(cfg.lr_end))


def test_rmsprop_takes_a_tensor_lr_as_a_float_one():
    """One centered-RMSProp step with the lr as a 0-d tensor against the
    same step with that lr as a float: bit-equal."""
    g = torch.Generator().manual_seed(0)
    init = [torch.randn(s, generator=g) for s in ((7, 3), (3,))]
    grads = [[torch.randn(x.shape, generator=g) for x in init]
             for _ in range(3)]
    out = []
    for lr in (torch.tensor(3e-3), float(np.float32(3e-3))):
        ps = [torch.nn.Parameter(x.clone()) for x in init]
        opt = tlearner.CenteredRMSProp(ps, lr=lr, decay=0.95, eps=1e-6)
        for gs in grads:
            for p, gr in zip(ps, gs):
                p.grad = gr.clone()
            opt.step()
        out.append([p.detach() for p in ps])
    for a, b in zip(*out):
        assert torch.equal(a, b)
