"""The captured act step and the captured device rollout, on the CPU.

On a card `Actor` replays one CUDA graph per act step and `DeviceActor`
one per chunk (`rltime_tpu_torch/acting/`), the port's counterparts of
the JAX package's jitted act step (`rltime_tpu/acting/actor.py`) and
rollout (`rltime_tpu/acting/device_actor.py`). What those graphs capture
runs here op by op (`Actor.use_static_buffers(graphed=False)`,
`DeviceActor._body`) behind `_ReplayLike`, which gives a replay's output
semantics: the same output tensors on every call, overwritten by the
next. Held bit for bit against the op-by-op route, which the trainer
tests hold against JAX on JAX's draws:

  * the act body (state in place, the device chunk column, the draws
    made inside from the actor's generator) over two chunks: actions,
    every chunk field, frames, obs_chunk, the carry, rnn_chunk, the
    generator's state and q_mean; for an MLP at F=1, the Nature CNN at
    F=4 with a dueling head, CNN + LSTM, IQN, actor-side priorities with
    an LSTM (the late route) and `model.channels_last`;
  * the late route's stored carries are one per step, not the last
    step's aliased;
  * `AsyncActorPool` acts with one model object for its life, holding
    the last published weights;
  * a queued chunk of a captured `DeviceActor` survives the rollouts
    after it;
  * the rollout body on a static eps buffer equals `rollout`.
"""
import time

import numpy as np
import pytest
import torch

from rltime_tpu_torch.acting.actor import Actor
from rltime_tpu_torch.acting.device_actor import DeviceActor
from rltime_tpu_torch.acting.pool import AsyncActorPool
from rltime_tpu_torch.envs.device import DeviceCartPole
from rltime_tpu_torch.envs.fake import CountingVecEnv
from rltime_tpu_torch.exploration.epsilon import EpsilonGreedy
from rltime_tpu_torch.models.policy import ModelConfig, QPolicy
from rltime_tpu_torch.training.trainer import model_in_shape
from rltime_tpu_torch.utils.prng import make_generator
from torch_port_draws import one_intra_op_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_intra_op_thread")

CPU = torch.device("cpu")
E, L = 3, 8
CNN = dict(torso="nature_cnn", cnn_channels=(4, 4, 4), cnn_fc=16)
# name -> (model kwargs, image obs, frame stack, actor-side priorities)
CASES = {
    "mlp-f1": (dict(torso="mlp", mlp_hidden=(12,), head="linear"),
               False, 1, False),
    "cnn-f4-dueling": (dict(head="dueling", dueling_hidden=8, **CNN),
                       True, 4, False),
    "cnn-lstm": (dict(head="dueling", dueling_hidden=8, lstm_size=6, **CNN),
                 True, 4, False),
    "iqn": (dict(torso="mlp", mlp_hidden=(12,), head="iqn", iqn_embed_dim=8,
                 dueling_hidden=8, num_tau_policy=5), False, 2, False),
    "late-priorities-lstm": (dict(torso="mlp", mlp_hidden=(12,),
                                  head="linear", lstm_size=5),
                             False, 1, True),
    "channels-last": (dict(head="dueling", dueling_hidden=8,
                           channels_last=True, **CNN), True, 4, False),
}


def _clone(x):
    if isinstance(x, torch.Tensor):
        return x.clone()
    if isinstance(x, tuple):
        return tuple(_clone(v) for v in x)
    if isinstance(x, dict):
        return {k: _clone(v) for k, v in x.items()}
    return x


def _copy_into(dst, src):
    if isinstance(dst, torch.Tensor):
        dst.copy_(src)
    elif isinstance(dst, (tuple, list)):
        for d, s in zip(dst, src):
            _copy_into(d, s)
    elif isinstance(dst, dict):
        for k in dst:
            _copy_into(dst[k], src[k])


class _ReplayLike:
    """A graph's output semantics around an op-by-op body: every call
    returns the same tensors, holding this call's values."""

    graph = "captured"      # the pool primes nothing

    def __init__(self, fn):
        self.fn = fn
        self.calls = 0
        self.output = None

    def __call__(self, *inputs):
        out = self.fn(*inputs)
        if self.output is None:
            self.output = _clone(out)
        else:
            _copy_into(self.output, out)
        self.calls += 1
        return self.output


def _actor(case, static):
    kw, image, frame_stack, late = CASES[case]
    env = CountingVecEnv(E, episode_len=5, num_actions=4, image_obs=image)
    cfg = ModelConfig(num_actions=4, **kw)
    actor = Actor(env, cfg, frame_stack,
                  EpsilonGreedy(eps_start=0.5, eps_end=0.5),
                  make_generator(3, "actor", CPU), L, CPU,
                  compute_priorities=late, capture=False)
    if static:
        actor.use_static_buffers(graphed=False)
        actor.graph = _ReplayLike(actor._body)
    model = QPolicy(cfg, model_in_shape(env.spec, frame_stack, cfg),
                    torch.Generator().manual_seed(0))
    return actor, model


def _assert_same(a, b, what):
    if isinstance(a, torch.Tensor):
        assert torch.equal(a, b), what
    else:
        np.testing.assert_array_equal(a, b, err_msg=what)


@pytest.mark.parametrize("case", list(CASES))
def test_act_body_equals_the_op_by_op_route(case):
    ops, model = _actor(case, static=False)
    body, _ = _actor(case, static=True)
    for c in range(2):
        want, want_info = ops.rollout(model)
        got, got_info = body.rollout(model)
        assert set(got) == set(want)
        for k in want:
            _assert_same(got[k], want[k], f"chunk {c} {k}")
        assert got_info == want_info
        sa, sb = ops.state, body.state
        for name in ("frames", "obs_chunk"):
            _assert_same(getattr(sb, name), getattr(sa, name), name)
        if sa.rnn is not None:
            for x, y in zip(sb.rnn + sb.rnn_chunk, sa.rnn + sa.rnn_chunk):
                _assert_same(x, y, "carry")
        assert torch.equal(body.generator.get_state(),
                           ops.generator.get_state())
        assert body.completed_returns == ops.completed_returns
    # the late route acts one step ahead of what it emits
    assert body.graph.calls == 2 * L + CASES[case][3]
    assert got_info["q_mean"] != 0.0


def test_late_route_stores_a_carry_per_step():
    actor, model = _actor("late-priorities-lstm", static=True)
    actor.rollout(model)
    chunk, _ = actor.rollout(model)
    c = chunk["rnn_c"]
    assert c.shape == (E, L, 5)
    # one carry per step, each the one its step consumed: not the last
    # replay's output L times over
    assert len({c[:, i].numpy().tobytes() for i in range(L)}) > L // 2
    assert not torch.equal(c[:, 0], c[:, -1])


def test_pool_keeps_one_actor_model():
    actor, model = _actor("mlp-f1", static=True)
    seen = []
    rollout = actor.rollout

    def recording(m):
        seen.append(m)
        return rollout(m)

    actor.rollout = recording
    pool = AsyncActorPool(actor, model, max_queue=1)
    try:
        for i in range(4):
            with torch.no_grad():
                for p in model.parameters():
                    p.add_(0.25)
            pool.set_params(model)
            published = [p.clone() for p in model.parameters()]
            deadline = time.time() + 30
            while pool._model_version != pool.version:
                pool.get_chunk(timeout=30)
                assert time.time() < deadline
        assert pool.model is not model
        assert all(m is pool.model for m in seen) and len(seen) >= 4
        for mine, want in zip(pool.model.parameters(), published):
            assert torch.equal(mine, want)
    finally:
        pool.close()


def _device_actor(static, compute_priorities=False, num_envs=4):
    cfg = ModelConfig(num_actions=2, torso="mlp", mlp_hidden=(8,),
                      head="linear")
    actor = DeviceActor(DeviceCartPole(), num_envs, cfg,
                        EpsilonGreedy(eps_start=0.5, eps_end=0.5), 7, L, CPU,
                        compute_priorities=compute_priorities, capture=False)
    if static:
        actor._eps = torch.empty((L, num_envs), dtype=torch.float32)
        actor.graph = _ReplayLike(actor._body)
    model = QPolicy(cfg, (4,), torch.Generator().manual_seed(1))
    return actor, model


def test_queued_device_chunk_survives_the_next_rollouts():
    actor, model = _device_actor(static=True)
    assert actor.replays_chunk
    pool = AsyncActorPool(actor, model, max_queue=1)
    try:
        first, _ = pool.get_chunk(timeout=30)
        kept = _clone(first)
        second, _ = pool.get_chunk(timeout=30)
        deadline = time.time() + 30
        while not pool._queue.full():      # the actor acted once more
            assert time.time() < deadline
            time.sleep(0.01)
        for k in kept:
            assert torch.equal(first[k], kept[k]), k
        assert not torch.equal(first["obs"], second["obs"])
    finally:
        pool.close()


@pytest.mark.parametrize("priorities", [False, True])
def test_rollout_body_on_a_static_eps_buffer_equals_rollout(priorities):
    ops, model = _device_actor(static=False, compute_priorities=priorities)
    body, _ = _device_actor(static=True, compute_priorities=priorities)
    for c in range(3):
        want, want_info = ops.rollout(model)
        got, got_info = body.rollout(model)
        assert got_info == want_info and set(got) == set(want)
        for k in want:
            assert torch.equal(got[k], want[k]), f"chunk {c} {k}"
    diffs = body.state.diffs(ops.state)
    assert len(diffs) == 11 and not any(diffs.values())
    assert torch.equal(body.state.ret_ring, ops.state.ret_ring)
    assert body.graph.calls == 3
    assert ops.episode_stats() == body.episode_stats()


def test_captured_routes_refuse_another_model_and_draws():
    actor, model = _actor("mlp-f1", static=True)
    actor.rollout(model)
    other = QPolicy(actor.cfg, (4,), torch.Generator().manual_seed(5))
    with pytest.raises(RuntimeError, match="in place"):
        actor.rollout(other)
    dactor, dmodel = _device_actor(static=True)
    dactor.rollout(dmodel)
    with pytest.raises(RuntimeError, match="in place"):
        dactor.rollout(QPolicy(dactor.cfg, (4,),
                               torch.Generator().manual_seed(2)))
    with pytest.raises(ValueError, match="capture=False"):
        dactor.rollout(dmodel, draws=[{}])


def test_shadow_holds_the_replays_against_the_eager_body():
    """`ActGraphShadow` (the card's check) over a replay-like act step:
    no difference; a perturbed clone shows one."""
    from rltime_tpu_torch.acting.actor import ActGraphShadow
    actor, model = _actor("cnn-lstm", static=True)
    actor.rollout(model)
    shadow = ActGraphShadow(actor)
    actor.rollout(model)
    assert shadow.steps == L and shadow.max_diff == 0.0
    assert not any(shadow.state_diffs().values())
    shadow.state.rnn[0].add_(1.0)
    actor.rollout(model)
    shadow.detach()
    assert shadow.max_diff > 0.0 and actor.graph is shadow.graph


def test_pool_captures_the_act_step_on_its_own_thread():
    """The pool's constructor returns once its thread (the one that
    replays the actor's graph) has acted the capture: the learner is off
    the card meanwhile, and the graph keeps that thread's cuBLAS
    workspace to itself."""
    import threading

    class _Capturing(_ReplayLike):
        graph = None

        def __call__(self, *inputs):
            threads.add(threading.current_thread().name)
            out = super().__call__(*inputs)
            if self.calls == 3:
                self.graph = "captured"
            return out

    threads = set()
    actor, model = _actor("mlp-f1", static=True)
    actor.graph = _Capturing(actor._body)
    pool = AsyncActorPool(actor, model, max_queue=1)
    try:
        assert actor.graph.graph == "captured"
        assert threads == {"actor-pool"}
        assert len(pool._primed) + pool._queue.qsize() >= 1
        chunk, info = pool.get_chunk(timeout=30)
        assert chunk["action"].shape == (E, L) and info["params_version"] == 1
    finally:
        pool.close()
