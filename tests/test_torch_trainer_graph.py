"""The host learners' step as a CUDA graph would replay it, on the CPU.

On a card `Trainer` and `ApexTrainer` capture each post-warmup chunk's
insert + K updates into one CUDA graph (`training/trainer.py:ChunkStep`)
at the device cursor and update counter. The CPU runs that same body op
by op, which shows here:

  * chunk by chunk against the host-cursor route (the learner's own
    functions at the host int cursor and count, run on clones of the
    trainer's states through the same `eager_step`) and against the JAX
    package's trainer on the JAX side's draws, from a shared learner
    before every chunk: a config-#1-shaped run (uniform replay, the lr
    schedule), a narrow config-#2 CNN (PER), a small R2D2 and a one-rank
    Ape-X. Rings, cursors, counters and the sampled leaves bit-equal
    across all three; the two port routes' priorities bit-equal where
    the lr is constant; floats to the stated tolerances;
  * every tensor the step carries keeps its address from chunk to
    chunk, and a resume into a live trainer loads in place.

The replay itself is held against the eager body on the card
(`tests/test_torch_cuda.py`, `chip_smoke.py` phases 12 and 16).
"""
import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_port_draws as draws_lib
from rltime_tpu.parallel.apex import ApexTrainer as JApexTrainer
from rltime_tpu.parallel.mesh import make_mesh as jmake_mesh
from rltime_tpu.training.trainer import Trainer as JTrainer
from rltime_tpu_torch.history import replay as treplay
from rltime_tpu_torch.models import bridge
from rltime_tpu_torch.parallel.apex import ApexTrainer
from rltime_tpu_torch.training import checkpoint as ckpt_lib
from rltime_tpu_torch.training.trainer import Trainer
from rltime_tpu_torch.utils.benchprog import clone_states
from test_torch_cartpole_learns import _copy_key, _max_dev, _set_learner
from test_torch_r2d2_trainer import _r2d2_cfg
from test_torch_trainer import _img_cfg
from torch_port_draws import one_intra_op_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_intra_op_thread")


def _cartpole_cfg():
    """Config #1's shape (host CartPole, MLP, 1-step double DQN, uniform
    replay, a linear lr decay) cut to a few lanes, with a decay short
    enough that the run crosses its end."""
    return {
        "seed": 0,
        "env": {"type": "cartpole", "num_envs": 4},
        "frame_stack": 1,
        "model": {"torso": "mlp", "mlp_hidden": [16, 16], "head": "linear"},
        "replay": {"steps_per_env": 64, "prioritized": False},
        "algo": {"algo": "dqn", "batch_size": 8, "n_step": 1, "lr": 1e-3,
                 "lr_end": 1e-4, "lr_decay_updates": 7,
                 "target_update_freq": 3},
        "exploration": {"type": "epsilon_greedy", "mode": "anneal",
                        "eps_start": 1.0, "eps_end": 0.1,
                        "anneal_steps": 200},
        "train": {"total_env_steps": 10**6, "warmup_env_steps": 32,
                  "chunk_len": 8, "updates_per_chunk": 2},
    }


def _apex_cfg():
    return {
        "seed": 0,
        "env": {"type": "counting_env", "num_envs": 4, "episode_len": 7},
        "frame_stack": 1,
        "model": {"torso": "mlp", "mlp_hidden": [16], "head": "linear"},
        "replay": {"steps_per_env": 128, "prioritized": True},
        "algo": {"algo": "dqn", "batch_size": 4, "n_step": 2, "lr": 1e-3,
                 "target_update_freq": 3},
        "exploration": {"type": "epsilon_greedy", "mode": "ladder"},
        "train": {"total_env_steps": 10**6, "warmup_env_steps": 64,
                  "chunk_len": 8, "updates_per_chunk": 2,
                  "publish_interval": 2, "track_best": False},
    }


def _case(name):
    if name == "config1":
        return _cartpole_cfg(), 8
    if name == "config2":
        cfg = _img_cfg()
        cfg["train"]["updates_per_chunk"] = 2
        cfg["model"]["compute_dtype"] = "float32"
        return cfg, 13
    if name == "r2d2":
        return _r2d2_cfg(), 8
    return _apex_cfg(), 10


def _host_route(tt):
    """Clones of the port trainer's learner and replay on the host-cursor
    route: the write cursor and the update count as host ints, a float
    lr (the schedule's host formula writes it before each step)."""
    ts, rs = clone_states(tt.train_state, tt.replay_state)
    ts.counter, rs.cursor = None, None
    for group in ts.optimizer.param_groups:
        group["lr"] = tt.algo_cfg.lr
    return ts, rs


def _copy_learner(src, dst):
    """dst's learner := src's (params, target, Adam moments, count)."""
    dst.model.load_state_dict(src.model.state_dict())
    dst.target.load_state_dict(src.target.state_dict())
    for p, q in zip(src.model.parameters(), dst.model.parameters()):
        dst.optimizer.state[q] = {k: v.clone() for k, v in
                                  src.optimizer.state[p].items()}
    dst.updates = src.updates


@pytest.mark.parametrize("name", ["config1", "config2", "r2d2", "apex"])
def test_device_route_matches_host_route_and_jax(tmp_path, monkeypatch,
                                                 name):
    """Chunk by chunk from JAX's learner: the trainer's own route (device
    cursor and counter: the body its graph holds) against the host route
    on the same chunks and draws, and both against the JAX trainer.
    Bit-equal: rings, cursor, counts, the last update's sampled leaves
    (both port routes and JAX's), and the routes' priorities where the lr
    is constant. Float plane: the routes' parameters to 1e-6 (the
    schedule's lr is one float32 rounding apart from the host formula's),
    parameters and priorities against JAX to 1e-5."""
    cfg, chunks = _case(name)
    apex = name == "apex"
    cfg["algo"]["debug_outputs"] = not apex
    cfg["train"].update(log_interval=10**9, checkpoint_interval=10**9)
    if apex:
        # the JAX trainer drives num_envs lanes per LOCAL device: one
        monkeypatch.setattr(jax, "local_device_count", lambda: 1)
        jt = JApexTrainer(copy.deepcopy(cfg), str(tmp_path / "jax"),
                          mesh=jmake_mesh(jax.devices()[:1]))
        tt = ApexTrainer(copy.deepcopy(cfg), str(tmp_path / "torch"),
                         device="cpu")
        tt.actor_model.load_state_dict(bridge.flax_to_state_dict(
            tt.model_cfg, draws_lib.np_tree(jt._actor_params)))
    else:
        jt = JTrainer(copy.deepcopy(cfg), str(tmp_path / "jax"))
        tt = Trainer(copy.deepcopy(cfg), str(tmp_path / "torch"),
                     device="cpu")
    assert tt.graph is None and tt.replay_state.cursor is not None
    assert tt.train_state.counter is not None
    hts, hrs = _host_route(tt)
    rcfg, mc = tt.replay_cfg, tt.model_cfg
    E, L, T = rcfg.num_envs, rcfg.chunk_len, rcfg.steps_per_env
    B, K = tt.algo_cfg.batch_size, tt.loop_cfg.updates_per_chunk

    act_key = [_copy_key(jt.actor.state.key)]
    jax_actions = {}
    port_act_step = tt.actor._act_step

    def act_step(model, state, obs, done_prev, eps, t, explore_u, random_a,
                 taus=None):
        # the JAX actor's draws (acting/actor.py:118-127) and its action
        act_key[0], _, ekey, akey = jax.random.split(act_key[0], 4)
        explore_u = torch.from_numpy(np.array(jax.random.uniform(ekey, (E,))))
        random_a = torch.from_numpy(np.array(jax.random.randint(
            akey, (E,), 0, mc.num_actions, dtype=jnp.int32)))
        _, state, info = port_act_step(model, state, obs, done_prev, eps, t,
                                       explore_u, random_a, taus)
        return (torch.from_numpy(jax_actions["chunk"][:, t].copy()), state,
                info)

    seen = []
    rollout = tt.actor.rollout

    def recording_rollout(model):
        chunk, info = rollout(model)
        seen.append(chunk)
        return chunk, info

    tt.actor._act_step = act_step
    tt.actor.rollout = recording_rollout
    trained = 0
    for c in range(chunks):
        _set_learner(tt, jt.train_state)
        _copy_learner(tt.train_state, hts)
        key = _copy_key(jt.train_state.key)
        before = jt.updates_done
        jout = jt.train_chunk()
        cols = [(c * L + i) % T for i in range(L)]
        jax_actions["chunk"] = np.asarray(
            jt.replay_state.storage["action"])[:, cols]
        draws = None
        if jt.updates_done > before:
            lo, hi = treplay.valid_range(rcfg, (c + 1) * L)
            draws = []
            for _ in range(K):          # training/learner.py:374
                k = jax.random.fold_in(key, 0) if apex else key
                draws.append(
                    draws_lib.update_draws(k, B) if rcfg.prioritized
                    else draws_lib.uniform_update_draws(
                        k, B, max(hi - lo, 1), E))
                key = jax.random.split(key, 3)[0]
        tm = tt.train_chunk(draws)
        tm = tm if apex else tm[0]
        chunk = seen[-1]
        if draws is None:
            assert tm == {}
            tt._insert(hrs, chunk)
        else:
            trained += 1
            hm = tt.eager_step(hts, hrs, chunk, tt._beta(), draws)
            assert torch.equal(tm["loss"], hm["loss"]) or np.isclose(
                tm["loss"].item(), hm["loss"].item(), rtol=1e-5), c
            if not apex:
                jm = jout[0]
                for m in (tm, hm):
                    np.testing.assert_array_equal(
                        m["debug_leaf"].numpy(), np.asarray(jm["debug_leaf"]))
                np.testing.assert_allclose(tm["loss"].item(),
                                           float(jm["loss"]), rtol=1e-4)
        rs = tt.replay_state
        assert (rs.cursor.item() == rs.t == hrs.t
                == int(jt.replay_state.t) == (c + 1) * L), c
        assert (tt.train_state.counter.item() == tt.train_state.updates
                == hts.updates == int(jt.train_state.updates)
                == tt.updates_done == jt.updates_done), c
        for n, ring in rs.storage.items():
            assert torch.equal(ring, hrs.storage[n]), (c, n)
            want = np.asarray(jt.replay_state.storage[n])
            if n.startswith("rnn_"):    # the actor's carry: float plane
                np.testing.assert_allclose(ring.numpy(), want, rtol=1e-5,
                                           atol=1e-6, err_msg=n)
            else:
                np.testing.assert_array_equal(ring.numpy(), want,
                                              err_msg=f"{n} after {c}")
        if rcfg.prioritized:
            assert torch.equal(rs.tree, hrs.tree), c
            assert torch.equal(rs.max_priority, hrs.max_priority), c
            np.testing.assert_allclose(rs.tree.numpy(),
                                       np.asarray(jt.replay_state.tree),
                                       rtol=1e-5, atol=1e-6)
        for a, b in zip(tt.train_state.model.parameters(),
                        hts.model.parameters()):
            torch.testing.assert_close(a, b, rtol=0, atol=1e-6)
        dev = max(_max_dev(mc, tt.train_state.model, jt.train_state.params),
                  _max_dev(mc, tt.train_state.target,
                           jt.train_state.target_params))
        assert dev <= 1e-5, (c, dev)
    assert trained >= 3
    if tt.algo_cfg.lr_decay_updates:
        # the schedule crossed its end; both routes' last lr is optax's
        n = tt.train_state.updates
        assert n > tt.algo_cfg.lr_decay_updates
        lr = tt.train_state.optimizer.param_groups[0]["lr"]
        assert isinstance(lr, torch.Tensor) and lr.item() == np.float32(
            tt.algo_cfg.lr_end)


def _carried(t):
    ts, rs = t.train_state, t.replay_state
    out = {f"model.{k}": v for k, v in ts.model.state_dict().items()}
    out.update({f"target.{k}": v for k, v in ts.target.state_dict().items()})
    for i, st in enumerate(ts.optimizer.state.values()):
        out.update({f"opt.{i}.{k}": v for k, v in st.items()})
    for i, g in enumerate(ts.optimizer.param_groups):
        if isinstance(g["lr"], torch.Tensor):
            out[f"lr.{i}"] = g["lr"]
    out.update({f"ring.{k}": v for k, v in rs.storage.items()})
    out.update(tree=rs.tree, max_priority=rs.max_priority, cursor=rs.cursor,
               counter=ts.counter)
    return out


@pytest.mark.parametrize("name", ["config1", "config2", "r2d2", "apex"])
def test_step_keeps_every_carried_tensor_in_place(tmp_path, name):
    """A graph reads the addresses it captured: after the first trained
    chunk made the optimizer's state, every tensor the step carries
    (params, target, moments, step counts, the lr tensor, rings, tree,
    max_priority, cursor, counter) keeps its address, and changes."""
    cfg, _ = _case(name)
    cls = ApexTrainer if name == "apex" else Trainer
    t = cls(cfg, str(tmp_path / "run"), device="cpu")
    while t.updates_done == 0:
        t.train_chunk()
    before = {k: v.data_ptr() for k, v in _carried(t).items()}
    values = {k: v.clone() for k, v in _carried(t).items()}
    for _ in range(2):
        t.train_chunk()
    assert {k: v.data_ptr() for k, v in _carried(t).items()} == before
    moved = {k for k, v in _carried(t).items()
             if not torch.equal(v, values[k])}
    assert {"cursor", "counter", "ring.obs"} <= moved
    assert any(k.startswith("model.") for k in moved)
    assert ("tree" in moved) == t.replay_cfg.prioritized
    assert ("lr.0" in moved) == (name == "config1")
    rs, ts = t.replay_state, t.train_state
    assert rs.cursor.item() == rs.t and ts.counter.item() == ts.updates


@pytest.mark.parametrize("name", ["config1", "apex"])
def test_resume_into_a_live_trainer_is_in_place(tmp_path, name):
    """A live trainer (optimizer state made, lr tensor written, replay
    filled) resumes from another run's checkpoint: its carried tensors
    keep their addresses, the cursor, counter and lr follow the
    checkpoint, and both then train alike."""
    cfg, _ = _case(name)
    cfg["train"]["checkpoint_replay"] = True
    cls = ApexTrainer if name == "apex" else Trainer
    a = cls(copy.deepcopy(cfg), str(tmp_path / "a"), device="cpu")
    for _ in range(8):
        a.train_chunk()
    a.save_checkpoint()
    live = cls(copy.deepcopy(cfg), str(tmp_path / "a"), device="cpu")
    for _ in range(6):
        live.train_chunk()
    before = {k: v.data_ptr() for k, v in _carried(live).items()}
    (live.try_resume if name == "apex" else live._try_resume)()
    assert {k: v.data_ptr() for k, v in _carried(live).items()} == before
    for x, y in zip(_carried(a).values(), _carried(live).values()):
        assert torch.equal(x, y)
    assert live.updates_done == a.updates_done > 0
    chunk, _ = a.actor.rollout(a.actor_model if name == "apex"
                               else a.train_state.model)
    live.actor.env_steps = a.actor.env_steps
    for t in (a, live):
        t.learn(copy.deepcopy(chunk))
    for x, y in zip(_carried(a).values(), _carried(live).values()):
        assert torch.equal(x, y)


def test_checkpoint_loads_across_the_lr_kind(tmp_path):
    """An optimizer saved by the host route (a float lr) loads into the
    device route's (a live lr tensor, kept in place and set), and the
    reverse leaves the host route a float."""
    cfg = _cartpole_cfg()
    t = Trainer(copy.deepcopy(cfg), str(tmp_path / "t"), device="cpu")
    while t.updates_done < 4:
        t.train_chunk()
    ts = t.train_state
    hts, _ = _host_route(t)
    hts.optimizer.param_groups[0]["lr"] = 2.5e-4
    lr = ts.optimizer.param_groups[0]["lr"]
    ckpt_lib.load_optimizer_state(ts.optimizer,
                                  copy.deepcopy(hts.optimizer.state_dict()))
    assert ts.optimizer.param_groups[0]["lr"] is lr
    assert lr.item() == np.float32(2.5e-4)
    assert ts.optimizer.param_groups[0]["foreach"] is False
    ckpt_lib.load_optimizer_state(hts.optimizer,
                                  copy.deepcopy(ts.optimizer.state_dict()))
    assert hts.optimizer.param_groups[0]["lr"] == lr.item()
    assert not isinstance(hts.optimizer.param_groups[0]["lr"], torch.Tensor)


def test_the_cpu_runs_the_body_without_a_graph(tmp_path):
    for cls, cfg in ((Trainer, _cartpole_cfg()), (ApexTrainer, _apex_cfg())):
        t = cls(cfg, str(tmp_path / cls.__name__), device="cpu")
        assert t.graph is None
        while t.updates_done == 0:
            t.train_chunk()
        assert t.last_metrics["loss"].isfinite()


def test_async_pool_pauses_for_the_capture(tmp_path):
    """The learner captures its graph in CUDA's global mode, where a CUDA
    call from another thread fails: `AsyncActorPool.paused()` waits for
    the chunk in progress and holds the actor back until it ends, then
    the actor goes on."""
    import time
    cfg = _cartpole_cfg()
    cfg["train"]["async_acting"] = True
    t = Trainer(cfg, str(tmp_path / "run"), device="cpu")
    try:
        while t.updates_done == 0:
            t.train_chunk()
        pool = t.pool
        with pool.paused():
            while pool._queue.qsize():      # room for the actor's next
                pool.get_chunk()
            steps = pool.env_steps
            time.sleep(0.3)
            assert pool.env_steps == steps
        deadline = time.time() + 30
        while pool.env_steps == steps and time.time() < deadline:
            time.sleep(0.01)
        assert pool.env_steps > steps and pool.alive
    finally:
        t.pool.close()
