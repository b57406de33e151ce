"""Port parity: the recurrent actor and the R2D2 Trainer on the CPU.

The carry the actor stores for each step is the carry that step
consumed, so one step of the policy from a stored carry, reset where the
step ended an episode, gives the next stored carry. A tiny recurrent
counting-env R2D2 `Trainer` against the JAX `Trainer`: greedy acting
(eps 0) and lr 0 keep both packages on the same weights (the port's
init, carried to flax by the bridge), so every ring (obs, actions,
rewards, dones, stored carries) must agree, the integer ones bit for
bit and the carries to the LSTM's float tolerance (1e-5). Also:
checkpoint/resume with the carry rings, and the CLI on the CPU.
"""
import json

import jax
import jax.numpy as jnp
import numpy as np
import torch

from rltime_tpu.training.trainer import Trainer as JTrainer
from rltime_tpu_torch import train as ttrain
from rltime_tpu_torch.acting.actor import Actor
from rltime_tpu_torch.envs.fake import CountingVecEnv
from rltime_tpu_torch.exploration.epsilon import EpsilonGreedy
from rltime_tpu_torch.models import bridge
from rltime_tpu_torch.models import policy as tpolicy
from rltime_tpu_torch.ops import gather
from rltime_tpu_torch.training import checkpoint as ckpt_lib
from rltime_tpu_torch.training.trainer import Trainer


def _r2d2_cfg():
    return {
        "seed": 0,
        "env": {"type": "counting_env", "num_envs": 2, "episode_len": 7},
        "frame_stack": 2,
        "model": {"torso": "mlp", "mlp_hidden": [12], "head": "dueling",
                  "dueling_hidden": 8, "lstm_size": 8,
                  "compute_dtype": "float32"},
        "replay": {"steps_per_env": 64, "prioritized": True, "alpha": 0.9},
        "algo": {"algo": "r2d2", "batch_size": 4, "n_step": 2,
                 "burn_in": 4, "seq_len": 8, "gamma": 0.97, "lr": 1e-3,
                 "adam_eps": 1e-3, "target_update_freq": 5},
        "exploration": {"type": "epsilon_greedy", "eps_start": 1.0,
                        "eps_end": 0.1, "anneal_steps": 100},
        "train": {"total_env_steps": 192, "warmup_env_steps": 64,
                  "chunk_len": 8, "updates_per_chunk": 1,
                  "log_interval": 10_000, "checkpoint_interval": 10_000},
    }


def test_actor_stores_the_carry_each_step_consumed():
    E, L = 2, 16
    cfg = tpolicy.ModelConfig(num_actions=3, torso="mlp", mlp_hidden=(12,),
                              lstm_size=8)
    model = tpolicy.QPolicy(cfg, (4,), torch.Generator().manual_seed(0))
    actor = Actor(CountingVecEnv(E, episode_len=5), cfg, 1,
                  EpsilonGreedy(eps_start=0.3, eps_end=0.3),
                  torch.Generator().manual_seed(0), L, torch.device("cpu"))
    chunks = [actor.rollout(model)[0] for _ in range(2)]
    obs, c, h = (torch.cat([ch[k] for ch in chunks], dim=1)
                 for k in ("obs", "rnn_c", "rnn_h"))
    done = torch.from_numpy(np.concatenate([ch["done"] for ch in chunks],
                                           axis=1))
    # the first step of the first chunk starts with done_prev all true
    assert not c[:, 0].any() and not h[:, 0].any()
    no_reset = torch.zeros((E, 1), dtype=torch.bool)
    for t in range(2 * L - 1):
        with torch.no_grad():
            _, (c1, h1) = tpolicy.unroll(model, obs[:, t:t + 1], no_reset,
                                         (c[:, t], h[:, t]))
        keep = (~done[:, t]).to(torch.float32)[:, None]
        torch.testing.assert_close(c[:, t + 1], c1 * keep, rtol=1e-6,
                                   atol=1e-7)
        torch.testing.assert_close(h[:, t + 1], h1 * keep, rtol=1e-6,
                                   atol=1e-7)
    # resets happened inside the chunks and zeroed the stored carry
    ends = done[:, :-1].nonzero()
    assert len(ends) >= 4
    assert all(not h[e, t + 1].any() for e, t in ends.tolist())
    assert h[:, 1:].abs().sum() > 0


def test_r2d2_trainer_rings_match_jax(tmp_path):
    cfg = _r2d2_cfg()
    cfg["algo"]["lr"] = 0.0                    # weights stay the init
    cfg["exploration"] = {"type": "epsilon_greedy", "eps_start": 0.0,
                          "eps_end": 0.0}      # greedy acting
    tt = Trainer(cfg, str(tmp_path / "torch"), device="cpu")
    jt = JTrainer(cfg, str(tmp_path / "jax"))
    params = jax.tree.map(jnp.asarray, bridge.state_dict_to_flax(
        tt.model_cfg, tt.train_state.model.state_dict()))
    jt.train_state = jt.train_state.replace(
        params=params, target_params=jax.tree.map(jnp.copy, params))
    jt.train()
    plain_before = dict(gather.PLAIN_CALLS)
    tt.train()
    assert tt.updates_done == jt.updates_done == 9
    # per update: the frame sequence, the done strip, the action,
    # reward and terminated strips and the stored carry, all in one
    # call of the K1 wrapper
    assert gather.PLAIN_CALLS["window_gather"] - plain_before[
        "window_gather"] == tt.updates_done
    assert gather.PLAIN_CALLS["union_gather"] == plain_before["union_gather"]
    assert tt.replay_state.t == int(jt.replay_state.t) == 192 // 2
    ts, js = tt.replay_state.storage, jt.replay_state.storage
    for name in ("obs", "action", "reward", "done", "terminated"):
        np.testing.assert_array_equal(ts[name].numpy(), np.asarray(js[name]),
                                      err_msg=name)
    for name in ("rnn_c", "rnn_h"):
        assert ts[name].shape == (2, 64, 8) and ts[name].abs().sum() > 0
        np.testing.assert_allclose(ts[name].numpy(), np.asarray(js[name]),
                                   rtol=1e-5, atol=1e-6, err_msg=name)
    for k in ("loss", "grad_norm", "td_abs", "q"):
        assert np.isfinite(tt.last_metrics[k].item()), k


def test_r2d2_checkpoint_save_and_restore(tmp_path):
    cfg = _r2d2_cfg()
    cfg["train"]["total_env_steps"] = 112
    cfg["train"]["checkpoint_replay"] = True
    rd = str(tmp_path / "run")
    t = Trainer(cfg, rd, device="cpu").train()
    assert ckpt_lib.latest_step(rd) == 112 and t.updates_done == 4
    cfg["train"]["resume"] = True
    r = Trainer(cfg, rd, device="cpu")
    assert r.actor.env_steps == 112 and r.updates_done == t.updates_done
    assert r.train_state.updates == t.train_state.updates == 4
    for a, b in ((t.train_state.model, r.train_state.model),
                 (t.train_state.target, r.train_state.target)):
        for (ka, va), (kb, vb) in zip(a.state_dict().items(),
                                      b.state_dict().items()):
            assert ka == kb and torch.equal(va, vb)
    assert "lstm.weight_hh" in r.train_state.model.state_dict()
    rt, rr = t.replay_state, r.replay_state
    assert rr.t == rt.t and torch.equal(rr.tree, rt.tree)
    assert set(rr.storage) >= {"rnn_c", "rnn_h"}
    for name, arr in rt.storage.items():
        assert torch.equal(rr.storage[name], arr), name


def test_r2d2_counting_config_is_config_4_on_counting_frames():
    """atari_r2d2_counting holds every block of atari_r2d2.json verbatim
    but env, plus the seed and frame stack it inherits from pong_dqn,
    and both packages load it alike. (The base merge would also carry
    pong_dqn's anneal keys, which the ladder exploration ignores, and
    `batched_next_forward`, which the R2D2 update does not read.)"""
    from rltime_tpu.config.config import load_config as jload
    from rltime_tpu_torch.config.config import load_config as tload
    from rltime_tpu_torch.config.config import _resolve_path
    cfg = tload("atari_r2d2_counting")
    assert cfg == jload("atari_r2d2_counting")
    with open(_resolve_path("atari_r2d2")) as f:
        raw = json.load(f)
    for block in set(raw) - {"base", "env", "_doc"}:
        assert cfg[block] == raw[block], block
    merged = jload("atari_r2d2")
    assert set(cfg) == set(merged)
    assert (cfg["seed"], cfg["frame_stack"]) == (merged["seed"],
                                                 merged["frame_stack"])
    assert cfg["env"] == {"type": "counting_env", "num_envs": 64,
                          "image_obs": True, "num_actions": 6,
                          "episode_len": 27}


def test_r2d2_cli_runs_on_cpu(tmp_path):
    path = tmp_path / "r2d2.json"
    path.write_text(json.dumps(_r2d2_cfg()))
    rd = tmp_path / "cli"
    trainer = ttrain.run([str(path), "--device", "cpu", "--result-dir",
                          str(rd), "--train.log_interval=32"])
    assert trainer.device.type == "cpu" and trainer.updates_done == 9
    assert ckpt_lib.latest_step(str(rd)) == 192
    lines = [json.loads(x)
             for x in (rd / "scalars.jsonl").read_text().splitlines()]
    losses = [x["train/loss"] for x in lines if "train/loss" in x]
    assert losses and all(np.isfinite(losses))
    # the priority write-back moved sampled leaves off the insert value
    tree = trainer.replay_state.tree
    assert torch.isfinite(tree).all()
    assert ((tree > 0) & (tree != trainer.replay_state.max_priority)).any()
