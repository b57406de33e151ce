"""The port's Atari stack (`envs/atari.py`) against the JAX package's.

Both run the same scripted emulators through a fake `ale_py`: the
`FakeALE` of tests/test_atari_stub.py (every wrapper branch: noop and
fire reset, the max-pool seam, EpisodicLife, game over, truncation,
reward clip, true scores, the thread pool) and the paddle-catch
`CatchALE` of tests/test_atari_learn.py. Frames, rewards, flags, the
emulator's action logs and the game scores are equal (tolerance 0: the
same numpy on the same script).
"""
import sys
import types

import numpy as np
import pytest
import torch

from rltime_tpu.envs import atari as jatari
from rltime_tpu_torch.envs import atari as tatari
from test_atari_learn import CatchALE
from test_atari_stub import FakeALE
from torch_port_draws import one_intra_op_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_intra_op_thread")

MODS = {"jax": jatari, "torch": tatari}


def _fake_ale(monkeypatch, ale_cls, **roms):
    fake = types.ModuleType("ale_py")
    fake.ALEInterface = ale_cls
    fake.roms = types.SimpleNamespace(**roms)
    monkeypatch.setitem(sys.modules, "ale_py", fake)
    monkeypatch.setattr(jatari, "_HAS_ALE", True)


@pytest.fixture
def fake_ale(monkeypatch):
    _fake_ale(monkeypatch, FakeALE, pong="pong-rom")


@pytest.fixture
def catch_ale(monkeypatch):
    _fake_ale(monkeypatch, CatchALE, catch="catch-rom")


def _lane(mod, **kw):
    args = dict(rom="pong", seed=0, noop_max=5, frameskip=4,
                episodic_life=True, fire_reset=True,
                max_episode_frames=10_000)
    args.update(kw)
    return mod._AtariLane(**args)


# Each case runs one script of tests/test_atari_stub.py on a module's
# stack, checks what that test checks and returns everything observable.

def _noop_and_fire_reset(mod):
    lane = _lane(mod)
    frame = lane.reset_episode()
    acts = [a for _, a in lane.ale.log]
    assert 1 <= len(acts) - 1 <= 5
    assert all(a == 0 for a in acts[:-1]) and acts[-1] == 1
    np.testing.assert_array_equal(
        frame, np.full((84, 84), lane.ale.screen_value(lane.ale.t)))
    return [frame, lane.ale.log, lane.lives, lane.frame_count]


def _max_pool_seam(mod):
    lane = _lane(mod)
    lane.reset_episode()
    t0 = lane.ale.t
    out = lane.step(2)
    assert [a for t, a in lane.ale.log if t > t0] == [3, 3, 3, 3]
    assert out[1:] == (4.0, False, False, False)
    expect = max(lane.ale.screen_value(t0 + 3),
                 lane.ale.screen_value(t0 + 4))
    np.testing.assert_array_equal(out[0], np.full((84, 84), expect))
    return [*out, lane.ale.log]


def _episodic_life(mod):
    lane = _lane(mod)
    lane.reset_episode()
    resets = lane.ale.resets
    lane.ale.life_loss_at = {lane.ale.t + 6}
    first = lane.step(0)
    out = lane.step(0)
    assert not first[2]
    assert out[2:] == (True, False, False)
    assert lane.ale.resets == resets and lane.lives == 2
    assert lane.ale.log[-1][1] == 1
    return [*first, *out, lane.ale.log, lane.lives]


def _game_over(mod):
    lane = _lane(mod)
    lane.reset_episode()
    resets = lane.ale.resets
    lane.ale.game_over_at = {lane.ale.t + 2}
    out = lane.step(0)
    assert out[1:] == (2.0, True, False, True)
    assert lane.ale.resets == resets + 1 and lane.lives == 3
    return [*out, lane.ale.log]


def _truncation(mod):
    lane = _lane(mod, max_episode_frames=8)
    lane.reset_episode()
    resets = lane.ale.resets
    first = lane.step(0)
    out = lane.step(0)
    assert first[2:4] == (False, False)
    assert out[2:] == (False, True, True)
    assert lane.ale.resets == resets + 1 and lane.frame_count == 0
    return [*first, *out, lane.ale.log]


def _clip_and_true_scores(mod):
    env = mod.AtariVecEnv(num_envs=3, rom="pong", seed=0,
                          clip_rewards=True, num_threads=0)
    assert env.spec.num_actions == 3
    obs = env.reset(seed=0)
    for lane in env._lanes:
        lane.ale.reward_value = lambda t: 2.0
    env._lanes[1].ale.game_over_at = {env._lanes[1].ale.t + 3}
    out = env.step(np.zeros((3,), np.int64))
    np.testing.assert_array_equal(out[1], np.ones((3,), np.float32))
    np.testing.assert_array_equal(out[2], [False, True, False])
    scores = env.pop_completed_scores()
    assert scores == [6.0] and env.pop_completed_scores() == []
    return [obs, *out, scores]


def _thread_pool(mod):
    e1 = mod.AtariVecEnv(num_envs=2, rom="pong", seed=0, num_threads=0)
    e2 = mod.AtariVecEnv(num_envs=2, rom="pong", seed=0, num_threads=2)
    rec = [e1.reset()]
    np.testing.assert_array_equal(rec[0], e2.reset())
    for _ in range(3):
        a = np.array([1, 2])
        r1, r2 = e1.step(a), e2.step(a)
        for x, y in zip(r1, r2):
            np.testing.assert_array_equal(x, y)
        rec.extend(r1)
    return rec


CASES = [_noop_and_fire_reset, _max_pool_seam, _episodic_life, _game_over,
         _truncation, _clip_and_true_scores, _thread_pool]


def _assert_same(a, b):
    assert len(a) == len(b)
    for x, y in zip(a, b):
        if isinstance(x, np.ndarray):
            assert x.dtype == y.dtype and x.shape == y.shape
            np.testing.assert_array_equal(x, y)
        else:
            assert x == y and type(x) is type(y)


@pytest.mark.parametrize("case", CASES, ids=[c.__name__[1:] for c in CASES])
def test_stub_case_matches_jax(fake_ale, case):
    _assert_same(case(tatari), case(jatari))


@pytest.mark.parametrize("cv2", [True, False], ids=["cv2", "numpy"])
def test_preprocess_frame_matches_jax(monkeypatch, cv2):
    """Both resize routes (the card's machine has no cv2, so it takes
    the numpy fallback) on random screens."""
    if cv2 and not tatari._HAS_CV2:
        pytest.skip("cv2 is not installed")
    monkeypatch.setattr(tatari, "_HAS_CV2", cv2)
    monkeypatch.setattr(jatari, "_HAS_CV2", cv2)
    rgb = np.random.default_rng(0).integers(0, 256, (3, 210, 160, 3),
                                            dtype=np.uint8)
    for x in rgb:
        t, j = tatari.preprocess_frame(x), jatari.preprocess_frame(x)
        assert t.shape == (84, 84) and t.dtype == np.uint8
        np.testing.assert_array_equal(t, j)


def test_missing_ale_py_raises(monkeypatch):
    monkeypatch.setitem(sys.modules, "ale_py", None)
    with pytest.raises(ImportError, match="ale_py is not installed"):
        tatari.AtariVecEnv(num_envs=1)


def test_catch_lanes_match_jax(catch_ale):
    """A random policy over the paddle-catch game: 200 steps of 3 lanes,
    every output and every game score equal."""
    acts = np.random.default_rng(2).integers(0, 4, (200, 3))
    recs = []
    for mod in (tatari, jatari):
        env = mod.AtariVecEnv(num_envs=3, rom="catch", seed=1, noop_max=5)
        rec = [env.reset()]
        for a in acts:
            rec.extend(env.step(a))
        rec.append(env.pop_completed_scores())
        recs.append(rec)
    assert len(recs[0][-1]) > 0
    _assert_same(*recs)


def _catch_cfg(**train):
    cfg = {
        "seed": 0,
        "env": {"type": "atari", "num_envs": 2, "rom": "catch",
                "noop_max": 2},
        "frame_stack": 4,
        "model": {"torso": "nature_cnn", "cnn_channels": [4, 4, 4],
                  "cnn_fc": 16, "head": "dueling",
                  "dueling_hidden": 8, "compute_dtype": "float32",
                  "channels_last": True},
        "replay": {"steps_per_env": 64, "prioritized": True},
        "algo": {"algo": "dqn", "batch_size": 4, "n_step": 2,
                 "lr": 1e-3, "target_update_freq": 10},
        "train": {"total_env_steps": 10**9, "warmup_env_steps": 0,
                  "chunk_len": 8, "updates_per_chunk": 1,
                  "log_interval": 10**9, "track_best": False},
    }
    cfg["train"].update(train)
    return cfg


def test_trainer_channels_last_constructs_and_trains(catch_ale, tmp_path):
    """model.channels_last through the port's Trainer on the Atari stack:
    the example input is NHWC and two chunks train."""
    from rltime_tpu_torch.training.trainer import Trainer
    t = Trainer(_catch_cfg(), str(tmp_path / "cl"), device="cpu")
    for _ in range(2):
        m, _ = t.train_chunk()
    assert np.isfinite(float(m["loss"]))


@pytest.mark.slow
def test_dqn_learns_catch_through_atari_stack(catch_ale, tmp_path):
    """Config-#2-shaped DQN (Nature CNN, PER, n-step, double/dueling,
    frame stack 4) learns paddle-catch through the port's AtariVecEnv to
    a greedy true game score no random policy reaches (random ~0.7,
    threshold 3.0, ceiling 12), as the JAX package's test does."""
    from rltime_tpu_torch.training.trainer import Trainer
    cfg = {
        "seed": 0,
        "env": {"type": "atari", "num_envs": 16, "rom": "catch",
                "noop_max": 5},
        "frame_stack": 4,
        "model": {"torso": "nature_cnn", "cnn_channels": [8, 16, 16],
                  "cnn_fc": 64, "head": "dueling",
                  "dueling_hidden": 64, "compute_dtype": "float32"},
        "replay": {"steps_per_env": 512, "prioritized": True},
        "algo": {"algo": "dqn", "batch_size": 32, "n_step": 3,
                 "double_q": True, "lr": 1e-3,
                 "target_update_freq": 100},
        "exploration": {"type": "epsilon_greedy", "eps_start": 1.0,
                        "eps_end": 0.02, "anneal_steps": 25_000},
        "train": {"total_env_steps": 60_000, "warmup_env_steps": 2_000,
                  "chunk_len": 16, "updates_per_chunk": 8,
                  "log_interval": 20_000, "checkpoint_interval": 10**9,
                  "track_best": False},
    }
    t = Trainer(cfg, str(tmp_path / "catch"), device="cpu").train()
    model = t.train_state.model
    eval_env = tatari.AtariVecEnv(num_envs=8, rom="catch", seed=123,
                                  noop_max=5)
    obs = eval_env.reset()
    frames = np.zeros((8, 4, 84, 84), np.uint8)
    frames[:, -1] = obs
    scores = []
    with torch.no_grad():
        for _ in range(600):
            a = model(torch.from_numpy(frames)).argmax(-1).numpy()
            obs, _, term, trunc = eval_env.step(a)
            done = term | trunc
            frames = np.roll(frames, -1, axis=1)
            frames[:, -1] = obs
            frames[done, :-1] = 0
            scores.extend(eval_env.pop_completed_scores())
            if len(scores) >= 16:
                break
    assert len(scores) >= 8, "eval produced too few completed games"
    mean = float(np.mean(scores))
    assert mean >= 3.0, f"greedy true-score mean {mean} ({scores})"
