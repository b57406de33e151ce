"""The port's eval entry point and the host CartPole env.

`rltime_tpu_torch.eval.evaluate` on checkpoints the port's own trainers
wrote (host `Actor` and `DeviceActor` by `env.is_device`): the report has
the reference's keys, `--best` loads the step `best.json` marks and
falls back to the latest checkpoint without one, the report covers
exactly the first `episodes` completed, `--record` always writes the
`.npz`, and `--device cuda` without a card raises. The numpy CartPole
copy steps bit for bit as the JAX package's, and both CartPole presets
(`cartpole_dqn`, `cartpole_dqn_device`) run as written through the CLI
at a cut length.
"""
import json

import numpy as np
import pytest
import torch

from rltime_tpu.envs.cartpole import CartPoleVecEnv as JCartPole
from rltime_tpu_torch import eval as teval
from rltime_tpu_torch import train as ttrain
from rltime_tpu_torch.envs.cartpole import CartPoleVecEnv
from rltime_tpu_torch.training import checkpoint as ckpt_lib
from rltime_tpu_torch.training.trainer import Trainer
from torch_port_draws import one_intra_op_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_intra_op_thread")

KEYS = {"episodes", "return_mean", "return_median", "return_min",
        "return_max", "checkpoint_step"}


def test_host_cartpole_steps_as_the_jax_package():
    a, b = CartPoleVecEnv(8, seed=3, time_limit=25), JCartPole(
        8, seed=3, time_limit=25)
    assert (a.spec.obs_shape, a.spec.num_actions) == (
        b.spec.obs_shape, b.spec.num_actions)
    np.testing.assert_array_equal(a.reset(seed=3), b.reset(seed=3))
    rng = np.random.default_rng(0)
    ends = 0
    for _ in range(200):
        act = rng.integers(0, 2, 8)
        out_a, out_b = a.step(act), b.step(act)
        for x, y in zip(out_a, out_b):
            assert x.dtype == y.dtype
            np.testing.assert_array_equal(x, y)
        ends += int((out_a[2] | out_a[3]).sum())
    assert ends > 8         # resets, terminated and truncated, compared too


@pytest.fixture(scope="module")
def cartpole_run(tmp_path_factory):
    rd = tmp_path_factory.mktemp("cartpole") / "run"
    t = ttrain.run(["cartpole_dqn", "--device", "cpu", "--result-dir",
                    str(rd), "--train.total_env_steps=6000",
                    "--train.log_interval=1024",
                    "--train.checkpoint_interval=2048"])
    return rd, t


def test_cartpole_preset_runs_as_written(cartpole_run):
    rd, t = cartpole_run
    assert isinstance(t, Trainer) and not t.replay_cfg.prioritized
    assert t.replay_state.tree.shape == (1,)
    assert t.actor.env_steps == 6144 and t.updates_done > 0
    assert t.train_state.updates == t.updates_done
    assert ckpt_lib.latest_step(str(rd)) == 6144
    assert np.isfinite(t.last_metrics["loss"].item())
    assert t.last_metrics["mean_weight"].item() == 1.0


def test_eval_report_latest_and_best(cartpole_run, tmp_path):
    import shutil
    rd, _ = cartpole_run
    latest = teval.evaluate(str(rd), episodes=6, device="cpu")
    assert set(latest) == KEYS and latest["episodes"] == 6
    assert latest["checkpoint_step"] == 6144
    assert latest["return_min"] <= latest["return_median"] <= latest[
        "return_max"]
    assert np.isfinite(latest["return_mean"]) and latest["return_min"] >= 8
    best = ckpt_lib.best_step(str(rd))      # track_best recorded one
    assert best is not None
    rep = teval.evaluate(str(rd), episodes=6, device="cpu", best=True)
    assert rep["checkpoint_step"] == best["step"]
    # a best that is not the latest: the interval checkpoint at 2048
    copy_dir = tmp_path / "copy"
    shutil.copytree(rd, copy_dir)
    ckpt_lib.record_best(str(copy_dir), 2048, 99.0)
    rep = teval.evaluate(str(copy_dir), episodes=6, device="cpu", best=True)
    assert rep["checkpoint_step"] == 2048
    assert teval.evaluate(str(copy_dir), episodes=6, device="cpu")[
        "checkpoint_step"] == 6144
    # the same seed and checkpoint give the same report
    assert teval.evaluate(str(rd), episodes=6, device="cpu") == latest


def test_best_falls_back_to_the_latest(cartpole_run, tmp_path):
    import shutil
    rd, _ = cartpole_run
    copy_dir = tmp_path / "copy"
    shutil.copytree(rd, copy_dir)
    (copy_dir / "checkpoints" / "best.json").unlink()
    rep = teval.evaluate(str(copy_dir), episodes=3, device="cpu", best=True)
    assert rep["checkpoint_step"] == 6144 and rep["episodes"] == 3


def test_first_completed_semantics_and_cli(cartpole_run, capsys):
    rd, _ = cartpole_run
    # 32 lanes cut to `episodes`; a 64-step chunk of a barely trained
    # policy completes several episodes per lane: exactly 2 are reported
    rep = teval.evaluate(str(rd), episodes=2, device="cpu")
    assert rep["episodes"] == 2
    assert teval.main([str(rd), "--episodes", "3", "--device", "cpu",
                       "--best", "--eps", "0.05"]) == 0
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert set(out) == KEYS and out["episodes"] == 3


def test_eval_cuda_without_a_card_raises(cartpole_run, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="cuda"):
        teval.main([str(cartpole_run[0])])


def test_device_preset_runs_as_written_and_evaluates(tmp_path):
    rd = tmp_path / "dev"
    t = ttrain.run(["cartpole_dqn_device", "--device", "cpu",
                    "--result-dir", str(rd),
                    "--train.total_env_steps=3000"])
    assert t.env.is_device and not t.replay_cfg.prioritized
    assert t.algo_cfg.lr_decay_updates == 9375      # the file's own block
    assert t.updates_done > 0
    rep = teval.evaluate(str(rd), episodes=4, device="cpu")
    assert set(rep) == KEYS and rep["episodes"] == 4
    assert rep["checkpoint_step"] == ckpt_lib.latest_step(str(rd))


def test_eval_of_an_image_run_records_frames(tmp_path):
    from test_torch_trainer import _img_cfg
    cfg = _img_cfg()
    cfg["model"].update(channels_last=True, space_to_depth=True)
    cfg["train"]["total_env_steps"] = 176
    rd = tmp_path / "img"
    Trainer(cfg, str(rd), device="cpu").train()
    rec = tmp_path / "rec.npz"
    rep = teval.evaluate(str(rd), episodes=2, device="cpu",
                         record_path=str(rec))
    assert rep["episodes"] == 2 and rep["checkpoint_step"] == 176
    frames = np.load(rec)["frames"]
    assert frames.dtype == np.uint8 and frames.shape[1:] == (84, 84)
    assert frames.shape[0] % 64 == 0


def test_eval_of_a_fused_minatar_run(tmp_path):
    rd = tmp_path / "fused"
    ttrain.run(["minatar_breakout_dqn", "--device", "cpu", "--result-dir",
                str(rd), "--env.num_envs=4", "--algo.batch_size=4",
                "--train.updates_per_chunk=2", "--train.warmup_env_steps=256",
                "--train.total_env_steps=500"])
    rep = teval.evaluate(str(rd), episodes=3, device="cpu")
    assert set(rep) == KEYS and rep["episodes"] == 3
    assert rep["checkpoint_step"] == ckpt_lib.latest_step(str(rd))
