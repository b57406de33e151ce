"""Port parity: `train.record_transcript`, `algo.debug_outputs` and
`utils/transcript.py`.

A transcript of the port's host `Trainer` against the JAX `Trainer`'s on
uniform replay (`counting_env`, greedy actions, the JAX side's weights
and its learner key chain replayed through `train_chunk(draws=...)`):
the integer plane of every record (env_steps, the sampled leaves) and
the actions digest are equal; the per-sample |TD| behind the `td` digest
agrees to rtol 1e-5 / atol 1e-6 (the digest itself rounds to 5 decimals
and may flip at a rounding boundary, so the values are compared). The
file format is the JAX one: each side's loader reads the other's file.
Within the port the fused trainer's transcript equals the `Trainer` +
`DeviceActor` one, and the fused refusals (warmup, S > 1) carry the
reference's messages.
"""
import copy
import json

import jax
import numpy as np
import pytest
import torch

import torch_port_draws as draws_lib
from rltime_tpu.training.trainer import Trainer as JTrainer
from rltime_tpu.utils.transcript import Transcript as JTranscript
from rltime_tpu.utils.transcript import digest_array as j_digest
from rltime_tpu_torch import train as ttrain
from rltime_tpu_torch.history import replay as treplay
from rltime_tpu_torch.models import bridge
from rltime_tpu_torch.parallel.fused import FusedApexTrainer
from rltime_tpu_torch.training.trainer import Trainer
from rltime_tpu_torch.utils.transcript import Transcript, digest_array
from test_torch_fused import _cfg as fused_cfg
from torch_port_draws import one_intra_op_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_intra_op_thread")

E, L, B, K, CHUNKS = 4, 8, 8, 2, 6


def _cfg():
    return {
        "seed": 5,
        "env": {"type": "counting_env", "num_envs": E, "episode_len": 7},
        "frame_stack": 2,
        "model": {"torso": "mlp", "mlp_hidden": [16], "head": "linear"},
        "replay": {"steps_per_env": 64, "prioritized": False},
        "algo": {"algo": "dqn", "batch_size": B, "n_step": 2, "lr": 1e-3,
                 "target_update_freq": 3},
        "exploration": {"type": "epsilon_greedy", "eps_start": 0.0,
                        "eps_end": 0.0},
        "train": {"total_env_steps": CHUNKS * L * E,
                  "warmup_env_steps": 2 * L * E, "chunk_len": L,
                  "updates_per_chunk": K, "log_interval": 10**9,
                  "checkpoint_interval": 10**9, "record_transcript": True},
    }


def test_digest_and_file_format_are_the_jax_ones(tmp_path):
    rng = np.random.default_rng(0)
    ints = rng.integers(0, 9, (4, 8)).astype(np.int32)
    floats = rng.normal(size=16).astype(np.float32)
    assert digest_array(ints) == j_digest(ints)
    assert digest_array(torch.from_numpy(ints)) == j_digest(ints)
    assert digest_array(torch.from_numpy(floats)) == j_digest(floats)
    t, j = Transcript(), JTranscript()
    for tr, conv in ((t, torch.from_numpy), (j, np.asarray)):
        tr.record_chunk(32, conv(ints), {})
        tr.record_chunk(64, conv(ints), {
            "debug_leaf": conv(np.arange(5, dtype=np.int64)),
            "debug_td": conv(floats)})
    assert t.records == j.records and t.digest() == j.digest()
    t.dump(str(tmp_path / "t.jsonl"))
    assert JTranscript.load(str(tmp_path / "t.jsonl")).digest() == j.digest()
    j.dump(str(tmp_path / "j.jsonl"))
    assert Transcript.load(str(tmp_path / "j.jsonl")).records == t.records


def test_trainer_transcript_matches_jax_on_uniform_replay(tmp_path):
    cfg = _cfg()
    jt = JTrainer(copy.deepcopy(cfg), str(tmp_path / "jax"))
    tt = Trainer(cfg, str(tmp_path / "torch"), device="cpu")
    assert tt.algo_cfg.debug_outputs and tt.transcript is not None
    for net in (tt.train_state.model, tt.train_state.target):
        net.load_state_dict(bridge.flax_to_state_dict(
            tt.model_cfg, draws_lib.np_tree(jt.train_state.params)))
    tds = []
    for c in range(CHUNKS):
        # a copy: the JAX trainer donates its state to the update
        key = jax.random.wrap_key_data(
            np.array(jax.random.key_data(jt.train_state.key)))
        jm, _ = jt.train_chunk()
        draws = None
        if (c + 1) * L * E >= cfg["train"]["warmup_env_steps"]:
            lo, hi = treplay.valid_range(tt.replay_cfg, (c + 1) * L)
            draws = []
            for _ in range(K):      # training/learner.py:374
                draws.append(draws_lib.uniform_update_draws(
                    key, B, max(hi - lo, 1), E))
                key = jax.random.split(key, 3)[0]
        tm, _ = tt.train_chunk(draws)
        if draws:
            tds.append((tm["debug_td"].numpy(), np.asarray(jm["debug_td"])))
    jrec, trec = jt.transcript.records, tt.transcript.records
    assert len(trec) == len(jrec) == CHUNKS
    for a, b in zip(trec, jrec):
        assert a["env_steps"] == b["env_steps"]
        assert a["actions"] == b["actions"]
        assert ("leaves" in a) == ("leaves" in b)
        if "leaves" in a:
            assert a["leaves"] == b["leaves"] and len(a["leaves"]) == B
            assert all(isinstance(x, int) for x in a["leaves"])
            assert set(a) == set(b) == {"env_steps", "actions", "leaves",
                                        "td"}
    assert sum("leaves" in r for r in trec) == CHUNKS - 1
    for got, want in tds:
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)
    # the actions are not all the same one
    acts = tt.replay_state.storage["action"][:, :tt.replay_state.t]
    assert acts.unique().numel() > 1


def test_cli_writes_the_transcript(tmp_path):
    path = tmp_path / "cfg.json"
    path.write_text(json.dumps(_cfg()))
    rd = tmp_path / "run"
    t = ttrain.run([str(path), "--device", "cpu", "--result-dir", str(rd)])
    loaded = Transcript.load(str(rd / "transcript.jsonl"))
    assert loaded.records == t.transcript.records
    assert len(loaded.records) == CHUNKS
    assert loaded.digest() == t.transcript.digest()
    # without the option no debug leaves reach the metrics, no file
    cfg = _cfg()
    cfg["train"]["record_transcript"] = False
    t2 = Trainer(cfg, str(tmp_path / "plain"), device="cpu").train()
    assert "debug_leaf" not in t2.last_metrics
    assert not (tmp_path / "plain" / "transcript.jsonl").exists()


@pytest.mark.parametrize("algo", ["dqn", "r2d2"])
def test_fused_transcript_equals_the_trainer_one(tmp_path, algo):
    cfg = fused_cfg(algo, warmup=0, record_transcript=True)
    cfg["train"]["total_env_steps"] = 6 * 8 * 4
    fused = FusedApexTrainer(cfg, str(tmp_path / "f"), device="cpu").train()
    host = Trainer(cfg, str(tmp_path / "h"), device="cpu").train()
    assert len(fused.transcript.records) == 6
    assert fused.transcript.records == host.transcript.records
    assert all("leaves" in r and "td" in r for r in fused.transcript.records)
    assert "debug_chunk_action" not in fused.last_metrics
    assert (tmp_path / "f" / "transcript.jsonl").is_file()


def test_fused_transcript_refusals(tmp_path):
    with pytest.raises(ValueError, match="warmup_env_steps=0"):
        FusedApexTrainer(fused_cfg(record_transcript=True),
                         str(tmp_path / "a"), device="cpu")
    with pytest.raises(ValueError, match="supersteps_per_dispatch=1"):
        FusedApexTrainer(fused_cfg(warmup=0, supersteps=2,
                                   record_transcript=True),
                         str(tmp_path / "b"), device="cpu")
    cfg = fused_cfg(warmup=0)
    cfg["algo"]["debug_outputs"] = True     # the option behind the flag
    t = FusedApexTrainer(cfg, str(tmp_path / "c"), device="cpu")
    m = t.superstep()
    assert m["debug_chunk_action"].shape == (4, 8) and t.transcript is None
