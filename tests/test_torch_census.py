"""The collectives the port issues (`rltime_tpu_torch/parallel/census.py`),
the counterpart of tests/test_collective_census.py.

The sample, gather and insert plane is rank-local: per fused superstep at
d=2 the ranks exchange K gradient all-reduces of the parameters' size,
K metric buffers and K+1 MAXes of `max_priority` (the insert's and each
update's), nothing else; no payload is larger than the parameters, and
one rank's obs ring is far larger than that cap, so a storage-sized
collective would trip it. The apex chunk issues the same per update.
"""
import json
import os

import pytest

import torch_port_mp
from rltime_tpu_torch.parallel import census
from rltime_tpu_torch.parallel.fused import FusedApexTrainer
from torch_port_draws import one_intra_op_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_intra_op_thread")

FUSED = {
    "seed": 0,
    # image env (uint8 ring): a storage-sized collective would dwarf the cap
    "env": {"type": "minatar_breakout", "num_envs": 8},
    "model": {"torso": "minatar_cnn", "cnn_channels": [16], "cnn_fc": 128,
              "head": "dueling"},
    "replay": {"steps_per_env": 4096, "prioritized": True},
    "algo": {"algo": "dqn", "batch_size": 32, "n_step": 3, "lr": 1e-3,
             "target_update_freq": 100},
    "train": {"total_env_steps": 10**6, "warmup_env_steps": 200,
              "chunk_len": 16, "updates_per_chunk": 2,
              "log_interval": 10**9, "trainer": "fused"},
}
APEX = {
    "seed": 0,
    "env": {"type": "counting_env", "num_envs": 2, "episode_len": 7},
    "model": {"torso": "mlp", "mlp_hidden": [16], "head": "linear"},
    "replay": {"steps_per_env": 128, "prioritized": True},
    "algo": {"algo": "dqn", "batch_size": 4, "n_step": 2, "lr": 1e-3},
    "exploration": {"type": "epsilon_greedy", "mode": "ladder"},
    "train": {"total_env_steps": 10**6, "warmup_env_steps": 64,
              "chunk_len": 8, "updates_per_chunk": 3, "trainer": "apex"},
}


@pytest.fixture(scope="module")
def two_ranks(tmp_path_factory):
    work = tmp_path_factory.mktemp("census2")
    with open(os.path.join(work, "cfg.json"), "w") as f:
        json.dump(dict(fused=FUSED, apex=APEX, result_dir=str(work)), f)
    return torch_port_mp.run_ranks("census", 2, str(work))


def _per_update_plane(ents, params_bytes, K, inserts):
    by = {(e["op"], e["site"], e["group"], e["bytes"]): e["count"]
          for e in ents}
    assert by == {("all_reduce", "grad", "device", params_bytes): K,
                  ("all_reduce", "metrics", "device", 20): K,
                  ("all_reduce", "max_priority", "device", 4): K + inserts}, \
        census.summarize(ents)


def test_fused_superstep_census_at_two_ranks(two_ranks):
    for out in two_ranks:
        ents = json.loads(str(out["fused"]))
        p = int(out["fused_params_bytes"])
        K = int(out["fused_updates"])
        _per_update_plane(ents, p, K, inserts=1)
        # byte cap: the replicated plane (parameters) bounds every payload
        cap = 2 * p + 4096
        assert max(e["bytes"] for e in ents) <= cap
        # ... and the cap binds against the sample plane: one rank's obs
        # ring alone is more than 4x it
        assert int(out["obs_ring_bytes"]) > 4 * cap
        total = sum(e["bytes"] * e["count"] for e in ents)
        assert total <= (K + 1) * p + 16384


def test_apex_chunk_census_at_two_ranks(two_ranks):
    for out in two_ranks:
        ents = json.loads(str(out["apex"]))
        _per_update_plane(ents, int(out["apex_params_bytes"]),
                          int(out["apex_updates"]), inserts=1)


def test_one_rank_identity_mesh_issues_nothing(tmp_path):
    cfg = json.loads(json.dumps(FUSED))
    cfg["env"]["num_envs"] = 2
    cfg["replay"]["steps_per_env"] = 64
    cfg["algo"]["batch_size"] = 4
    cfg["train"]["warmup_env_steps"] = 0
    t = FusedApexTrainer(cfg, str(tmp_path / "f"), device="cpu")
    census.reset_counts()
    t.superstep()
    assert t.updates_done == 2 and census.entries() == []


def test_census_counts_and_summary():
    census.reset_counts()
    for _ in range(3):
        census.record("all_reduce", "float32", 400, "device", "grad")
    census.record("all_gather", "float32", 16, "host", "stats")
    ents = census.entries()
    assert ents == [
        dict(op="all_reduce", dtype="float32", bytes=400, group="device",
             site="grad", count=3),
        dict(op="all_gather", dtype="float32", bytes=16, group="host",
             site="stats", count=1)]
    assert "3 x all_reduce" in census.summarize()
    census.reset_counts()
    assert census.entries() == [] and census.summarize() == "(no collectives)"
