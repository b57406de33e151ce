"""The fused trainer end to end over gloo ranks (tests/test_multiprocess.py's
test_fused_two_process_end_to_end, on the port).

2x1 and 4x1 runs, each with resume: the learner is identical on every
rank, two resumes of the last checkpoint evolve identically, every rank
holds the same best.json and each wrote its sidecar.
"""
import json
import os

import numpy as np
import pytest

import torch_port_mp
from rltime_tpu_torch.training import checkpoint as ckpt_lib

FUSED_CFG = {
    "seed": 0,
    "env": {"type": "cartpole_device", "num_envs": 2},
    "model": {"torso": "mlp", "mlp_hidden": [16], "head": "linear"},
    "replay": {"steps_per_env": 128, "prioritized": True,
               "use_inserted_priorities": True},
    "algo": {"algo": "dqn", "batch_size": 4, "n_step": 2, "lr": 1e-3,
             "target_update_freq": 10},
    "exploration": {"type": "epsilon_greedy", "eps_start": 1.0,
                    "eps_end": 0.1, "anneal_steps": 2000},
    "train": {"total_env_steps": 1024, "warmup_env_steps": 128,
              "chunk_len": 8, "updates_per_chunk": 2, "log_interval": 256,
              "track_best": True, "best_min_episodes": 1,
              "checkpoint_interval": 10**9, "checkpoint_replay": True,
              "trainer": "fused", "supersteps_per_dispatch": 2},
}


@pytest.mark.parametrize("world", [2, 4])
def test_fused_gloo_ranks_end_to_end_with_resume(tmp_path, world):
    with open(tmp_path / "cfg.json", "w") as f:
        json.dump(dict(config=FUSED_CFG, result_dir=str(tmp_path / "res")),
                  f)
    outs = torch_port_mp.run_ranks("fused", world, str(tmp_path))
    for o in outs:
        assert int(o["updates_done"]) > 0
        assert int(o["env_steps"]) >= 1024
        assert int(o["num_episodes"]) > 0
    # the learner is the same on every rank, though each acted on lanes
    # of its own: the gradient average crossed the ranks
    assert len({float(o["checksum"]) for o in outs}) == 1
    for o in outs[1:]:
        for k, v in outs[0]["params"].items():
            np.testing.assert_array_equal(o["params"][k], v, err_msg=k)
    # two resumes of the last checkpoint evolve identically everywhere
    for o in outs:
        a, b = o["resumed"]
        assert a == b and a != float(o["checksum"])
    assert len({float(o["resumed"][0]) for o in outs}) == 1
    # one best.json for all, a sidecar per rank at its step
    best = [json.loads(str(o["best"])) for o in outs]
    assert best[0] is not None and all(b == best[0] for b in best)
    assert len({float(o["best_score"]) for o in outs}) == 1
    aux = ckpt_lib.aux_dir(str(tmp_path / "res"), best[0]["step"])
    assert sorted(os.listdir(aux)) == [f"proc{r}.pt" for r in range(world)]
