"""The fused trainers' protected-checkpoint bookkeeping, both packages.

A best snapshot at step X, an interval save at the same X, a resume, then
a new best: the interval save makes X a protected checkpoint
(`unmark_best_only`), the resumed run rebuilds its protected steps from
disk (`derive_protected_steps`), so the new best must not reclaim X.
Both `FusedApexTrainer`s keep X and write the same `best.json`. On
several ranks only the lead reads and writes `best.json`.
"""
import copy
import json
import os

import jax
import pytest

from rltime_tpu.parallel.fused import FusedApexTrainer as JFused
from rltime_tpu.parallel.mesh import make_mesh
from rltime_tpu.training import checkpoint as jckpt
from rltime_tpu_torch.parallel.fused import FusedApexTrainer
from rltime_tpu_torch.training import checkpoint as tckpt
from torch_port_draws import one_intra_op_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_intra_op_thread")

CFG = {
    "seed": 2,
    "env": {"type": "cartpole_device", "num_envs": 2},
    "model": {"torso": "mlp", "mlp_hidden": [8], "head": "linear"},
    "replay": {"steps_per_env": 64, "prioritized": True},
    "algo": {"algo": "dqn", "batch_size": 4, "n_step": 2, "lr": 1e-3,
             "target_update_freq": 5},
    "train": {"total_env_steps": 10**6, "warmup_env_steps": 0,
              "chunk_len": 8, "updates_per_chunk": 1,
              "log_interval": 10**9, "trainer": "fused"},
}


def _drive(make, ckpt_lib, rd):
    """best at X -> interval save at X -> resume -> a new best, with the
    calls the train loop makes. Returns X."""
    t = make(CFG, rd)
    t.superstep()
    x = t.env_steps
    t._best_score = ckpt_lib.maybe_record_best(
        rd, t._best_score, 1.0, 5, 1, x,
        lambda: t.save_checkpoint(protect=False), t._protected_steps)
    assert ckpt_lib.best_step(rd)["best_only"]
    t.save_checkpoint()                       # the interval save at X
    cfg = copy.deepcopy(CFG)
    cfg["train"]["resume"] = True
    r = make(cfg, rd)
    assert r.env_steps == x and r._best_score == 1.0
    r.superstep()
    r._best_score = ckpt_lib.maybe_record_best(
        rd, r._best_score, 2.0, 5, 1, r.env_steps,
        lambda: r.save_checkpoint(protect=False), r._protected_steps)
    return x


def test_interval_checkpoint_at_the_best_step_survives_a_resume(tmp_path):
    jrd, trd = str(tmp_path / "jax"), str(tmp_path / "torch")
    jx = _drive(lambda c, rd: JFused(c, rd, mesh=make_mesh(jax.devices()[:1])),
                jckpt, jrd)
    tx = _drive(lambda c, rd: FusedApexTrainer(c, rd, device="cpu"),
                tckpt, trd)
    assert jx == tx
    for rd in (jrd, trd):
        assert os.path.isdir(os.path.join(rd, "checkpoints", str(jx))), rd
    best = [json.load(open(os.path.join(rd, "checkpoints", "best.json")))
            for rd in (jrd, trd)]
    assert best[0] == best[1] == {"step": 2 * jx, "score": 2.0,
                                  "best_only": True}


def test_only_the_lead_reads_best_json(tmp_path):
    """A rank other than the lead neither reads best.json (the lead may be
    rewriting it) nor writes it; it runs its own save. best.json itself is
    replaced whole, never left half-written."""
    rd = str(tmp_path / "run")
    os.makedirs(os.path.join(rd, "checkpoints"))
    with open(os.path.join(rd, "checkpoints", "best.json"), "w") as f:
        f.write('{"step": 1')                 # the lead mid-write
    saved = []
    got = tckpt.maybe_record_best(rd, 0.5, 1.0, 5, 1, 64,
                                  lambda: saved.append(1), lead=False)
    assert got == 1.0 and saved == [1]
    assert open(os.path.join(rd, "checkpoints", "best.json")).read() == (
        '{"step": 1')
    tckpt.record_best(rd, 64, 1.0, best_only=True)
    assert tckpt.best_step(rd) == {"step": 64, "score": 1.0,
                                   "best_only": True}
    assert os.listdir(os.path.join(rd, "checkpoints")) == ["best.json"]
