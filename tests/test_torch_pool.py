"""Async acting (`rltime_tpu_torch/acting/pool.py`, JAX `acting/pool.py`).

A Trainer with `train.async_acting` runs to the end and closes its pool
(tests/test_integration.py's test_async_acting_pool); the weights are
published every `publish_interval` trained chunks; no chunk is acted
with half-copied weights while the learner changes its own in place; an
exception in the actor thread is raised on the learner side; `close()`
joins a producer blocked on a full queue.
"""
import threading
import time

import pytest
import torch

from rltime_tpu_torch.acting.pool import AsyncActorPool
from rltime_tpu_torch.training.trainer import Trainer
from torch_port_draws import one_intra_op_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_intra_op_thread")


def _cfg(publish_interval):
    return {
        "seed": 0,
        "env": {"type": "counting_env", "num_envs": 4, "episode_len": 9},
        "model": {"torso": "mlp", "mlp_hidden": [16], "head": "linear"},
        "replay": {"steps_per_env": 128, "prioritized": True},
        "algo": {"algo": "dqn", "batch_size": 8, "n_step": 2, "lr": 1e-3,
                 "target_update_freq": 10},
        "train": {"total_env_steps": 640, "warmup_env_steps": 128,
                  "chunk_len": 8, "updates_per_chunk": 1,
                  "log_interval": 256, "async_acting": True,
                  "publish_interval": publish_interval},
    }


@pytest.mark.parametrize("publish_interval", [1, 3])
def test_async_trainer_runs_and_publishes_every_interval(tmp_path,
                                                         publish_interval):
    t = Trainer(_cfg(publish_interval), str(tmp_path / "run"),
                device="cpu").train()
    assert t.updates_done > 0 and t.actor.env_steps >= 640
    assert not t.pool.alive
    # one publish at start, then one per `publish_interval` trained chunks
    assert t._chunks_trained == t.updates_done
    assert t.pool.version == 1 + t._chunks_trained // publish_interval
    for k in ("loss", "grad_norm"):
        assert torch.isfinite(t.last_metrics[k])


class _FakeActor:
    """Acts a 'chunk' by reading every weight of the model, slowly."""

    def __init__(self, fail_at=None):
        self.device = torch.device("cpu")
        self.env_steps = 0
        self.fail_at = fail_at

    def rollout(self, model):
        if self.fail_at is not None and self.env_steps >= self.fail_at:
            raise ValueError("env broke")
        seen = set()
        for p in model.parameters():
            seen.update(torch.unique(p).tolist())
            time.sleep(0.001)
        self.env_steps += 1
        return {"seen": sorted(seen)}, {}

    def episode_stats(self, clear=True):
        return [], []


def test_no_chunk_sees_half_copied_weights():
    learner = torch.nn.Sequential(*[torch.nn.Linear(4, 4) for _ in range(6)])
    with torch.no_grad():
        for p in learner.parameters():
            p.fill_(0.0)
    pool = AsyncActorPool(_FakeActor(), learner, max_queue=1)
    versions = []
    try:
        for v in range(1, 40):
            with torch.no_grad():          # the learner's in-place update
                for p in learner.parameters():
                    p.fill_(float(v))
            pool.set_params(learner)
            chunk, info = pool.get_chunk(timeout=30)
            # every weight of the chunk's model carried one value: the
            # publish it was acted with
            assert len(chunk["seen"]) == 1, chunk
            assert chunk["seen"][0] == info["params_version"] - 1
            versions.append(info["params_version"])
    finally:
        pool.close()
    assert versions == sorted(versions) and versions[-1] > versions[0]


def test_actor_exception_is_raised_on_the_learner_side():
    pool = AsyncActorPool(_FakeActor(fail_at=2), torch.nn.Linear(2, 2))
    try:
        with pytest.raises(RuntimeError, match="actor thread died") as err:
            for _ in range(10):
                pool.get_chunk(timeout=30)
        assert isinstance(err.value.__cause__, ValueError)
    finally:
        pool.close()
    assert not pool.alive


def test_close_joins_a_producer_blocked_on_a_full_queue():
    pool = AsyncActorPool(_FakeActor(), torch.nn.Linear(2, 2), max_queue=1)
    deadline = time.monotonic() + 30
    while pool._queue.qsize() < 1 and time.monotonic() < deadline:
        time.sleep(0.01)
    assert pool.alive and pool._queue.full()
    t0 = time.monotonic()
    pool.close()
    assert not pool.alive and time.monotonic() - t0 < 5
    assert all(t.name != "actor-pool" for t in threading.enumerate())
