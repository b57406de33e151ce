"""Port parity: `train.interleave_updates` and actor-side priorities on
the fused trainer.

One interleaved superstep (L iterations of {one env step over all lanes,
a one-column insert, K / L updates}) of the port's `FusedApexTrainer`
on the CPU against the JAX one at d = 1, from the JAX side's weights and
its own draws (`torch_port_draws`): ring bytes, cursors, actor state and
env state bit-equal; loss, |TD|, grad norm, priorities and the params
after Adam to 2e-4: the superstep chains sixteen updates, each feeding
the next through the weights and the priorities, so f32 differences of
1e-6 compound (the two-update chunked superstep of
`test_torch_fused.superstep_parity`, which runs both sides, holds 1e-5). With and without a warm chunk (the warm program
acts L steps and inserts column by column), with actor-side initial
priorities (`replay.use_inserted_priorities`: the stored "priority" ring
to rtol 1e-5), and the chunked superstep with priorities. Within the
port: the fused trainer with priorities equals `Trainer` +
`DeviceActor` bit for bit, the replay runs with chunk_len 1 and escapes
the ring-safety bound, and what the reference refuses is refused with
its messages.
"""
import numpy as np
import pytest
import torch

from rltime_tpu_torch.parallel.fused import FusedApexTrainer
from rltime_tpu_torch.training.trainer import Trainer
from test_torch_fused import (
    E, _assert_same_run, _assert_same_tensors, _cfg, _fused_parts,
    superstep_parity,
)
from torch_port_draws import one_intra_op_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_intra_op_thread")

LI, KI = 8, 16          # interleaved: 2 updates after each of 8 env steps
PRIO = {"use_inserted_priorities": True}


@pytest.mark.parametrize("warmup,replay", [
    (0, None), (2 * LI * E, PRIO)])
def test_interleaved_superstep_matches_jax(tmp_path, warmup, replay):
    superstep_parity(tmp_path, "dqn", warmup, replay=replay, rtol=2e-4,
                     chunk_len=LI, updates_per_chunk=KI,
                     interleave_updates=True)


@pytest.mark.parametrize("algo,warmup", [("dqn", 0), ("iqn", 64)])
def test_chunked_superstep_with_priorities_matches_jax(tmp_path, algo,
                                                       warmup):
    superstep_parity(tmp_path, algo, warmup, replay=PRIO)


def _interleaved(tmp_path, name, **kw):
    return FusedApexTrainer(
        _cfg(chunk_len=LI, updates_per_chunk=KI, interleave_updates=True,
             warmup=2 * LI * E, **kw), str(tmp_path / name), device="cpu")


def test_interleaved_geometry_and_cadence(tmp_path):
    t = _interleaved(tmp_path, "a")
    assert t.replay_cfg.chunk_len == 1 and t.loop_cfg.chunk_len == LI
    assert t.superstep() == {}                      # the warm chunk
    assert t.replay_state.t == LI and t.updates_done == 0
    m = t.superstep()
    assert t.replay_state.t == 2 * LI and t.updates_done == KI
    assert t.train_state.updates == KI
    assert t.env_steps == 2 * LI * E
    for k in ("loss", "grad_norm", "td_abs", "q"):
        assert np.isfinite(m[k].item()), k
    # one-column inserts escape the bound T >= 2 * (chunk_len + horizon):
    # a 32-step chunk on a 64-column ring
    big = _cfg(chunk_len=32, updates_per_chunk=32, warmup=0)
    with pytest.raises(ValueError, match="steps_per_env too small"):
        FusedApexTrainer(big, str(tmp_path / "b"), device="cpu")
    big["train"]["interleave_updates"] = True
    t = FusedApexTrainer(big, str(tmp_path / "c"), device="cpu")
    t.superstep()
    assert t.replay_state.t == 32 and t.updates_done == 32


def test_interleaved_s2_equals_two_dispatches(tmp_path):
    one = _interleaved(tmp_path, "one")
    two = _interleaved(tmp_path, "two", supersteps=2)
    for t in (one, two):
        t.superstep()
    one.superstep()
    m1 = one.superstep()
    m2 = two.superstep()
    _assert_same_run(*_fused_parts(one), *_fused_parts(two))
    _assert_same_tensors(m1, m2, "metrics")


@pytest.mark.parametrize("algo", ["dqn", "iqn", "r2d2"])
def test_fused_equals_trainer_with_priorities(tmp_path, algo):
    cfg = _cfg(algo, replay=PRIO)
    fused = FusedApexTrainer(cfg, str(tmp_path / "f"), device="cpu")
    host = Trainer(cfg, str(tmp_path / "h"), device="cpu")
    for _ in range(4):
        fused.superstep()
        host.train_chunk()
    assert host.updates_done == fused.updates_done > 0
    _assert_same_run(*_fused_parts(fused), host.train_state,
                     host.replay_state, host.actor.state)
    _assert_same_tensors(fused.last_metrics, host.last_metrics, "metrics")
    prio = fused.replay_state.storage["priority"]
    assert prio.shape == (E, 64) and prio[:, :fused.replay_state.t].sum() > 0
    # leaves activate at the actor's priorities, not at max-priority
    live = fused.replay_state.tree[fused.replay_state.tree > 0]
    assert live.unique().numel() > E


def test_refusals_carry_the_reference_messages(tmp_path):
    with pytest.raises(ValueError, match="multiple of chunk_len"):
        FusedApexTrainer(_cfg(chunk_len=4, updates_per_chunk=6,
                              interleave_updates=True),
                         str(tmp_path / "a"), device="cpu")
    cfg = _cfg(chunk_len=4, updates_per_chunk=4, warmup=0,
               interleave_updates=True)
    cfg["algo"]["debug_outputs"] = True
    with pytest.raises(ValueError, match="not supported with "
                       "interleave_updates"):
        FusedApexTrainer(cfg, str(tmp_path / "b"), device="cpu")
    with pytest.raises(ValueError, match="not supported with "
                       "interleave_updates"):
        FusedApexTrainer(_cfg(chunk_len=4, updates_per_chunk=4, warmup=0,
                              interleave_updates=True,
                              record_transcript=True),
                         str(tmp_path / "c"), device="cpu")
