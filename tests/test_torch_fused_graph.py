"""The fused superstep as a CUDA graph would replay it, on the CPU.

On a card `FusedApexTrainer` captures one superstep into a CUDA graph
and replays it (`parallel/fused.py`, `utils/graphs.py`). A graph records
device addresses, so its body must leave every tensor it carries from
one superstep to the next at the address it found it at. The CPU runs
the same body eagerly, which shows that half here:

  * address stability: every carried tensor (parameters, target, Adam
    moments, rings, tree, max_priority, cursor, counter, the actor's env
    state, carry, running returns, stat rings and ring cursor) keeps its
    `data_ptr` across supersteps, chunked (DQN, IQN, R2D2, the sum-tree
    sampler) and interleaved, and the device cursor and counter agree
    with the host's mirrors;
  * resume into a live trainer restores every tensor in place and
    continues bit-identically;
  * the IQN taus of the post-chunk forward come from a generator of the
    actor state, saved and restored with the sidecar;
  * Adam's state loads across `capturable` (an eager checkpoint into the
    captured route's optimizer, and the reverse).

The replay itself is held against the eager body on the card
(`tests/test_torch_cuda.py`, `chip_smoke.py`).
"""
import copy
import sys

import pytest
import torch

from rltime_tpu_torch.parallel import census
from rltime_tpu_torch.parallel.fused import FusedApexTrainer
from rltime_tpu_torch.parallel.mesh import sidecar_path
from rltime_tpu_torch.training import checkpoint as ckpt_lib
from rltime_tpu_torch.training.learner import AlgoConfig, make_optimizer
from test_torch_fused import _assert_same_run, _cfg, _fused_parts
from torch_port_draws import one_intra_op_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_intra_op_thread")

E, L = 4, 8
PRIO = {"use_inserted_priorities": True}


def _trainer(tmp_path, case, name="run", **train):
    """`case`: an algo, "interleaved" (DQN, one update a step) or
    "sum tree" (DQN on `replay.sampler=tree`); actor-side priorities on."""
    algo = case if case in ("dqn", "iqn", "r2d2") else "dqn"
    replay = dict(PRIO, sampler="tree" if case == "sum tree" else "dense")
    if case == "interleaved":
        train.update(interleave_updates=True, updates_per_chunk=8)
    return FusedApexTrainer(_cfg(algo, replay=replay, **train),
                            str(tmp_path / name), device="cpu")


def _carried(t):
    """name -> every tensor the superstep carries to the next one."""
    ts, rs, a = t.train_state, t.replay_state, t.actor_state
    out = {f"model.{k}": v for k, v in ts.model.state_dict().items()}
    out.update({f"target.{k}": v for k, v in ts.target.state_dict().items()})
    for i, st in enumerate(ts.optimizer.state.values()):
        out.update({f"adam.{i}.{k}": v for k, v in st.items()
                    if isinstance(v, torch.Tensor)})
    out.update({f"ring.{k}": v for k, v in rs.storage.items()})
    out.update(tree=rs.tree, max_priority=rs.max_priority,
               cursor=rs.cursor, counter=ts.counter)
    out.update({f"env.{k}": v for k, v in a.env_state.items()})
    out.update(done_prev=a.done_prev, ep_ret=a.ep_ret, ep_len=a.ep_len,
               ret_ring=a.ret_ring, len_ring=a.len_ring,
               ring_cursor=a.ring_cursor)
    if a.rnn is not None:
        out.update(rnn_c=a.rnn[0], rnn_h=a.rnn[1])
    return out


def _addresses(t):
    return {k: v.data_ptr() for k, v in _carried(t).items()}


@pytest.mark.parametrize("case", ["dqn", "iqn", "r2d2", "interleaved",
                                  "sum tree"])
def test_superstep_keeps_every_carried_tensor_in_place(tmp_path, case):
    t = _trainer(tmp_path, case)
    t.superstep()                   # the warm chunk
    t.superstep()                   # the first update makes Adam's state
    before = _addresses(t)
    state_before = {k: v.clone() for k, v in _carried(t).items()}
    for _ in range(2):
        t.superstep()
    assert _addresses(t) == before
    # ... and the tensors did change in place (the test sees the carry)
    moved = {k for k, v in _carried(t).items()
             if not torch.equal(v, state_before[k])}
    assert {"tree", "cursor", "counter", "ring.obs", "ep_len",
            "ring_cursor"} <= moved
    for part in ("model.", "target.", "adam.", "env."):
        assert any(k.startswith(part) for k in moved), part
    if case == "r2d2":
        assert "rnn_h" in moved
    rs, ts = t.replay_state, t.train_state
    assert rs.cursor.item() == rs.t == t.env_steps // E
    assert ts.counter.item() == ts.updates == t.updates_done > 0
    # the warm program writes in place too
    before = _addresses(t)
    t._warm_super(ts.model, t.actor_state, rs, t._eps(L))
    assert _addresses(t) == before


def test_resume_into_a_live_trainer_is_in_place(tmp_path):
    """A live trainer (Adam state made, replay filled) resumes from
    another run's checkpoint: its tensors keep their addresses, and it
    continues as the run that wrote the checkpoint."""
    a = _trainer(tmp_path, "dqn", supersteps=2, checkpoint_replay=True)
    for _ in range(3):
        a.superstep()
    a.save_checkpoint()
    live = _trainer(tmp_path, "dqn", name="run", supersteps=2,
                    checkpoint_replay=True)
    for _ in range(2):
        live.superstep()
    before = _addresses(live)
    live._try_resume()
    assert _addresses(live) == before
    assert (live.env_steps, live.updates_done) == (a.env_steps,
                                                   a.updates_done)
    assert live.replay_state.cursor.item() == live.replay_state.t
    assert live.train_state.counter.item() == live.train_state.updates
    _assert_same_run(*_fused_parts(a), *_fused_parts(live))
    for t in (a, live):
        t.superstep()
    assert _addresses(live) == before
    _assert_same_run(*_fused_parts(a), *_fused_parts(live))


def test_final_qbest_generator_rides_in_the_sidecar(tmp_path):
    """IQN with actor-side priorities draws the post-chunk forward's taus
    from the actor state's `final_generator`: it advances each chunk,
    leaves the actor's own stream alone, is saved in the sidecar and is
    restored by a resume."""
    a = _trainer(tmp_path, "iqn", supersteps=2, checkpoint_replay=True)
    gen = a.actor_state.final_generator
    start = gen.get_state().clone()
    a.superstep()
    assert not torch.equal(gen.get_state(), start)
    a.superstep()
    a.save_checkpoint()
    aux = torch.load(sidecar_path(a.result_dir, a.env_steps, 0),
                     weights_only=True)
    assert torch.equal(aux["actor_state"]["final_generator"],
                       gen.get_state())
    cfg = copy.deepcopy(a.config)
    cfg["train"]["resume"] = True
    b = FusedApexTrainer(cfg, a.result_dir, device="cpu")
    assert torch.equal(b.actor_state.final_generator.get_state(),
                       gen.get_state())
    for t in (a, b):
        t.superstep()
    _assert_same_run(*_fused_parts(a), *_fused_parts(b))
    # without actor-side priorities nothing draws from it
    c = FusedApexTrainer(_cfg("iqn"), str(tmp_path / "c"), device="cpu")
    start = c.actor_state.final_generator.get_state().clone()
    for _ in range(2):
        c.superstep()
    assert torch.equal(c.actor_state.final_generator.get_state(), start)


@pytest.fixture
def capturable_on_cpu(monkeypatch):
    """torch keeps capturable Adam to accelerators; let it run on the
    CPU, the same arithmetic as on the card."""
    adam = sys.modules["torch.optim.adam"]
    supported = adam._get_capturable_supported_devices()
    monkeypatch.setattr(adam, "_get_capturable_supported_devices",
                        lambda *a, **k: supported + ["cpu"])


@pytest.mark.parametrize("saved_capturable", [False, True])
def test_adam_state_loads_across_capturable(capturable_on_cpu,
                                            saved_capturable):
    """An optimizer state saved by one Adam loads into the other (the
    eager route's into the captured route's, and the reverse) in place:
    the live optimizer keeps its flag and its tensors, holds the saved
    moments and step count, and its next step equals the saver's."""
    cfg = AlgoConfig(lr=1e-2)
    g = torch.Generator().manual_seed(0)
    shapes = [(3, 5), (5,)]
    init = [torch.randn(s, generator=g) for s in shapes]
    grads = [[torch.randn(s, generator=g) for s in shapes] for _ in range(4)]

    def make(capturable):
        ps = [torch.nn.Parameter(x.clone()) for x in init]
        return ps, make_optimizer(cfg, ps, capturable=capturable)

    def step(ps, opt, gs):
        for p, gr in zip(ps, gs):
            p.grad = gr.clone()
        opt.step()

    src_p, src = make(saved_capturable)
    dst_p, dst = make(not saved_capturable)
    for gs in grads[:2]:
        step(src_p, src, gs)
    step(dst_p, dst, grads[3])      # the live optimizer has state
    for p, q in zip(dst_p, src_p):
        with torch.no_grad():
            p.copy_(q)
    keys = ("exp_avg", "exp_avg_sq", "step")
    ptrs = [{k: dst.state[p][k].data_ptr() for k in keys} for p in dst_p]
    ckpt_lib.load_optimizer_state(dst, copy.deepcopy(src.state_dict()))
    assert dst.param_groups[0]["capturable"] is (not saved_capturable)
    for p, q, was in zip(dst_p, src_p, ptrs):
        for k in keys:
            mine, theirs = dst.state[p][k], src.state[q][k]
            assert torch.equal(mine, theirs.to(mine.device)), k
            assert mine.data_ptr() == was[k], k
    step(src_p, src, grads[2])
    step(dst_p, dst, grads[2])
    for p, q in zip(dst_p, src_p):
        torch.testing.assert_close(p, q, rtol=0, atol=1e-6)


def test_census_counts_each_replay():
    """What a captured graph issued is recorded once at its capture;
    `add` counts it again for every later replay."""
    census.reset_counts()
    census.record("all_reduce", "float32", 64, "device", "grad")
    per_replay = dict(census.COUNTS)
    for _ in range(3):
        census.add(per_replay)
    assert census.entries() == [dict(op="all_reduce", dtype="float32",
                                     bytes=64, group="device", site="grad",
                                     count=4)]
    census.reset_counts()


def test_the_cpu_runs_the_body_without_a_graph(tmp_path):
    t = _trainer(tmp_path, "dqn")
    assert t.graph is None
    t.superstep()
    assert t.superstep()["loss"].isfinite()
