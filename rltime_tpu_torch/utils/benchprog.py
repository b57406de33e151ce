"""The bench's learner superstep, one definition for
`python -m rltime_tpu_torch.bench`, `chip_smoke.py` and the tests (port
of `rltime_tpu/utils/benchprog.py`).

The program: the steady-state update cycle of the Atari
double/dueling n-step PER config (config #2's model at one card's
shapes): dense-PER sample -> both frame stacks (the union-gather
kernel, K2) and the n-step strips (the window-gather kernel, K1) ->
Nature-CNN forward and backward in bf16 -> global-norm clip -> Adam ->
priority write-back -> target sync, S x (1 chunk insert + K updates)
per dispatch.

Where the JAX version scans the S chunks into ONE XLA program, the
port captures them into ONE CUDA graph (`utils/graphs.py`): on the card
`superstep` is one graph replay, after copying the S chunks into the
graph's static input buffer. What the scan carries becomes state that
the graph updates in place: the write cursor (`ReplayState.cursor`) and
the update counter (`TrainState.counter`) are device tensors, the
insert and the sampler read the cursor on the device
(`replay_insert_device`, `replay_sample_indices_device`), Adam is
capturable on the card, and the sampler's generator is registered with
the graph.
`eager_superstep` is the same body run op by op: the CPU route, and on
the card what the graph is held against. `build(pipelined=True)` is the
JAX version's pipelined program: the next batch sampled while the
current one trains, on a side stream inside the same graph on the card.
"""
from __future__ import annotations

import copy
import types

import numpy as np
import torch

from rltime_tpu_torch.device import resolve_device
from rltime_tpu_torch.history.replay import (
    ReplayConfig, ReplayState, replay_in_place, replay_init, replay_insert,
    replay_insert_device,
)
from rltime_tpu_torch.models.policy import ModelConfig
from rltime_tpu_torch.training.learner import (
    AlgoConfig, TrainState, make_insert_and_update_step,
    make_pipelined_insert_and_update_step, make_train_state,
    make_update_step, use_device_counter,
)
from rltime_tpu_torch.training.r2d2 import make_r2d2_update_step, r2d2_horizon
from rltime_tpu_torch.utils.graphs import GraphedStep

# The bench shapes of the JAX version (config #2 scaled to one chip)
E, T, L, F, N_STEP = 64, 1024, 32, 4, 3
BATCH = 1024    # batch 1024 x K=1 with batched_next_forward: the JAX
                # version's best shape at the recipe's sample ratio
S = 64          # chunks (supersteps) per dispatch
K = 1           # learner updates per chunk


def build(warm_chunks: int = 8, seed: int = 0, batch: int = BATCH,
          k: int = K, channels_last: bool = False,
          space_to_depth: bool = False, unroll: int = 1,
          pipelined: bool = False, supersteps: int = S,
          algo: str = "dqn", num_envs: int = E, chunk_len: int = L,
          device: str = "cuda", **algo_overrides):
    """Construct the bench program on `device`. Returns a namespace with
    superstep, eager_superstep, tstate, rstate, stacked(base) -> device
    chunks, chunk, graph (None on the CPU) and the shape constants.

    The arguments are the JAX version's: the same configs, the same
    fields, the same seeded numpy draws in the same order, so the
    inserted bytes are equal bit for bit. On the card `superstep(tstate,
    rstate, beta, chunks)` takes the namespace's own states and is one
    graph replay after two eager warm-up calls (the third call
    captures); it updates both states in place, adds what it ran to
    their host counts (`updates`, `t`) and returns the last update's
    metrics (the graph's tensors, overwritten by the next replay).

    `pipelined` (DQN and IQN; R2D2 raises, as in the JAX version): each
    update trains on the batch sampled during the previous one
    (`learner.make_pipelined_insert_and_update_step`: priorities one
    update stale), re-primed once per dispatch, so a dispatch samples
    and gathers S x K + 1 times; on the card the next batch's sample and
    gathers run on a side stream inside the same graph. `unroll` (>= 1)
    is the JAX version's chunk-scan unroll, an XLA schedule of the same
    values: the graph already holds all S chunks as straight-line work,
    so it changes nothing here."""
    if unroll < 1:
        raise ValueError(f"unroll must be >= 1, got {unroll}")
    if pipelined and algo == "r2d2":
        raise ValueError("pipelined is a feed-forward learner experiment "
                         "(DQN, IQN); the R2D2 update does not split")
    dev = resolve_device(device)
    E_, L_ = num_envs, chunk_len
    head = "dueling"
    lstm = 0
    if algo == "iqn":
        head = "iqn"
        algo_overrides.setdefault("num_tau", 64)
        algo_overrides.setdefault("num_tau_prime", 64)
    elif algo == "r2d2":
        lstm = 512
        algo_overrides.setdefault("burn_in", 40)
        algo_overrides.setdefault("seq_len", 80)
        algo_overrides.setdefault("eta", 0.9)
    mcfg = ModelConfig(num_actions=6, torso="nature_cnn", head=head,
                       lstm_size=lstm, compute_dtype="bfloat16",
                       channels_last=channels_last,
                       space_to_depth=space_to_depth)
    if algo == "dqn":
        algo_overrides.setdefault("batched_next_forward", True)
    acfg = AlgoConfig(algo=algo, batch_size=batch, n_step=N_STEP,
                      double_q=True, lr=1e-4, target_update_freq=500,
                      **algo_overrides)
    horizon = r2d2_horizon(acfg) if algo == "r2d2" else N_STEP
    rcfg = ReplayConfig(num_envs=E_, steps_per_env=T, horizon=horizon,
                        chunk_len=L_, lookback=F - 1, prioritized=True)
    fields = {"obs": ((84, 84), torch.uint8),
              "action": ((), torch.int32),
              "reward": ((), torch.float32),
              "terminated": ((), torch.bool),
              "done": ((), torch.bool)}
    if algo == "r2d2":
        fields["rnn_c"] = ((512,), torch.float32)
        fields["rnn_h"] = ((512,), torch.float32)
    rstate = replay_init(rcfg, fields, dev)
    rng = np.random.default_rng(seed)

    def chunk(i):
        del i  # draws advance `rng`; arg kept for call-site clarity
        out = dict(
            obs=rng.integers(0, 255, size=(E_, L_, 84, 84),
                             dtype=np.uint8),
            action=rng.integers(0, 6, size=(E_, L_)).astype(np.int32),
            reward=rng.normal(size=(E_, L_)).astype(np.float32),
            terminated=(rng.random((E_, L_)) < 0.02),
            done=(rng.random((E_, L_)) < 0.02))
        if algo == "r2d2":
            out["rnn_c"] = rng.normal(
                size=(E_, L_, 512)).astype(np.float32)
            out["rnn_h"] = rng.normal(
                size=(E_, L_, 512)).astype(np.float32)
        return out

    for w in range(warm_chunks):
        rstate = replay_insert(rcfg, rstate, chunk(w))
    rstate.cursor = torch.tensor(rstate.t, dtype=torch.int64, device=dev)

    in_shape = (84, 84, F) if channels_last else (F, 84, 84)
    # the JAX version's jax.random.key(0), whatever `seed`; Adam
    # capturable where the graph holds it
    tstate = make_train_state(mcfg, acfg, in_shape, 0, dev,
                              capturable=dev.type == "cuda")
    use_device_counter(tstate, acfg)
    if algo == "r2d2":
        update = make_r2d2_update_step(mcfg, acfg, rcfg, F, False)
    else:
        update = make_update_step(acfg, rcfg, F, False,
                                  channels_last=channels_last)
    def insert(rs, ck):
        return replay_insert_device(rcfg, rs, ck)

    if pipelined:
        prime, insert_update_p = make_pipelined_insert_and_update_step(
            rcfg, update, k, insert=insert)
    else:
        insert_update = make_insert_and_update_step(rcfg, update, k,
                                                    insert=insert)

    def body(tstate, rstate, beta, chunks, draws=None):
        """S x (device-cursor insert of chunk s + K updates), in place
        (the next replay reads the tree and max_priority from the
        tensors this one started from). `draws[s]` (tests) injects chunk
        s's K updates' draws; pipelined, `draws` is (the prime's `u`,
        that list)."""
        metrics = {}
        with replay_in_place(rstate):
            if pipelined:
                u, draws = draws if draws else (None, None)
                tstate, pending = prime(tstate, rstate, beta, u)
            for s in range(supersteps):
                ck = {name: x[s] for name, x in chunks.items()}
                d = draws[s] if draws else None
                if pipelined:
                    tstate, rstate, pending, metrics = insert_update_p(
                        tstate, rstate, pending, ck, beta, d)
                else:
                    tstate, rstate, metrics = insert_update(
                        tstate, rstate, ck, beta, d)
        return metrics

    def _count(tstate, rstate):
        tstate.updates += supersteps * k
        rstate.t += supersteps * L_

    def _beta(beta):
        if isinstance(beta, torch.Tensor):
            return beta.to(device=dev, dtype=torch.float32)
        return torch.full((), float(beta), dtype=torch.float32, device=dev)

    def eager_superstep(tstate, rstate, beta, chunks, draws=None):
        """The superstep's body run op by op (any states of this
        program's shapes)."""
        metrics = body(tstate, rstate, _beta(beta), chunks, draws)
        _count(tstate, rstate)
        return tstate, rstate, metrics

    names = list(fields)
    graph = None
    superstep = eager_superstep
    if dev.type == "cuda":
        static = [torch.empty((), dtype=torch.float32, device=dev)] + [
            torch.empty((supersteps, E_, L_) + tuple(shape), dtype=dtype,
                        device=dev) for shape, dtype in fields.values()]
        graph = GraphedStep(
            lambda beta, *bufs: body(tstate, rstate, beta,
                                     dict(zip(names, bufs))),
            static, generators=[tstate.generator])

        def superstep(ts, rs, beta, chunks):
            if ts is not tstate or rs is not rstate:
                raise ValueError("the graph holds this program's own "
                                 "tstate and rstate; pass those")
            metrics = graph(_beta(beta), *[chunks[n] for n in names])
            _count(ts, rs)
            return ts, rs, metrics

    def stacked(base):
        out = [chunk(base + i) for i in range(supersteps)]
        return {name: torch.from_numpy(np.stack([c[name] for c in out]))
                .to(dev) for name in out[0]}

    return types.SimpleNamespace(
        superstep=superstep, eager_superstep=eager_superstep, graph=graph,
        tstate=tstate, rstate=rstate, stacked=stacked, chunk=chunk,
        E=E_, T=T, L=L_, F=F, n_step=N_STEP, batch=batch, S=supersteps,
        K=k, device=dev,
        # transitions CONSUMED per update (R2D2 consumes whole training
        # windows per sampled sequence)
        tx_per_update=batch * (acfg.seq_len if algo == "r2d2" else 1),
        rcfg=rcfg, mcfg=mcfg, acfg=acfg)


def clone_states(tstate: TrainState, rstate: ReplayState):
    """Independent copies of a program's states (model, target,
    optimizer and its moments, generator state, counters; rings, tree,
    cursor), to run the eager body beside the graph from the same
    state."""
    model, target, optimizer = copy.deepcopy(
        (tstate.model, tstate.target, tstate.optimizer))
    gen = torch.Generator(device=tstate.generator.device)
    gen.set_state(tstate.generator.get_state())
    ts = TrainState(model=model, target=target, optimizer=optimizer,
                    generator=gen, updates=tstate.updates,
                    counter=None if tstate.counter is None
                    else tstate.counter.clone())
    rs = ReplayState(
        storage={n: x.clone() for n, x in rstate.storage.items()},
        t=rstate.t, tree=rstate.tree.clone(),
        max_priority=rstate.max_priority.clone(),
        cursor=None if rstate.cursor is None else rstate.cursor.clone())
    return ts, rs
