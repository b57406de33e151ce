"""The port's CUDA kernels against their plain versions, on a GPU.

Every test here is marked `cuda` and skips itself where no card is
present. This file imports neither jax nor rltime_tpu, so it also runs
on a GPU machine without them:

    python -m pytest tests/test_torch_cuda.py -m cuda --noconftest -q
"""
import pytest
import torch

from rltime_tpu_torch.ops import gather


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run on the GPU machine)")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("row_shape,dtype", [((84, 84), torch.uint8),
                                             ((12, 16), torch.float32),
                                             ((5, 7), torch.uint8)])
def test_union_gather_kernel_matches_plain(cuda_device, row_shape, dtype):
    """Bit-exact, incl. negative col0 and windows across the ring seam;
    the (5, 7) uint8 row (35 B) is copied by bytes."""
    g = torch.Generator().manual_seed(0)
    E, T, B, W = 8, 128, 64, 7
    storage = torch.randint(0, 256, (E, T) + row_shape, generator=g)
    storage = storage.to(dtype).to(cuda_device)
    env = torch.randint(0, E, (B,), generator=g, dtype=torch.int32)
    col0 = torch.randint(-3, T, (B,), generator=g, dtype=torch.int32)
    col0[:2] = torch.tensor([-3, T - 2], dtype=torch.int32)
    env, col0 = env.to(cuda_device), col0.to(cuda_device)
    before = gather.LAUNCHES["union_gather"]
    out = gather.union_gather(storage, env, col0, W)
    torch.cuda.synchronize()
    assert gather.LAUNCHES["union_gather"] == before + 1
    assert torch.equal(out, gather.window_gather_reference(storage, env,
                                                           col0, W))


@pytest.mark.cuda
@pytest.mark.parametrize("row_shape,dtype,window", [
    ((84, 84), torch.uint8, 128),     # the R2D2 frame sequence
    ((), torch.float32, 125),         # 4-byte strips
    ((), torch.bool, 125),            # 1-byte strips
    ((512,), torch.float32, 1),       # the stored LSTM carry
    ((5, 7), torch.uint8, 33),        # odd row width: byte path
    ((10, 10, 4), torch.uint8, 65),   # MinAtar planes: 400-byte rows
    ((10, 10, 4), torch.uint8, 1),
    ((), torch.bool, 66),             # the fused R2D2 done window
])
def test_window_gather_kernel_matches_plain(cuda_device, row_shape, dtype,
                                            window):
    """Bit-exact, incl. negative col and windows across the ring seam."""
    g = torch.Generator().manual_seed(1)
    E, T, B = 4, 256, 64
    storage = torch.randint(0, 256, (E, T) + row_shape, generator=g)
    storage = storage.to(dtype).to(cuda_device)
    env = torch.randint(0, E, (B,), generator=g, dtype=torch.int32)
    col = torch.randint(-8, T, (B,), generator=g, dtype=torch.int32)
    col[:3] = torch.tensor([-3, T - 2, T - window // 2], dtype=torch.int32)
    env, col = env.to(cuda_device), col.to(cuda_device)
    before = dict(gather.LAUNCHES)
    out = gather.window_gather(storage, env, col, window)
    torch.cuda.synchronize()
    assert gather.LAUNCHES["window_gather"] == before["window_gather"] + 1
    assert gather.LAUNCHES["union_gather"] == before["union_gather"]
    assert torch.equal(out, gather.window_gather_reference(storage, env,
                                                           col, window))


def _rand(shape, dtype, g):
    r = torch.randint(0, 256, shape, generator=g)
    return (r & 1).bool() if dtype == torch.bool else r.to(dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("row_shape,dtype,F,n", [
    ((84, 84), torch.uint8, 4, 3),     # config #2
    ((12, 16), torch.float32, 4, 3),
    ((5, 7), torch.uint8, 4, 3),       # 35-byte rows: copied by bytes
    ((84, 84), torch.uint8, 3, 5),     # n > F: stacks do not overlap
    ((84, 84), torch.uint8, 16, 16),   # 32 union rows
    ((160, 160), torch.uint8, 4, 6),   # 25,600-byte rows: several rounds
    ((84, 84), torch.uint8, 30, 5),    # 35 union rows: two ballots
    ((84, 84), torch.uint8, 4, 29),
    ((5, 7), torch.uint8, 2, 63),      # 65 union rows: three ballots
])
def test_union_stack_gather_kernel_matches_plain(cuda_device, row_shape,
                                                 dtype, F, n):
    """Bit-exact (for floats: torch.equal, which equates the kernel's
    +0.0 with the plain version's x * 0), incl. col < F-1, windows
    across the seam and done flags at every slot."""
    g = torch.Generator().manual_seed(2)
    E, T, B = 4, 128, 96
    storage = _rand((E, T) + row_shape, dtype, g).to(cuda_device)
    done = (torch.rand((E, T), generator=g) < 0.25).to(cuda_device)
    env = torch.randint(0, E, (B,), generator=g, dtype=torch.int32)
    col = torch.randint(0, T, (B,), generator=g, dtype=torch.int32)
    col[:5] = torch.tensor([0, 1, F - 2, T - 1, T - n], dtype=torch.int32)
    env, col = env.to(cuda_device), col.to(cuda_device)
    ref_t, ref_tn = gather.union_stack_gather_reference(storage, done, env,
                                                        col, F, n)
    assert (ref_t.flatten(2) == 0).all(2).any()       # some rows were cut
    before = dict(gather.LAUNCHES)
    out_t, out_tn = gather.union_stack_gather(storage, done, env, col, F, n)
    torch.cuda.synchronize()
    assert gather.LAUNCHES == {
        "union_gather": before["union_gather"] + 1,
        "window_gather": before["window_gather"]}
    assert out_t.dtype == ref_t.dtype and out_t.shape == ref_t.shape
    assert torch.equal(out_t, ref_t) and torch.equal(out_tn, ref_tn)


@pytest.mark.cuda
@pytest.mark.parametrize("num_segments,launches", [(1, 1), (7, 1), (8, 1),
                                                   (9, 2), (17, 3)])
def test_window_gather_multi_kernel_matches_plain(cuda_device, num_segments,
                                                  launches):
    """Every segment bit-exact: mixed leads, windows, dtypes, row widths
    and ring lengths; more than 8 segments make several launches."""
    g = torch.Generator().manual_seed(3)
    E, B = 4, 64
    kinds = [((84, 84), torch.uint8, 256, 3, 128), ((), torch.bool, 256, 3, 128),
             ((), torch.int32, 256, 0, 125), ((), torch.float32, 256, 0, 125),
             ((), torch.bool, 256, 0, 125), ((512,), torch.float32, 256, 0, 1),
             ((512,), torch.float32, 128, 0, 1), ((5, 7), torch.uint8, 64, -2, 33),
             ((10, 10, 4), torch.uint8, 512, 1, 65)]
    specs = [kinds[i % len(kinds)] for i in range(num_segments)]
    fields = [_rand((E, T) + row, dtype, g).to(cuda_device)
              for row, dtype, T, _, _ in specs]
    leads = [lead for *_, lead, _ in specs]
    windows = [window for *_, window in specs]
    env = torch.randint(0, E, (B,), generator=g, dtype=torch.int32)
    col = torch.randint(-8, 512, (B,), generator=g, dtype=torch.int32)
    col[:4] = torch.tensor([-3, 0, 63, 255], dtype=torch.int32)
    env, col = env.to(cuda_device), col.to(cuda_device)
    before = dict(gather.LAUNCHES)
    outs = gather.window_gather_multi(fields, env, col, leads, windows)
    torch.cuda.synchronize()
    assert gather.LAUNCHES == {
        "union_gather": before["union_gather"],
        "window_gather": before["window_gather"] + launches}
    for out, field, lead, window in zip(outs, fields, leads, windows):
        assert torch.equal(out, gather.window_gather_reference(
            field, env, col - lead, window))


@pytest.mark.cuda
def test_frame_stack_union_gather_is_one_launch(cuda_device):
    """On the card the replay's frame-stack gather is one kernel launch
    and no other device work."""
    from torch.profiler import ProfilerActivity, profile
    from rltime_tpu_torch.history import replay
    g = torch.Generator().manual_seed(4)
    E, T, B, F, n = 4, 128, 32, 4, 3
    cfg = replay.ReplayConfig(num_envs=E, steps_per_env=T, horizon=n,
                              chunk_len=8, lookback=F - 1)
    state = replay.ReplayState(
        storage={"obs": _rand((E, T, 84, 84), torch.uint8, g).to(cuda_device),
                 "done": (torch.rand((E, T), generator=g) < 0.2).to(
                     cuda_device)},
        t=0, tree=torch.zeros(1), max_priority=torch.ones(()))
    env = torch.randint(0, E, (B,), generator=g,
                        dtype=torch.int32).to(cuda_device)
    col = torch.randint(0, T, (B,), generator=g,
                        dtype=torch.int32).to(cuda_device)
    replay.frame_stack_union_gather(cfg, state, env, col, F, n)   # builds
    torch.cuda.synchronize()
    before = dict(gather.LAUNCHES)
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        obs_t, obs_tn = replay.frame_stack_union_gather(cfg, state, env, col,
                                                        F, n)
        torch.cuda.synchronize()
    assert gather.LAUNCHES == {"union_gather": before["union_gather"] + 1,
                               "window_gather": before["window_gather"]}
    names = [e.name for e in prof.events()
             if e.device_type == torch.autograd.DeviceType.CUDA]
    assert len(names) == 1 and "union_gather_kernel" in names[0], names
    ref_t, ref_tn = gather.union_stack_gather_reference(
        state.storage["obs"], state.storage["done"], env, col, F, n)
    assert torch.equal(obs_t, ref_t) and torch.equal(obs_tn, ref_tn)


@pytest.mark.cuda
def test_union_gather_rejects_mixed_devices(cuda_device):
    storage = torch.zeros((2, 8, 16), dtype=torch.uint8, device=cuda_device)
    idx = torch.zeros((4,), dtype=torch.int32)
    with pytest.raises(ValueError):
        gather.union_gather(storage, idx, idx, 3)


@pytest.mark.cuda
def test_window_gather_rejects_mixed_devices(cuda_device):
    storage = torch.zeros((2, 8), dtype=torch.bool, device=cuda_device)
    idx = torch.zeros((4,), dtype=torch.int32)
    with pytest.raises(ValueError):
        gather.window_gather(storage, idx, idx, 3)


@pytest.mark.cuda
@pytest.mark.parametrize("algo", ["dqn", "iqn", "r2d2"])
def test_captured_superstep_equals_eager_body(cuda_device, algo, monkeypatch,
                                              tmp_path):
    """`utils/benchprog.py` at a small size: one CUDA-graph replay of
    S=2 x (insert + K=2 updates) against the same body run op by op from
    a clone of the same state: rings, tree, cursor, counter, metrics and
    parameters equal (cuDNN deterministic), and the graph holds one K2
    (dqn, iqn) and one K1 kernel node per update."""
    from rltime_tpu_torch.utils import benchprog
    monkeypatch.setattr(benchprog, "T", 64)
    monkeypatch.setattr(torch.backends.cudnn, "deterministic", True)
    kw = dict(warm_chunks=4, batch=8, k=2, supersteps=2, num_envs=4,
              chunk_len=8, algo=algo, debug_outputs=True)
    if algo == "r2d2":
        kw.update(batch=4, burn_in=4, seq_len=8)
    p = benchprog.build(device="cuda", **kw)
    p.graph.debug = True                      # keep the graph to count
    beta = torch.full((), 0.5, device=cuda_device)
    for i in range(p.graph.WARMUP + 1):       # eager warm-ups, then capture
        p.superstep(p.tstate, p.rstate, beta, p.stacked(10 + 2 * i))
    assert p.graph.graph is not None
    chunks = p.stacked(100)
    ts, rs = benchprog.clone_states(p.tstate, p.rstate)
    gather.reset_counts()
    _, _, graph_m = p.superstep(p.tstate, p.rstate, beta, chunks)
    assert gather.LAUNCHES == {"union_gather": 0, "window_gather": 0}
    _, _, eager_m = p.eager_superstep(ts, rs, beta, chunks)
    torch.cuda.synchronize()
    assert p.rstate.t == rs.t and p.tstate.updates == ts.updates
    for a, b in ((p.rstate.tree, rs.tree), (p.rstate.cursor, rs.cursor),
                 (p.rstate.max_priority, rs.max_priority),
                 (p.tstate.counter, ts.counter)):
        assert torch.equal(a, b)
    for name, ring in p.rstate.storage.items():
        assert torch.equal(ring, rs.storage[name]), name
    for k, v in graph_m.items():
        assert torch.equal(v, eager_m[k]), k
    for net, other in ((p.tstate.model, ts.model),
                       (p.tstate.target, ts.target)):
        for (name, a), b in zip(net.state_dict().items(),
                                other.state_dict().values()):
            assert torch.equal(a, b), name
    counts = p.graph.kernel_counts(("union_gather_kernel",
                                    "window_gather_kernel"),
                                   str(tmp_path / "graph.dot"))
    updates = p.S * p.K
    assert counts == {"union_gather_kernel": 0 if algo == "r2d2" else updates,
                      "window_gather_kernel": updates}


@pytest.mark.cuda
@pytest.mark.parametrize("algo", ["dqn", "iqn"])
def test_captured_pipelined_superstep_equals_eager_body(cuda_device, algo,
                                                        monkeypatch,
                                                        tmp_path):
    """`utils/benchprog.py` pipelined at a small size: one replay of
    prime + S=2 x (insert + K=2 updates) against the same body op by op
    from a clone of the same state, every carried tensor and the metrics
    equal (cuDNN deterministic); the graph holds S x K + 1 nodes of each
    gather, and each of them but the prime's sits on a branch beside
    other work: the side stream the next batch is gathered on."""
    from rltime_tpu_torch.utils import benchprog
    monkeypatch.setattr(benchprog, "T", 64)
    monkeypatch.setattr(torch.backends.cudnn, "deterministic", True)
    p = benchprog.build(device="cuda", warm_chunks=4, batch=8, k=2,
                        supersteps=2, num_envs=4, chunk_len=8, algo=algo,
                        pipelined=True, debug_outputs=True)
    p.graph.debug = True                      # keep the graph to read
    beta = torch.full((), 0.5, device=cuda_device)
    for i in range(p.graph.WARMUP + 1):       # eager warm-ups, then capture
        p.superstep(p.tstate, p.rstate, beta, p.stacked(10 + 2 * i))
    assert p.graph.graph is not None
    chunks = p.stacked(100)
    ts, rs = benchprog.clone_states(p.tstate, p.rstate)
    _, _, graph_m = p.superstep(p.tstate, p.rstate, beta, chunks)
    graph_m = {k: v.clone() for k, v in graph_m.items()}
    _, _, eager_m = p.eager_superstep(ts, rs, beta, chunks)
    torch.cuda.synchronize()
    for a, b in ((p.rstate.tree, rs.tree), (p.rstate.cursor, rs.cursor),
                 (p.rstate.max_priority, rs.max_priority),
                 (p.tstate.counter, ts.counter)):
        assert torch.equal(a, b)
    for name, ring in p.rstate.storage.items():
        assert torch.equal(ring, rs.storage[name]), name
    for k, v in graph_m.items():
        assert torch.equal(v, eager_m[k]), k
    for net, other in ((p.tstate.model, ts.model),
                       (p.tstate.target, ts.target)):
        for (name, a), b in zip(net.state_dict().items(),
                                other.state_dict().values()):
            assert torch.equal(a, b), name
    from rltime_tpu_torch.utils.graphs import concurrent_nodes
    names = ("union_gather_kernel", "window_gather_kernel")
    updates = p.S * p.K
    dot = tmp_path / "graph.dot"
    assert p.graph.kernel_counts(names, str(dot)) == {
        name: updates + 1 for name in names}
    assert concurrent_nodes(dot.read_text(), names) == {
        name: updates for name in names}


@pytest.mark.cuda
@pytest.mark.parametrize("shapes", [
    [(16, 4, 3, 3), (16,), (128, 1024), (128,), (256, 128), (256,), (1, 256),
     (1,), (256, 128), (256,), (3, 256), (3,)],                 # MinAtar net
    [(32, 4, 8, 8), (32,), (64, 32, 4, 4), (64,), (64, 64, 3, 3), (64,),
     (512, 3136), (512,), (256, 512), (256,), (1, 256), (1,), (256, 512),
     (256,), (6, 256), (6,)]])                                  # Nature CNN
def test_global_norm_ignores_the_gradients_layout(cuda_device, shapes):
    """The grad norm over a mesh's gradients (views of one flat buffer,
    most of them unaligned) equals the norm over the same values as
    separate tensors, contiguous or with the weights transposed, bit for
    bit, over 200 draws (a foreach norm of the gradients themselves
    parts them)."""
    from rltime_tpu_torch.training.learner import _global_norm
    g = torch.Generator(device=cuda_device).manual_seed(0)
    for _ in range(200):
        grads = [0.01 * torch.randn(s, generator=g, device=cuda_device)
                 for s in shapes]
        transposed = [x.t().contiguous().t() if x.dim() == 2 else x
                      for x in grads]
        flat = torch.cat([x.reshape(-1) for x in grads])
        views = [part.view_as(x) for part, x in zip(
            flat.split([x.numel() for x in grads]), grads)]
        norm = _global_norm(grads)
        assert torch.equal(norm, _global_norm(views))
        assert torch.equal(norm, _global_norm(transposed))


def _small_fused_config(case):
    """A MinAtar Breakout fused trainer at a small size: 8 lanes of
    8-step chunks, batch 8, 2 updates a chunk (8, one a step,
    interleaved), actor-side priorities for IQN and interleaved."""
    cfg = {
        "seed": 3,
        "env": {"type": "minatar_breakout", "num_envs": 8, "time_limit": 12},
        "model": {"torso": "minatar_cnn", "cnn_channels": [6], "cnn_fc": 16,
                  "head": "dueling", "dueling_hidden": 8},
        "replay": {"steps_per_env": 64,
                   "use_inserted_priorities": case in ("iqn",
                                                       "interleaved")},
        "algo": {"algo": "dqn", "batch_size": 8, "n_step": 3, "lr": 1e-3,
                 "target_update_freq": 3},
        "train": {"total_env_steps": 10**6, "warmup_env_steps": 128,
                  "chunk_len": 8, "updates_per_chunk": 2,
                  "log_interval": 10**9, "trainer": "fused"},
    }
    if case == "iqn":
        cfg["model"].update(head="iqn", iqn_embed_dim=8, num_tau_policy=6)
        cfg["algo"].update(algo="iqn", num_tau=7, num_tau_prime=5)
    elif case == "r2d2":
        cfg["model"]["lstm_size"] = 8
        cfg["algo"].update(algo="r2d2", n_step=2, burn_in=2, seq_len=4)
    elif case == "interleaved":
        cfg["train"].update(interleave_updates=True, updates_per_chunk=8)
    return cfg


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["dqn", "iqn", "r2d2", "interleaved"])
def test_captured_fused_superstep_equals_eager_body(cuda_device, case,
                                                    monkeypatch, tmp_path):
    """The fused trainer on the card: its third trained superstep
    captures the graph; one more, a replay, equals the eager body run
    from clones of the same states on the same epsilons and beta, every
    tensor and generator state (cuDNN deterministic); the replay runs no
    Python wrapper, and the graph holds one window_gather node per
    update and no union_gather."""
    from rltime_tpu_torch.parallel.fused import FusedApexTrainer, state_diffs
    from rltime_tpu_torch.utils import benchprog
    from rltime_tpu_torch.utils.graphs import GraphedStep
    monkeypatch.setattr(torch.backends.cudnn, "deterministic", True)
    monkeypatch.setattr(GraphedStep, "debug", True)
    t = FusedApexTrainer(_small_fused_config(case), str(tmp_path / "run"),
                         device=cuda_device)
    while t.graph.graph is None:
        t.superstep()
    L = t.loop_cfg.chunk_len
    eps, beta = t._eps(L), t._betas(1)[0]
    ts, rs = benchprog.clone_states(t.train_state, t.replay_state)
    clone = (ts, t.actor_state.clone(), rs)
    gather.reset_counts()
    m = t.superstep()
    assert gather.LAUNCHES == {"union_gather": 0, "window_gather": 0}
    eager_m = t.eager_superstep(*clone, eps, beta)
    torch.cuda.synchronize()
    diffs = state_diffs((t.train_state, t.actor_state, t.replay_state),
                        clone)
    assert not {k: v for k, v in diffs.items() if v}
    for k, v in m.items():
        assert torch.equal(v, eager_m[k]), k
    counts = t.graph.kernel_counts(("union_gather_kernel",
                                    "window_gather_kernel"),
                                   str(tmp_path / "graph.dot"))
    assert counts == {"union_gather_kernel": 0,
                      "window_gather_kernel": t.loop_cfg.updates_per_chunk}


def _small_host_config(case):
    """Small host-trainer configs (no jax in this file): config #2's
    shape on counting-env frames (PER, frame stack 4); the same on
    uniform replay with a linear lr decay; a recurrent R2D2; a one-rank
    Ape-X."""
    cfg = {
        "seed": 0,
        "env": {"type": "counting_env", "num_envs": 2, "episode_len": 11,
                "image_obs": True},
        "frame_stack": 4,
        "model": {"torso": "nature_cnn", "cnn_channels": [4, 4, 4],
                  "cnn_fc": 16, "head": "dueling", "dueling_hidden": 8},
        "replay": {"steps_per_env": 128, "prioritized": True},
        "algo": {"algo": "dqn", "batch_size": 4, "n_step": 3, "lr": 1e-3,
                 "target_update_freq": 3},
        "exploration": {"type": "epsilon_greedy", "eps_start": 1.0,
                        "eps_end": 0.1, "anneal_steps": 200},
        "train": {"total_env_steps": 10**6, "warmup_env_steps": 48,
                  "chunk_len": 8, "updates_per_chunk": 2,
                  "log_interval": 10**9, "checkpoint_interval": 10**9},
    }
    if case == "uniform":
        cfg["replay"]["prioritized"] = False
        cfg["algo"].update(lr_end=1e-4, lr_decay_updates=7)
    elif case == "r2d2":
        cfg.update(frame_stack=2, env={"type": "counting_env",
                                       "num_envs": 2, "episode_len": 7})
        cfg["model"] = {"torso": "mlp", "mlp_hidden": [12],
                        "head": "dueling", "dueling_hidden": 8,
                        "lstm_size": 8}
        cfg["algo"].update(algo="r2d2", n_step=2, burn_in=4, seq_len=8)
        cfg["train"]["warmup_env_steps"] = 64
    elif case == "apex":
        cfg.update(frame_stack=1, env={"type": "counting_env",
                                       "num_envs": 4, "episode_len": 7})
        cfg["model"] = {"torso": "mlp", "mlp_hidden": [16],
                        "head": "linear"}
        cfg["exploration"] = {"type": "epsilon_greedy", "mode": "ladder"}
        cfg["train"].update(trainer="apex", warmup_env_steps=64,
                            track_best=False)
    return cfg


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["dqn", "uniform", "r2d2", "apex"])
def test_captured_host_step_equals_eager_body(cuda_device, case,
                                              monkeypatch, tmp_path):
    """The host trainers on the card: the third trained chunk captures
    {insert + K updates}; three more chunks, each a replay, equal the
    eager body run from clones of the states taken before them on the
    same chunks and betas, every tensor and generator state and each
    chunk's metrics (cuDNN deterministic); a replay runs no Python
    wrapper, and the graph holds K window_gather nodes and, where the FF
    update stacks frames, K union_gather nodes."""
    from rltime_tpu_torch.parallel.apex import ApexTrainer
    from rltime_tpu_torch.parallel.fused import state_diffs
    from rltime_tpu_torch.training.trainer import Trainer
    from rltime_tpu_torch.utils import benchprog
    from rltime_tpu_torch.utils.graphs import GraphedStep
    monkeypatch.setattr(torch.backends.cudnn, "deterministic", True)
    monkeypatch.setattr(GraphedStep, "debug", True)
    cls = ApexTrainer if case == "apex" else Trainer
    t = cls(_small_host_config(case), str(tmp_path / "run"),
            device=cuda_device)
    while t.graph is not None and t.graph.graph is None:
        t.train_chunk()
    assert t.graph is not None
    ts, rs = benchprog.clone_states(t.train_state, t.replay_state)
    for _ in range(3):
        chunk, _ = t.actor.rollout(getattr(t, "actor_model",
                                           t.train_state.model))
        beta = t._beta().to(cuda_device)
        gather.reset_counts()
        m = t.learn(chunk)
        assert gather.LAUNCHES == {"union_gather": 0, "window_gather": 0}
        eager_m = t.eager_step(ts, rs, chunk, beta)
        torch.cuda.synchronize()
        for k, v in m.items():
            assert torch.equal(v, eager_m[k]), k
    diffs = state_diffs((t.train_state, None, t.replay_state),
                        (ts, None, rs))
    assert not {k: v for k, v in diffs.items() if v}
    assert t.replay_state.cursor.item() == t.replay_state.t
    assert t.train_state.counter.item() == t.train_state.updates
    K = t.loop_cfg.updates_per_chunk
    stacks = t.algo_cfg.algo != "r2d2" and t.frame_stack > 1
    counts = t.graph.kernel_counts(("union_gather_kernel",
                                    "window_gather_kernel"),
                                   str(tmp_path / "graph.dot"))
    assert counts == {"union_gather_kernel": K if stacks else 0,
                      "window_gather_kernel": K}


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["dqn", "priorities", "r2d2", "device"])
def test_captured_act_step_equals_eager_body(cuda_device, case,
                                             monkeypatch, tmp_path):
    """The actors' graphs on the card: a host actor's act step (config
    #2's shape; with actor-side priorities, the late route; R2D2's LSTM
    carry) and `cartpole_dqn_device`'s rollout under the host Trainer.
    Three chunks of replays equal the eager body run beside them from
    clones of the state and generators taken before them (cuDNN
    deterministic): every step's outputs, the carried tensors and the
    generator states; a device chunk's fields too."""
    from rltime_tpu_torch.acting.actor import ActGraphShadow
    from rltime_tpu_torch.config.config import apply_overrides, load_config
    from rltime_tpu_torch.training.trainer import Trainer
    monkeypatch.setattr(torch.backends.cudnn, "deterministic", True)
    if case == "device":
        cfg = apply_overrides(load_config("cartpole_dqn_device"), [
            "env.num_envs=64", "train.chunk_len=16"])
    else:
        cfg = _small_host_config("r2d2" if case == "r2d2" else "dqn")
        cfg["replay"]["use_inserted_priorities"] = case == "priorities"
    t = Trainer(cfg, str(tmp_path / "run"), device=cuda_device)
    actor, model = t.actor, t.train_state.model
    while actor.graph.graph is None:
        actor.rollout(model)
    if case == "device":
        shadow = actor.state.clone()
        for _ in range(3):
            chunk, _ = actor.rollout(model)
            want = actor.eager_rollout(shadow, actor._eps)
            for k, v in want.items():
                assert torch.equal(chunk[k], v), k
        assert not {k: v for k, v in actor.state.diffs(shadow).items()
                    if v}
        return
    shadow = ActGraphShadow(actor)
    for _ in range(3):
        chunk, _ = actor.rollout(model)
    shadow.detach()
    assert shadow.steps == 3 * t.loop_cfg.chunk_len
    assert shadow.max_diff == 0.0
    assert not {k: v for k, v in shadow.state_diffs().items() if v}
