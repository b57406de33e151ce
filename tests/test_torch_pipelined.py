"""Port parity: the pipelined learner step (one-update-stale PER
sampling) and the last learner options, against the JAX package.

`training/learner.py:make_pipelined_insert_and_update_step` trains each
update on the batch sampled during the previous one, which crosses each
chunk's insert. Held against `rltime_tpu/training/learner.py:431-490` on
JAX's own key schedule (`torch_port_draws.pipelined_draws`), every
update's sampled leaves recorded on both sides (JAX's through a
`jax.debug.callback` in its `apply_phase`):

  * the bench program (`utils/benchprog.py:build(pipelined=True)`) at
    `test_torch_benchprog.py`'s shapes, one superstep from the JAX
    params: the integer plane bit-equal (every update's leaves, the
    rings, `tree > 0`, the cursor and the count); the float plane, bf16
    as there, to that file's tolerances (rtol 1e-2 on loss, td_abs,
    grad_norm and mean_weight, atol 2e-3 on q, rtol/atol 1e-2 on the
    tree);
  * the step itself at float32, DQN and IQN, K=2 over two chunks, where
    the second insert kills most of the pending batch's leaves: leaves,
    `tree > 0` and the next pending batch bit-equal, loss, |TD|, grad
    norm, mean Q, priorities to rtol 1e-5 (the metrics and |TD| also to
    atol 1e-6) and params to atol 1e-5 after four Adam steps;
  * `make_multi_update_step` (K updates, no insert) at float32 to the
    same tolerances.

Also: the update is `sample_phase` then `apply_phase`, bit for bit;
`unroll` and `algo.gather_barrier` change nothing; R2D2 refuses the
pipelined step, as the JAX bench asserts.
"""
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_port_draws as draws_lib
from rltime_tpu.history import replay as jreplay
from rltime_tpu.models.policy import ModelConfig as JModelConfig
from rltime_tpu.models.policy import init_params
from rltime_tpu.training import learner as jlearner
from rltime_tpu.utils import benchprog as jbenchprog
from rltime_tpu_torch.history import replay as treplay
from rltime_tpu_torch.models import bridge
from rltime_tpu_torch.models.policy import ModelConfig
from rltime_tpu_torch.training import learner as tlearner
from rltime_tpu_torch.training import r2d2 as tr2d2
from rltime_tpu_torch.utils import benchprog as tbenchprog
from rltime_tpu_torch.utils import graphs
from torch_port_draws import one_intra_op_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_intra_op_thread")

SMALL = dict(warm_chunks=4, batch=8, k=2, supersteps=2, num_envs=4,
             chunk_len=8, debug_outputs=True)
CPU = torch.device("cpu")
F, N_STEP, B = 4, 3, 8
CNN = dict(num_actions=5, torso="nature_cnn", cnn_channels=(4, 4, 4),
           cnn_fc=16)
MODELS = {"dqn": dict(head="dueling", dueling_hidden=8, **CNN),
          "iqn": dict(head="iqn", iqn_embed_dim=8, dueling_hidden=12,
                      num_tau_policy=6, **CNN)}
TAUS = dict(num_tau=7, num_tau_prime=5)


def _record_jax(update, leaves):
    """Make `update`'s apply_phase append each update's sampled leaves
    to `leaves` as it runs, inside jit and scan."""
    apply = update.apply_phase

    def recording(*args, **kw):
        state, rstate, m = apply(*args, **kw)
        jax.debug.callback(lambda x: leaves.append(np.array(x)),
                           m["debug_leaf"], ordered=True)
        return state, rstate, m
    update.apply_phase = recording
    return update


def _record_torch(update, leaves):
    apply = update.apply_phase

    def recording(*args, **kw):
        state, rstate, m = apply(*args, **kw)
        leaves.append(m["debug_leaf"].clone())
        return state, rstate, m
    update.apply_phase = recording
    return update


def _recording_maker(make, record, leaves):
    def maker(*args, **kw):
        return record(make(*args, **kw), leaves)
    return maker


# ----- (a) the bench program, pipelined ------------------------------------

@pytest.fixture(scope="module")
def bench_pair():
    """Both pipelined bench programs at T=64, the port's nets loaded with
    the JAX params, one superstep of each on the same chunks, the port
    on JAX's draws; every update's leaves recorded on both sides. Built
    on one PyTorch thread, the thread count restored after the module."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    out = types.SimpleNamespace(jleaves=[], tleaves=[])
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jbenchprog, "T", 64)
        mp.setattr(tbenchprog, "T", 64)
        mp.setattr(jlearner, "make_update_step", _recording_maker(
            jlearner.make_update_step, _record_jax, out.jleaves))
        mp.setattr(tbenchprog, "make_update_step", _recording_maker(
            tbenchprog.make_update_step, _record_torch, out.tleaves))
        jp = jbenchprog.build(pipelined=True, **SMALL)
        tp = tbenchprog.build(device="cpu", pipelined=True, **SMALL)
    out.jp, out.tp = jp, tp
    for net, params in ((tp.tstate.model, jp.tstate.params),
                        (tp.tstate.target, jp.tstate.target_params)):
        net.load_state_dict(bridge.flax_to_state_dict(
            tp.mcfg, draws_lib.np_tree(params)))
    _, prime_u, draws = draws_lib.pipelined_draws(jp.tstate.key, jp.batch,
                                                  jp.S, jp.K)
    jchunks, tchunks = jp.stacked(50), tp.stacked(50)
    out.jts, out.jrs, jm = jp.superstep(jp.tstate, jp.rstate,
                                        jnp.float32(0.4), jchunks)
    out.jm = draws_lib.np_tree(jm)
    jax.effects_barrier()
    out.tts, out.trs, out.tm = tp.eager_superstep(
        tp.tstate, tp.rstate, 0.4, tchunks, draws=(prime_u, draws))
    yield out
    torch.set_num_threads(threads)


def test_pipelined_superstep_integer_plane_matches_jax(bench_pair):
    p = bench_pair
    updates = p.tp.S * p.tp.K
    assert len(p.jleaves) == len(p.tleaves) == updates
    for i, (j, t) in enumerate(zip(p.jleaves, p.tleaves)):
        np.testing.assert_array_equal(t.numpy(), j, err_msg=f"update {i}")
    np.testing.assert_array_equal(p.tm["debug_leaf"].numpy(),
                                  p.jm["debug_leaf"])
    assert int(p.jrs.t) == p.trs.t == p.trs.cursor.item() == 32 + 2 * 8
    assert int(p.jts.updates) == p.tts.updates == p.tts.counter.item() \
        == updates
    for name, ring in p.trs.storage.items():
        np.testing.assert_array_equal(ring.numpy(),
                                      np.asarray(p.jrs.storage[name]),
                                      err_msg=name)
    np.testing.assert_array_equal(p.trs.tree.numpy() > 0,
                                  np.asarray(p.jrs.tree) > 0)


def test_pipelined_superstep_float_plane_matches_jax(bench_pair):
    p = bench_pair
    for k in ("loss", "td_abs", "grad_norm", "mean_weight"):
        np.testing.assert_allclose(p.tm[k].item(), float(p.jm[k]),
                                   rtol=1e-2, err_msg=k)
    np.testing.assert_allclose(p.tm["q"].item(), float(p.jm["q"]), atol=2e-3)
    np.testing.assert_allclose(p.trs.tree.numpy(), np.asarray(p.jrs.tree),
                               rtol=1e-2, atol=1e-2)


# ----- (b) the pipelined step, DQN and IQN, at float32 ---------------------

E, T, L = 4, 32, 8
DYING = range(21, 27)   # the columns the second insert kills for good


def _replays():
    """Both replays after 5 inserts (t = 40 on a 32-column ring), with
    the leaves of DYING made 1000x heavier than any other, so that the
    batches sampled before the second chunk's insert (at t = 48: it
    overwrites columns 16-23, re-activates 16-20 and kills the stack
    frames of 19-26) land mostly on leaves that insert kills."""
    kw = dict(num_envs=E, steps_per_env=T, horizon=N_STEP, chunk_len=L,
              lookback=F - 1)
    jcfg, tcfg = jreplay.ReplayConfig(**kw), treplay.ReplayConfig(**kw)
    jrs = jreplay.replay_init(jcfg, {
        "obs": ((84, 84), jnp.uint8), "action": ((), jnp.int32),
        "reward": ((), jnp.float32), "terminated": ((), jnp.bool_),
        "done": ((), jnp.bool_)})
    trs = treplay.replay_init(tcfg, {
        "obs": ((84, 84), torch.uint8), "action": ((), torch.int32),
        "reward": ((), torch.float32), "terminated": ((), torch.bool),
        "done": ((), torch.bool)}, CPU)
    rng = np.random.default_rng(11)

    def chunk():
        done = rng.random((E, L)) < 0.1
        return dict(obs=rng.integers(0, 256, (E, L, 84, 84), dtype=np.uint8),
                    action=rng.integers(0, 5, (E, L)).astype(np.int32),
                    reward=rng.normal(size=(E, L)).astype(np.float32),
                    terminated=done & (rng.random((E, L)) < 0.5), done=done)
    for _ in range(5):
        c = chunk()
        jrs = jreplay.replay_insert(jcfg, jrs, {k: jnp.asarray(v)
                                                for k, v in c.items()})
        treplay.replay_insert(tcfg, trs, c)
    tree = trs.tree.numpy().copy()
    for e in range(E):
        for c in DYING:
            assert tree[e * T + c] > 0
            tree[e * T + c] = 1000.0
    jrs = jrs.replace(tree=jnp.asarray(tree))
    trs.tree = torch.from_numpy(tree.copy())
    return jcfg, jrs, tcfg, trs, [chunk() for _ in range(2)]


def _states(name, algo_kw):
    """The JAX train state (a target net apart from the online one) and
    the port's, loaded with its params."""
    jmcfg, tmcfg = JModelConfig(**MODELS[name]), ModelConfig(**MODELS[name])
    jalgo = jlearner.AlgoConfig(**algo_kw)
    talgo = tlearner.AlgoConfig(**algo_kw)
    ex = jnp.zeros((1, F, 84, 84), jnp.uint8)
    js = jlearner.make_train_state(jmcfg, jalgo, jax.random.key(7), ex)
    js = js.replace(target_params=init_params(jmcfg, jax.random.key(8), ex))
    ts = tlearner.make_train_state(tmcfg, talgo, (F, 84, 84), 0, CPU)
    ts.model.load_state_dict(bridge.flax_to_state_dict(
        tmcfg, draws_lib.np_tree(js.params)))
    ts.target.load_state_dict(bridge.flax_to_state_dict(
        tmcfg, draws_lib.np_tree(js.target_params)))
    return jmcfg, jalgo, js, tmcfg, talgo, ts


def _algo_kw(name):
    kw = dict(batch_size=B, n_step=N_STEP, gamma=0.97, lr=1e-3,
              adam_eps=1e-6, grad_clip=0.5, target_update_freq=3,
              debug_outputs=True)
    if name == "iqn":
        kw.update(algo="iqn", **TAUS)
    return kw


def _float_plane(tm, jm, trs, jrs, tmcfg, ts, js):
    # atol: a mean Q near 0 has no meaningful relative error
    for k in ("loss", "grad_norm", "td_abs", "q", "mean_weight"):
        np.testing.assert_allclose(tm[k].item(), float(jm[k]), rtol=1e-5,
                                   atol=1e-6, err_msg=k)
    np.testing.assert_allclose(tm["debug_td"].numpy(),
                               np.asarray(jm["debug_td"]), rtol=1e-5,
                               atol=1e-6)
    np.testing.assert_allclose(trs.tree.numpy(), np.asarray(jrs.tree),
                               rtol=1e-5)
    back = bridge.state_dict_to_flax(tmcfg, ts.model.state_dict())
    jax.tree.map(lambda a, b: np.testing.assert_allclose(
        a, np.asarray(b), rtol=0, atol=1e-5), back,
        draws_lib.np_tree(js.params))


@pytest.mark.parametrize("name", ["dqn", "iqn"])
def test_pipelined_step_matches_jax(name):
    """prime + 2 x (insert + K=2 updates) on both sides from one state,
    the port on JAX's key schedule. The batch pending across the second
    insert lost leaves to it: their write-backs are dropped on both
    sides (the final tree is 0 there)."""
    jcfg, jrs, tcfg, trs, chunks = _replays()
    jmcfg, jalgo, js, tmcfg, talgo, ts = _states(name, _algo_kw(name))
    jleaves, tleaves = [], []
    jupd = _record_jax(jlearner.make_update_step(jmcfg, jalgo, jcfg, F,
                                                 flatten=False), jleaves)
    jprime, jfused = (jax.jit(f) for f in
                      jlearner.make_pipelined_insert_and_update_step(
                          jcfg, jupd, 2))
    tupd = _record_torch(tlearner.make_update_step(talgo, tcfg, F,
                                                   flatten=False), tleaves)
    tprime, tfused = tlearner.make_pipelined_insert_and_update_step(
        tcfg, tupd, 2)
    taus = dict(TAUS, num_tau_policy=MODELS["iqn"]["num_tau_policy"]) \
        if name == "iqn" else {}
    _, prime_u, draws = draws_lib.pipelined_draws(js.key, B, 2, 2, **taus)
    beta = 0.6
    js, jpend = jprime(js, jrs, jnp.float32(beta))
    ts, tpend = tprime(ts, trs, beta, prime_u)
    for c, d in zip(chunks, draws):
        js, jrs, jpend, jm = jfused(js, jrs, jpend,
                                    {k: jnp.asarray(v) for k, v in c.items()},
                                    jnp.float32(beta))
        ts, trs, tpend, tm = tfused(ts, trs, tpend, c, beta, d)
    jax.effects_barrier()
    assert len(jleaves) == len(tleaves) == 4
    for i, (j, t) in enumerate(zip(jleaves, tleaves)):
        np.testing.assert_array_equal(t.numpy(), j, err_msg=f"update {i}")
    # the batch the third update trained on was sampled before the second
    # insert, mostly from DYING; that insert killed those leaves, and the
    # write-back left them dead
    stale = tleaves[2].numpy()
    dead = [leaf for leaf in stale if leaf % T in DYING]
    assert len(dead) >= B // 2, stale
    assert (trs.tree.numpy()[dead] == 0).all()
    assert (np.asarray(jrs.tree)[dead] == 0).all()
    np.testing.assert_array_equal(tpend[0]["leaf"].numpy(),
                                  np.asarray(jpend[0]["leaf"]))
    np.testing.assert_array_equal(trs.tree.numpy() > 0,
                                  np.asarray(jrs.tree) > 0)
    assert int(jrs.t) == trs.t == 56 and ts.updates == int(js.updates) == 4
    _float_plane(tm, jm, trs, jrs, tmcfg, ts, js)


# ----- (f) K updates with no insert ----------------------------------------

@pytest.mark.parametrize("name", ["dqn", "iqn"])
def test_multi_update_step_matches_jax(name):
    jcfg, jrs, tcfg, trs, _ = _replays()
    jmcfg, jalgo, js, tmcfg, talgo, ts = _states(name, _algo_kw(name))
    jmulti = jax.jit(jlearner.make_multi_update_step(
        jlearner.make_update_step(jmcfg, jalgo, jcfg, F, flatten=False), 3))
    tmulti = tlearner.make_multi_update_step(
        tlearner.make_update_step(talgo, tcfg, F, flatten=False), 3)
    taus = dict(TAUS, num_tau_policy=MODELS["iqn"]["num_tau_policy"]) \
        if name == "iqn" else {}
    key, draws = js.key, []
    for _ in range(3):
        draws.append(draws_lib.update_draws(key, B, **taus))
        key = jax.random.split(key, 3)[0]
    js, jrs, jm = jmulti(js, jrs, jnp.float32(0.6))
    ts, trs, tm = tmulti(ts, trs, 0.6, draws)
    np.testing.assert_array_equal(tm["debug_leaf"].numpy(),
                                  np.asarray(jm["debug_leaf"]))
    np.testing.assert_array_equal(trs.tree.numpy() > 0,
                                  np.asarray(jrs.tree) > 0)
    assert ts.updates == int(js.updates) == 3
    _float_plane(tm, jm, trs, jrs, tmcfg, ts, js)


# ----- (c) the split update ------------------------------------------------

@pytest.mark.parametrize("case", ["dqn", "iqn", "lambda", "uniform"])
def test_update_is_sample_phase_then_apply_phase(case):
    """`update_step` against its two phases called in turn on a copy of
    the same state, three updates each, every draw from the state's
    generator: metrics, tree, params and the generator's state bit-equal
    (the sample's uniforms come first, then IQN's taus)."""
    name = "iqn" if case == "iqn" else "dqn"
    kw = _algo_kw(name)
    if case == "lambda":
        kw["use_lambda"] = True
    _, _, tcfg, trs, _ = _replays()
    if case == "uniform":
        tcfg = treplay.ReplayConfig(num_envs=E, steps_per_env=T,
                                    horizon=N_STEP, chunk_len=L,
                                    lookback=F - 1, prioritized=False)
        trs.tree = torch.zeros((1,))       # uniform replay keeps no tree
    _, _, _, tmcfg, talgo, ts = _states(name, kw)
    ts2, trs2 = tbenchprog.clone_states(ts, trs)
    upd = tlearner.make_update_step(talgo, tcfg, F, flatten=False)
    for _ in range(3):
        _, _, m1 = upd(ts, trs, 0.6)
        idx, batch = upd.sample_phase(ts2.generator, trs2, 0.6)
        _, _, m2 = upd.apply_phase(ts2, trs2, idx, batch)
        assert m1.keys() == m2.keys()
        for k in m1:
            assert torch.equal(m1[k], m2[k]), k
    assert torch.equal(trs.tree, trs2.tree)
    assert torch.equal(ts.generator.get_state(), ts2.generator.get_state())
    for (k, a), b in zip(ts.model.state_dict().items(),
                         ts2.model.state_dict().values()):
        assert torch.equal(a, b), k


# ----- (d) R2D2 refuses the pipelined step ---------------------------------

def test_pipelined_bench_refuses_r2d2():
    with pytest.raises(ValueError, match="R2D2 update does not split"):
        tbenchprog.build(device="cpu", algo="r2d2", pipelined=True)


def test_pipelined_step_needs_the_split_update():
    cfg = treplay.ReplayConfig(num_envs=2, steps_per_env=64, horizon=8,
                               chunk_len=8)
    algo = tlearner.AlgoConfig(algo="r2d2", batch_size=2, burn_in=2,
                               seq_len=4)
    mcfg = ModelConfig(num_actions=3, torso="mlp", mlp_hidden=(8,),
                       lstm_size=4, head="linear")
    update = tr2d2.make_r2d2_update_step(mcfg, algo, cfg, 1, True)
    with pytest.raises(ValueError, match="sample_phase and apply_phase"):
        tlearner.make_pipelined_insert_and_update_step(cfg, update, 1)


# ----- (e) unroll and gather_barrier change nothing ------------------------

def _run(kw):
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(tbenchprog, "T", 64)
        p = tbenchprog.build(device="cpu", **SMALL, **kw)
    _, _, m = p.eager_superstep(p.tstate, p.rstate, 0.4, p.stacked(50))
    return p, m


@pytest.mark.parametrize("kw", [dict(unroll=2),
                                dict(gather_barrier=True),
                                dict(unroll=3, pipelined=True)])
def test_unroll_and_gather_barrier_change_nothing(kw):
    """The option against the same program without it, every draw from
    the seeded generators: metrics, rings, tree, params bit-equal."""
    base = {k: v for k, v in kw.items() if k == "pipelined"}
    (p, m), (q, n) = _run(kw), _run(base)
    assert p.acfg.gather_barrier == kw.get("gather_barrier", False)
    for k in m:
        assert torch.equal(m[k], n[k]), k
    assert torch.equal(p.rstate.tree, q.rstate.tree)
    for name, ring in p.rstate.storage.items():
        assert torch.equal(ring, q.rstate.storage[name]), name
    for (k, a), b in zip(p.tstate.model.state_dict().items(),
                         q.tstate.model.state_dict().values()):
        assert torch.equal(a, b), k


def test_unroll_below_one_raises():
    with pytest.raises(ValueError, match="unroll must be >= 1"):
        tbenchprog.build(device="cpu", unroll=0)


# ----- the graph reader behind the card's overlap check --------------------

def _dot(nodes, edges):
    lines = ["digraph dot {", 'subgraph cluster_1 {', 'label="graph_1";']
    for i, name in enumerate(nodes):
        lines.append(f'"graph_1_node_{i}"[style="solid" shape="record" '
                     f'label="{{KERNEL\\n| {{ID | {i} | {name}}}}}"];')
    for a, b in edges:
        lines.append(f'"graph_1_node_{a}" -> "graph_1_node_{b}";')
    return "\n".join(lines + ["}", "}"])


def test_concurrent_nodes_of_a_chain_and_a_fork():
    """A capture on one stream is a chain: no node has a parallel one. A
    fork (node 1 -> 2 and 1 -> 3, joined at 4) puts the gather beside
    the conv."""
    names = ["insert", "fork", "union_gather_kernel", "conv_kernel", "join"]
    chain = _dot(names, [(0, 1), (1, 2), (2, 3), (3, 4)])
    fork = _dot(names, [(0, 1), (1, 2), (1, 3), (2, 4), (3, 4)])
    want = ("union_gather_kernel", "conv_kernel", "insert")
    assert graphs.concurrent_nodes(chain, want) == {
        "union_gather_kernel": 0, "conv_kernel": 0, "insert": 0}
    assert graphs.concurrent_nodes(fork, want) == {
        "union_gather_kernel": 1, "conv_kernel": 1, "insert": 0}
