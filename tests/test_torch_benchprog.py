"""Port parity: the bench superstep (`rltime_tpu_torch/utils/benchprog.py`)
against `rltime_tpu/utils/benchprog.py`, and the capturable pieces under
it: the device-cursor insert and sampler, the device update counter and
its target sync, capturable Adam, `batched_next_forward`, the bench's
FLOP count.

Both builds read their module's `T` when called, so the shared build runs
at T=64 (E=4, L=8, batch 8, S=2, K=2). On one superstep from the JAX
params (carried by `models/bridge.py`) and JAX's sampler uniforms:
the chunks, the rings, the cursor and the sampled leaves are bit-equal;
the float plane runs in bf16 (the bench's Nature CNN computes in
bfloat16: 8 mantissa bits, rounded after other accumulation orders in
XLA and PyTorch), so loss, grad norm and priorities are held to rtol
1e-2, per-sample |TD| (a difference of two bf16 Q values) and the
priorities made from it also to atol 2e-2 and 1e-2, and the params to
atol 1e-3: Adam moves a parameter whose
gradient is bf16 noise around 0 by +-lr = 1e-4 per update whatever its
size, so two sides may part by 2 lr per update (8e-4 over 4). That
bound is wider than what 4 steps move a parameter (at most 4 lr), so
the test also holds what each side moved from the shared initial
params: the port's move within 0.25 of JAX's in relative L2, and of
the same sign as JAX's on more than 99% of the parameters JAX moved by
more than 2 lr. A superstep that skipped the optimizer step, or
stepped the wrong way, fails both. The float32 tests hold the file `test_torch_learner.py`'s
tolerances.
"""
import sys
import types

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import bench as root_bench
from rltime_tpu.history import replay as jreplay
from rltime_tpu.models.policy import ModelConfig as JModelConfig
from rltime_tpu.models.policy import init_params
from rltime_tpu.training import learner as jlearner
from rltime_tpu.utils import benchprog as jbenchprog
from rltime_tpu_torch import bench as tbench
from rltime_tpu_torch.history import replay as treplay
from rltime_tpu_torch.models import bridge
from rltime_tpu_torch.models.policy import ModelConfig
from rltime_tpu_torch.training import learner as tlearner
from rltime_tpu_torch.utils import benchprog as tbenchprog
from rltime_tpu_torch.utils.graphs import GraphedStep
from torch_port_draws import one_intra_op_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_intra_op_thread")

SMALL = dict(warm_chunks=4, batch=8, k=2, supersteps=2, num_envs=4,
             chunk_len=8, debug_outputs=True)
CNN = dict(num_actions=5, torso="nature_cnn", cnn_channels=(4, 4, 4),
           cnn_fc=16, head="dueling", dueling_hidden=8)
F, N_STEP = 4, 3
CPU = torch.device("cpu")


def _np_tree(t):
    return jax.tree.map(np.asarray, t)


@pytest.fixture(scope="module")
def pair():
    """Both bench programs at T=64, the port's nets loaded with the JAX
    params, one superstep of each on the same chunks and JAX's draws.
    Everything the tests compare is kept here, taken in build order.
    Built on one PyTorch thread; the thread count is restored after the
    module (a later file on this worker keeps its own)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jbenchprog, "T", 64)
        mp.setattr(tbenchprog, "T", 64)
        jp = jbenchprog.build(**SMALL)
        tp = tbenchprog.build(device="cpu", **SMALL)
    out = types.SimpleNamespace(jp=jp, tp=tp)
    out.warm = dict(
        jax=({n: np.asarray(v) for n, v in jp.rstate.storage.items()},
             np.asarray(jp.rstate.tree), int(jp.rstate.t),
             float(jp.rstate.max_priority)),
        torch=({n: v.clone() for n, v in tp.rstate.storage.items()},
               tp.rstate.tree.clone(), tp.rstate.t, tp.rstate.cursor.item(),
               tp.rstate.max_priority.item()))
    for net, params in ((tp.tstate.model, jp.tstate.params),
                        (tp.tstate.target, jp.tstate.target_params)):
        net.load_state_dict(bridge.flax_to_state_dict(tp.mcfg,
                                                      _np_tree(params)))
    out.init = jax.tree.map(np.array, jp.tstate.params)
    out.jchunks, out.tchunks = jp.stacked(50), tp.stacked(50)
    out.next_chunk = (jp.chunk(0), tp.chunk(0))
    # the JAX update splits its key into (key, sample key, tau key); the
    # dense sampler draws B uniforms from the sample key
    key, draws = jp.tstate.key, []
    for _ in range(jp.S):
        row = []
        for _ in range(jp.K):
            key, skey, _ = jax.random.split(key, 3)
            row.append({"u": torch.from_numpy(np.asarray(
                jax.random.uniform(skey, (jp.batch,))))})
        draws.append(row)
    out.jts, out.jrs, jm = jp.superstep(jp.tstate, jp.rstate,
                                        jnp.float32(0.4), out.jchunks)
    out.jm = _np_tree(jm)
    out.tts, out.trs, out.tm = tp.eager_superstep(
        tp.tstate, tp.rstate, 0.4, out.tchunks, draws=draws)
    yield out
    torch.set_num_threads(threads)


def test_chunks_are_bit_equal(pair):
    for name, x in pair.tchunks.items():
        assert x.shape == (2, 4, 8) + x.shape[3:]
        np.testing.assert_array_equal(x.numpy(), np.asarray(pair.jchunks[name]),
                                      err_msg=name)
    (jc, tc) = pair.next_chunk
    assert set(jc) == set(tc) == {"obs", "action", "reward", "terminated",
                                  "done"}
    for name in jc:
        np.testing.assert_array_equal(tc[name], jc[name], err_msg=name)


def test_replay_after_the_warm_inserts_is_bit_equal(pair):
    (jst, jtree, jt, jmax), (tst, ttree, tt, tcur, tmax) = (
        pair.warm["jax"], pair.warm["torch"])
    assert jt == tt == tcur == 4 * 8
    assert set(jst) == set(tst)
    for name in jst:
        assert tst[name].dtype == torch.from_numpy(
            np.zeros(0, jst[name].dtype)).dtype, name
        np.testing.assert_array_equal(tst[name].numpy(), jst[name],
                                      err_msg=name)
    np.testing.assert_array_equal(ttree.numpy(), jtree)
    assert tmax == jmax


def test_one_superstep_matches_jax(pair):
    jm, tm, jrs, trs = pair.jm, pair.tm, pair.jrs, pair.trs
    # integer plane: bit-equal
    np.testing.assert_array_equal(tm["debug_leaf"].numpy(), jm["debug_leaf"])
    assert int(jrs.t) == trs.t == trs.cursor.item() == 32 + 2 * 8
    assert int(pair.jts.updates) == pair.tts.updates == \
        pair.tts.counter.item() == 4
    for name, ring in trs.storage.items():
        np.testing.assert_array_equal(ring.numpy(),
                                      np.asarray(jrs.storage[name]),
                                      err_msg=name)
    jtree, ttree = np.asarray(jrs.tree), trs.tree.numpy()
    np.testing.assert_array_equal(ttree > 0, jtree > 0)
    # float plane in bf16 (module doc)
    for k in ("loss", "td_abs", "grad_norm", "mean_weight"):
        np.testing.assert_allclose(tm[k].item(), float(jm[k]), rtol=1e-2,
                                   err_msg=k)
    np.testing.assert_allclose(tm["q"].item(), float(jm["q"]), atol=2e-3)
    np.testing.assert_allclose(tm["debug_td"].numpy(), jm["debug_td"],
                               rtol=1e-2, atol=2e-2)
    # priorities (|TD| + eps)^0.6 carry |TD|'s absolute error, times
    # 0.6 |TD|^-0.4 (> 1 below |TD| = 0.28)
    np.testing.assert_allclose(ttree, jtree, rtol=1e-2, atol=1e-2)
    np.testing.assert_allclose(trs.max_priority.item(),
                               float(jrs.max_priority), rtol=1e-2)
    back = bridge.state_dict_to_flax(pair.tp.mcfg,
                                     pair.tts.model.state_dict())
    jax.tree.map(lambda a, b: np.testing.assert_allclose(
        a, np.asarray(b), rtol=0, atol=1e-3), back, _np_tree(pair.jts.params))
    # what the 4 Adam steps moved, each side from the shared initial
    # params (module doc): a superstep that skipped, repeated or reversed
    # a step fails here
    tmoved, jmoved = (np.concatenate([
        x.ravel() for x in jax.tree.leaves(jax.tree.map(
            lambda a, b: a - b, params, pair.init))])
        for params in (back, _np_tree(pair.jts.params)))
    assert np.linalg.norm(tmoved - jmoved) < 0.25 * np.linalg.norm(jmoved)
    far = np.abs(jmoved) > 2 * pair.tp.acfg.lr
    assert far.sum() > jmoved.size // 4
    assert np.mean(np.sign(tmoved[far]) == np.sign(jmoved[far])) > 0.99


@pytest.mark.parametrize("sampler,inserted", [("dense", False),
                                              ("tree", False),
                                              ("dense", True)])
def test_device_cursor_matches_host_int_over_two_laps(sampler, inserted):
    """Insert 20 chunks of 4 columns into a 32-column ring (before it is
    full, at the seam, after it wraps twice) by both routes, sample and
    write back after each: every state and sample bit-equal."""
    cfg = treplay.ReplayConfig(num_envs=3, steps_per_env=32, horizon=3,
                               chunk_len=4, lookback=3, sampler=sampler,
                               use_inserted_priorities=inserted)
    fields = {"obs": ((2, 2), torch.uint8), "done": ((), torch.bool)}
    if inserted:
        fields["priority"] = ((), torch.float32)
    host = treplay.replay_init(cfg, fields, CPU)
    dev = treplay.replay_init(cfg, fields, CPU)
    dev.cursor = torch.zeros((), dtype=torch.int64)
    rng = np.random.default_rng(0)
    # one beta for both (a float exponent of 0.5 takes torch's rsqrt path,
    # a tensor exponent powf: the last bit may differ)
    beta = torch.tensor(0.5)
    for i in range(20):
        chunk = {"obs": rng.integers(0, 256, (3, 4, 2, 2), dtype=np.uint8),
                 "done": rng.random((3, 4)) < 0.2}
        if inserted:
            chunk["priority"] = rng.random((3, 4)).astype(np.float32)
        treplay.replay_insert(cfg, host, chunk)
        treplay.replay_insert_device(cfg, dev, chunk)
        assert dev.t == 0 and dev.cursor.item() == host.t == 4 * (i + 1)
        for name in fields:
            assert torch.equal(dev.storage[name], host.storage[name]), name
        assert torch.equal(dev.tree, host.tree), i
        assert torch.equal(dev.max_priority, host.max_priority)
        u = torch.from_numpy(rng.random(6).astype(np.float32))
        a = treplay.replay_sample_indices(cfg, host, 6, beta, u=u)
        b = treplay.replay_sample_indices_device(cfg, dev, 6, beta, u=u)
        assert b["num_valid"].item() == a["num_valid"]
        for k in ("env", "col", "leaf", "weight"):
            assert torch.equal(a[k], b[k]), (i, k)
        td = torch.from_numpy(rng.random(6).astype(np.float32))
        treplay.replay_update_priorities(cfg, host, a["leaf"], td)
        treplay.replay_update_priorities(cfg, dev, b["leaf"], td)
    assert host.t > 2 * 32 and int((host.tree > 0).sum()) > 0


def _capturable_on_cpu(monkeypatch):
    """torch keeps capturable Adam to accelerators; the tests let it run
    on the CPU, the same arithmetic as on the card."""
    adam = sys.modules["torch.optim.adam"]
    supported = adam._get_capturable_supported_devices()
    monkeypatch.setattr(adam, "_get_capturable_supported_devices",
                        lambda *a, **k: supported + ["cpu"])


def _small_replay():
    cfg = treplay.ReplayConfig(num_envs=4, steps_per_env=64, horizon=N_STEP,
                               chunk_len=8, lookback=F - 1)
    fields = {"obs": ((84, 84), torch.uint8), "action": ((), torch.int32),
              "reward": ((), torch.float32), "terminated": ((), torch.bool),
              "done": ((), torch.bool)}
    state = treplay.replay_init(cfg, fields, CPU)
    rng = np.random.default_rng(3)

    def chunk():
        done = rng.random((4, 8)) < 0.1
        return dict(obs=rng.integers(0, 256, (4, 8, 84, 84), dtype=np.uint8),
                    action=rng.integers(0, 5, (4, 8)).astype(np.int32),
                    reward=rng.normal(size=(4, 8)).astype(np.float32),
                    terminated=done & (rng.random((4, 8)) < 0.5), done=done)
    for _ in range(4):
        treplay.replay_insert(cfg, state, chunk())
    return cfg, state, chunk, rng


def test_device_counter_and_capturable_adam_match_the_host_route(
        monkeypatch):
    """Eight updates (an insert after the fourth) at float32 with
    target_update_freq 3, by the host route (host int cursor and count,
    plain Adam) and the captured step's route (device cursor and counter,
    capturable Adam) on the same draws: leaves bit-equal, params to
    atol 1e-6, and each route's target is its online net of updates 3
    and 6 bit for bit."""
    algo = tlearner.AlgoConfig(batch_size=8, n_step=N_STEP, lr=1e-3,
                               target_update_freq=3, debug_outputs=True)
    cfg, host_rs, chunk, rng = _small_replay()
    host = tlearner.make_train_state(ModelConfig(**CNN), algo, (F, 84, 84),
                                     0, CPU)
    _, dev_rs = tbenchprog.clone_states(host, host_rs)
    dev_rs.cursor = torch.tensor(dev_rs.t)
    init = {k: v.clone() for k, v in host.model.state_dict().items()}
    _capturable_on_cpu(monkeypatch)
    dev = tlearner.make_train_state(ModelConfig(**CNN), algo, (F, 84, 84), 0,
                                    CPU, capturable=True)
    dev.counter = torch.zeros((), dtype=torch.int64)
    assert not host.optimizer.defaults["capturable"]
    assert dev.optimizer.defaults["capturable"]
    update = tlearner.make_update_step(algo, cfg, F, flatten=False)
    snaps = {"host": [], "dev": []}
    for i in range(8):
        if i == 4:
            ck = chunk()
            treplay.replay_insert(cfg, host_rs, ck)
            treplay.replay_insert_device(cfg, dev_rs, ck)
        u = torch.from_numpy(rng.random(8).astype(np.float32))
        _, _, hm = update(host, host_rs, 0.4, u=u)
        _, _, dm = update(dev, dev_rs, torch.tensor(0.4), u=u)
        assert torch.equal(hm["debug_leaf"], dm["debug_leaf"]), i
        assert host.updates == dev.counter.item() == i + 1 and dev.updates == 0
        for route, ts in (("host", host), ("dev", dev)):
            snaps[route].append({k: v.clone() for k, v in
                                 ts.model.state_dict().items()})
            synced = snaps[route][3 * ((i + 1) // 3) - 1] if i >= 2 else init
            for k, v in ts.target.state_dict().items():
                assert torch.equal(v, synced[k]), (route, i, k)
        for k, v in dev.model.state_dict().items():
            np.testing.assert_allclose(v.numpy(),
                                       host.model.state_dict()[k].numpy(),
                                       rtol=0, atol=1e-6, err_msg=k)
        np.testing.assert_allclose(dm["loss"].item(), hm["loss"].item(),
                                   rtol=1e-5)
    assert torch.equal(dev_rs.tree > 0, host_rs.tree > 0)


def test_capturable_adam_matches_optax(monkeypatch):
    """Three clipped steps of capturable Adam (its step count a tensor,
    its bias corrections tensor ops) against optax.adam on the same
    gradients: params to rtol 1e-5 / atol 1e-7."""
    _capturable_on_cpu(monkeypatch)
    mlp = dict(num_actions=3, torso="mlp", mlp_hidden=(16, 8),
               head="dueling", dueling_hidden=8)
    kw = dict(lr=1e-2, adam_eps=1e-6, grad_clip=0.5)
    jcfg, tcfg = JModelConfig(**mlp), ModelConfig(**mlp)
    params = init_params(jcfg, jax.random.key(0), jnp.zeros((1, 5)))
    tx = jlearner.make_optimizer(jlearner.AlgoConfig(**kw))
    opt_state = tx.init(params)
    algo = tlearner.AlgoConfig(**kw)
    ts = tlearner.make_train_state(tcfg, algo, (5,), 0, CPU, capturable=True)
    assert ts.optimizer.defaults["capturable"]
    ts.counter = torch.zeros((), dtype=torch.int64)
    ts.model.load_state_dict(bridge.flax_to_state_dict(tcfg, _np_tree(params)))
    x = np.random.default_rng(1).normal(size=(8, 5)).astype(np.float32)
    from rltime_tpu.models.policy import make_model
    for step in range(3):
        scale = float(step + 1)

        def jloss(p):
            q, _ = make_model(jcfg).apply(p, jnp.asarray(x), ())
            return scale * jnp.sum(q * q)
        grads = jax.grad(jloss)(params)
        upd, opt_state = tx.update(grads, opt_state, params)
        params = optax.apply_updates(params, upd)
        loss = scale * torch.sum(ts.model(torch.from_numpy(x)) ** 2)
        g_norm = tlearner.apply_gradients(algo, ts, loss)
        np.testing.assert_allclose(g_norm.item(), float(optax.global_norm(
            grads)), rtol=1e-5)
    back = bridge.state_dict_to_flax(tcfg, ts.model.state_dict())
    jax.tree.map(lambda a, b: np.testing.assert_allclose(
        a, np.asarray(b), rtol=1e-5, atol=1e-7), back, _np_tree(params))
    assert ts.counter.item() == 3 and ts.updates == 0


def test_batched_next_forward_matches_jax():
    """`batched_next_forward=True` on both sides (JAX vmaps the online and
    target next-obs forwards; the port runs both): loss, per-sample |TD|
    (the targets against the same Q), grad norm and priorities at
    float32 to rtol 1e-5."""
    kw = dict(batch_size=16, n_step=N_STEP, gamma=0.97, lr=1e-3,
              batched_next_forward=True, debug_outputs=True)
    jcfg = jreplay.ReplayConfig(num_envs=4, steps_per_env=64,
                                horizon=N_STEP, chunk_len=8, lookback=F - 1)
    jrs = jreplay.replay_init(jcfg, {"obs": ((84, 84), jnp.uint8),
                                     "action": ((), jnp.int32),
                                     "reward": ((), jnp.float32),
                                     "terminated": ((), jnp.bool_),
                                     "done": ((), jnp.bool_)})
    tcfg, trs, _, _ = _small_replay()
    # the same bytes into the JAX ring
    for c in range(4):
        jrs = jreplay.replay_insert(jcfg, jrs, {
            n: jnp.asarray(v[:, 8 * c:8 * c + 8].numpy())
            for n, v in trs.storage.items()})
    np.testing.assert_array_equal(np.asarray(jrs.tree), trs.tree.numpy())
    mcfg = ModelConfig(**CNN)
    jalgo = jlearner.AlgoConfig(**kw)
    ex = jnp.zeros((1, F, 84, 84), jnp.uint8)
    js = jlearner.make_train_state(JModelConfig(**CNN), jalgo,
                                   jax.random.key(7), ex)
    js = js.replace(target_params=init_params(JModelConfig(**CNN),
                                              jax.random.key(8), ex))
    _, skey, _ = jax.random.split(js.key, 3)
    u = torch.from_numpy(np.array(jax.random.uniform(skey, (16,))))
    talgo = tlearner.AlgoConfig(**kw)
    ts = tlearner.make_train_state(mcfg, talgo, (F, 84, 84), 0, CPU)
    ts.model.load_state_dict(bridge.flax_to_state_dict(mcfg,
                                                       _np_tree(js.params)))
    ts.target.load_state_dict(bridge.flax_to_state_dict(
        mcfg, _np_tree(js.target_params)))
    _, jrs2, jm = jax.jit(jlearner.make_update_step(
        JModelConfig(**CNN), jalgo, jcfg, F, flatten=False))(
            js, jrs, jnp.float32(0.6))
    _, trs2, tm = tlearner.make_update_step(talgo, tcfg, F, flatten=False)(
        ts, trs, 0.6, u=u)
    np.testing.assert_array_equal(tm["debug_leaf"].numpy(),
                                  np.asarray(jm["debug_leaf"]))
    for k in ("loss", "grad_norm", "td_abs", "q"):
        np.testing.assert_allclose(tm[k].item(), float(jm[k]), rtol=1e-5,
                                   err_msg=k)
    np.testing.assert_allclose(tm["debug_td"].numpy(),
                               np.asarray(jm["debug_td"]), rtol=1e-5,
                               atol=1e-6)
    np.testing.assert_allclose(trs2.tree.numpy(), np.asarray(jrs2.tree),
                               rtol=1e-5)


def test_global_norm_depends_on_the_values_only():
    """The grad norm of one set of values in three layouts (contiguous;
    the weight gradients transposed, as autograd hands some back; views
    of one flat buffer, as a mesh hands them back) is the same bit for
    bit, and optax.global_norm's to rtol 1e-6. (A foreach norm of the
    gradients themselves fails this.)"""
    rng = np.random.default_rng(0)
    shapes = [(16, 4, 3, 3), (16,), (128, 1024), (128,), (256, 128), (256,),
              (3, 256), (3,)]
    values = [rng.normal(scale=0.01, size=s).astype(np.float32)
              for s in shapes]
    plain = [torch.from_numpy(v) for v in values]
    transposed = [t.t().contiguous().t() if t.dim() == 2 else t
                  for t in plain]
    assert not all(t.is_contiguous() for t in transposed)
    flat = torch.cat([t.reshape(-1) for t in plain])
    views = [part.view_as(t) for part, t in zip(
        flat.split([t.numel() for t in plain]), plain)]
    norms = [tlearner._global_norm(ts) for ts in (plain, transposed, views)]
    assert all(torch.equal(n, norms[0]) for n in norms)
    np.testing.assert_allclose(norms[0].item(), float(optax.global_norm(
        [jnp.asarray(v) for v in values])), rtol=1e-6)


def test_capture_refuses_the_cpu():
    with pytest.raises(RuntimeError, match="on the CPU call the step"):
        GraphedStep(lambda x: x, [torch.zeros(1)])


def test_bench_refuses_the_cpu():
    with pytest.raises(SystemExit, match="measures a CUDA device"):
        tbench.main(["--device", "cpu"])


def test_analytic_flops_equal_the_root_bench(pair):
    full = types.SimpleNamespace(batch=1024, S=64, K=1)
    for p in (pair.tp, pair.jp, full):
        assert (tbench.analytic_flops_per_dispatch(p)
                == root_bench._analytic_flops_per_dispatch(p))
    # ~98 GFLOP per update at batch 1024
    assert 97e9 < tbench.analytic_flops_per_dispatch(full) / 64 < 99e9


def test_cpu_route_is_the_eager_body(pair):
    assert pair.tp.graph is None
    assert pair.tp.superstep is pair.tp.eager_superstep
    assert pair.tp.device == CPU
