"""One gloo rank of a multi-rank port test (started by
`torch_port_mp.run_ranks`; imports torch, numpy and the port, never jax).

    python torch_port_mp_worker.py <scenario> <rank> <world> <workdir>

The rank joins the process group through `file://<workdir>/rendezvous`,
reads `<workdir>/in.npz` and `<workdir>/cfg.json` where its scenario
takes inputs, runs it on the CPU with one PyTorch thread, and writes
`<workdir>/out_<rank>.npz`. Scenarios:

  sharded_update  replay insert + 3 sharded updates (PER and uniform) on
                  injected per-shard draws, pooled stats, the census of
                  one update;
  apex            ApexTrainer end to end, then two resumes of its last
                  checkpoint;
  fused           FusedApexTrainer end to end, then two resumes;
  fused_parity    one warm chunk and one superstep of FusedApexTrainer on
                  injected per-shard weights and draws;
  census          the collectives of one fused superstep and one apex
                  chunk.
"""
import copy
import json
import os
import sys

import numpy as np
import torch
import torch.distributed as dist

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from torch_port_mp import load_tree, save_tree  # noqa: E402

from rltime_tpu_torch.acting.device_actor import (  # noqa: E402
    init_device_actor_state,
)
from rltime_tpu_torch.history.replay import (  # noqa: E402
    ReplayConfig, replay_init,
)
from rltime_tpu_torch.models.policy import ModelConfig  # noqa: E402
from rltime_tpu_torch.parallel import census  # noqa: E402
from rltime_tpu_torch.parallel.apex import ApexTrainer  # noqa: E402
from rltime_tpu_torch.parallel.fused import FusedApexTrainer  # noqa: E402
from rltime_tpu_torch.parallel.mesh import (  # noqa: E402
    make_mesh, make_sharded_insert, make_sharded_update_step,
    pool_process_stats,
)
from rltime_tpu_torch.training import checkpoint as ckpt_lib  # noqa: E402
from rltime_tpu_torch.training.learner import (  # noqa: E402
    AlgoConfig, make_train_state,
)

CPU = torch.device("cpu")


def _t(x):
    return torch.from_numpy(np.array(x))


def _params(model):
    return {k: v.detach().numpy().copy() for k, v in model.state_dict().items()}


def _checksum(model):
    return float(sum(np.abs(v.detach().numpy().astype(np.float64)).sum()
                     for v in model.state_dict().values()))


def _census():
    return json.dumps(census.entries())


def sharded_update(rank, world, mesh, inp, cfg):
    E, T, L, n = cfg["E_local"], cfg["T"], cfg["L"], cfg["n_step"]
    mc = ModelConfig(num_actions=3, torso="mlp", mlp_hidden=(16,),
                     head="linear")
    ac = AlgoConfig(algo="dqn", batch_size=cfg["B"], n_step=n, lr=1e-3,
                    target_update_freq=5)
    fields = {"obs": ((4,), torch.float32), "action": ((), torch.int32),
              "reward": ((), torch.float32), "terminated": ((), torch.bool),
              "done": ((), torch.bool)}
    lanes = slice(rank * E, (rank + 1) * E)
    out = {}
    for kind, prioritized in (("per", True), ("uni", False)):
        rcfg = ReplayConfig(num_envs=E, steps_per_env=T, horizon=n,
                            chunk_len=L, prioritized=prioritized)
        rstate = replay_init(rcfg, fields, mesh.device)
        insert = make_sharded_insert(rcfg, mesh)
        for chunk in inp["chunks"]:
            rstate = insert(rstate, {k: v[lanes] for k, v in chunk.items()})
        tree_insert = rstate.tree.clone()
        state = make_train_state(mc, ac, (4,), 0, CPU)
        state.model.load_state_dict({k: _t(v) for k, v in
                                     inp["model"].items()})
        state.target.load_state_dict({k: _t(v) for k, v in
                                      inp["target"].items()})
        update = make_sharded_update_step(mc, ac, rcfg, 1, True, mesh)
        for k, d in enumerate(inp["draws"][kind][rank]):
            u = d["u"]
            u = tuple(_t(x) for x in u) if isinstance(u, list) else _t(u)
            if k == len(inp["draws"][kind][rank]) - 1:
                census.reset_counts()
            state, rstate, m = update(state, rstate, 0.4, [dict(u=u)])
        out[kind] = dict(
            tree_insert=tree_insert.numpy(), tree=rstate.tree.numpy(),
            max_priority=rstate.max_priority.numpy(), t=rstate.t,
            obs=rstate.storage["obs"].numpy(), params=_params(state.model),
            updates=state.updates,
            metrics={k: v.numpy() for k, v in m.items()},
            census=_census())
    vals = inp["stats"][rank]
    pooled, g_sum, g_n = pool_process_stats(vals, cfg["cap"], mesh)
    out["stats"] = dict(pooled=np.array(pooled, np.float32), sum=g_sum, n=g_n)
    return out


def apex(rank, world, mesh, inp, cfg):
    rd = cfg["result_dir"]
    t = ApexTrainer(cfg["config"], rd, device="cpu", mesh=mesh).train()
    mesh.barrier()                    # the lead's checkpoint is written
    checksum = _checksum(t.train_state.model)
    rets, _ = t.actor.episode_stats()
    resumed = []
    for _ in range(2):
        c2 = copy.deepcopy(cfg["config"])
        c2["train"].update(resume=True, total_env_steps=10**9)
        r = ApexTrainer(c2, rd, device="cpu", mesh=mesh)
        assert r.actor.env_steps == t.actor.env_steps
        assert torch.equal(r.actor.generator.get_state(),
                           t.actor.generator.get_state())
        assert torch.equal(r.replay_state.tree, t.replay_state.tree)
        for _ in range(3):
            r.train_chunk()
        resumed.append(_checksum(r.train_state.model))
        mesh.barrier()
    best = ckpt_lib.best_step(rd)
    return dict(updates_done=t.updates_done,
                global_env_steps=t.global_env_steps, checksum=checksum,
                num_episodes=t.episodes_seen + len(rets),
                resumed=np.array(resumed), params=_params(t.train_state.model),
                eps=t.actor.exploration.epsilons(0, 0),
                best=json.dumps(best), best_score=t._best_score)


def fused(rank, world, mesh, inp, cfg):
    rd = cfg["result_dir"]
    t = FusedApexTrainer(cfg["config"], rd, device="cpu", mesh=mesh).train()
    mesh.barrier()
    checksum = _checksum(t.train_state.model)
    t.episode_stats()
    resumed = []
    for _ in range(2):
        c2 = copy.deepcopy(cfg["config"])
        c2["train"]["resume"] = True
        r = FusedApexTrainer(c2, rd, device="cpu", mesh=mesh)
        assert r.env_steps == t.env_steps, (r.env_steps, t.env_steps)
        for _ in range(3):
            r.superstep()
        resumed.append(_checksum(r.train_state.model))
        mesh.barrier()
    best = ckpt_lib.best_step(rd)
    return dict(updates_done=t.updates_done, env_steps=t.env_steps,
                checksum=checksum, num_episodes=t._stats_popped,
                resumed=np.array(resumed), params=_params(t.train_state.model),
                best=json.dumps(best), best_score=t._best_score)


def fused_parity(rank, world, mesh, inp, cfg):
    t = FusedApexTrainer(cfg["config"], cfg["result_dir"], device="cpu",
                         mesh=mesh)
    for net, name in ((t.train_state.model, "model"),
                      (t.train_state.target, "target")):
        net.load_state_dict({k: _t(v) for k, v in inp[name].items()})
    rk = inp["ranks"][rank]
    t.actor_state = init_device_actor_state(
        t.env, t.model_cfg, t.num_envs, 0, CPU,
        reset_draws={k: _t(v) for k, v in rk["reset"].items()})

    def act(draws):
        return [{g: {k: _t(v) for k, v in d[g].items()} for g in d}
                for d in draws]

    assert t.superstep(dict(act=act(rk["warm"]))) == {}
    census.reset_counts()
    m = t.superstep([dict(act=act(rk["act"]),
                          update=[{k: _t(v) for k, v in d.items()}
                                  for d in rk["update"]])])
    rs, a = t.replay_state, t.actor_state
    return dict(
        storage={k: v.numpy() for k, v in rs.storage.items()}, t=rs.t,
        tree=rs.tree.numpy(), max_priority=rs.max_priority.numpy(),
        ret_ring=a.ret_ring.numpy(), ring_cursor=a.ring_cursor.numpy(),
        env_state={k: v.numpy() for k, v in a.env_state.items()},
        metrics={k: v.numpy() for k, v in m.items()},
        params=_params(t.train_state.model), env_steps=t.env_steps,
        updates_done=t.updates_done, census=_census())


def census_run(rank, world, mesh, inp, cfg):
    t = FusedApexTrainer(cfg["fused"], os.path.join(cfg["result_dir"], "f"),
                         device="cpu", mesh=mesh)
    t.superstep()                     # warm: compiles nothing, fills a chunk
    census.reset_counts()
    t.superstep()
    fused_census = _census()
    a = ApexTrainer(cfg["apex"], os.path.join(cfg["result_dir"], "a"),
                    device="cpu", mesh=mesh)
    while a.updates_done == 0:
        a.train_chunk()
    census.reset_counts()
    a.train_chunk()
    return dict(
        fused=fused_census, apex=_census(),
        fused_params_bytes=sum(p.numel() * p.element_size()
                               for p in t.train_state.model.parameters()),
        apex_params_bytes=sum(p.numel() * p.element_size()
                              for p in a.train_state.model.parameters()),
        obs_ring_bytes=t.replay_state.storage["obs"].numel(),
        fused_updates=t.loop_cfg.updates_per_chunk,
        apex_updates=a.loop_cfg.updates_per_chunk)


SCENARIOS = dict(sharded_update=sharded_update, apex=apex, fused=fused,
                 fused_parity=fused_parity, census=census_run)


def main():
    scenario, rank, world, workdir = (sys.argv[1], int(sys.argv[2]),
                                      int(sys.argv[3]), sys.argv[4])
    torch.set_num_threads(1)
    dist.init_process_group(
        "gloo", init_method=f"file://{os.path.join(workdir, 'rendezvous')}",
        world_size=world, rank=rank)
    try:
        mesh = make_mesh(CPU, size=world)
        inp_path = os.path.join(workdir, "in.npz")
        inp = load_tree(inp_path) if os.path.exists(inp_path) else {}
        cfg_path = os.path.join(workdir, "cfg.json")
        cfg = json.load(open(cfg_path)) if os.path.exists(cfg_path) else {}
        out = SCENARIOS[scenario](rank, world, mesh, inp, cfg)
        save_tree(os.path.join(workdir, f"out_{rank}.npz"), out)
        mesh.barrier()
    finally:
        dist.destroy_process_group()


if __name__ == "__main__":
    main()
