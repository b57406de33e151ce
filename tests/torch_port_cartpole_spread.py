"""The spread of config #1's learning-run score (PERF.md quotes it).

Not a test. Prints, for each seed, `eval --best` over 10 episodes after
the 400k-step run of `cartpole_dqn` on the CPU: of the port (`port`), of
the JAX package (`jax`), of the JAX package at seed 0 with its initial
weights perturbed by 1e-6 relative (`perturb`: the mean training return
of each 20,480-step window), and (`cross`) of the JAX run's best weights
acting through the port's actor.

    PYTHONPATH=. python tests/torch_port_cartpole_spread.py \
        [port|jax|perturb|cross] [seeds...]

`summary LOG...` reads the `port seed N {...}` and `jax seed N {...}`
lines of such runs' output and prints, per side, the number of seeds,
the median score, how many reach the bar (475), and a two-sided Fisher
exact test of those two counts.
"""
import sys
import tempfile

import jax
import jax.numpy as jnp
import numpy as np
import torch

import torch_port_draws as draws_lib
from rltime_tpu.training.trainer import Trainer as JTrainer
from rltime_tpu_torch import eval as teval
from rltime_tpu_torch import train as ttrain
from rltime_tpu_torch.config.config import load_config
from rltime_tpu_torch.models import bridge
from rltime_tpu_torch.training.trainer import Trainer


def _config():
    cfg = load_config("cartpole_dqn")
    cfg["train"].update(log_interval=10**9, checkpoint_interval=10**9)
    return cfg


def _port_score(seed, root):
    rd = f"{root}/port_seed{seed}"
    ttrain.run(["cartpole_dqn", "--device", "cpu", "--result-dir", rd,
                f"--seed={seed}"])
    return teval.evaluate(rd, episodes=10, best=True, device="cpu")


def _jax_score(seed, root):
    from rltime_tpu import eval as jeval
    cfg = load_config("cartpole_dqn")
    cfg["seed"] = seed
    rd = f"{root}/jax_seed{seed}"
    JTrainer(cfg, rd).train()
    return jeval.evaluate(rd, episodes=10, best=True)


def _jax_perturbed(seed, root, scale=1e-6):
    """Seed 0 as written, the initial weights times (1 + scale * N(0, 1))
    drawn from `seed`: the mean training return of each 40-chunk window
    (20,480 env steps)."""
    jt = JTrainer(_config(), f"{root}/jax_perturbed{seed}")
    rng = np.random.default_rng(seed)
    params = jax.tree.map(
        lambda x: x * (1.0 + scale * jnp.asarray(
            rng.standard_normal(x.shape).astype(np.float32))),
        jt.train_state.params)
    jt.train_state = jt.train_state.replace(
        params=params, target_params=jax.tree.map(jnp.copy, params))
    curve = []
    for c in range(782):                # 400,384 env steps
        jt.train_chunk()
        if c % 40 == 39:
            rets, _ = jt.actor.episode_stats()
            curve.append(round(float(np.mean(rets)), 1) if rets else None)
    return curve


def _jax_weights_through_port_actor(seed, root):
    """Train the JAX package, bridge its best checkpoint's weights into
    the port's net and play 10 episodes with the port's host actor."""
    from rltime_tpu.training import checkpoint as jckpt
    from rltime_tpu_torch.acting.actor import Actor
    from rltime_tpu_torch.envs.cartpole import CartPoleVecEnv
    from rltime_tpu_torch.models.policy import QPolicy
    cfg = load_config("cartpole_dqn")
    cfg["seed"] = seed
    rd = f"{root}/jax_cross{seed}"
    jt = JTrainer(cfg, rd).train()
    best = jckpt.best_step(rd)
    params = jckpt.restore(rd, best["step"])["train_state"]["params"]
    tt = Trainer(cfg, f"{root}/port_cross{seed}", device="cpu")
    model = QPolicy(tt.model_cfg, (4,))
    model.load_state_dict(bridge.flax_to_state_dict(
        tt.model_cfg, draws_lib.np_tree(params)))
    actor = Actor(CartPoleVecEnv(10, seed=1234), tt.model_cfg, 1,
                  teval._FixedEps(1e-3), torch.Generator().manual_seed(0),
                  64, torch.device("cpu"))
    rets = []
    while len(rets) < 10:
        actor.rollout(model)
        rets += actor.episode_stats()[0]
    del jt
    return dict(jax_best_step=best["step"], jax_best_score=best["score"],
                port_actor_returns=rets[:10])


def summary(paths, bar=475.0):
    """Per side: seeds, median, how many reach `bar`; Fisher's p."""
    import ast
    import re

    from scipy.stats import fisher_exact
    scores = {"port": {}, "jax": {}}
    for path in paths:
        with open(path) as f:
            for line in f:
                m = re.match(r"(port|jax) seed (\d+) (\{.*\})$", line.strip())
                if m:
                    rec = ast.literal_eval(m.group(3))
                    scores[m.group(1)][int(m.group(2))] = rec["return_mean"]
    out = {}
    for side, by_seed in scores.items():
        vals = [by_seed[k] for k in sorted(by_seed)]
        out[side] = dict(seeds=len(vals), median=float(np.median(vals)),
                         reach=sum(v >= bar for v in vals),
                         scores=dict(sorted(by_seed.items())))
    table = [[out[s]["reach"], out[s]["seeds"] - out[s]["reach"]]
             for s in ("port", "jax")]
    out["fisher_two_sided_p"] = float(fisher_exact(table)[1])
    return out


if __name__ == "__main__":
    if sys.argv[1:2] == ["summary"]:
        print(summary(sys.argv[2:]))
        sys.exit(0)
    jax.config.update("jax_platforms", "cpu")
    what = sys.argv[1] if len(sys.argv) > 1 else "port"
    seeds = [int(s) for s in sys.argv[2:]] or [0, 1, 2]
    fn = {"port": _port_score, "jax": _jax_score, "perturb": _jax_perturbed,
          "cross": _jax_weights_through_port_actor}[what]
    with tempfile.TemporaryDirectory() as root:
        for seed in seeds:
            print(what, "seed", seed, fn(seed, root), flush=True)
