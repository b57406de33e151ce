"""Run the port on several gloo ranks from a test (no jax import).

`run_ranks(scenario, world, workdir)` starts `world` processes of
`torch_port_mp_worker.py`, one per rank, which meet through a
`file://` rendezvous under `workdir` (no TCP port, so parallel test
workers cannot collide) and run the named scenario. Inputs go in as
`workdir/in.npz` (`save_tree`), results come back as
`workdir/out_<rank>.npz` (`load_tree`). Each spawn has its own timeout.

Nested dicts and lists of arrays cross as flat npz keys: a dict key
stays a path element, a list index becomes `#<i>`.
"""
import os
import subprocess
import sys
import time

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
WORKER = os.path.join(HERE, "torch_port_mp_worker.py")


def _flatten(tree, prefix, out):
    if isinstance(tree, dict):
        for k, v in tree.items():
            assert "/" not in str(k) and not str(k).startswith("#"), k
            _flatten(v, f"{prefix}{k}/", out)
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            _flatten(v, f"{prefix}#{i}/", out)
    else:
        out[prefix[:-1]] = np.asarray(tree)


def save_tree(path, tree):
    flat = {}
    _flatten(tree, "", flat)
    np.savez(path, **flat)


def _insert(node, parts, value):
    head, rest = parts[0], parts[1:]
    if not rest:
        node[head] = value
        return
    _insert(node.setdefault(head, {}), rest, value)


def _listify(node):
    if not isinstance(node, dict):
        return node
    node = {k: _listify(v) for k, v in node.items()}
    if node and all(k.startswith("#") for k in node):
        return [node[f"#{i}"] for i in range(len(node))]
    return node


def load_tree(path):
    root = {}
    with np.load(path) as z:
        for key in z.files:
            _insert(root, key.split("/"), z[key])
    return _listify(root)


def run_ranks(scenario, world, workdir, timeout=120):
    """Run `scenario` on `world` gloo ranks; returns each rank's output
    tree (rank order). When a rank fails the others are stopped, and the
    failure shows every rank's log."""
    os.makedirs(workdir, exist_ok=True)
    env = {k: v for k, v in os.environ.items()
           if k not in ("XLA_FLAGS", "JAX_PLATFORMS")}
    env["PYTHONPATH"] = (os.path.dirname(HERE) + os.pathsep
                         + env.get("PYTHONPATH", ""))
    env["OMP_NUM_THREADS"] = "1"
    logs = [os.path.join(workdir, f"log_{r}.txt") for r in range(world)]
    procs = []
    for r in range(world):
        with open(logs[r], "w") as f:
            procs.append(subprocess.Popen(
                [sys.executable, WORKER, scenario, str(r), str(world),
                 str(workdir)], stdout=f, stderr=subprocess.STDOUT, env=env))
    deadline = time.monotonic() + timeout
    try:
        while any(p.poll() is None for p in procs):
            if (time.monotonic() > deadline
                    or any(p.poll() not in (None, 0) for p in procs)):
                break
            time.sleep(0.05)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
            p.wait()
    if any(p.returncode != 0 for p in procs):
        text = "\n".join(f"--- rank {r} (rc={p.returncode}):\n"
                         + open(logs[r]).read()[-4000:]
                         for r, p in enumerate(procs))
        raise AssertionError(f"{scenario} on {world} ranks failed:\n{text}")
    return [load_tree(os.path.join(workdir, f"out_{r}.npz"))
            for r in range(world)]
