"""What the mesh's collectives cost on one card. (A script, not a test:
it needs a card.)

    python tests/torch_port_collective_cost.py [--calls N]

On a one-rank NCCL group and on the identity mesh, times each collective
one learner update of config #5 issues (`parallel/mesh.py`): the
gradient all-reduce at the Nature CNN's parameters (`Mesh.mean_grads`:
the flatten, the all-reduce, the division, the views), the 20-byte
metrics buffer (`mean_metrics`) and the 4-byte MAX (`max_`). Per call:
the host time to enqueue it, the host time to a synchronise over N calls,
and the device time between CUDA events. The last line is one JSON
object.
"""
import argparse
import json
import os
import subprocess
import sys
import tempfile
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _time(fn, calls):
    import torch
    for _ in range(10):
        fn()
    torch.cuda.synchronize()
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    t0 = time.perf_counter()
    start.record()
    for _ in range(calls):
        fn()
    enqueue = time.perf_counter() - t0
    end.record()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    return dict(enqueue_ms=enqueue / calls * 1e3, host_ms=wall / calls * 1e3,
                device_ms=start.elapsed_time(end) / calls)


def main():
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--calls", type=int, default=200)
    args = ap.parse_args()
    sys.path.insert(0, ROOT)
    import torch
    import torch.distributed as dist
    from rltime_tpu_torch.config.config import load_config
    from rltime_tpu_torch.models.policy import QPolicy
    from rltime_tpu_torch.parallel.mesh import identity_mesh, make_mesh
    from rltime_tpu_torch.training.trainer import _mk_model_cfg
    dev = torch.device("cuda", 0)
    cfg = load_config("apex_multihost_counting")
    mc = _mk_model_cfg(cfg["model"], 6)
    model = QPolicy(mc, (4, 84, 84), torch.Generator().manual_seed(0)).to(dev)
    grads = [torch.randn_like(p) for p in model.parameters()]
    metrics = {k: torch.rand((), device=dev)
               for k in ("loss", "q", "td_abs", "grad_norm", "mean_weight")}
    scalar = torch.rand((), device=dev)
    rdv = tempfile.mkdtemp(prefix="collective_cost_")
    dist.init_process_group("nccl", init_method=f"file://{rdv}/f",
                            world_size=1, rank=0, device_id=dev)
    out = dict(device=torch.cuda.get_device_name(0),
               power=subprocess.run(
                   ["nvidia-smi", "--query-gpu=name,power.limit",
                    "--format=csv,noheader"], capture_output=True,
                   text=True).stdout.strip(),
               params=sum(g.numel() for g in grads), calls=args.calls)
    try:
        for tag, mesh in (("nccl", make_mesh(dev, size=1)),
                          ("identity", identity_mesh(dev))):
            out[tag] = dict(
                grad=_time(lambda: mesh.mean_grads(grads), args.calls),
                metrics=_time(lambda: mesh.mean_metrics(metrics), args.calls),
                max=_time(lambda: mesh.max_(scalar, "max_priority"),
                          args.calls))
    finally:
        dist.destroy_process_group()
    print(json.dumps(out), flush=True)


if __name__ == "__main__":
    main()
