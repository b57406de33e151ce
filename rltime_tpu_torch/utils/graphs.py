"""CUDA-graph capture of a step: the port's counterpart of one jitted
XLA program per dispatch.

The JAX package needs no such module: `jax.jit` traces a step once and
every call is one dispatch. PyTorch runs eagerly, one launch per op, and
a learner update is hundreds of launches (PERF.md §5: every eager path
is host-bound). `GraphedStep` records a step's launches once into a
`torch.cuda.CUDAGraph` and replays them with one call:

  * the first `WARMUP` calls run the step eagerly on a side stream (they
    are real work: cuDNN and cuBLAS choose their algorithms, the
    optimizer makes its state, autograd sets up its streams), and the
    call after them captures it and replays the graph;
  * the step reads its inputs from static buffers that every call copies
    into (device to device, no host sync; a numpy array crosses from the
    host), and its outputs are the capture's own tensors, overwritten by
    each replay;
  * every `torch.Generator` the step draws from is registered with the
    graph, so each replay draws fresh numbers from the generator's state
    at that replay, and advances it, as the eager step would;
  * state that the step updates in place (parameters, optimizer moments,
    replay rings, device counters) carries over from replay to replay;
    a step must write what it carries back into the same tensors;
  * collectives the step issues (`parallel/mesh.py`) are recorded in
    `parallel/census.py` once, while it is captured; every later replay
    adds them again.

While a graph is captured, CUDA forbids calls that could sync with it
(torch's default, global mode: in any thread of the process). Two kinds
would come from outside the step: another thread's work on the card
(the async acting pool), which the caller pauses for the capture
(`__call__`'s `quiet`), and the destructor of a graph that dies
meanwhile, which voids the capture. Dead trainers hold their graphs in
reference cycles, so the capture collects them first and keeps
Python's collector off until it ends (on the card a capture failed
that way once earlier graphs had been dropped).

The actors' graphs (an act step, `acting/actor.py`; a device rollout,
`acting/device_actor.py`) are captured in global mode too. Under
`train.async_acting` they are captured and replayed on the pool's
thread while the learner is held off the card: the pool's constructor
waits until the thread's first chunks have captured the actor's graph
(`acting/pool.py`). Global mode thus keeps its check that nothing else
touches the card during a capture (`thread_local` mode would drop it),
and the learner needs no lock around all of its card work (logging and
checkpoints included). The thread matters: torch keeps cuBLAS's
workspace per thread (and stream), and a captured matmul keeps the
workspace's address. Two graphs captured on one thread share it, which
is safe while they replay one after the other on one stream (the
synchronous trainer) but not when two threads replay them at once: on
the card an act graph captured on the learner's thread and replayed by
the pool beside the learner's graph hung the card, or faulted on an
illegal address.

A graph records device addresses, so the step must allocate nothing
that outlives it, read no host value that changes between calls, and
never sync (`torch.cuda.set_sync_debug_mode("error")` shows one). There
is no capture on the CPU: the CPU route calls the step itself.

Two streams inside one graph (`SideStream`; the pipelined learner step
of `training/learner.py` is the one user). A step may fork work that
only reads state onto one side stream, made once, so that it overlaps
the work that follows on the current stream; the capture records the
fork and the join as edges between two branches. The rule:
  * the fork waits on `torch.cuda.current_stream()`, never the default
    stream (`GraphedStep` runs its warm-ups on a stream of its own);
  * what the side stream writes goes into buffers made before the
    capture and kept by the step, so no tensor crosses between the two
    streams' allocator pools;
  * the current stream joins the side stream before it writes anything
    the side stream reads, or frees a tensor the side stream reads, and
    before the step ends (a capture with a branch left unjoined fails);
  * nothing on the side stream calls cuBLAS: its workspace is per
    thread and stream, and a captured matmul keeps its address (below).
On the CPU there are no streams and the same body runs in program
order, which is what the CPU tests hold against the JAX package.

A caller that reads the graph back (`kernel_counts`, and
`concurrent_nodes` on the dump it writes, for the checks on the card)
sets `debug = True` before the capturing call, on the step or on the
class (for steps that an entry point builds); only then is the captured
`cudaGraph_t` kept beside its executable.
"""
from __future__ import annotations

import contextlib
import gc
import re
from typing import Callable, Dict, Sequence

import numpy as np
import torch

from rltime_tpu_torch.parallel import census


class GraphedStep:
    """fn(*static_inputs) as one CUDA-graph replay per call (see the
    module doc). `static_inputs` are CUDA tensors the step reads;
    `generators` the CUDA generators it draws from."""

    WARMUP = 2      # eager calls before the capture
    debug = False   # keep the captured graph for `kernel_counts`

    def __init__(self, fn: Callable, static_inputs: Sequence[torch.Tensor],
                 generators: Sequence[torch.Generator] = ()):
        devices = {_indexed(t.device) for t in static_inputs} | {
            _indexed(g.device) for g in generators}
        if len(devices) != 1 or next(iter(devices)).type != "cuda":
            raise RuntimeError(
                "CUDA-graph capture needs its inputs and generators on one "
                f"CUDA device, got {sorted(map(str, devices))}; on the CPU "
                "call the step itself")
        if not hasattr(torch.cuda.CUDAGraph, "register_generator_state"):
            raise RuntimeError(
                "this torch has no CUDAGraph.register_generator_state: a "
                "captured step would replay the draws of its capture")
        self.fn = fn
        self.static_inputs = list(static_inputs)
        self.generators = list(generators)
        self.device = next(iter(devices))
        self.calls = 0
        self.replays = 0
        self.graph = None
        self.kept = False   # the capture kept its cudaGraph_t (debug)
        self.output = None
        self.census: Dict = {}   # the collectives one replay issues

    def __call__(self, *inputs: torch.Tensor, quiet=None):
        """Copy `inputs` into the static buffers and run the step: eagerly
        for the first WARMUP calls, then captured, then replayed.
        `quiet`: a context manager that keeps other threads off the card
        while the capturing call runs."""
        if len(inputs) != len(self.static_inputs):
            raise ValueError(f"expected {len(self.static_inputs)} inputs, "
                             f"got {len(inputs)}")
        for buf, x in zip(self.static_inputs, inputs):
            if isinstance(x, np.ndarray):
                x = torch.from_numpy(np.ascontiguousarray(x))
            if x is not buf:
                if x.shape != buf.shape or x.dtype != buf.dtype:
                    raise ValueError(
                        f"input {tuple(x.shape)} {x.dtype} does not match "
                        f"its buffer {tuple(buf.shape)} {buf.dtype}")
                buf.copy_(x)
        self.calls += 1
        if self.graph is None:
            if self.calls <= self.WARMUP:
                return self._eager()
            before = dict(census.COUNTS)
            with quiet if quiet is not None else contextlib.nullcontext():
                self._capture()
            self.census = {k: n - before.get(k, 0)
                           for k, n in census.COUNTS.items()
                           if n > before.get(k, 0)}
        else:
            census.add(self.census)
        self.graph.replay()
        self.replays += 1
        return self.output

    def _eager(self):
        main = torch.cuda.current_stream(self.device)
        side = torch.cuda.Stream(self.device)
        side.wait_stream(main)
        with torch.cuda.stream(side):
            out = self.fn(*self.static_inputs)
        main.wait_stream(side)
        return out

    def _capture(self) -> None:
        graph = torch.cuda.CUDAGraph(keep_graph=self.debug)
        if self.debug:      # keep the cudaGraph_t for debug_dump
            graph.enable_debug_mode()
        for gen in self.generators:
            graph.register_generator_state(gen)
        gc.collect()        # no graph may be freed during the capture
        collecting = gc.isenabled()
        gc.disable()
        try:
            with torch.cuda.device(self.device), torch.cuda.graph(graph):
                self.output = self.fn(*self.static_inputs)
        finally:
            if collecting:
                gc.enable()
        self.graph, self.kept = graph, self.debug

    def kernel_counts(self, names: Sequence[str], path: str) -> Dict[str, int]:
        """How many kernel nodes of the captured graph launch a kernel
        whose name contains each of `names`, read from the graph's
        Graphviz dump (`CUDAGraph.debug_dump`, written to `path`)."""
        if self.graph is None or not self.kept:
            raise RuntimeError("no graph captured with debug = True")
        self.graph.debug_dump(path)
        with open(path) as f:
            nodes = _node_labels(f.read())
        return {name: sum(name in label for label in nodes) for name in names}


class SideStream:
    """One side stream for read-only work that overlaps the current
    stream's (the rule is in the module doc). `fork(device)` runs its
    block on the side stream after all work already queued on the
    current stream; `join()` makes the current stream wait for what was
    forked, and does nothing when nothing was forked since the last
    join. On the CPU both do nothing. The stream is made at the first
    fork onto a card and kept."""

    def __init__(self):
        self.stream = None
        self.pending = False    # forked work the current stream has not joined

    @contextlib.contextmanager
    def fork(self, device: torch.device):
        if device.type != "cuda":
            yield
            return
        if self.stream is None:
            self.stream = torch.cuda.Stream(device)
        self.stream.wait_stream(torch.cuda.current_stream(device))
        self.pending = True
        with torch.cuda.stream(self.stream):
            yield

    def join(self) -> None:
        if self.pending:
            torch.cuda.current_stream(self.stream.device).wait_stream(
                self.stream)
            self.pending = False


def _indexed(device: torch.device) -> torch.device:
    """`cuda` as `cuda:<current device>`, so two names of one card agree."""
    if device.type == "cuda" and device.index is None:
        return torch.device("cuda", torch.cuda.current_device())
    return device


def _node_labels(dot: str) -> list:
    """The label of every node of a Graphviz dump of a CUDA graph."""
    return re.findall(r'\blabel="((?:[^"\\]|\\.)*)"', dot)


_NODE = re.compile(r'"([^"]+)"\s*\[(?:[^\]"]|"(?:[^"\\]|\\.)*")*?'
                   r'\blabel="((?:[^"\\]|\\.)*)"')
_EDGE = re.compile(r'"([^"]+)"\s*->\s*"([^"]+)"')


def _nodes_and_edges(dot: str):
    """({node id: label}, [(from, to)]) of a Graphviz dump of a CUDA
    graph."""
    labels = {m.group(1): m.group(2) for m in _NODE.finditer(dot)}
    edges = [e for e in _EDGE.findall(dot)
             if e[0] in labels and e[1] in labels]
    return labels, edges


def concurrent_nodes(dot: str, names: Sequence[str]) -> Dict[str, int]:
    """How many nodes of a Graphviz dump of a CUDA graph whose label
    contains each of `names` have some other node on a parallel branch:
    neither its ancestor nor its descendant. A capture on one stream is
    a chain and has none; a node counted here runs beside other work (a
    side stream's fork)."""
    labels, edges = _nodes_and_edges(dot)
    nodes = set(labels)
    children: Dict[str, list] = {n: [] for n in labels}
    parents: Dict[str, list] = {n: [] for n in labels}
    for a, b in edges:
        children[a].append(b)
        parents[b].append(a)
    out = {}
    for name in names:
        count = 0
        for node in (n for n in nodes if name in labels[n]):
            ordered = _reach(node, children) | _reach(node, parents) | {node}
            count += bool(nodes - ordered)
        out[name] = count
    return out


def _reach(node: str, step: Dict[str, list]) -> set:
    """Every node reachable from `node` along `step` (not `node`)."""
    seen, todo = set(), list(step[node])
    while todo:
        n = todo.pop()
        if n not in seen:
            seen.add(n)
            todo.extend(step[n])
    return seen
