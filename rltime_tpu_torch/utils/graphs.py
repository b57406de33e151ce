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
    into (device to device, no host sync), and its outputs are the
    capture's own tensors, overwritten by each replay;
  * every `torch.Generator` the step draws from is registered with the
    graph, so each replay draws fresh numbers from the generator's state
    at that replay, and advances it, as the eager step would;
  * state that the step updates in place (parameters, optimizer moments,
    replay rings, device counters) carries over from replay to replay;
    a step must write what it carries back into the same tensors.

A graph records device addresses, so the step must allocate nothing
that outlives it, read no host value that changes between calls, and
never sync (`torch.cuda.set_sync_debug_mode("error")` shows one). There
is no capture on the CPU: the CPU route calls the step itself.

A caller that reads the graph back (`kernel_counts`, for the checks on
the card) sets `debug = True` before the capturing call, on the step or
on the class (for steps that an entry point builds); only then is the
captured `cudaGraph_t` kept beside its executable.
"""
from __future__ import annotations

import re
from typing import Callable, Dict, Sequence

import torch


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

    def __call__(self, *inputs: torch.Tensor):
        if len(inputs) != len(self.static_inputs):
            raise ValueError(f"expected {len(self.static_inputs)} inputs, "
                             f"got {len(inputs)}")
        for buf, x in zip(self.static_inputs, inputs):
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
            self._capture()
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
        with torch.cuda.device(self.device), torch.cuda.graph(graph):
            self.output = self.fn(*self.static_inputs)
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


def _indexed(device: torch.device) -> torch.device:
    """`cuda` as `cuda:<current device>`, so two names of one card agree."""
    if device.type == "cuda" and device.index is None:
        return torch.device("cuda", torch.cuda.current_device())
    return device


def _node_labels(dot: str) -> list:
    """The label of every node of a Graphviz dump of a CUDA graph."""
    return re.findall(r'\blabel="((?:[^"\\]|\\.)*)"', dot)
