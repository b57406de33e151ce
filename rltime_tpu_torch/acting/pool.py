"""Async acting: a background rollout thread feeding the learner (port of
`rltime_tpu/acting/pool.py`).

ONE background thread runs `Actor.rollout` and hands fixed-shape chunks
to the learner thread through a bounded queue. The learner publishes
weights with `set_params`; the actor picks them up at its next chunk
boundary, the staleness semantics of the reference's periodic refresh.
The queue holds at most `max_queue` chunks and the actor blocks when the
learner falls behind, so staleness is bounded by max_queue * chunk_len
steps. The synchronous path (the Trainer calling `Actor.rollout` inline)
stays the default: async acting trades exact reproducibility for
overlap.

Weights. The learner updates its parameters in place (on a card by a
CUDA-graph replay on the learner's stream), so the pool's actor acts on
its OWN model, one object for the pool's life (`self.model`: a captured
act step records its addresses). `set_params` stages a copy of the
learner's model on the learner's stream, after the step that updated
it, and swaps the staged copy in under a lock; at the start of a chunk
the actor copies the newest staged copy into its model, in place, and
acts the whole chunk with it, so no chunk sees half-copied weights.
On a card the actor thread runs on a stream of its own: it waits on an
event recorded after the staging copy before it copies it, the learner
waits on an event recorded after the rollout before it uses a chunk,
and each tensor that crosses is marked used on the other stream
(`record_stream`), so the caching allocator does not hand its memory out
while the other stream may still read it. A chunk whose tensors are a
graph's outputs (`DeviceActor.replays_chunk`) is cloned before it is
queued.

Captures. While the learner captures its step into a CUDA graph, the
actor must make no CUDA call (in the capture's global mode that call
would fail): `paused()` holds the lock the actor takes around each
chunk's work on the card, so the actor waits between chunks. The other
way round, the actor's own graph (a captured act step or rollout) is
captured on the actor's thread, the one that replays it, before the
learner runs: the thread acts the first chunks until the capture is
done while the constructor waits for it, so the caller (the learner) is
off the card. Those chunks are queued first. (Captured on the learner's
thread instead, the act graph shared that thread's cuBLAS workspace with
the learner's graph, and the two replaying at once on two streams read
each other's scratch memory: an illegal address or a hang on the card.)

An exception in the actor thread is raised on the learner side by the
next `get_chunk`; `close()` stops the thread, drains the queue and joins.
"""
from __future__ import annotations

import contextlib
import copy
import queue
import threading
from typing import Optional

import torch

from rltime_tpu_torch.acting.actor import Actor


class AsyncActorPool:
    """Runs an Actor on a background thread; the learner pulls chunks."""

    def __init__(self, actor: Actor, initial_model: torch.nn.Module,
                 max_queue: int = 2):
        self.actor = actor
        self._cuda = actor.device.type == "cuda"
        self._device = actor.device
        if self._cuda and self._device.index is None:
            self._device = torch.device("cuda", torch.cuda.current_device())
        self._stream = (torch.cuda.Stream(device=self._device)
                        if self._cuda else None)
        self._queue: queue.Queue = queue.Queue(maxsize=max_queue)
        self._stop = threading.Event()
        self._lock = threading.Lock()
        self._acting = threading.Lock()     # held around a chunk's CUDA work
        self._exc: Optional[BaseException] = None
        self.version = 0            # publishes so far
        self.gets = 0               # chunks handed to the learner
        self.depth_sum = 0          # queue depth summed over those
        self._params = None
        with torch.no_grad():
            self.model = copy.deepcopy(initial_model).requires_grad_(False)
        self._model_version = 0     # the publish `self.model` holds
        self.set_params(initial_model)
        self._primed = []           # the chunks acted until the capture
        self._captured = threading.Event()
        self._thread = threading.Thread(target=self._run, daemon=True,
                                        name="actor-pool")
        self._thread.start()
        self._captured.wait()
        if self._exc is not None:
            raise RuntimeError("actor thread died") from self._exc

    # -- learner side --------------------------------------------------
    def get_chunk(self, timeout: float = 300.0):
        """The next (chunk, info); blocks until the actor produced one.
        `info["params_version"]` is the publish the chunk was acted with."""
        self.depth_sum += self._queue.qsize()
        self.gets += 1
        while True:
            if self._exc is not None:
                raise RuntimeError("actor thread died") from self._exc
            try:
                chunk, info, done = self._queue.get(timeout=min(timeout, 1.0))
                break
            except queue.Empty:
                timeout -= 1.0
                if timeout <= 0:
                    raise
        if self._cuda:
            cur = torch.cuda.current_stream(self._device)
            cur.wait_event(done)
            for v in chunk.values():
                if isinstance(v, torch.Tensor) and v.is_cuda:
                    v.record_stream(cur)
        return chunk, info

    def set_params(self, model: torch.nn.Module) -> None:
        """Publish fresh weights (copied into the actor's model at its next
        chunk): a staged copy of `model` taken now, on the caller's
        stream."""
        with torch.no_grad():
            staged = copy.deepcopy(model).requires_grad_(False)
        ready = None
        if self._cuda:
            ready = torch.cuda.Event()
            ready.record(torch.cuda.current_stream(self._device))
        with self._lock:
            self.version += 1
            self._params = (staged, ready, self.version)

    @contextlib.contextmanager
    def paused(self):
        """No chunk of the actor runs on the card inside this block: it
        waits for the chunk in progress, then holds the actor back."""
        with self._acting:
            yield

    @property
    def env_steps(self) -> int:
        return self.actor.env_steps

    def episode_stats(self, clear: bool = True):
        return self.actor.episode_stats(clear)

    def close(self) -> None:
        self._stop.set()
        # drain so the producer unblocks
        try:
            while True:
                self._queue.get_nowait()
        except queue.Empty:
            pass
        self._thread.join(timeout=30)

    @property
    def mean_depth(self) -> float:
        """Chunks waiting in the queue when the learner asked, on average
        (0: the learner waits on the actor; max_queue: the other way)."""
        return self.depth_sum / max(self.gets, 1)

    @property
    def alive(self) -> bool:
        return self._thread.is_alive()

    # -- actor thread --------------------------------------------------
    def _take_params(self) -> int:
        """Copy the newest staged weights into `self.model` (in place, on
        the current stream: the actor's on a card). Returns the publish
        the model now holds."""
        with self._lock:
            staged, ready, version = self._params
        if version != self._model_version:
            if self._cuda:
                self._stream.wait_event(ready)
            with torch.no_grad():
                for dst, src in zip(_tensors(self.model), _tensors(staged)):
                    dst.copy_(src)
                    if self._cuda:
                        src.record_stream(self._stream)
            self._model_version = version
        return version

    def _act(self):
        """One chunk with the newest weights: (chunk, info, done event)."""
        with (torch.cuda.stream(self._stream) if self._cuda
              else contextlib.nullcontext()):
            version = self._take_params()
            chunk, info = self.actor.rollout(self.model)
            if getattr(self.actor, "replays_chunk", False):
                chunk = {k: v.clone() if isinstance(v, torch.Tensor) else v
                         for k, v in chunk.items()}
            done = None
            if self._cuda:
                done = torch.cuda.Event()
                done.record(self._stream)
        return chunk, dict(info, params_version=version), done

    def _run(self):
        try:
            if self._cuda:
                torch.cuda.set_device(self._device)
            graph = getattr(self.actor, "graph", None)
            while graph is not None and graph.graph is None:
                self._primed.append(self._act())
            self._captured.set()
            while not self._stop.is_set():
                if self._primed:
                    item = self._primed.pop(0)
                else:
                    with self._acting:
                        item = self._act()
                while not self._stop.is_set():
                    try:
                        self._queue.put(item, timeout=0.5)
                        break
                    except queue.Full:
                        continue
        except BaseException as e:  # raised on the learner side
            self._exc = e
        finally:
            self._captured.set()


def _tensors(model: torch.nn.Module):
    return list(model.parameters()) + list(model.buffers())
