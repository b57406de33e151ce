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
its OWN copy: `set_params` copies the learner's model on the learner's
stream, after the step that updated it, and swaps the copy in under a
lock; the actor takes the current copy at the start of a chunk
and acts the whole chunk with it, so no chunk sees half-copied weights.
On a card the actor thread runs on a stream of its own: it waits on an
event recorded after the copy before it uses a model, the learner waits
on an event recorded after the rollout before it uses a chunk, and each
tensor that crosses is marked used on the other stream
(`record_stream`), so the caching allocator does not hand its memory out
while the other stream may still read it.

While the learner captures its step into a CUDA graph, the actor must
make no CUDA call (in the capture's global mode that call would fail):
`paused()` holds the lock the actor takes around each chunk's work on
the card, so the actor waits between chunks.

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
        self.set_params(initial_model)
        self._thread = threading.Thread(target=self._run, daemon=True,
                                        name="actor-pool")
        self._thread.start()

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
        """Publish fresh weights (picked up at the next chunk): a copy of
        `model` taken now, on the caller's stream."""
        with torch.no_grad():
            fresh = copy.deepcopy(model).requires_grad_(False)
        ready = None
        if self._cuda:
            ready = torch.cuda.Event()
            ready.record(torch.cuda.current_stream(self._device))
        with self._lock:
            self.version += 1
            self._params = (fresh, ready, self.version)

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
    def _take_params(self):
        with self._lock:
            model, ready, version = self._params
        if self._cuda:
            self._stream.wait_event(ready)
            for t in list(model.parameters()) + list(model.buffers()):
                t.record_stream(self._stream)
        return model, version

    def _run(self):
        try:
            if self._cuda:
                torch.cuda.set_device(self._device)
            while not self._stop.is_set():
                with self._acting:
                    model, version = self._take_params()
                    done = None
                    if self._cuda:
                        with torch.cuda.stream(self._stream):
                            chunk, info = self.actor.rollout(model)
                            done = torch.cuda.Event()
                            done.record(self._stream)
                    else:
                        chunk, info = self.actor.rollout(model)
                info = dict(info, params_version=version)
                while not self._stop.is_set():
                    try:
                        self._queue.put((chunk, info, done), timeout=0.5)
                        break
                    except queue.Full:
                        continue
        except BaseException as e:  # raised on the learner side
            self._exc = e
