"""Tracing and phase timers (port of `rltime_tpu/utils/profiling.py`).

  * `trace(log_dir)`: a `torch.profiler` capture of everything inside
    the context (CPU activity, and CUDA activity where a card is
    present), written as a TensorBoard / Chrome trace into `log_dir`
    (`train.profile_dir`).
  * `start_server(port, log_dir)`: the counterpart of
    `jax.profiler.start_server`, an on-demand capture endpoint
    (`train.profile_port`). PyTorch has none, so a small `http.server`
    on a daemon thread, bound to localhost, serves
    `GET /trace?chunks=N`: it arms a capture of the trainer's next N
    chunks into `<log_dir>/profile/<time>/` and answers with that
    directory as JSON. The trainer brackets each chunk with
    `ProfileServer.chunk()`, which starts and stops the capture on the
    training thread.
  * `PhaseTimers`: cheap wall-clock accounting of the trainer phases
    (act / insert / insert+update), logged as scalars per log interval
    and marked as `phase/<name>` ranges in a trace. CUDA work is
    asynchronous, so a phase that launches device work passes `sync`
    (its device) to end only when the device has finished.
"""
from __future__ import annotations

import contextlib
import json
import os
import threading
import time
from collections import defaultdict
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Dict, Optional
from urllib.parse import parse_qs, urlparse

import torch


@contextlib.contextmanager
def trace(log_dir: str):
    """Capture a trace viewable in TensorBoard or chrome://tracing."""
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    handler = torch.profiler.tensorboard_trace_handler(log_dir)
    with torch.profiler.profile(activities=acts,
                                on_trace_ready=handler) as prof:
        yield prof


class ProfileServer:
    """The capture endpoint `start_server` runs (see the module doc)."""

    def __init__(self, port: int, log_dir: str):
        self.log_dir = log_dir
        self.captures: list = []          # directories of finished captures
        self._lock = threading.Lock()
        self._arms = 0                    # requests served
        self._armed = 0                   # chunks asked for, not started
        self._dir = ""                    # ... and where they go
        self._left = 0                    # chunks left in the running one
        self._ctx = None
        self._ctx_dir = ""
        server = self

        class Handler(BaseHTTPRequestHandler):
            def do_GET(self):
                url = urlparse(self.path)
                try:
                    n = int(parse_qs(url.query).get("chunks", ["1"])[0])
                except ValueError:
                    n = 0
                if url.path != "/trace" or n < 1:
                    self.send_error(400, "use GET /trace?chunks=N, N >= 1")
                    return
                body = json.dumps({"chunks": n,
                                   "dir": server.arm(n)}).encode()
                self.send_response(200)
                self.send_header("Content-Type", "application/json")
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def log_message(self, *args):
                pass

        self._httpd = ThreadingHTTPServer(("127.0.0.1", port), Handler)
        self.port = self._httpd.server_address[1]
        threading.Thread(target=self._httpd.serve_forever,
                         daemon=True).start()

    def arm(self, chunks: int) -> str:
        with self._lock:
            self._arms += 1
            self._armed = chunks
            self._dir = os.path.join(
                self.log_dir, "profile",
                f"{time.strftime('%Y%m%d-%H%M%S')}-{self._arms}")
            return self._dir

    @contextlib.contextmanager
    def chunk(self):
        """Bracket one trainer chunk: start an armed capture before it,
        stop the capture after its last chunk."""
        with self._lock:
            if self._ctx is None and self._armed:
                self._left, self._armed = self._armed, 0
                self._ctx_dir = self._dir
                self._ctx = trace(self._ctx_dir)
                self._ctx.__enter__()
        try:
            yield
        finally:
            if self._ctx is not None:
                self._left -= 1
                if self._left == 0:
                    self._ctx.__exit__(None, None, None)
                    self._ctx = None
                    self.captures.append(self._ctx_dir)

    def close(self):
        self._httpd.shutdown()
        self._httpd.server_close()


def start_server(port: int, log_dir: str) -> ProfileServer:
    """On-demand capture endpoint on localhost:`port` (0: any free port,
    read back from `.port`); captures go under `log_dir`."""
    return ProfileServer(port, log_dir)


class PhaseTimers:
    """Accumulate per-phase seconds between logs."""

    def __init__(self):
        self._acc: Dict[str, float] = defaultdict(float)

    @contextlib.contextmanager
    def phase(self, name: str, sync: Optional[torch.device] = None):
        """Time the block; in a torch.profiler trace it is the range
        `phase/<name>`."""
        t0 = time.perf_counter()
        try:
            with torch.profiler.record_function(f"phase/{name}"):
                yield
                if sync is not None and sync.type == "cuda":
                    torch.cuda.synchronize(sync)
        finally:
            self._acc[name] += time.perf_counter() - t0

    def pop(self) -> Dict[str, float]:
        out = dict(self._acc)
        self._acc.clear()
        return out
