"""`utils/profiling.py`: torch.profiler traces and the capture endpoint.

`trace(dir)` writes a Chrome/TensorBoard trace holding the ops run inside
it; `start_server(port, dir)` answers `GET /trace?chunks=N` by arming a
capture of the next N chunks, which `chunk()` starts and stops.
"""
import json
import os
import urllib.error
import urllib.request

import pytest
import torch

from rltime_tpu_torch.utils import profiling


def _events(trace_dir):
    files = [f for f in os.listdir(trace_dir) if f.endswith(".json")]
    assert len(files) == 1, files
    with open(os.path.join(trace_dir, files[0])) as f:
        return [e.get("name", "") for e in json.load(f)["traceEvents"]]


def test_trace_writes_a_trace(tmp_path):
    a = torch.ones((64, 64))
    with profiling.trace(str(tmp_path / "t")):
        (a @ a).sum()
    names = _events(str(tmp_path / "t"))
    assert "aten::mm" in names and "aten::sum" in names


def test_server_captures_the_armed_chunks(tmp_path):
    server = profiling.start_server(0, str(tmp_path))
    try:
        base = f"http://127.0.0.1:{server.port}"
        with pytest.raises(urllib.error.HTTPError):
            urllib.request.urlopen(f"{base}/trace?chunks=0", timeout=30)
        a = torch.ones((32, 32))
        with server.chunk():             # not armed: nothing captured
            a @ a
        with urllib.request.urlopen(f"{base}/trace?chunks=2",
                                    timeout=30) as r:
            armed = json.loads(r.read())
        assert armed["chunks"] == 2
        assert armed["dir"].startswith(str(tmp_path / "profile"))
        with server.chunk():
            a @ a
        assert server.captures == []     # one chunk of two so far
        with server.chunk():
            a.sum()
        with server.chunk():             # after the capture: not traced
            a.mean()
        assert server.captures == [armed["dir"]]
        names = _events(armed["dir"])
        assert "aten::mm" in names and "aten::sum" in names
        assert "aten::mean" not in names
    finally:
        server.close()
