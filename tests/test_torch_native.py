"""The port's C++ lane pool (`envs/native`) against the JAX package's.

Mirrors tests/test_native.py on the port's bindings and its copy of
`stepper.cpp`, and holds both libraries bit-equal (tolerance 0: same
source, same flags) for the same seed, thread count and actions.
"""
import ctypes
import glob
import os
import shutil
import subprocess
import sys

import numpy as np
import pytest

from rltime_tpu_torch.envs.native import bindings
from torch_port_native import jax_native_lib  # noqa: F401  (fixture)

pytestmark = pytest.mark.skipif(shutil.which("g++") is None,
                                reason="no g++ toolchain")


def test_build_and_basic_step():
    env = bindings.NativeCartPoleVecEnv(16, seed=0, num_threads=1)
    obs = env.reset(0)
    assert obs.shape == (16, 4) and obs.dtype == np.float32
    assert np.all(np.abs(obs) <= 0.05)
    o, r, tm, tr = env.step(np.ones(16, np.int32))
    assert o.shape == (16, 4)
    np.testing.assert_allclose(r, 1.0)
    assert tm.dtype == bool and tr.dtype == bool
    env.close()


def test_dynamics_match_numpy_engine():
    """Same random policy: the C++ lanes and the numpy CartPole give the
    same episode-length distribution (their init RNGs differ)."""
    from rltime_tpu_torch.envs.cartpole import CartPoleVecEnv
    E, S = 256, 300
    acts = np.random.default_rng(0).integers(0, 2, (S, E)).astype(np.int32)
    lens = []
    for env in (bindings.NativeCartPoleVecEnv(E, seed=0, num_threads=1),
                CartPoleVecEnv(E, seed=0)):
        env.reset(0)
        steps, out = np.zeros(E), []
        for t in range(S):
            _, _, tm, tr = env.step(acts[t])
            d = tm | tr
            steps += 1
            out.extend(steps[d].tolist())
            steps[d] = 0
        lens.append(out)
    assert len(lens[0]) > 100 and len(lens[1]) > 100
    m_n, m_r = np.mean(lens[0]), np.mean(lens[1])
    assert abs(m_n - m_r) / m_r < 0.15, (m_n, m_r)


def test_step_many_matches_stepwise():
    E, S = 32, 50
    acts = np.random.default_rng(1).integers(0, 2, (S, E)).astype(np.int32)
    a = bindings.NativeCartPoleVecEnv(E, seed=3, num_threads=1)
    b = bindings.NativeCartPoleVecEnv(E, seed=3, num_threads=1)
    a.reset(7)
    b.reset(7)
    obs_m, rew_m, term_m, trunc_m = a.step_many(acts)
    for t in range(S):
        o, r, tm, tr = b.step(acts[t])
        np.testing.assert_array_equal(obs_m[t], o)
        np.testing.assert_array_equal(rew_m[t], r)
        np.testing.assert_array_equal(term_m[t], tm)
        np.testing.assert_array_equal(trunc_m[t], tr)


@pytest.mark.parametrize("spec", [
    {"type": "cartpole_native", "num_envs": 4},
    {"type": "atari_native", "num_envs": 2, "num_threads": 1},
])
def test_registry_buildable(spec):
    import rltime_tpu_torch.envs  # noqa: F401  (registers)
    from rltime_tpu_torch.config.config import build
    env = build(spec)
    assert env.reset(0).shape[0] == spec["num_envs"]
    env.close()


def test_tsan_build_clean():
    """The ThreadSanitizer build of the lane pool steps 2 threads over
    256 lanes cleanly: any reported race fails through the exit code."""
    tsan_so = (glob.glob("/lib/x86_64-linux-gnu/libtsan.so.*")
               + glob.glob("/usr/lib/x86_64-linux-gnu/libtsan.so.*"))
    if not tsan_so:
        pytest.skip("libtsan runtime not found")
    lib = bindings.build_library(tsan=True)
    code = f"""
import ctypes, numpy as np
lib = ctypes.CDLL({lib!r})
lib.cartpole_create.restype = ctypes.c_void_p
lib.cartpole_create.argtypes = [ctypes.c_int32, ctypes.c_uint64,
                                ctypes.c_int32, ctypes.c_int32]
h = lib.cartpole_create(256, 0, 2, 500)
E = 256
obs = np.empty((E,4), np.float32); rew = np.empty(E, np.float32)
term = np.empty(E, np.uint8); trunc = np.empty(E, np.uint8)
a = np.random.randint(0,2,E).astype(np.int32)
p = lambda x: x.ctypes.data_as(ctypes.c_void_p)
for _ in range(200):
    lib.cartpole_step(ctypes.c_void_p(h), p(a), p(obs), p(rew),
                      p(term), p(trunc))
lib.cartpole_destroy(ctypes.c_void_p(h))
print("tsan run done")
"""
    # LD_PRELOAD: tsan cannot be dlopen'd late (static TLS exhaustion)
    r = subprocess.run([sys.executable, "-c", code],
                       capture_output=True, text=True,
                       env={"TSAN_OPTIONS": "exitcode=66",
                            "LD_PRELOAD": tsan_so[0],
                            "PATH": "/usr/bin:/bin"})
    assert "tsan run done" in r.stdout, r.stderr[-2000:]
    assert r.returncode == 0, r.stderr[-2000:]


def test_atari_lane_synthetic_backend():
    """84x84 uint8 frames, clipped rewards, life-loss boundaries, true
    scores at game over; the same frames at 1 and 2 threads."""
    assert bindings.atari_backend() == "synthetic"   # no ale_py here
    env = bindings.NativeAtariVecEnv(num_envs=4, seed=7, num_threads=2)
    obs = env.reset()
    assert obs.shape == (4, 84, 84) and obs.dtype == np.uint8
    assert env.spec.num_actions >= 3
    rng = np.random.default_rng(0)
    terms = 0
    for _ in range(400):
        a = rng.integers(0, env.spec.num_actions, 4).astype(np.int32)
        o, r, tm, tr = env.step(a)
        assert o.shape == (4, 84, 84)
        assert set(np.unique(r)) <= {-1.0, 0.0, 1.0}
        terms += int(tm.sum())
    assert int((obs > 0).sum()) > 0
    assert terms > 0
    assert len(env.pop_completed_scores()) > 0
    env.close()
    e1 = bindings.NativeAtariVecEnv(num_envs=2, seed=3, num_threads=1)
    e2 = bindings.NativeAtariVecEnv(num_envs=2, seed=3, num_threads=2)
    np.testing.assert_array_equal(e1.reset(), e2.reset())
    for _ in range(20):
        a = np.zeros(2, np.int32)
        np.testing.assert_array_equal(e1.step(a)[0], e2.step(a)[0])
    e1.close()
    e2.close()


def test_atari_lane_real_ale_compiles():
    """The port's copy of the real-ALE lane compiles against the mirror
    of the public ALE C++ API in tests/fake_ale_include."""
    inc = os.path.join(os.path.dirname(__file__), "fake_ale_include")
    r = subprocess.run(
        ["g++", "-fsyntax-only", "-std=c++17", "-DRLTIME_HAVE_ALE",
         f"-I{inc}", bindings._SRC], capture_output=True, text=True)
    assert r.returncode == 0, r.stderr[-2000:]


def test_stepper_is_the_reference_source():
    """The copy differs from the JAX package's source only by its first
    line, which names the original."""
    ref = os.path.join(os.path.dirname(os.path.dirname(__file__)),
                       "rltime_tpu", "envs", "native", "stepper.cpp")
    with open(bindings._SRC) as f:
        head, rest = f.readline(), f.read()
    assert "rltime_tpu/envs/native/stepper.cpp" in head
    assert rest == open(ref).read()


def _run(env, acts, kind):
    out = [env.reset(0)]
    for a in acts:
        out.extend(env.step(a))
    scores = env.pop_completed_scores() if kind == "atari" else []
    env.close()
    return out, scores


@pytest.mark.parametrize("threads", [1, 2])
@pytest.mark.parametrize("kind", ["cartpole", "atari"])
def test_native_matches_jax_package(jax_native_lib, kind, threads):
    """300 steps of the same seed and actions through the port's library
    and the JAX package's: every output and every game score equal."""
    E, S = 8, 300
    rng = np.random.default_rng(5)
    if kind == "cartpole":
        acts = rng.integers(0, 2, (S, E)).astype(np.int32)
        make = lambda m: m.NativeCartPoleVecEnv(E, seed=11,  # noqa: E731
                                                num_threads=threads)
    else:
        acts = rng.integers(0, 6, (S, E)).astype(np.int32)
        make = lambda m: m.NativeAtariVecEnv(E, seed=11,  # noqa: E731
                                             num_threads=threads)
    t_out, t_scores = _run(make(bindings), acts, kind)
    j_out, j_scores = _run(make(jax_native_lib), acts, kind)
    assert len(t_out) == len(j_out)
    for t, j in zip(t_out, j_out):
        assert t.dtype == j.dtype
        np.testing.assert_array_equal(t, j)
    assert t_scores == j_scores
    if kind == "atari":
        assert len(t_scores) > 0


def test_concurrent_builds_load(tmp_path, monkeypatch):
    """Three processes that build the library at once into one directory
    each load a whole file (every build is renamed into place)."""
    build = tmp_path / "b"
    code = f"""
import ctypes
from rltime_tpu_torch.envs.native import bindings
bindings._BUILD_DIR = {str(build)!r}
bindings._LIB_PATH = {str(build / "libstepper.so")!r}
lib = ctypes.CDLL(bindings.build_library(force=True))
print("loaded", lib.atari_backend())
"""
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    procs = [subprocess.Popen([sys.executable, "-c", code], cwd=root,
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                              text=True) for _ in range(3)]
    for p in procs:
        out, err = p.communicate(timeout=120)
        assert p.returncode == 0 and "loaded 0" in out, err[-2000:]
    assert sorted(os.listdir(build)) == ["libstepper.so"]


def test_ale_flags_without_headers_is_synthetic(tmp_path):
    assert bindings._ale_flags(str(tmp_path)) == []


def test_ale_flags_prefers_libale(tmp_path):
    inc = tmp_path / "include"
    inc.mkdir()
    shutil.copy(os.path.join(os.path.dirname(__file__), "fake_ale_include",
                             "ale_interface.hpp"), inc)
    (tmp_path / "_ale_py.cpython-312-x86_64-linux-gnu.so").write_bytes(b"")
    (tmp_path / "libale.so").write_bytes(b"")
    flags = bindings._ale_flags(str(tmp_path))
    assert "-DRLTIME_HAVE_ALE" in flags
    assert str(tmp_path / "libale.so") in flags
    assert not any("_ale_py" in f for f in flags)


def test_ale_flags_raise_when_nothing_links(tmp_path):
    """Headers but only an extension module that does not link: a clear
    error, not synthetic lanes."""
    inc = tmp_path / "include"
    inc.mkdir()
    (inc / "ale_interface.hpp").write_text(
        "namespace ale { struct ALEInterface { ALEInterface(); "
        "int lives(); }; }\n")
    (tmp_path / "_ale_py.cpython-312-x86_64-linux-gnu.so").write_bytes(
        b"not an object")
    with pytest.raises(RuntimeError, match="no shared object"):
        bindings._ale_flags(str(tmp_path))


def test_ale_flags_probe_links_an_extension(tmp_path):
    """An extension module that defines the ALE symbols passes the probe
    link and is used."""
    inc = tmp_path / "include"
    inc.mkdir()
    (inc / "ale_interface.hpp").write_text(
        "namespace ale { struct ALEInterface { ALEInterface(); "
        "int lives(); }; }\n")
    src = tmp_path / "ale.cpp"
    src.write_text('#include "ale_interface.hpp"\n'
                   "ale::ALEInterface::ALEInterface() {}\n"
                   "int ale::ALEInterface::lives() { return 3; }\n")
    so = tmp_path / "_ale_py.cpython-312-x86_64-linux-gnu.so"
    subprocess.run(["g++", "-shared", "-fPIC", f"-I{inc}", str(src), "-o",
                    str(so)], check=True)
    flags = bindings._ale_flags(str(tmp_path))
    assert str(so) in flags and "-DRLTIME_HAVE_ALE" in flags
    assert ctypes.CDLL(str(so))
