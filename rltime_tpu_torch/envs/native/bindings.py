"""ctypes bindings for the C++ lane pool (port of `rltime_tpu/envs/native/bindings.py`).

`stepper.cpp` beside this file is a copy of the reference's source, so
both libraries step identically for the same seed, thread count and
actions. The shared library is built by `g++ -O3 -march=native` at the
first env construction (about a second) into `_build/` here: nothing is
built at import. Several processes may build it at once (parallel test
workers): each compiles to a name of its own in the same directory and
renames the result into place, so no process loads a half-written file.
The ABI is plain C; arrays are preallocated numpy buffers passed by
pointer, so the step path copies nothing.

Differs from the reference in `_ale_flags`: it links `libale*.so` where
the installed `ale_py` has one, probe-links the Python extension
`_ale_py*.so` with a small program before it commits to it, and raises
when ALE headers are present but no object links (the reference warns
and builds synthetic lanes). Without ALE headers the lanes are the
synthetic load generators, as in the reference; `atari_backend()` says
which.
"""
from __future__ import annotations

import ctypes
import glob
import os
import shutil
import subprocess
import threading

import numpy as np

from rltime_tpu_torch.config.registry import register
from rltime_tpu_torch.envs.base import EnvSpec, VecEnv

_DIR = os.path.dirname(os.path.abspath(__file__))
_SRC = os.path.join(_DIR, "stepper.cpp")
_BUILD_DIR = os.path.join(_DIR, "_build")
_LIB_PATH = os.path.join(_BUILD_DIR, "libstepper.so")
_LOCK = threading.Lock()
_LIB = None


def library_path() -> str:
    return _LIB_PATH


def _compile(cmd_head, out: str, tail=()) -> subprocess.CompletedProcess:
    """Run `g++ ... -o <tmp> tail` and rename <tmp> to `out` on success."""
    tmp = f"{out}.tmp{os.getpid()}.{threading.get_ident()}"
    r = subprocess.run(list(cmd_head) + ["-o", tmp] + list(tail),
                       capture_output=True, text=True)
    if r.returncode == 0:
        os.replace(tmp, out)
    elif os.path.exists(tmp):
        os.remove(tmp)
    return r


def _links(flags) -> bool:
    """Whether a program that makes an ALEInterface links and resolves
    every symbol against `flags` (a Python extension often leaves
    libpython's undefined, which an executable's link catches)."""
    os.makedirs(_BUILD_DIR, exist_ok=True)
    probe = os.path.join(_BUILD_DIR, f"ale_probe{os.getpid()}.cpp")
    with open(probe, "w") as f:
        f.write("#include <ale_interface.hpp>\n"
                "int main() { ale::ALEInterface a; return a.lives(); }\n")
    out = probe[:-4]
    try:
        r = _compile(["g++", "-std=c++17", probe], out, flags)
        return r.returncode == 0
    finally:
        for p in (probe, out):
            if os.path.exists(p):
                os.remove(p)


def _ale_flags(ale_dir=None):
    """Compile flags for the REAL ALE lane, or [] for synthetic lanes.

    `ale_dir` is the installed `ale_py` package's directory (looked up
    when None; no `ale_py` means synthetic lanes). With its bundled
    `include/ale_interface.hpp` present, link `libale*.so` if the wheel
    has one, else `_ale_py*.so` if a probe program links against it;
    raise if neither does, so that a run that asked for a game never
    trains on the load generator."""
    if ale_dir is None:
        try:
            import ale_py
        except ImportError:
            return []
        ale_dir = os.path.dirname(ale_py.__file__)
    inc = os.path.join(ale_dir, "include")
    if not os.path.exists(os.path.join(inc, "ale_interface.hpp")):
        return []
    libs = sorted(glob.glob(os.path.join(ale_dir, "libale*.so*"))
                  + glob.glob(os.path.join(ale_dir, "**", "libale*.so*"),
                              recursive=True))
    exts = sorted(glob.glob(os.path.join(ale_dir, "_ale_py*.so")))
    for so in libs + exts:
        d = os.path.dirname(so)
        flags = ["-DRLTIME_HAVE_ALE", f"-I{inc}", so, f"-Wl,-rpath,{d}"]
        if so in libs or _links(flags[1:]):
            return flags
    raise RuntimeError(
        f"ALE headers found in {inc} but no shared object under {ale_dir} "
        f"links (tried {libs + exts or 'none found'}): the native Atari "
        "lane cannot drive a real emulator. Use env.type='atari' (the "
        "Python ALE stack) or install an ale-py wheel that ships libale.")


def _resolve_rom(rom: str) -> str:
    """Game name -> ROM file path for the real-ALE lane (pass-through
    for existing paths and for synthetic lanes, which ignore it)."""
    if os.path.exists(rom) or atari_backend() != "ale":
        return rom
    try:
        from ale_py import roms
        if hasattr(roms, "get_rom_path"):
            p = roms.get_rom_path(rom)
            if p:
                return str(p)
        name = "".join(w.capitalize() for w in rom.split("_"))
        if hasattr(roms, name):
            return str(getattr(roms, name))
    except ImportError:
        pass
    raise FileNotFoundError(
        f"cannot resolve Atari ROM {rom!r}: not a file and ale_py.roms"
        " has no entry for it")


def build_library(force: bool = False, tsan: bool = False) -> str:
    """Build the stepper .so (tsan=True: a ThreadSanitizer variant, for
    the lane pool's threads) unless an up-to-date one exists; returns
    its path. Raises when there is no `g++`."""
    out = _LIB_PATH.replace(".so", "_tsan.so") if tsan else _LIB_PATH
    with _LOCK:
        if (not force and os.path.exists(out)
                and os.path.getmtime(out) >= os.path.getmtime(_SRC)):
            return out
        if shutil.which("g++") is None:
            raise RuntimeError(
                "g++ not found: the native env lanes (cartpole_native, "
                "atari_native) are compiled from stepper.cpp at first use "
                "and need a C++ compiler")
        os.makedirs(_BUILD_DIR, exist_ok=True)
        cmd = ["g++", "-O3", "-march=native", "-shared", "-fPIC",
               "-std=c++17", "-pthread"]
        if tsan:
            cmd += ["-fsanitize=thread", "-g"]
        r = _compile(cmd + [_SRC], out, _ale_flags())
        if r.returncode != 0:
            raise RuntimeError(f"building {out} failed:\n{r.stderr[-4000:]}")
    return out


def _load():
    global _LIB
    if _LIB is None:
        lib = ctypes.CDLL(build_library())
        vp, i32, u64 = ctypes.c_void_p, ctypes.c_int32, ctypes.c_uint64
        lib.cartpole_create.restype = vp
        lib.cartpole_create.argtypes = [i32, u64, i32, i32]
        lib.cartpole_destroy.argtypes = [vp]
        lib.cartpole_reset.argtypes = [vp, u64, vp]
        lib.cartpole_step.argtypes = [vp] * 6
        lib.cartpole_step_many.argtypes = [vp, i32] + [vp] * 5
        lib.atari_backend.restype = i32
        lib.atari_create.restype = vp
        lib.atari_create.argtypes = [i32, u64, i32, ctypes.c_char_p, i32,
                                     i32, i32, i32, ctypes.c_int64]
        lib.atari_destroy.argtypes = [vp]
        lib.atari_num_actions.restype = i32
        lib.atari_num_actions.argtypes = [vp]
        lib.atari_reset.argtypes = [vp, vp]
        lib.atari_step.argtypes = [vp] * 7
        _LIB = lib
    return _LIB


def _ptr(a: np.ndarray):
    return a.ctypes.data_as(ctypes.c_void_p)


class _Handle:
    """Owns a lane pool made by `<kind>_create` and frees it once."""

    _kind = ""

    def close(self):
        if getattr(self, "_h", None):
            getattr(self._lib, f"{self._kind}_destroy")(self._h)
            self._h = None

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass


@register("cartpole_native")
class NativeCartPoleVecEnv(_Handle, VecEnv):
    """C++ lane-pool CartPole: `envs/cartpole.py`'s semantics (its
    init-state RNG is std::mt19937, so trajectories match numpy's in
    distribution, not bit for bit)."""

    _kind = "cartpole"

    def __init__(self, num_envs: int, seed: int = 0,
                 num_threads: int = 0, time_limit: int = 500):
        lib = _load()
        self.num_envs = num_envs
        self.spec = EnvSpec(obs_shape=(4,), obs_dtype=np.float32,
                            num_actions=2)
        if num_threads <= 0:
            # the lockstep barrier costs ~µs a step: a cheap lane needs
            # >= 1024 lanes per thread to amortize it
            num_threads = max(1, min(os.cpu_count() or 1,
                                     num_envs // 1024))
        self._h = lib.cartpole_create(num_envs, seed, num_threads,
                                      time_limit)
        self._lib = lib
        E = num_envs
        self._obs = np.empty((E, 4), np.float32)
        self._rew = np.empty((E,), np.float32)
        self._term = np.empty((E,), np.uint8)
        self._trunc = np.empty((E,), np.uint8)

    def reset(self, seed: int = 0) -> np.ndarray:
        self._lib.cartpole_reset(self._h, seed, _ptr(self._obs))
        return self._obs.copy()

    def step(self, actions: np.ndarray):
        a = np.ascontiguousarray(actions, np.int32)
        self._lib.cartpole_step(self._h, _ptr(a), _ptr(self._obs),
                                _ptr(self._rew), _ptr(self._term),
                                _ptr(self._trunc))
        return (self._obs.copy(), self._rew.copy(),
                self._term.astype(bool), self._trunc.astype(bool))

    def step_many(self, actions: np.ndarray):
        """(steps, E) actions -> stacked outputs; one C call per chunk."""
        S, E = actions.shape
        a = np.ascontiguousarray(actions, np.int32)
        obs = np.empty((S, E, 4), np.float32)
        rew = np.empty((S, E), np.float32)
        term = np.empty((S, E), np.uint8)
        trunc = np.empty((S, E), np.uint8)
        self._lib.cartpole_step_many(self._h, S, _ptr(a), _ptr(obs),
                                     _ptr(rew), _ptr(term), _ptr(trunc))
        return obs, rew, term.astype(bool), trunc.astype(bool)


def atari_backend() -> str:
    """'ale' when the library was compiled against real ALE headers,
    else 'synthetic'."""
    return "ale" if _load().atari_backend() else "synthetic"


@register("atari_native")
class NativeAtariVecEnv(_Handle, VecEnv):
    """C++ Atari-shaped lane pool (`stepper.cpp` AtariPool).

    Against real ALE it runs the DeepMind stack natively (noop/fire
    reset, frameskip max-pool, EpisodicLife, truncation, as
    `envs/atari.py:_AtariLane`; gray/resize is an integer area resample,
    not cv2's). Without ALE headers the lanes are synthetic load
    generators with the same 84x84 uint8 contract, a real per-step
    210x160x3 max-pool and gray-resize, life-loss and game-over
    boundaries and game scores. Rewards are clipped to their sign when
    `clip_rewards`; `pop_completed_scores` returns the unclipped score
    of every game that ended since the last call."""

    _kind = "atari"

    def __init__(self, num_envs: int, rom: str = "pong", seed: int = 0,
                 num_threads: int = 0, noop_max: int = 30,
                 frameskip: int = 4, episodic_life: bool = True,
                 fire_reset: bool = True, clip_rewards: bool = True,
                 max_episode_frames: int = 108_000):
        lib = _load()
        self.num_envs = num_envs
        self.clip_rewards = clip_rewards
        if num_threads <= 0:
            # emulator-priced lanes amortize the barrier at ~8 a thread
            num_threads = max(1, min(os.cpu_count() or 1, num_envs // 8))
        self._h = lib.atari_create(
            num_envs, seed, num_threads, _resolve_rom(rom).encode(),
            noop_max, frameskip, int(episodic_life), int(fire_reset),
            max_episode_frames)
        self._lib = lib
        self.spec = EnvSpec((84, 84), np.uint8,
                            int(lib.atari_num_actions(self._h)))
        E = num_envs
        self._obs = np.empty((E, 84, 84), np.uint8)
        self._rew = np.empty((E,), np.float32)
        self._term = np.empty((E,), np.uint8)
        self._trunc = np.empty((E,), np.uint8)
        self._over = np.empty((E,), np.uint8)
        self._game_score = np.zeros((E,), np.float64)
        self.completed_scores: list = []

    def reset(self, seed: int = 0) -> np.ndarray:
        self._game_score[:] = 0.0
        self._lib.atari_reset(self._h, _ptr(self._obs))
        return self._obs.copy()

    def pop_completed_scores(self):
        s, self.completed_scores = self.completed_scores, []
        return s

    def step(self, actions: np.ndarray):
        a = np.ascontiguousarray(actions, np.int32)
        self._lib.atari_step(self._h, _ptr(a), _ptr(self._obs),
                             _ptr(self._rew), _ptr(self._term),
                             _ptr(self._trunc), _ptr(self._over))
        rew = self._rew.copy()
        self._game_score += rew
        for i in np.nonzero(self._over)[0]:
            self.completed_scores.append(float(self._game_score[i]))
            self._game_score[i] = 0.0
        if self.clip_rewards:
            rew = np.sign(rew).astype(np.float32)
        return (self._obs.copy(), rew, self._term.astype(bool),
                self._trunc.astype(bool))
