"""A private build of the JAX package's native library, for parity tests.

The JAX package builds its lane pool into one shared path under a
thread lock, so two test processes that build it at once can load a
half-written file. `jax_native_lib` points the JAX bindings at a build
of the same `stepper.cpp`, by the same code and flags, in the test's
own directory, and restores them afterwards.
"""
import pytest


@pytest.fixture
def jax_native_lib(tmp_path, monkeypatch):
    from rltime_tpu.envs.native import bindings
    build = tmp_path / "jax_native_build"
    monkeypatch.setattr(bindings, "_BUILD_DIR", str(build))
    monkeypatch.setattr(bindings, "_LIB_PATH", str(build / "libstepper.so"))
    monkeypatch.setattr(bindings, "_LIB", None)
    return bindings
