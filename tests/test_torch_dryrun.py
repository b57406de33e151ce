"""`rltime_tpu_torch.dryrun` against the repository's root entry module.

`entry()` on the CPU with the JAX network's parameters carried across by
`models/bridge.py` gives the JAX forward's Q values within 5e-3 absolute
(both compute the torso and head in bfloat16, which rounds differently
through XLA's and PyTorch's convolutions: 7.4e-4 at most on random
frames, for Q values up to 0.34; zero frames give exactly 0, the
biases' init). `dryrun_multichip(2)` runs its five legs on
two gloo processes.
"""
import glob
import importlib.util
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_port_draws as draws_lib
from rltime_tpu_torch import dryrun
from rltime_tpu_torch.models import bridge
from torch_port_draws import one_intra_op_thread  # noqa: F401

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _root_entry():
    """The repository's root entry module (`__*_entry__.py`)."""
    path, = glob.glob(os.path.join(ROOT, "__*_entry__.py"))
    spec = importlib.util.spec_from_file_location("root_entry", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.usefixtures("one_intra_op_thread")
@pytest.mark.parametrize("obs_kind", ["zeros", "frames"])
def test_entry_matches_root_entry(obs_kind):
    j_fn, (j_params, j_obs) = _root_entry().entry()
    t_fn, (t_params, t_obs) = dryrun.entry("cpu")
    assert t_obs.shape == j_obs.shape and t_obs.dtype == torch.uint8
    cfg = dryrun.ModelConfig(num_actions=6, torso="nature_cnn",
                             head="dueling", compute_dtype="bfloat16")
    params = bridge.flax_to_state_dict(cfg, draws_lib.np_tree(j_params))
    assert params.keys() == t_params.keys()
    obs = np.zeros(j_obs.shape, np.uint8)
    if obs_kind == "frames":
        obs = np.random.default_rng(0).integers(0, 256, obs.shape,
                                                dtype=np.uint8)
    want = np.asarray(j_fn(j_params, jnp.asarray(obs)), np.float32)
    got = t_fn(params, torch.from_numpy(obs))
    assert got.shape == (128, 6) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, atol=5e-3, rtol=0)
    # the port's own initial parameters give finite Q values too
    assert torch.isfinite(t_fn(t_params, t_obs)).all()


def test_dryrun_multichip_on_two_gloo_ranks():
    line = dryrun.dryrun_multichip(2, device="cpu", timeout=240)
    assert line.startswith("dryrun_multichip(2) OK:")
    for leg in ("ff", "r2d2", "fused", "fused_iqn", "fused_interleaved"):
        assert f" {leg}_loss=" in line
    assert "'backend': 'gloo'" in line
