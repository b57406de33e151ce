"""The options of the host Trainer that earlier slices refused.

With the sum tree or uniform replay the rings of a whole run still equal
the JAX Trainer's bit for bit, on the Atari-shaped config of
tests/test_torch_trainer.py; RMSProp and space-to-depth alone train end
to end there. The other options' trainer runs, and every option's
numerics against the JAX package, are in the option's own file
(test_torch_{sum_tree,uniform_replay,optimizer,qlambda,nhwc_s2d,
priorities,interleave,transcript}.py).
"""
import numpy as np
import pytest

from rltime_tpu_torch.training.trainer import Trainer
import test_torch_trainer as trainer_tests
from test_torch_trainer import _img_cfg
from torch_port_draws import one_intra_op_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_intra_op_thread")


@pytest.mark.parametrize("replay", [{"sampler": "tree"},
                                    {"prioritized": False}])
def test_trainer_rings_match_jax_with_other_samplers(tmp_path, replay):
    trainer_tests.test_trainer_rings_match_jax(tmp_path, replay)


@pytest.mark.parametrize("section,key,value", [
    ("algo", "optimizer", "rmsprop"), ("model", "space_to_depth", True),
])
def test_options_ported_since_run(tmp_path, section, key, value):
    cfg = _img_cfg()
    cfg[section][key] = value
    cfg["train"]["total_env_steps"] = 208
    t = Trainer(cfg, str(tmp_path / "p"), device="cpu").train()
    assert t.updates_done > 0
    for k in ("loss", "grad_norm", "td_abs"):
        assert np.isfinite(t.last_metrics[k].item()), k
