"""PyTorch port, the train step's 5-step trajectory held against the JAX
package's un-jitted `_build_step_fn` for the full transformer with
attn_impl=packed: the port's attention runs through the packed kernel's
autograd.Function (the plain version on the CPU), the JAX model takes the
einsum path, as it does on the CPU. The comparisons and their tolerances are
those of tests/test_torch_train_step.py.
"""

from __future__ import annotations

from particle_fm_tpu_torch.ops import short_attention as pshort
from tests.test_torch_train_model import _packed_route
from tests.test_torch_train_step import check_trajectory
from tests.torch_port_helpers import droid_configs


def test_trajectory_matches_jax_packed_transformer(monkeypatch):
    calls = _packed_route(monkeypatch)
    jax_cfg, port_cfg = droid_configs(port_mha={"attn_impl": "packed"})["transformer"]
    check_trajectory(monkeypatch, jax_cfg, port_cfg)
    assert calls == [True] * 2 * 5  # two layers, five steps, each under autograd
    assert pshort.packed_short_attention.launches == 0  # no kernel on the CPU
