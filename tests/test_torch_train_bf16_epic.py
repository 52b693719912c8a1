"""PyTorch port, training in bfloat16 (float32 master weights, bfloat16
compute), EPiC: one training loss and its gradients of the narrow flagship
(t-cats on, cond on both MLP paths) with `dtype=bfloat16` against the JAX
package's bfloat16 and float32 models, from the same parameters, batch and
pinned draws of t and the noise. The JAX side runs op by op
(`jax.disable_jit`; under jit XLA keeps excess bfloat16 precision).

The gate (`tests/torch_port_helpers.py::hold_bf16`): |port_bf16 - jax_bf16|
< |jax_bf16 - jax_f32| in Frobenius norms, for the loss, for the gradient of
the whole network as one vector, and for every gradient of at least 1,000
entries. The loss and every gradient are float32. Each reading is printed.
The other architectures: tests/test_torch_train_bf16_{droid,cross,mdma}.py;
the loss families: tests/test_torch_train_bf16_losses.py.
"""

from __future__ import annotations

import torch

from particle_fm_tpu_torch.models import flow_matching as pflow
from tests.torch_port_helpers import YAML_FLAGSHIP, check_bf16_step, cloud, t


def test_epic_loss_and_gradients_bf16_closer_to_jax_bf16_than_jax_is_to_f32(monkeypatch):
    check_bf16_step(monkeypatch, YAML_FLAGSHIP)


def test_loss_accum_weight_is_the_float32_mask_sum_in_bf16():
    pm = pflow.FlowMatchingModel(**dict(YAML_FLAGSHIP, dtype="bfloat16"))
    x, mask, _, _ = cloud(b=3, n=16, seed=1)
    w = pm.loss_accum_weight(t(x), t(mask))
    assert w.dtype == torch.float32 and float(w) == mask.sum()
    assert float(pm.loss_accum_weight(t(x), None)) == 3 * 16
