"""PyTorch port, training in bfloat16, MDMA (the CaloChallenge network): one
training loss (CFM, two noises) and its gradients with `dtype=bfloat16`
against the JAX package's bfloat16 and float32 models (op by op, pinned
draws) under the gate of tests/test_torch_train_bf16_epic.py. The narrow
stand-in of calo/mdma_calo.yaml has 4 heads of 8, on the einsum path, as
the shipped 8 heads of 32 train.
"""

from __future__ import annotations

from tests.torch_port_helpers import MDMA_SMALL, check_bf16_step


def test_mdma_loss_and_gradients_bf16_closer_to_jax_bf16_than_jax_is_to_f32(monkeypatch):
    check_bf16_step(monkeypatch, MDMA_SMALL, n_normals=2, fill=0.05)
