"""PyTorch port, training in bfloat16, the loss families on the narrow EPiC
flagship: one training loss and its gradients with `dtype=bfloat16` against
the JAX package's bfloat16 and float32 models (op by op, pinned draws of t,
the noises, the cond-dropout and the self-conditioning draws) under the gate
of tests/test_torch_train_bf16_epic.py, for FM-OT with the huber criterion,
CFM, CFM-OT (its pairing on the float32 data), PC-JeDi VP-diffusion (MLE
weight on), PC-Droid (VE range t_max 25), self-conditioning (its no-grad
pass in bfloat16) and cond_dropout.
"""

from __future__ import annotations

import numpy as np
import pytest

from tests.torch_port_helpers import YAML_FLAGSHIP, check_bf16_step

KEEP = np.array([[True], [False], [True], [True], [False], [True]])
USE = np.array([False, True, True, False, True, True])[:, None, None]
CASES = {
    "FM-OT huber": (dict(loss_type="FM-OT", criterion="huber"), 1),
    "CFM": (dict(loss_type="CFM"), 2),
    "CFM-OT": (dict(loss_type="CFM-OT"), 2),
    "diffusion": (dict(loss_type="diffusion", criterion="huber",
                       diff_config={"max_sr": 0.999, "min_sr": 0.02}), 1),
    "droid": (dict(loss_type="droid", droid_t_max=25.0), 1),
    "self_cond FM-OT": (dict(loss_type="FM-OT", self_cond=True), 1),
    "cond_dropout CFM": (dict(loss_type="CFM", cond_dropout=0.5), 2),
}


@pytest.mark.parametrize("case", list(CASES))
def test_family_loss_and_gradients_bf16_closer_to_jax_bf16_than_jax_is_to_f32(monkeypatch,
                                                                                 case):
    fields, n_normals = CASES[case]
    check_bf16_step(monkeypatch, dict(YAML_FLAGSHIP, **fields), n_normals=n_normals,
                    keep=KEEP, use=USE)
