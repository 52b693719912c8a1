"""PyTorch port, training in bfloat16, the PC-Droid full transformer: one
training loss and its gradients with `dtype=bfloat16` against the JAX
package's bfloat16 and float32 models (op by op, pinned draws) under the
gate of tests/test_torch_train_bf16_epic.py, with the attention

- on the einsum path with float32 scores (`scores_dtype=None`) and with the
  shipped bfloat16 scores (`scores_dtype: bfloat16`,
  configs/model/fm_droid_transformer.yaml), on both sides;
- through the packed kernel's autograd Function (`attn_impl=packed`) on
  both sides: in the port its forward is the plain version of the bfloat16
  kernel on the CPU, its backward `packed_ref_math`; JAX runs its Pallas
  packed kernel in interpret mode with its custom VJP (`_ref_math`), where
  its dispatcher takes the einsum path on the CPU.

JAX's LayerNorm rounds its input's gradient once here, as the port's does
(`tests/torch_port_helpers.py::flax_layer_norm_rounds_once`).
"""

from __future__ import annotations

import pytest

from particle_fm_tpu_torch.ops import short_attention as pshort
from tests.test_torch_train_model import _packed_route
from tests.torch_port_helpers import check_bf16_step, droid_configs, jax_packed_route

CASES = {
    "einsum, float32 scores": droid_configs()["transformer"],
    "einsum, bfloat16 scores": droid_configs(jax_mha={"scores_dtype": "bfloat16"},
                                             port_mha={"scores_dtype": "bfloat16"})["transformer"],
    "packed": droid_configs(jax_mha={"attn_impl": "packed"},
                            port_mha={"attn_impl": "packed"})["transformer"],
}


@pytest.mark.parametrize("case", list(CASES))
def test_transformer_loss_and_gradients_bf16_closer_to_jax_bf16_than_jax_is_to_f32(
        monkeypatch, case):
    jax_cfg, port_cfg = CASES[case]
    calls = _packed_route(monkeypatch)
    jax_packed_route(monkeypatch)
    check_bf16_step(monkeypatch, jax_cfg, port_cfg=port_cfg)
    assert calls == ([True] * 2 if case == "packed" else [])  # one a layer, under autograd
    assert pshort.packed_short_attention_bf16.launches == 0  # no kernel on the CPU
