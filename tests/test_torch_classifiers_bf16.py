"""PyTorch port, the EPiC discriminator in bfloat16 (`dtype` as the classifier
configs pass it) and its folded route: the logits of a narrow
jetclass_classifier_epic (17 features) and of a super-set discriminator,
in bfloat16 on the module path and on a copy folded by `inference_network` (on the
CPU the fused layer's plain version, which rounds where the Pallas kernel
rounds), held against the JAX package's bfloat16 op by op
(`jax.disable_jit`; its bfloat16 sums accumulating in float32, as torch's
do) by the bf16 gate of tests/test_torch_port_bf16_*.py,
|port_bf16 - jax_bf16| < |jax_bf16 - jax_f32|
(Frobenius norms), both routes. In float32 the folded route holds the
unfolded one within 1e-6.
"""

from __future__ import annotations

import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from particle_fm_tpu.models import classifiers as jcls
from particle_fm_tpu_torch.models import classifiers as pcls
from particle_fm_tpu_torch.models.flow_matching import FlowMatchingModel
from particle_fm_tpu_torch.utils.from_jax import load_flax_params
from tests.torch_port_helpers import bf16_gaps, filled, jax_reductions_in_float32, t

CFGS = {
    "jetclass_classifier_epic": dict(arch="epic", n_classes=1, num_particles=16, features=17,
                                     net_config=dict(hid_dim=32, latent_dim=10,
                                                     equiv_layers=3, dropout=0.3)),
    "super_sets": dict(arch="epic", n_classes=1, num_particles=16, features=3,
                       net_config=dict(hid_dim=32, latent_dim=10, equiv_layers=2,
                                       num_sup_sets=2)),
}


def _inputs(cfg, b=8, seed=0):
    rs = np.random.RandomState(seed)
    n = cfg["num_particles"]
    counts = rs.randint(2, n + 1, size=(b, 1))
    mask = (np.arange(n)[None, :] < counts).astype(np.float32)[..., None]
    return rs.randn(b, n, cfg["features"]).astype(np.float32) * mask, mask


@pytest.mark.parametrize("name", list(CFGS))
def test_epic_discriminator_bf16_closer_to_jax_bf16_than_jax_is_to_f32(name, monkeypatch):
    cfg = CFGS[name]
    jm, jm16 = jcls.SetClassifierModel(**cfg), jcls.SetClassifierModel(**cfg, dtype="bfloat16")
    params = filled(jax.eval_shape(jm.init, jax.random.PRNGKey(0))["params"], 0, 0.6)
    variables = {"params": params}
    pm16 = pcls.SetClassifierModel(**cfg, dtype="bfloat16")
    net16 = pm16.init(device="cpu")
    load_flax_params(net16, params)
    x, mask = _inputs(cfg)
    ref32 = np.asarray(jm.logits(variables, jnp.asarray(x), jnp.asarray(mask)))
    jax_reductions_in_float32(monkeypatch)
    with jax.disable_jit():
        ref16 = np.asarray(jm16.logits(variables, jnp.asarray(x), jnp.asarray(mask))
                           .astype(jnp.float32))
    with torch.no_grad():
        module = net16(t(x), mask=t(mask))
        FlowMatchingModel.fold_weight_norm(net16)
        folded = net16(t(x), mask=t(mask))
        FlowMatchingModel.unfold_weight_norm(net16)
    assert module.dtype == folded.dtype == torch.bfloat16
    ours, theirs = bf16_gaps(module.float().numpy(), ref16, ref32, f"{name} logits")
    assert np.abs(ref32).max() > 0.1 and ours < theirs
    ours, theirs = bf16_gaps(folded.float().numpy(), ref16, ref32, f"{name} folded logits")
    assert ours < theirs
    probs = pm16.predict(net16, t(x), t(mask))
    assert probs.shape == (8,) and torch.isfinite(probs.float()).all()


@pytest.mark.parametrize("name", list(CFGS))
def test_folded_route_matches_the_module_path_in_float32(name):
    cfg = CFGS[name]
    pm = pcls.SetClassifierModel(**cfg)
    net = pm.init(seed=3, device="cpu")
    x, mask = _inputs(cfg, seed=1)
    copied = pm.inference_network(copy.deepcopy(net))
    folded = pm.predict(copied, t(x), t(mask))
    module = pm.predict(net, t(x), t(mask))
    np.testing.assert_allclose(folded.numpy(), module.numpy(), rtol=1e-6, atol=1e-6)
    # inference_network folds the copy for good and leaves the network it came from unfolded
    assert not any(m._kernel_weights is not None for m in net.layers())
    assert all(m._kernel_weights is not None for m in copied.layers())
    np.testing.assert_allclose(pm.predict(copied, t(x), t(mask)).numpy(), folded.numpy(), atol=0)
    with pytest.raises(RuntimeError, match="unfolded"):
        pm.loss(copied, torch.Generator(), t(x), t(mask), torch.ones(8, 1), train=True)
