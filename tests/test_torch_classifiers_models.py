"""PyTorch port, the classifier models (`models/classifiers.py`) held against
the JAX package's on the same numpy inputs and carried weights: the loss
(binary BCE, softmax cross-entropy on integer and one-hot labels,
super-sets) and its gradients for the EPiC discriminator and the
transformer classifier, the HL-MLP, `predict`, `reinit_head`, the dropout
draw itself, and `binary_metrics` against sklearn. Gates: losses and
predictions rtol 1e-5, gradients within 1e-5 of the largest, AUROC 1e-12.
(tests/test_torch_classifiers_graphs.py: ParT and ParticleNet, and dropout
on pinned masks.)
"""

from __future__ import annotations

import copy
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from particle_fm_tpu.models import classifiers as jcls
from particle_fm_tpu_torch.models import classifiers as pcls
from particle_fm_tpu_torch.nets import common as pcommon
from particle_fm_tpu_torch.utils.from_jax import load_flax_params
from tests.torch_port_helpers import (CLASSIFIER_CONFIGS, CLASSIFIER_EPIC17, CLASSIFIER_RTOL,
                                      classifier_batch, classifier_pair, filled, grads_by_name,
                                      hold_loss_grads, jax_classifier_loss_grads,
                                      port_classifier_loss_grads, t)


@pytest.mark.parametrize("name,labels", [("epic", "binary"), ("epic_sup_sets", "binary"),
                                         ("epic_two_logits", "int"),
                                         ("transformer", "int"), ("transformer", "onehot")])
def test_loss_and_gradients_match_jax(name, labels, monkeypatch):
    cfg = CLASSIFIER_CONFIGS[name]
    jm, params, pm, net = classifier_pair(cfg)
    batch = classifier_batch(cfg, labels=labels)
    hold_loss_grads(port_classifier_loss_grads(pm, net, batch),
                    jax_classifier_loss_grads(jm, params, batch))


def test_the_dropout_draw_keeps_its_rate_and_scales_what_it_keeps():
    x = torch.ones(200_000)
    gen = torch.Generator().manual_seed(0)
    y = pcommon.dropout(x, 0.3, gen)
    kept = y != 0
    assert abs(kept.float().mean().item() - 0.7) < 0.005
    assert torch.all(y[kept] == 1 / 0.7)
    assert pcommon.dropout(x, 0.3, None) is x and pcommon.dropout(x, 0.0, gen) is x
    assert torch.all(pcommon.dropout(x, 1.0, gen) == 0)
    again = pcommon.dropout(x, 0.3, torch.Generator().manual_seed(0))
    assert torch.equal(again, y)  # the generator alone decides the mask
    # bfloat16 divides by keep rounded to bfloat16, as JAX's weakly typed constant
    yb = pcommon.dropout(x.to(torch.bfloat16), 0.3, torch.Generator().manual_seed(0))
    want = torch.tensor(1.0, dtype=torch.bfloat16) / torch.tensor(0.7, dtype=torch.bfloat16)
    assert torch.all(yb[yb != 0] == want)
    cfg = dict(CLASSIFIER_EPIC17, net_config=dict(CLASSIFIER_EPIC17["net_config"], dropout=0.3))
    net = pcls.SetClassifierModel(**cfg).init(device="cpu")
    drops = [m for m in net.modules() if isinstance(m, pcommon.Dropout)]
    assert len(drops) == 1 + 2 * 2
    with pcommon.dropout_generator(net, gen):
        assert all(m.generator is gen for m in drops)
    assert all(m.generator is None for m in drops)


@pytest.mark.parametrize("name", ["epic", "epic_sup_sets", "epic_two_logits", "transformer",
                                  "part"])
def test_predict_matches_jax(name):
    cfg = CLASSIFIER_CONFIGS[name]
    jm, params, pm, net = classifier_pair(cfg)
    x, mask, _ = classifier_batch(cfg, seed=4)
    ref = np.asarray(jm.predict({"params": params}, jnp.asarray(x), jnp.asarray(mask)))
    # EPiC: a folded copy (the fused layer's plain version) and the unfolded network
    for nett in (pm.inference_network(copy.deepcopy(net)), net):
        out = pm.predict(nett, t(x), t(mask))
        assert out.shape == ref.shape
        np.testing.assert_allclose(out.numpy(), ref, rtol=CLASSIFIER_RTOL, atol=1e-6)
    assert not any(m._folded is not None for m in net.modules() if hasattr(m, "_folded"))


def test_hl_classifier_matches_jax():
    jm = jcls.HLClassifierModel(features=3, layers=(16, 32, 16))
    params = filled(jax.eval_shape(jm.init, jax.random.PRNGKey(0))["params"])
    pm = pcls.HLClassifierModel(features=3, layers=(16, 32, 16))
    net = pm.init(device="cpu")
    load_flax_params(net, params)
    rs = np.random.RandomState(5)
    x = rs.randn(20, 3).astype(np.float32)
    y = rs.randint(0, 2, (20, 1)).astype(np.float32)
    loss, grads = jax.value_and_grad(
        lambda p: jm.loss({"params": p}, None, jnp.asarray(x), None, jnp.asarray(y))[0])(params)
    pl = pm.loss(net, torch.Generator(), t(x), None, t(y), train=True)
    names = [n for n, _ in net.named_parameters()]
    pg = torch.autograd.grad(pl, list(net.parameters()))
    hold_loss_grads((float(pl.detach()), {n: g.numpy() for n, g in zip(names, pg)}),
          (float(loss), grads_by_name(grads)))
    np.testing.assert_allclose(pm.predict(net, t(x)).numpy(),
                               np.asarray(jm.predict({"params": params}, jnp.asarray(x))),
                               rtol=CLASSIFIER_RTOL)


@pytest.mark.parametrize("name", ["epic", "transformer", "part", "particlenet"])
def test_reinit_head_draws_what_jax_draws_anew(name):
    """The parameters `reinit_head` replaces are those JAX's replaces; the
    trunk stays as it was."""
    cfg = CLASSIFIER_CONFIGS[name]
    jm, params, pm, net = classifier_pair(cfg)
    fresh = jm.reinit_head({"params": params}, jax.random.PRNGKey(7))["params"]
    before, after = grads_by_name(params), grads_by_name(fresh)
    jax_changed = {n for n in before if not np.array_equal(before[n], after[n])}
    old = {n: p.detach().clone() for n, p in net.named_parameters()}
    assert pm.reinit_head(net, seed=7) is net
    port_changed = {n for n, p in net.named_parameters() if not torch.equal(p, old[n])}
    assert port_changed == jax_changed and jax_changed
    want = pm.init(seed=7, device="cpu").state_dict()
    for n in port_changed:
        assert torch.equal(net.state_dict()[n], want[n])


def test_binary_metrics_match_sklearn():
    from sklearn.metrics import roc_auc_score

    rs = np.random.RandomState(6)
    labels = rs.randint(0, 2, 5000).astype(np.float32)
    probs = np.round(rs.rand(5000) * 0.6 + 0.3 * labels, 2).astype(np.float32)  # many ties
    out = pcls.binary_metrics(probs, labels[:, None])
    assert out["auroc"] == pytest.approx(roc_auc_score(labels, probs), abs=1e-12)
    assert out == pytest.approx(jcls.binary_metrics(probs, labels[:, None]), abs=1e-12)
    assert pcls.roc_auc([0, 0, 1, 1], [0.5, 0.5, 0.5, 0.5]) == 0.5
    # one class only: sklearn calls the score undefined (a ValueError in older
    # versions, a warning and nan in newer ones); the port raises
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        with pytest.raises((ValueError, Warning), match="[Oo]nly one class"):
            roc_auc_score(np.ones(4), probs[:4])
    with pytest.raises(ValueError, match="two classes"):
        pcls.binary_metrics(probs[:4], np.ones(4))
