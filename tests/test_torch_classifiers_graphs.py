"""PyTorch port, the classifier models on ParT and ParticleNet held against
the JAX package's: the loss and its gradients (ParticleNet on JAX's
neighbour indices, `knn_indices` pinned; tests/test_torch_classifiers_nets.py
holds the indices themselves), and dropout in training with both packages'
masks pinned to the same numpy draws (the EPiC discriminator of
jetclass_classifier_epic at rate 0.3, ParticleNet's head at 0.1). Gates:
losses rtol 1e-5, gradients within 1e-5 of the largest.
"""

from __future__ import annotations

import pytest

from tests.torch_port_helpers import (CLASSIFIER_CONFIGS, classifier_batch, classifier_pair,
                                      hold_loss_grads, jax_classifier_loss_grads, pin_dropout,
                                      pin_knn, port_classifier_loss_grads)


@pytest.mark.parametrize("name", ["part", "particlenet"])
def test_loss_and_gradients_match_jax(name, monkeypatch):
    cfg = CLASSIFIER_CONFIGS[name]
    jm, params, pm, net = classifier_pair(cfg)
    batch = classifier_batch(cfg, labels="int")
    if name == "particlenet":
        pin_knn(monkeypatch, jm, params, *batch[:2])
    hold_loss_grads(port_classifier_loss_grads(pm, net, batch),
                    jax_classifier_loss_grads(jm, params, batch))


@pytest.mark.parametrize("name", ["epic", "particlenet"])
def test_dropout_losses_and_gradients_match_jax_on_pinned_masks(name, monkeypatch):
    """jetclass_classifier_epic's dropout 0.3 (after the local embed and in
    every EPiC layer, on both paths) and ParticleNet's head dropout 0.1,
    in training, on the same keep masks."""
    cfg = dict(CLASSIFIER_CONFIGS[name])
    if name == "epic":
        cfg["net_config"] = dict(cfg["net_config"], dropout=0.3)
    jm, params, pm, net = classifier_pair(cfg)
    batch = classifier_batch(cfg, seed=3, labels="binary" if name == "epic" else "int")
    if name == "particlenet":
        pin_knn(monkeypatch, jm, params, *batch[:2])
    masks = pin_dropout(monkeypatch)
    ref = jax_classifier_loss_grads(jm, params, batch, train=True)
    assert len(masks) == (1 + 2 * 2 if name == "epic" else 1)
    assert not all(m.all() for m in masks)
    port = port_classifier_loss_grads(pm, net, batch, train=True)
    hold_loss_grads(port, ref)
    # in evaluation nothing is drawn, and the loss is the deterministic one
    n = len(masks)
    hold_loss_grads(port_classifier_loss_grads(pm, net, batch),
                    jax_classifier_loss_grads(jm, params, batch))
    assert len(masks) == n
    assert port[0] != port_classifier_loss_grads(pm, net, batch)[0]
