"""PyTorch port, training on the card (cuda-marked: skips without a GPU).
The file imports no JAX, so that the card's machine runs it:

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_train_cuda.py

- One EPiC training loss and its gradients on the card against the CPU, from
  the same weights and pinned draws of t and the noise: loss rtol 1e-5,
  gradients atol 1e-5 of the largest gradient (TF32 off).
- The transformer with attn_impl=packed: the loss and gradients with the
  packed kernel in the forward pass against the wrapper replaced by its
  plain version, within the same tolerances, and one packed launch per layer
  per step; then a train step on the card.
- log_prob raises where the packed kernel would launch (no forward-mode rule).
- The scanned and fused epochs (training/epochs.py) as a captured CUDA graph
  of one step against the eager per-step path, EPiC and the transformer
  with attn_impl=packed, float32 and bfloat16, with and without
  accumulation: every loss, parameter, EMA weight and AdamW moment equal to
  the bit; the packed kernel counted at the warm-up step and the capture
  only. Then the Trainer with fuse_epochs=2 against scan_epochs=False.
- Every shipped family the Trainer captures by default, composed from
  configs/ at its widths on synthetic data (the ParT, ParticleNet, HL and
  EPiC classifiers, the flat model, the MoE transformer, diffusion, droid,
  self-conditioning, LHCO x_jet, jetclass_cond): 3 captured steps equal the
  eager ones, to the bit.
"""

from __future__ import annotations

import os
from unittest import mock

import numpy as np
import pytest
import torch

from particle_fm_tpu_torch.losses import flow_matching as ploss
from particle_fm_tpu_torch.models.flow_matching import FlowMatchingModel
from particle_fm_tpu_torch.ops import short_attention as sa
from particle_fm_tpu_torch.training import epochs as pepochs
from particle_fm_tpu_torch.training import step as pstep

SMALL = dict(features=3, num_particles=16, frequencies=16, t_emb="cosine", global_cond_dim=2)
EPIC = dict(SMALL, hidden_dim=32, latent=8, layers=2, t_global_cat=True, t_local_cat=True,
            add_time_to_input=False, local_cond_dim=2)
_EMBD = dict(act_h="lrlu", nrm="layer")
TRANSFORMER = dict(SMALL, model="droid_fulltransformer", add_time_to_input=True, net_config=dict(
    node_embd_config=_EMBD, ctxt_embd_config=dict(_EMBD, outp_dim=12),
    outp_embd_config=dict(_EMBD, output_init_zeros=True),
    te_config=dict(model_dim=64, num_layers=2, dense_config=dict(_EMBD, output_init_zeros=True),
                   mha_config=dict(num_heads=4, init_zeros=True, do_layer_norm=True,
                                   attn_impl="packed"))))


@pytest.fixture()
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _batch(b=8, n=16, seed=0):
    rs = np.random.RandomState(seed)
    mask = (np.arange(n)[None, :] < rs.randint(3, n + 1, (b, 1))).astype(np.float32)[..., None]
    x = rs.randn(b, n, 3).astype(np.float32) * mask
    return [torch.from_numpy(a) for a in (x, mask, rs.randn(b, 2).astype(np.float32))]


def _loss_and_grads(model, net, batch, seed=1):
    rs = np.random.RandomState(seed)
    dev = batch[0].device
    tt = torch.from_numpy(rs.rand(batch[0].shape[0]).astype(np.float32)).to(dev)
    z = torch.from_numpy(rs.randn(*batch[0].shape).astype(np.float32)).to(dev)
    with mock.patch.multiple(ploss, _sample_t=lambda g, b, d: tt, _normal=lambda g, s, d: z):
        loss = model.loss(net, torch.Generator(dev), *batch, train=True)
        grads = torch.autograd.grad(loss, list(net.parameters()))
    return float(loss.detach()), [g.cpu() for g in grads]


def _assert_close(got, want):
    np.testing.assert_allclose(got[0], want[0], rtol=1e-5)
    scale = max(g.abs().max().item() for g in want[1])
    for a, b in zip(got[1], want[1]):
        torch.testing.assert_close(a, b, rtol=0, atol=1e-5 * scale)


def _redrawn(net, seed=3):
    gen = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for p in net.parameters():
            draw = torch.randn(p.shape, generator=gen).to(p.device)
            p.copy_(draw / p.shape[-1] ** 0.5 if p.ndim >= 2 else p + 0.1 * draw)
    return net


@pytest.mark.cuda
def test_epic_loss_on_the_card_matches_the_cpu(cuda):
    model = FlowMatchingModel(**EPIC)
    net = model.init(seed=2, device=cuda)
    batch = _batch()
    card = _loss_and_grads(model, net, [a.to(cuda) for a in batch])
    _assert_close(card, _loss_and_grads(model, model.init(seed=2, device="cpu"), batch))


@pytest.mark.cuda
def test_packed_training_matches_the_plain_attention(cuda):
    model = FlowMatchingModel(**TRANSFORMER)
    net = _redrawn(model.init(seed=2, device=cuda))
    batch = [a.to(cuda) for a in _batch()]
    sa.packed_short_attention.launches = 0
    kernel = _loss_and_grads(model, net, batch)
    assert sa.packed_short_attention.launches == 2
    with mock.patch.object(sa, "packed_short_attention", sa.packed_short_attention_reference):
        _assert_close(kernel, _loss_and_grads(model, net, batch))
    state = pstep.create_train_state(model, pstep.make_optimizer(), seed=2, device=cuda)
    step = pstep.make_train_step(model, pstep.make_optimizer())
    loss = step(state, torch.Generator(cuda).manual_seed(0), *batch)
    assert torch.isfinite(loss) and state.step == 1


@pytest.mark.cuda
def test_log_prob_raises_where_an_attention_kernel_would_launch(cuda):
    """log_prob differentiates forward; the packed kernel's autograd Function
    has no forward-mode rule, so on CUDA tensors at a shape the kernel takes
    log_prob raises (on the CPU, where the dispatcher takes the einsum path,
    it computes: tests/test_torch_log_prob.py)."""
    model = FlowMatchingModel(**TRANSFORMER)
    net = model.init(seed=0, device=cuda)
    x, mask, cond = (a.to(cuda) for a in _batch(b=2))
    before = sa.packed_short_attention.launches
    with pytest.raises(NotImplementedError, match="packed attention kernel"):
        model.log_prob(net, x, cond, mask, ode_steps=3)
    assert sa.packed_short_attention.launches == before


def _state_tensors(state):
    opt = state.opt_state.state
    return ([p.detach() for p in state.params()] + list(state.ema_params)
            + [opt[p][k] for p in state.params() for k in ("exp_avg", "exp_avg_sq")])


def _redraw_state(state, seed=3):
    _redrawn(state.net, seed)
    with torch.no_grad():
        for e, p in zip(state.ema_params, state.params()):
            e.copy_(p)


SCAN_CASES = {
    "epic": (EPIC, None, 1),
    "epic bf16": (EPIC, "bfloat16", 1),
    "epic accum 2": (EPIC, None, 2),
    "packed": (TRANSFORMER, None, 1),
    "packed bf16": (TRANSFORMER, "bfloat16", 1),
}


@pytest.mark.cuda
@pytest.mark.parametrize("case", list(SCAN_CASES))
def test_captured_epochs_equal_the_per_step_path(cuda, case):
    cfg, dtype, accum = SCAN_CASES[case]
    model = FlowMatchingModel(**cfg, dtype=dtype)
    opt = pstep.make_optimizer(lr=lambda s: 1e-3 * (1 + s) / 8)  # a schedule: lr from the table
    x, mask, cond = (a.to(cuda) for a in _batch(b=64, seed=4))
    rs = np.random.RandomState(5)
    e, k, b = 2, 4, 8
    row = (k, accum, b) if accum > 1 else (k, b)
    perms = np.stack([rs.permutation(64)[:k * accum * b].reshape(row) for _ in range(e)])
    states = [pstep.create_train_state(model, opt, seed=2, device=cuda) for _ in range(2)]
    for st in states:
        _redraw_state(st)
    eager = pstep.make_train_step(model, opt, ema_decay=0.9, ema_start_step=2, accum=accum)
    gen = torch.Generator(cuda)
    want = []
    for p in perms.reshape((e * k,) + perms.shape[2:]):
        idx = torch.from_numpy(p.reshape(-1)).to(cuda)
        batch = [a.index_select(0, idx).reshape(p.shape + a.shape[1:]) for a in (x, mask, cond)]
        gen.manual_seed(pepochs.step_seed(7, states[0].step))
        want.append(eager(states[0], gen, *batch))
    sa.packed_short_attention.launches = sa.packed_short_attention_bf16.launches = 0
    run = pepochs.make_train_superepoch(model, opt, ema_decay=0.9, ema_start_step=2,
                                        accum=accum, seed=7)
    got = run(states[1], x, mask, cond, perms)
    graphs = int(cuda.type == "cuda")
    assert run.runner.captures == graphs and states[1].step == states[0].step == e * k
    torch.testing.assert_close(got.reshape(-1), torch.stack(want).float(), rtol=0, atol=0)
    for a, b_ in zip(_state_tensors(states[1]), _state_tensors(states[0])):
        assert torch.equal(a, b_)
    counted = sa.packed_short_attention.launches + sa.packed_short_attention_bf16.launches
    layers = cfg.get("net_config", {}).get("te_config", {}).get("num_layers", 0)
    # the warm-up step and the capture, not the replays
    assert counted == 2 * accum * layers * graphs
    got = run(states[1], x, mask, cond, perms[:1])  # a shorter run: the same graph
    assert run.runner.captures == graphs and torch.isfinite(got).all()


@pytest.mark.cuda
def test_trainer_fused_epochs_on_the_card_equal_the_per_step_path(cuda):
    from particle_fm_tpu_torch.data.jetnet import JetNetDataModule
    from particle_fm_tpu_torch.training.trainer import Trainer

    def fit(**kw):
        dm = JetNetDataModule(jet_type=("t",), num_particles=16, batch_size=32, synthetic=True,
                              synthetic_num_jets=400)
        dm.setup()
        model = FlowMatchingModel(**dict(EPIC, global_cond_dim=dm.num_cond_features,
                                         local_cond_dim=dm.num_cond_features))
        trainer = Trainer(model, dm, pstep.make_optimizer(lr=1e-3), max_epochs=3, device=cuda,
                          verbose=False, **kw)
        trainer.fit()
        return trainer

    fused, per_step = fit(fuse_epochs=2), fit(scan_epochs=False)
    # groups of 2 and 1 epochs, one graph
    assert fused.train_superepoch.runner.captures == int(cuda.type == "cuda")
    assert fused.state.step == per_step.state.step
    for a, b in zip(_state_tensors(fused.state), _state_tensors(per_step.state)):
        assert torch.equal(a, b)
    assert fused.last_metrics["val_loss"] == per_step.last_metrics["val_loss"]


CONFIGS = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "configs")
_JETCLASS = ["data.synthetic=true", "data.synthetic_num_particles=128", "data.used_flavor=QCD",
             "data.synthetic_num_jets=800"]
FAMILIES = {
    "ParT": ["experiment=jetclass_classifier", *_JETCLASS],
    "ParticleNet": ["experiment=jetclass_classifier_particlenet", *_JETCLASS],
    "HL-MLP": ["experiment=jetclass_classifier_hl", *_JETCLASS],
    "flat (jet_features)": ["experiment=lhco/jet_features", "data.synthetic=true",
                            "data.synthetic_num_events=4000"],
    "MoE transformer": ["experiment=jetnet/fm_moe_transformer", "data.synthetic=true",
                        "data.synthetic_num_jets=2000"],
    "diffusion": ["experiment=jetnet/diffusion_tops150_cond", "data.synthetic=true",
                  "data.synthetic_num_jets=2000"],
    "droid": ["experiment=jetnet/droid_tops30", "data.synthetic=true",
              "data.synthetic_num_jets=2000"],
    "self-cond": ["experiment=jetnet/fm_selfcond_tops30", "data.synthetic=true",
                  "data.synthetic_num_jets=2000"],
    "lhco x_jet": ["experiment=lhco/x_jet", "data.synthetic=true",
                   "data.synthetic_num_events=2000"],
    "jetclass_cond": ["experiment=jetclass/jetclass_cond", "data.synthetic=true",
                      "data.synthetic_num_jets=800"],
    "EPiC classifier": None,
}


def _family(name, cuda):
    """(model, optimizer, the train split as device tensors, batch size)."""
    from particle_fm_tpu_torch.config.core import compose, instantiate, load_config
    from particle_fm_tpu_torch.utils.run_io import build_run

    if FAMILIES[name] is None:  # configs/model/epic_classifier.yaml on random sets
        cfg = load_config(os.path.join(CONFIGS, "model", "epic_classifier.yaml"))
        model = instantiate({k: v for k, v in cfg.items() if k not in ("optimizer", "scheduler")})
        rs = np.random.RandomState(0)
        n, parts = 96, model.num_particles
        mask = (np.arange(parts)[None] < rs.randint(20, parts, (n, 1))).astype(np.float32)[..., None]
        x = rs.randn(n, parts, model.features).astype(np.float32) * mask
        split = (x, mask, (rs.rand(n, 1) < 0.5).astype(np.float32))
        return model, pstep.make_optimizer(), [torch.from_numpy(a).to(cuda) for a in split], 32
    dm, model, opt = build_run(compose(CONFIGS, "train", FAMILIES[name]))
    split = [None if a is None else torch.as_tensor(a).to(cuda)
             for a in (dm.train.x, dm.train.mask, dm.train.cond)]
    return model, opt, split, min(dm.batch_size, 256)


@pytest.mark.cuda
@pytest.mark.parametrize("name", list(FAMILIES))
def test_every_shipped_family_captures(cuda, name):
    model, opt, split, b = _family(name, cuda)
    n = split[0].shape[0]
    perms = np.stack([np.random.RandomState(i).permutation(n)[:b] for i in range(3)])[None]
    states = [pstep.create_train_state(model, opt, seed=1, device=cuda) for _ in range(2)]
    eager = pstep.make_train_step(model, opt)
    gen, want = torch.Generator(cuda), []
    for p in perms[0]:
        idx = torch.from_numpy(p).to(cuda)
        gen.manual_seed(pepochs.step_seed(0, states[0].step))
        want.append(eager(states[0], gen, *[None if a is None else a.index_select(0, idx)
                                            for a in split]))
    run = pepochs.make_train_superepoch(model, opt, seed=0)
    got = run(states[1], *split, perms)
    assert run.runner.captures == int(cuda.type == "cuda")
    torch.testing.assert_close(got.reshape(-1), torch.stack(want).float(), rtol=0, atol=0)
    for a, b_ in zip(_state_tensors(states[1]), _state_tensors(states[0])):
        assert torch.equal(a, b_)
