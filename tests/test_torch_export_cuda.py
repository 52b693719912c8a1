"""PyTorch port, the served artifact and the kernels' custom ops on the card:

- `torch.library.opcheck` of each custom op's CUDA implementation (schema,
  fake implementation, autograd registration, AOT dispatch), each in its
  type, the bfloat16 flash op's class-token route too;
- an artifact exported for CUDA (serving.py) equals `make_serve_fn` bit for
  bit for the same seeds and weights, and launches its kernel an exact
  number of times a batch: a narrow EPiC flagship (midpoint, float32 and
  bfloat16) and the narrow attention paths (packed, fused, flash; euler);
- a process that imports no model code loads the EPiC artifact, and its
  samples and launches are those of this process;
- every looped solver's artifact (em, with guidance too, ddim, ab2, ab3,
  the self-conditioned midpoint loop, dopri5 and dopri5_per_sample; float32
  and bfloat16) equals `make_serve_fn` bit for bit, launches the EPiC kernel
  once a layer an evaluation, and DOPRI5 reports the live run's attempts.

Every test needs an NVIDIA GPU and skips without one. This file imports no
JAX:

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_export_cuda.py
"""

from __future__ import annotations

import dataclasses
import json
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from particle_fm_tpu_torch import serving
from particle_fm_tpu_torch.models.flow_matching import FlowMatchingModel
from particle_fm_tpu_torch.ops import epic_layer as ops
from particle_fm_tpu_torch.ops import flash_attention as fa
from particle_fm_tpu_torch.ops import short_attention as sa

ROOT = Path(__file__).resolve().parent.parent
BF16 = torch.bfloat16
JETS = dict(features=3, frequencies=16, t_emb="cosine", loss_type="FM-OT", num_particles=30,
            global_cond_dim=2)
EPIC = dict(JETS, model="epic", hidden_dim=32, latent=4, layers=2, t_global_cat=True,
            t_local_cat=True, add_time_to_input=False, local_cond_dim=2)


def _mha(attn_impl):
    embd = {"act_h": "lrlu", "nrm": "layer"}
    return {"num_heads": 4, "init_zeros": False, "do_layer_norm": True, "scores_dtype": None,
            "attn_impl": attn_impl}, embd


def _droid(core, attn_impl, **kw):
    mha, embd = _mha(attn_impl)
    return dict(JETS, model="droid_fulltransformer" if core == "te_config"
                else "droid_fullcrossattention", add_time_to_input=True, net_config={
                    "node_embd_config": embd, "ctxt_embd_config": dict(embd, outp_dim=16),
                    "outp_embd_config": embd,
                    core: {"model_dim": 32, "num_layers": 1, "mha_config": mha,
                           "dense_config": dict(embd, **kw)}})


PATHS = {  # config, counting wrapper, launches an evaluation
    "packed": (_droid("te_config", "packed"), sa.packed_short_attention, 1),
    "fused": (_droid("cae_config", "fused", hddn_dim=32), sa.fused_short_attention, 2),
    "flash": (_droid("te_config", "flash"), fa.flash_masked_attention, 1),
    "class_token": (dict(model="mdma", features=4, num_particles=1200, global_cond_dim=1,
                         frequencies=16, t_emb="cosine", add_time_to_input=False,
                         loss_type="CFM", net_config=dict(latent=16, hidden_dim=256, layers=2,
                                                          num_heads=2, t_local_cat=True,
                                                          t_global_cat=True, global_cond_dim=1)),
                    fa.flash_masked_attention, 2),
}
BF16_TWIN = {sa.packed_short_attention: sa.packed_short_attention_bf16,
             sa.fused_short_attention: sa.fused_short_attention_bf16,
             fa.flash_masked_attention: fa.flash_masked_attention_bf16}
COUNTED = [ops.epic_layer, ops.epic_layer_bf16, sa.packed_short_attention,
           sa.packed_short_attention_bf16, sa.fused_short_attention, sa.fused_short_attention_bf16,
           fa.flash_masked_attention, fa.flash_masked_attention_bf16]


@pytest.fixture()
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU; the kernels have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _request(model, b, seed=0):
    rs = np.random.RandomState(seed)
    n = model.num_particles
    mask = (np.arange(n)[None, :] < rs.randint(n // 3, n + 1, (b, 1))).astype(np.float32)
    return mask[..., None], rs.randn(b, model.global_cond_dim).astype(np.float32)


def _launches():
    return {w.__name__: w.launches for w in COUNTED}


def _held(model, net, tmp_path, counter, per_eval, solver, steps, b=8):
    """Export, load, run one batch: bit for bit against make_serve_fn, the
    exact launches; returns the artifact's directory and the request."""
    kw = dict(batch_size=b, ode_solver=solver, ode_steps=steps, means=[0.0] * model.features,
              stds=[0.5] * model.features)
    serving.export_sampler(model, net, num_points=model.num_particles,
                           features=model.features, cond_dim=model.global_cond_dim,
                           out_dir=str(tmp_path), **kw)
    fn, meta = serving.load_exported(str(tmp_path))
    assert meta["platforms"] == ["cuda"]
    live = serving.make_serve_fn(model, net, has_cond=True, has_mask=True, **kw)
    mask, cond = _request(model, b)
    for w in COUNTED:
        w.launches = 0
    got = fn(11, cond, mask)
    torch.cuda.synchronize()
    nfe = (steps - 1) * (2 if solver == "midpoint" else 1)
    want = {w.__name__: 0 for w in COUNTED}
    want[counter.__name__] = per_eval * nfe
    assert _launches() == want
    assert torch.equal(got, live(11, cond, mask)) and bool(torch.isfinite(got).all())
    return mask, cond


def _opcheck_cases(dev):
    gen = torch.Generator().manual_seed(0)

    def r(*shape, scale=1.0):
        return (torch.randn(*shape, generator=gen) * scale).to(dev)

    b, n, h, lat, t, c = 4, 16, 32, 8, 4, 2
    mask = torch.ones(b, n, device=dev)
    mask[0, 10:] = 0
    epic = [r(b, n, h), r(b, lat), mask, r(b, t + c), r(t + 2 * h + lat + c, h, scale=0.1), r(h),
            r(t + h + c, lat, scale=0.1), r(lat), r(h, h, scale=0.1), r(t + lat + c, h, scale=0.1),
            r(h), r(h, h, scale=0.1), r(t + c, h, scale=0.1), r(h)]
    e16 = [a if i == 2 else a.to(BF16) for i, a in enumerate(epic)]
    image = ops.bf16_weight_image(e16[4], e16[6], e16[9], e16[12], e16[8], e16[11])
    q, k, v = r(b, n, 2, 16), r(b, n, 2, 16), r(b, n, 2, 16)
    b16 = [x.to(BF16) for x in (q, k, v)]
    tok = [r(b, 1, 2, 128).to(BF16), r(b, 600, 2, 128).to(BF16), r(b, 600, 2, 128).to(BF16)]
    pf, dims = torch.ops.particle_fm, (0.01, t, t, c, c)
    return {
        "epic_layer": (pf.epic_layer, (*epic, *dims)),
        "epic_layer_bf16": (pf.epic_layer_bf16, (*e16, *dims, image)),
        "packed_short_attention": (pf.packed_short_attention, (q, k, v, mask, r(b, 2, n, n))),
        "packed_short_attention_bf16": (pf.packed_short_attention_bf16, (*b16, mask, None)),
        "fused_short_attention": (pf.fused_short_attention, (q, k, v, mask, r(b, 2, n, n))),
        "fused_short_attention_bf16": (pf.fused_short_attention_bf16, (*b16, mask, None)),
        "flash_masked_attention": (pf.flash_masked_attention, (q, k, v, mask)),
        "flash_masked_attention_bf16": (pf.flash_masked_attention_bf16, (*b16, mask)),
        "class_token_bf16": (pf.flash_masked_attention_bf16,
                             (*tok, torch.ones(b, 600, device=dev))),
    }


OPCHECK = ["epic_layer", "epic_layer_bf16", "packed_short_attention",
           "packed_short_attention_bf16", "fused_short_attention", "fused_short_attention_bf16",
           "flash_masked_attention", "flash_masked_attention_bf16", "class_token_bf16"]


@pytest.mark.cuda
@pytest.mark.parametrize("name", OPCHECK)
def test_opcheck_on_the_card(cuda, name):
    op, args = _opcheck_cases(cuda)[name]
    torch.library.opcheck(op, args)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [None, "bfloat16"], ids=["f32", "bf16"])
def test_epic_artifact_on_the_card(cuda, tmp_path, dtype):
    model = FlowMatchingModel(**EPIC, dtype=dtype)
    net = model.init(seed=0, device=cuda)
    counter = ops.epic_layer_bf16 if dtype else ops.epic_layer
    mask, cond = _held(model, net, tmp_path, counter, model.layers, "midpoint", 4)
    np.savez(tmp_path / "req.npz", cond=cond, mask=mask)
    code = (
        "import json, sys, numpy as np, torch\n"
        f"sys.path.insert(0, {str(ROOT)!r})\n"
        "from particle_fm_tpu_torch import serving\n"
        "from particle_fm_tpu_torch.ops import epic_layer as ops\n"
        f"fn, meta = serving.load_exported({str(tmp_path)!r})\n"
        f"d = np.load({str(tmp_path / 'req.npz')!r})\n"
        "x = fn(11, d['cond'], d['mask']); torch.cuda.synchronize()\n"
        f"np.save({str(tmp_path / 'x.npy')!r}, x.cpu().numpy())\n"
        "bad = [m for m in sys.modules if m.startswith(tuple('particle_fm_tpu_torch.' + p for p "
        "in ('models', 'nets', 'config', 'training')))]\n"
        "print(json.dumps({'bad': bad, 'launches': [ops.epic_layer.launches, "
        "ops.epic_layer_bf16.launches]}))\n"
    )
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                          text=True, timeout=600, check=True)
    out = json.loads(proc.stdout.strip().splitlines()[-1])
    assert out["bad"] == []
    assert sum(out["launches"]) == model.layers * 6 and out["launches"][bool(dtype)] > 0
    live = serving.make_serve_fn(model, net, batch_size=8, ode_solver="midpoint", ode_steps=4,
                                 has_cond=True, has_mask=True, means=[0.0] * 3, stds=[0.5] * 3)
    np.testing.assert_array_equal(np.load(tmp_path / "x.npy"), live(11, cond, mask).cpu().numpy())


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [None, "bfloat16"], ids=["f32", "bf16"])
@pytest.mark.parametrize("path", list(PATHS))
def test_attention_artifacts_on_the_card(cuda, tmp_path, path, dtype):
    cfg, counter, per_eval = PATHS[path]
    model = FlowMatchingModel(**cfg)
    net = model.init(seed=0, device=cuda)
    if dtype:
        model = dataclasses.replace(model, dtype=dtype)
        net16 = model.init(seed=0, device=cuda)
        net16.load_state_dict(net.state_dict())
        net, counter = net16, BF16_TWIN[counter]
    _held(model, net, tmp_path, counter, per_eval, "euler", 3, b=4)


DIFFUSION = dict(EPIC, loss_type="diffusion", criterion="huber",
                 diff_config={"max_sr": 0.999, "min_sr": 0.02})
SINCOS = dict(EPIC, t_emb="sincos", frequencies=2)
SOLVER_CASES = {  # config, solver, ode_steps, guidance, evaluations a batch (None: the stats')
    "em": (DIFFUSION, "em", 6, None, 6),
    "em_guidance": (DIFFUSION, "em", 6, 2.0, 6),
    "ddim": (DIFFUSION, "ddim", 6, None, 6),
    "ab2": (EPIC, "ab2", 6, None, 5),
    "ab3": (EPIC, "ab3", 6, None, 6),
    "self_cond_midpoint": (dict(EPIC, self_cond=True), "midpoint", 4, None, 6),
    "dopri5": (SINCOS, "dopri5", 100, None, None),
    "dopri5_per_sample": (SINCOS, "dopri5_per_sample", 100, None, None),
}


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [None, "bfloat16"], ids=["f32", "bf16"])
@pytest.mark.parametrize("case", list(SOLVER_CASES))
def test_solver_artifacts_on_the_card(cuda, tmp_path, case, dtype):
    """Every looped solver's artifact (one `while_loop` of one step) equals
    make_serve_fn bit for bit on the card and launches the EPiC kernel once
    a layer an evaluation; DOPRI5 reports the live run's attempts."""
    cfg, solver, steps, guidance, nfe = SOLVER_CASES[case]
    model = FlowMatchingModel(**cfg, dtype=dtype)
    net = model.init(seed=0, device=cuda)
    counter = ops.epic_layer_bf16 if dtype else ops.epic_layer
    b = 8
    kw = dict(batch_size=b, ode_solver=solver, ode_steps=steps, means=[0.1, -0.2, 0.3],
              stds=[1.5, 0.5, 2.0], guidance_scale=guidance)
    serving.export_sampler(model, net, num_points=model.num_particles, features=3, cond_dim=2,
                           out_dir=str(tmp_path), **kw)
    fn, meta = serving.load_exported(str(tmp_path))
    assert meta["platforms"] == ["cuda"] and ("step_noise" in meta) == (solver == "em")
    live = serving.make_serve_fn(model, net, has_cond=True, has_mask=True, **kw)
    mask, cond = _request(model, b, seed=3)
    for seed in (11, 2**40 + 3):
        for w in COUNTED:
            w.launches = 0
        got = fn(seed, cond, mask)
        torch.cuda.synchronize()
        launches = _launches()
        if nfe is None:
            (st,) = fn.stats
            stats = []
            model.sample(net, torch.Generator(cuda).manual_seed(seed),
                         cond=torch.as_tensor(cond, device=cuda),
                         mask=torch.as_tensor(mask, device=cuda), ode_solver=solver, stats=stats)
            assert torch.equal(torch.as_tensor(st["steps"]).cpu(),
                               torch.as_tensor(stats[0]["steps"]).cpu())
            assert bool(torch.as_tensor(st["reached"]).all())
            nfe = 7 * int(st["loops"] if solver == "dopri5_per_sample" else st["steps"])
        want = {w.__name__: 0 for w in COUNTED}
        want[counter.__name__] = model.layers * nfe
        assert launches == want
        assert torch.equal(got, live(seed, cond, mask)) and bool(torch.isfinite(got).all())
        nfe = SOLVER_CASES[case][4]
