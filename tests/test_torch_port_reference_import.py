"""PyTorch port, reference-checkpoint import
(particle_fm_tpu_torch/utils/torch_import.py and
scripts/torch_import_reference_ckpt.py) held against the JAX package's
(particle_fm_tpu/utils/torch_import.py, scripts/import_reference_ckpt.py).

No reference checkout is needed: a state dict under the reference's key
names (what the JAX `*_params_from_sd` converters read) is written from a
seeded port network by `reference_state_dict`, with the `loss.flows.*`
aliases of a Lightning checkpoint and, for MDMA, the dead `cond_cls`
Linears. For EPiC, both droid transformers and MDMA the port's import equals
`from_jax` of JAX's import bit for bit, and the vector fields (sincos time,
JAX's jitted) agree within 1e-5; the refusals raise as in JAX. The CLI's run directory loads through
`load_run`, and 16 sets sampled from it (sincos time, the same noise) lie
within 1e-4 of JAX's `load_run` on JAX's own import directory.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from particle_fm_tpu.models.flow_matching import FlowMatchingModel as JaxModel
from particle_fm_tpu.utils import torch_import as jti
from particle_fm_tpu_torch.models.flow_matching import FlowMatchingModel as PortModel
from particle_fm_tpu_torch.utils import torch_import as pti
from particle_fm_tpu_torch.utils.from_jax import state_dict_from_flax
from scripts import import_reference_ckpt as jcli
from scripts import torch_import_reference_ckpt as pcli
from tests.torch_port_helpers import (
    MDMA_SMALL,
    YAML_FLAGSHIP,
    cloud,
    droid_configs,
    jax_noise,
    t,
)

CONFIGS = {"epic": YAML_FLAGSHIP,
           **{name: cfg for name, (cfg, _) in droid_configs().items()},
           "mdma": MDMA_SMALL}
SCALE = {"mdma": 0.15}  # of the drawn parameters: keeps MDMA's 2-layer field of order 1


def seeded_network(cfg: dict, seed: int = 0, scale: float = 0.3):
    """(port model, its network with every parameter a seeded normal draw)."""
    pm = PortModel(**cfg)
    net = pm.init(seed=seed, device="cpu")
    rs = np.random.RandomState(seed)
    with torch.no_grad():
        for p in net.parameters():
            p.copy_(torch.from_numpy((rs.randn(*p.shape) * scale).astype(np.float32)))
    return pm, net


def shapes_only(jm: JaxModel) -> JaxModel:
    """`jm` with an `init` that traces shapes only: JAX's import reads its
    template's shapes and nothing else, and a traced init costs seconds less."""
    init = jm.init
    object.__setattr__(jm, "init", lambda rng: jax.eval_shape(init, rng))
    return jm


def lightning_state_dict(net) -> dict:
    """The network under the reference's names as a Lightning checkpoint
    holds it: `flows.*`, their `loss.flows.*` aliases (one tensor apart: the
    importer must not read them) and MDMA's dead `cond_cls` Linears."""
    sd = pti.reference_state_dict(net.state_dict())
    blocks = {k.rsplit(".attn.", 1)[0] for k in sd if ".attn.in_proj_weight" in k}
    for b in blocks:
        sd[f"{b}.cond_cls.weight"] = torch.zeros(4, 2)
        sd[f"{b}.cond_cls.bias"] = torch.zeros(4)
    sd.update({f"loss.{k}": v + 1.0 for k, v in sd.items()})
    return sd


@pytest.fixture(scope="module", params=list(CONFIGS))
def imported(request):
    cfg = CONFIGS[request.param]
    pm, net = seeded_network(cfg, scale=SCALE.get(request.param, 0.3))
    sd = lightning_state_dict(net)
    jm = JaxModel(**cfg)
    variables = jti.variables_from_reference_state_dict(sd, shapes_only(JaxModel(**cfg)))
    return request.param, cfg, pm, net, sd, jm, variables


def test_import_is_from_jax_of_the_jax_import_bit_for_bit(imported):
    name, _, pm, net, sd, _, variables = imported
    got = pti.state_dict_from_reference(sd, pm)
    want = state_dict_from_flax(jax.device_get(variables["params"]))
    assert sorted(got) == sorted(want) == sorted(net.state_dict())
    for k, v in got.items():
        assert v.dtype == torch.float32
        assert torch.equal(v, want[k]), k
        assert torch.equal(v, net.state_dict()[k]), k  # the relayout is exact both ways
    fresh = pm.init(seed=5, device="cpu")
    fresh.load_state_dict(got)
    for k, v in fresh.state_dict().items():
        assert torch.equal(v, got[k]), k


def test_imported_field_matches_jax(imported):
    """The field of the imported weights with sincos time (the parameter-free
    embeddings carry no weight), JAX's jitted: under jit XLA's cosine table
    is an ulp off the one the port would load."""
    name, cfg, _, net, sd, _, variables = imported
    pm, jm = PortModel(**dict(cfg, t_emb="sincos")), JaxModel(**dict(cfg, t_emb="sincos"))
    fresh = pm.init(seed=1, device="cpu")
    fresh.load_state_dict(pti.state_dict_from_reference(sd, pm))
    x, mask, cond, ts = cloud(b=3, feats=pm.features, cond_dim=pm.global_cond_dim, seed=3)
    ref = np.asarray(jax.jit(jm.vector_field)(variables, jnp.asarray(ts), jnp.asarray(x),
                                              jnp.asarray(cond), jnp.asarray(mask)))
    with torch.no_grad():
        out = pm.vector_field(fresh, t(ts), t(x), t(cond), t(mask)).numpy()
    assert np.abs(ref).max() > 0.1  # a field that a wrong weight would move
    np.testing.assert_allclose(out, ref, atol=1e-5)


def test_refusals_match_jax():
    pm, net = seeded_network(YAML_FLAGSHIP)
    sd = lightning_state_dict(net)
    cases = [
        (dict(YAML_FLAGSHIP, hidden_dim=16), ValueError),  # a mismatched model
        (dict(YAML_FLAGSHIP, layers=3), ValueError),
        (dict(YAML_FLAGSHIP, t_emb="gaussian"), NotImplementedError),
        (dict(YAML_FLAGSHIP, use_normaliser=True), NotImplementedError),
        (dict(YAML_FLAGSHIP, model="flat"), NotImplementedError),
    ]
    for cfg, exc in cases:
        with pytest.raises(exc) as want:
            jti.variables_from_reference_state_dict(sd, shapes_only(JaxModel(**cfg)))
        with pytest.raises(exc) as got:
            pti.state_dict_from_reference(sd, PortModel(**cfg))
        assert type(got.value) is type(want.value)
    # only the aliases: no `flows.{k}.net.` keys
    aliases = {k: v for k, v in sd.items() if k.startswith("loss.")}
    for load, model in ((jti.variables_from_reference_state_dict,
                         shapes_only(JaxModel(**YAML_FLAGSHIP))),
                        (pti.state_dict_from_reference, pm)):
        with pytest.raises(KeyError, match="flows.0.net"):
            load(aliases, model)
    with pytest.raises(ValueError, match=r"shape mismatch at flows\.0\.net\.fc_l1\.weight_v"):
        bad = dict(sd, **{"flows.0.net.fc_l1.weight_v": torch.zeros(3, 3)})
        pti.state_dict_from_reference(bad, pm)
    # the parametrizations spelling of weight norm reads the same
    renamed = {k.replace(".weight_g", ".parametrizations.weight.original0")
               .replace(".weight_v", ".parametrizations.weight.original1"): v
               for k, v in sd.items()}
    got = pti.state_dict_from_reference(renamed, pm)
    for k, v in net.state_dict().items():
        assert torch.equal(got[k], v), k


NARROW_RUN = ["experiment=jetnet/fm_tops30_cond", "data.synthetic=true",
              "data.synthetic_num_jets=200", "model.hidden_dim=16", "model.layers=2",
              "model.latent=4", "model.t_emb=sincos"]


def test_cli_run_directory_loads_and_samples_as_jax(tmp_path, monkeypatch):
    from particle_fm_tpu.utils.run_io import load_run as jax_load_run

    # JAX's CLI and load_run build the model's init op by op; jitted it
    # draws the same arrays in a fraction of the time
    init = JaxModel.init
    monkeypatch.setattr(JaxModel, "init", lambda self, rng: jax.jit(lambda r: init(self, r))(rng))
    from particle_fm_tpu_torch.utils.run_io import load_run

    port_dir, jax_dir = str(tmp_path / "port"), str(tmp_path / "jax")
    # the model the dotlist composes, seeded, under the reference's names
    from particle_fm_tpu_torch.config.core import compose
    from particle_fm_tpu_torch.train import CONFIG_DIR
    from particle_fm_tpu_torch.utils.run_io import build_run

    _, model, _ = build_run(compose(CONFIG_DIR, "train", overrides=NARROW_RUN))
    net = model.init(seed=2, device="cpu")
    with torch.no_grad():
        rs = np.random.RandomState(2)
        for p in net.parameters():
            p.copy_(torch.from_numpy((rs.randn(*p.shape) * 0.3).astype(np.float32)))
    ckpt = tmp_path / "epoch=9-EMA.ckpt"
    torch.save({"state_dict": lightning_state_dict(net)}, ckpt)

    assert pcli.main(["--ckpt", str(ckpt), "--out", port_dir] + NARROW_RUN) == port_dir
    jcli.main(["--ckpt", str(ckpt), "--out", jax_dir] + NARROW_RUN)

    for ema in (True, False):
        _, dm, pm, got = load_run(port_dir, "last", ema=ema, device="cpu")
        for k, v in got.state_dict().items():
            assert torch.equal(v, net.state_dict()[k]), k
    _, jdm, jm, variables = jax_load_run(jax_dir, "last")
    _, mask, cond, _ = cloud(b=16, n=pm.num_particles, cond_dim=pm.global_cond_dim, seed=5)
    ref = np.asarray(jm.sample(variables, jax.random.PRNGKey(3), cond=jnp.asarray(cond),
                               mask=jnp.asarray(mask), ode_steps=5))
    z = jax_noise(3, ref.shape, mask)
    out = pm.integrate(got, t(z), t(cond), t(mask), "midpoint", 5).numpy()
    assert ref.shape == (16, pm.num_particles, 3)
    np.testing.assert_allclose(out, ref, atol=1e-4)
