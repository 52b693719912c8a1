"""PyTorch port, the fused EPiC layer (ops/epic_layer.py, csrc/epic_layer.cu).

On the CPU: the plain version `epic_layer_reference` against the JAX linen
`EPiCLayer` and against the Pallas kernel `epic_layer_fused_fwd` in
interpret mode, and the port's `EPiCLayer` (module path and folded path)
against the linen layer, for these layouts: t-cats on with cond (the yaml
flagship), t-cats off with cond (__graft_entry__.py), t-cats on without
cond, neither (the second local bias is then b2 alone), cond on the global
MLPs only (configs/experiment/jetclass/jetclass_cond.yaml) and cond on the
local biases only. The Pallas kernel takes one cond width for both paths, so
it is compared only where cond feeds both or neither. Tolerance: atol 1e-5
(float32; H=32-wide matmuls summed in another order). The kernel itself is held against the plain version on the card by
tests/test_torch_port_kernel.py and chip_smoke.py.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from particle_fm_tpu.nets.epic import EPiCLayer as JaxEPiCLayer
from particle_fm_tpu.ops.pallas.epic_layer import epic_layer_fused_fwd
from particle_fm_tpu_torch.nets.epic import EPiCLayer
from particle_fm_tpu_torch.ops import epic_layer as ops
from particle_fm_tpu_torch.utils.from_jax import load_flax_params
from tests.torch_port_helpers import t

ATOL = 1e-5
B, N, H, L, T = 4, 16, 32, 8, 12

# c: width of cond; cg, cl: whether it feeds the global MLPs, the local biases
LAYOUTS = {
    "yaml": dict(t_cat=True, c=2, cg=True, cl=True),
    "graft": dict(t_cat=False, c=2, cg=True, cl=True),
    "nocond": dict(t_cat=True, c=0, cg=False, cl=False),
    "bare": dict(t_cat=False, c=0, cg=False, cl=False),
    "global_cond_only": dict(t_cat=True, c=5, cg=True, cl=False),
    "local_cond_only": dict(t_cat=True, c=3, cg=False, cl=True),
}


def _cond_dims(cfg: dict) -> tuple[int, int]:
    return (cfg["c"] if cfg["cg"] else 0), (cfg["c"] if cfg["cl"] else 0)


def _inputs(c: int, seed: int = 0, b: int = B, n: int = N, h: int = H):
    rs = np.random.RandomState(seed)
    x = rs.randn(b, n, h).astype(np.float32)
    g = rs.randn(b, L).astype(np.float32)
    temb = rs.randn(b, T).astype(np.float32)
    cond = rs.randn(b, c).astype(np.float32) if c else None
    n_valid = rs.randint(3, n + 1, size=(b, 1))
    mask = (np.arange(n)[None, :] < n_valid).astype(np.float32)
    return x, g, temb, cond, mask


def _fold(p):
    v, g, b = (np.asarray(p[k]) for k in ("kernel", "g", "bias"))
    return v * (g[None, :] / np.maximum(np.linalg.norm(v, axis=0, keepdims=True), 1e-12)), b


def _kernel_weights(params, tl: int, h: int = H):
    """The fused layer's weights from a linen EPiCLayer's params, cut as
    tests/test_pallas.py cuts them."""
    wg1, bg1 = _fold(params["fc_global1"])
    wg2, bg2 = _fold(params["fc_global2"])
    w1, b1 = _fold(params["fc_local1"])
    w2, b2 = _fold(params["fc_local2"])
    w1x, w1s = w1[tl : tl + h], np.concatenate([w1[:tl], w1[tl + h :]], axis=0)
    w2x, w2s = w2[tl : tl + h], np.concatenate([w2[:tl], w2[tl + h :]], axis=0)
    return [wg1, bg1, wg2, bg2, w1x, w1s, b1, w2x, w2s, b2]


def _jax_layer(layout: str, seed: int = 0):
    cfg = LAYOUTS[layout]
    c = cfg["c"]
    cg, cl = _cond_dims(cfg)
    x, g, temb, cond, mask = _inputs(c, seed)
    layer = JaxEPiCLayer(hid_dim=H, latent_dim=L, global_cond_dim=cg, local_cond_dim=cl,
                         t_local_cat=cfg["t_cat"], t_global_cat=cfg["t_cat"])
    tb = jnp.asarray(np.tile(temb[:, None, :], (1, N, 1)))
    jcond = None if cond is None else jnp.asarray(cond)
    jmask = jnp.asarray(mask[..., None])
    params = layer.init(jax.random.PRNGKey(seed), tb, jnp.asarray(g), jnp.asarray(x),
                        cond=jcond, mask=jmask)
    ref_g, ref_x = layer.apply(params, tb, jnp.asarray(g), jnp.asarray(x), cond=jcond, mask=jmask)
    tdim = T if cfg["t_cat"] else 0
    set_feat = np.concatenate([temb[:, :tdim]] + ([cond] if c else []), axis=-1)
    dims = dict(sum_scale=1e-2, tg_dim=tdim, tl_dim=tdim, cg_dim=cg, cl_dim=cl)
    return dict(x=x, g=g, temb=temb, cond=cond, mask=mask, set_feat=set_feat, dims=dims,
                params=jax.device_get(params["params"]),
                ref_x=np.asarray(ref_x), ref_g=np.asarray(ref_g))


@pytest.mark.parametrize("layout", list(LAYOUTS))
def test_reference_matches_linen_layer(layout):
    d = _jax_layer(layout)
    w = _kernel_weights(d["params"], d["dims"]["tl_dim"])
    xo, go = ops.epic_layer_reference(t(d["x"]), t(d["g"]), t(d["mask"]), t(d["set_feat"]),
                                      *map(t, w), **d["dims"])
    np.testing.assert_allclose(xo.numpy(), d["ref_x"], atol=ATOL)
    np.testing.assert_allclose(go.numpy(), d["ref_g"], atol=ATOL)


# the Pallas kernel takes no zero-width set_feat, so "bare" is not among these,
# and one cond width for both paths, so neither are the one-sided layouts
@pytest.mark.parametrize("layout", ["yaml", "graft", "nocond"])
def test_reference_matches_pallas_interpret(layout):
    d = _jax_layer(layout, seed=1)
    w = _kernel_weights(d["params"], d["dims"]["tl_dim"])
    dims = d["dims"]
    jxo, jgo = epic_layer_fused_fwd(
        jnp.asarray(d["x"]), jnp.asarray(d["g"]), jnp.asarray(d["mask"]),
        jnp.asarray(d["set_feat"]), *map(jnp.asarray, w), sum_scale=dims["sum_scale"],
        tg_dim=dims["tg_dim"], tl_dim=dims["tl_dim"], c_dim=dims["cg_dim"],
        tile_b=2, interpret=True,
    )
    xo, go = ops.epic_layer_reference(t(d["x"]), t(d["g"]), t(d["mask"]), t(d["set_feat"]),
                                      *map(t, w), **d["dims"])
    np.testing.assert_allclose(xo.numpy(), np.asarray(jxo), atol=ATOL)
    np.testing.assert_allclose(go.numpy(), np.asarray(jgo), atol=ATOL)


@pytest.mark.parametrize("layout", list(LAYOUTS))
def test_port_layer_matches_linen_layer(layout):
    d = _jax_layer(layout, seed=2)
    cfg = LAYOUTS[layout]
    cg, cl = _cond_dims(cfg)
    layer = EPiCLayer(hid_dim=H, latent_dim=L, t_dim=T, cond_dim=cfg["c"], global_cond_dim=cg,
                      local_cond_dim=cl, t_local_cat=cfg["t_cat"], t_global_cat=cfg["t_cat"])
    load_flax_params(layer, d["params"])
    args = (t(d["temb"]), t(d["g"]), t(d["x"]),
            None if d["cond"] is None else t(d["cond"]), t(d["mask"][..., None]))
    launches = ops.epic_layer.launches
    with torch.no_grad():
        for folded in (False, True):
            if folded:
                layer.fold()
            go, xo = layer(*args)
            np.testing.assert_allclose(xo.numpy(), d["ref_x"], atol=ATOL)
            np.testing.assert_allclose(go.numpy(), d["ref_g"], atol=ATOL)
    assert ops.epic_layer.launches == launches  # CPU tensors never count a launch


def test_padded_rows_finite_and_empty_set_nan():
    """Padded rows get finite values; a set with no real particle gives 0/0
    in the mean and so NaN, as the JAX layer does (no epsilon)."""
    d = _jax_layer("yaml")
    w = _kernel_weights(d["params"], T)
    mask = d["mask"].copy()
    mask[1] = 0.0
    xo, go = ops.epic_layer_reference(t(d["x"]), t(d["g"]), t(mask), t(d["set_feat"]),
                                      *map(t, w), **d["dims"])
    keep = np.arange(B) != 1
    assert np.isfinite(xo.numpy()[keep]).all() and np.isfinite(go.numpy()[keep]).all()
    assert np.isnan(xo.numpy()[1]).all() and np.isnan(go.numpy()[1]).all()


def test_fold_refuses_what_the_kernel_does_not_compute():
    """Only another activation is refused: cond on one MLP path alone is
    computed (the layouts above hold it against linen)."""
    with pytest.raises(NotImplementedError, match="leaky_relu"):
        EPiCLayer(hid_dim=8, latent_dim=4, activation="gelu").fold()
    for gc, lc in ((2, 0), (0, 2)):
        layer = EPiCLayer(hid_dim=8, latent_dim=4, cond_dim=2, global_cond_dim=gc,
                          local_cond_dim=lc)
        layer.fold()
        w = layer._kernel_weights
        assert w["wg1"].shape == (2 * 8 + 4 + gc, 8) and w["wg2"].shape == (8 + gc, 4)
        assert w["w1s"].shape == (4 + lc, 8) and w["w2s"].shape == (lc, 8)
