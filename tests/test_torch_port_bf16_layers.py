"""PyTorch port in bfloat16, layer by layer, held against the JAX package in
bfloat16 on the same numpy inputs and parameters.

Two kinds of gate:
  * layers and the kernels' plain versions: the largest |port - JAX| within
    a stated number of bfloat16 ulps of the largest |out| (`ulps`): 1 for the
    Dense layers, the pool, LayerNorm, leaky_relu and the einsum attention
    (the same operations rounded at the same places: the port matches JAX's
    op-by-op bfloat16 to the bit on these inputs, and one ulp leaves room for
    a product summed in another order), 2 for the plain versions of the four
    kernels against the Pallas kernels in interpret mode (the sums of the
    products run in other orders, so a value next to a rounding boundary of
    an intermediate such as x1 or P may round the other way);
  * the EPiC layer's module path: the inequality
    |port_bf16 - jax_bf16| < |jax_bf16 - jax_f32| (Frobenius norms, `bf16_gaps`):
    the port in bfloat16 is closer to JAX in bfloat16 than JAX's bfloat16 is
    to its float32. The folded layer rounds where the Pallas kernel rounds
    (four times), the linen layer after every Dense: the two are different
    bfloat16 computations of one function, so that gap is held to 1.5 times
    JAX's own bfloat16 gap (`FOLDED_GAP`; roundings that are independent add
    up to about sqrt(2) of one).
Each test prints what it measured.
"""

from __future__ import annotations

import math

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tests.test_torch_port_epic_layer as f32_epic
from particle_fm_tpu.nets import common as jcommon
from particle_fm_tpu.nets.epic import EPiCLayer as JaxEPiCLayer
from particle_fm_tpu.ops import attention as jattn
from particle_fm_tpu.ops import masked as jmasked
from particle_fm_tpu.ops.pallas import flash_attention as jflash
from particle_fm_tpu.ops.pallas import short_attention as jshort
from particle_fm_tpu.ops.pallas.epic_layer import epic_layer_fused_fwd
from particle_fm_tpu_torch.nets import common as pcommon
from particle_fm_tpu_torch.nets.epic import EPiCLayer
from particle_fm_tpu_torch.ops import attention as pattn
from particle_fm_tpu_torch.ops import epic_layer as pepic
from particle_fm_tpu_torch.ops import flash_attention as pflash
from particle_fm_tpu_torch.ops import masked as pmasked
from particle_fm_tpu_torch.ops import short_attention as pshort
from particle_fm_tpu_torch.utils.from_jax import load_flax_params
from tests.torch_port_helpers import FOLDED_GAP, bf16_gaps

BF16 = torch.bfloat16


def ulps(got, want) -> float:
    """max |got - want| in bfloat16 ulps of the largest |want|."""
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    top = float(np.abs(want).max())
    return float(np.abs(got - want).max()) / 2.0 ** (math.floor(math.log2(top)) - 7)


def j16(a):
    return jnp.asarray(np.asarray(a, np.float32), jnp.bfloat16)


def p16(a):
    return torch.from_numpy(np.asarray(a, np.float32).copy()).to(BF16)


def f32(a) -> np.ndarray:
    if isinstance(a, torch.Tensor):
        return a.float().numpy()
    return np.asarray(jnp.asarray(a, jnp.float32))


# ----------------------------------------------------------------- Dense layers


@pytest.mark.parametrize("wn", [True, False])
def test_wndense_bf16_matches_flax(wn):
    rs = np.random.RandomState(0)
    x = rs.randn(4, 16, 24).astype(np.float32)
    jd = jcommon.WNDense(40, use_weight_norm=wn, dtype=jnp.bfloat16)
    params = jd.init(jax.random.PRNGKey(0), jnp.asarray(x))["params"]
    params = jax.tree_util.tree_map(lambda a: (rs.randn(*a.shape) * 0.3).astype(np.float32),
                                    jax.device_get(params))
    ref = f32(jd.apply({"params": params}, jnp.asarray(x)))
    pd = pcommon.WNDense(24, 40, use_weight_norm=wn, dtype=BF16)
    load_flax_params(pd, params)
    with torch.no_grad():
        for folded in (False, True):
            if folded:
                pd.fold()
            out = pd(torch.from_numpy(x))
            param = pd.weight_v if wn else pd.weight
            assert out.dtype == BF16 and param.dtype == torch.float32
            print(f"WNDense wn={wn} folded={folded}: {ulps(f32(out), ref):.3g} ulps")
            assert ulps(f32(out), ref) <= 1.0


def test_wndense_split_bf16_matches_flax():
    rs = np.random.RandomState(1)
    xs = rs.randn(3, 10, 20).astype(np.float32)
    t_set, c_set = rs.randn(3, 6).astype(np.float32), rs.randn(3, 2).astype(np.float32)
    jd = jcommon.WNDenseSplit(20, dtype=jnp.bfloat16)
    segs = lambda T, X, C: [(T, "set"), (X, "particle"), (C, "set")]
    params = jd.init(jax.random.PRNGKey(0), segs(*map(jnp.asarray, (t_set, xs, c_set))))["params"]
    ref = f32(jd.apply({"params": params}, segs(*map(jnp.asarray, (t_set, xs, c_set)))))
    pd = pcommon.WNDenseSplit([(6, "set"), (20, "particle"), (2, "set")], 20, dtype=BF16)
    load_flax_params(pd, jax.device_get(params))
    with torch.no_grad():
        out = pd(segs(*(torch.from_numpy(a) for a in (t_set, xs, c_set))))
    print(f"WNDenseSplit: {ulps(f32(out), ref):.3g} ulps")
    assert out.dtype == BF16 and ulps(f32(out), ref) <= 1.0


def test_meansum_pool_bf16_promotes_as_jax():
    """bfloat16 x times a float32 mask is float32 in both packages, so the
    pool of a bfloat16 set is float32."""
    rs = np.random.RandomState(2)
    x = rs.randn(4, 16, 8).astype(np.float32)
    mask = (rs.rand(4, 16, 1) > 0.3).astype(np.float32)
    mask[:, 0] = 1.0
    jm, js = jmasked.meansum_pool(j16(x), jnp.asarray(mask))
    pm, ps = pmasked.meansum_pool(p16(x), torch.from_numpy(mask))
    assert pm.dtype == ps.dtype == torch.float32 and jm.dtype == js.dtype == jnp.float32
    for got, want in ((pm, jm), (ps, js)):
        print(f"meansum_pool: {ulps(f32(got), f32(want)):.3g} ulps")
        assert ulps(f32(got), f32(want)) <= 1.0


def test_layer_norm_bf16_follows_flax():
    rs = np.random.RandomState(3)
    x = (rs.randn(4, 16, 32) * 3 + 1).astype(np.float32)
    jl = fnn.LayerNorm(epsilon=1e-5, dtype=jnp.bfloat16)
    params = {"scale": (1 + 0.2 * rs.randn(32)).astype(np.float32),
              "bias": (0.2 * rs.randn(32)).astype(np.float32)}
    ref = f32(jl.apply({"params": params}, j16(x)))
    pl = pcommon.LayerNorm(32, dtype=BF16)
    load_flax_params(pl, params)
    with torch.no_grad():
        out = pl(p16(x))
        plain = torch.nn.functional.layer_norm(p16(x), (32,), pl.weight.to(BF16),
                                               pl.bias.to(BF16), 1e-5)
    print(f"LayerNorm: {ulps(f32(out), ref):.3g} ulps; torch's own on bfloat16 "
          f"{ulps(f32(plain), ref):.3g} ulps")
    assert out.dtype == BF16 and pl.weight.dtype == torch.float32
    assert ulps(f32(out), ref) <= 1.0


@pytest.mark.parametrize("slope", [0.01, 0.1])
def test_leaky_relu_bf16_rounds_its_slope_as_jax(slope):
    x = np.linspace(-40.0, 3.0, 4001, dtype=np.float32)
    ref = f32(jax.nn.leaky_relu(j16(x), slope))
    out = pcommon.leaky_relu(p16(x), slope)
    assert np.array_equal(f32(out), ref)
    # torch's own multiplies by the float32 slope and rounds elsewhere
    assert not np.array_equal(f32(torch.nn.functional.leaky_relu(p16(x), slope)), ref)


# -------------------------------------------------------------------- EPiC layer


def _bf16_layer_pair(layout: str, seed: int):
    """The linen layer in float32 and in bfloat16 on the test inputs of
    tests/test_torch_port_epic_layer.py with x and g rounded to bfloat16 (as
    the bfloat16 network hands them on: the outputs of bfloat16 Dense
    layers; t, cond and the mask stay float32), and the port's bfloat16
    layer with the same parameters."""
    d = f32_epic._jax_layer(layout, seed)
    cfg = f32_epic.LAYOUTS[layout]
    cg, cl = f32_epic._cond_dims(cfg)
    kw = dict(hid_dim=f32_epic.H, latent_dim=f32_epic.L, global_cond_dim=cg, local_cond_dim=cl,
              t_local_cat=cfg["t_cat"], t_global_cat=cfg["t_cat"])
    n = f32_epic.N
    tb = jnp.asarray(np.tile(d["temb"][:, None, :], (1, n, 1)))
    jcond = None if d["cond"] is None else jnp.asarray(d["cond"])
    jmask = jnp.asarray(d["mask"][..., None])
    out = {}
    for name, dtype in (("f32", None), ("bf16", jnp.bfloat16)):
        g, x = (j16(d[k]) if dtype else j16(d[k]).astype(jnp.float32) for k in ("g", "x"))
        out[name] = JaxEPiCLayer(dtype=dtype, **kw).apply({"params": d["params"]}, tb, g, x,
                                                         cond=jcond, mask=jmask)
    layer = EPiCLayer(t_dim=f32_epic.T, cond_dim=cfg["c"], dtype=BF16, **kw)
    load_flax_params(layer, d["params"])
    port_args = (torch.from_numpy(d["temb"]), p16(d["g"]), p16(d["x"]),
                 None if d["cond"] is None else torch.from_numpy(d["cond"]),
                 torch.from_numpy(d["mask"][..., None]))
    assert out["bf16"][1].dtype == jnp.bfloat16
    return out, layer, port_args


@pytest.mark.parametrize("layout", list(f32_epic.LAYOUTS))
def test_epic_layer_bf16_module_and_folded_paths_against_linen(layout):
    ref, layer, args = _bf16_layer_pair(layout, seed=2)
    with torch.no_grad():
        for folded in (False, True):
            if folded:
                layer.fold()
                assert all(w.dtype == BF16 for w in layer._kernel_weights.values())
            go, xo = layer(*args)
            assert xo.dtype == go.dtype == BF16
            path = "folded" if folded else "module"
            for i, (name, got) in enumerate((("g", go), ("x", xo))):
                ours, theirs = bf16_gaps(f32(got), f32(ref["bf16"][i]), f32(ref["f32"][i]),
                                    f"EPiC {layout} {path} path {name}")
                assert ours < (FOLDED_GAP if folded else 1.0) * theirs


@pytest.mark.parametrize("layout", ["yaml", "graft", "nocond"])
def test_epic_reference_bf16_matches_pallas_interpret(layout):
    """bfloat16 x, g, set features, weights and biases, float32 mask."""
    d = f32_epic._jax_layer(layout, seed=1)
    w = f32_epic._kernel_weights(d["params"], d["dims"]["tl_dim"])
    dims = d["dims"]
    ins = (d["x"], d["g"], d["set_feat"])
    jxo, jgo = epic_layer_fused_fwd(
        *map(j16, ins[:2]), jnp.asarray(d["mask"]), j16(ins[2]), *map(j16, w),
        sum_scale=dims["sum_scale"], tg_dim=dims["tg_dim"], tl_dim=dims["tl_dim"],
        c_dim=dims["cg_dim"], tile_b=2, interpret=True)
    assert jxo.dtype == jnp.bfloat16
    xo, go = pepic.epic_layer_reference(*map(p16, ins[:2]), torch.from_numpy(d["mask"]),
                                        p16(ins[2]), *map(p16, w), **dims)
    assert xo.dtype == go.dtype == BF16
    for name, got, want in (("x", xo, jxo), ("g", go, jgo)):
        print(f"epic_layer_reference {layout} {name}: {ulps(f32(got), f32(want)):.3g} ulps")
        assert ulps(f32(got), f32(want)) <= 2.0


# --------------------------------------------------------------------- attention


def _attn(b, lq, lk, h, d, seed, bias=False):
    rs = np.random.RandomState(seed)
    q, k, v = (rs.randn(b, l, h, d).astype(np.float32) for l in (lq, lk, lk))
    mask = (np.arange(lk)[None, :] < rs.randint(1, lk + 1, size=(b, 1))).astype(np.float32)
    ab = rs.randn(b, h, lq, lk).astype(np.float32) if bias else None
    return q, k, v, mask, ab


@pytest.mark.parametrize("bias", [False, True])
@pytest.mark.parametrize("l,d", [(16, 16), (21, 8), (37, 32)])
def test_packed_plain_bf16_matches_pallas_interpret(l, d, bias):
    q, k, v, mask, ab = _attn(3, l, l, 4, d, l + d, bias)
    jab = None if ab is None else jnp.asarray(ab)
    ref = jshort.packed_short_attention(j16(q), j16(k), j16(v), jnp.asarray(mask), jab,
                                        interpret=True)
    assert ref.dtype == jnp.bfloat16
    pab = None if ab is None else torch.from_numpy(ab)
    out = pshort.packed_short_attention_reference(p16(q), p16(k), p16(v), torch.from_numpy(mask),
                                                  pab)
    print(f"packed plain L={l} D={d} bias={bias}: {ulps(f32(out), f32(ref)):.3g} ulps")
    assert out.dtype == BF16 and ulps(f32(out), f32(ref)) <= 2.0


@pytest.mark.parametrize("lq,lk,bias", [(4, 21, False), (21, 4, False), (9, 13, True)])
def test_fused_plain_bf16_matches_pallas_interpret(lq, lk, bias):
    q, k, v, mask, ab = _attn(3, lq, lk, 4, 8, lq + lk, bias)
    jab = None if ab is None else jnp.asarray(ab)
    ref = jshort.fused_short_attention(j16(q), j16(k), j16(v), jnp.asarray(mask), jab,
                                       interpret=True)
    pab = None if ab is None else torch.from_numpy(ab)
    out = pshort.fused_short_attention_reference(p16(q), p16(k), p16(v), torch.from_numpy(mask),
                                                 pab)
    print(f"fused plain Lq={lq} Lk={lk} bias={bias}: {ulps(f32(out), f32(ref)):.3g} ulps")
    assert out.dtype == BF16 and ulps(f32(out), f32(ref)) <= 2.0


@pytest.mark.parametrize("lq,lk,d", [(1, 300, 16), (20, 20, 16), (33, 150, 32)])
def test_flash_plain_bf16_matches_pallas_interpret(lq, lk, d):
    """One chunk of keys covers every set here: the TPU kernel pads Lk to
    its chunk, the plain version does not (the same function)."""
    q, k, v, mask, _ = _attn(2, lq, lk, 2, d, lq + lk)
    ref = jflash.flash_masked_attention(j16(q), j16(k), j16(v), jnp.asarray(mask), block_k=512,
                                        interpret=True)
    out = pflash.flash_masked_attention_reference(p16(q), p16(k), p16(v), torch.from_numpy(mask),
                                                  block_k=512)
    print(f"flash plain Lq={lq} Lk={lk} D={d}: {ulps(f32(out), f32(ref)):.3g} ulps")
    assert out.dtype == BF16 and ulps(f32(out), f32(ref)) <= 2.0


@pytest.mark.parametrize("scores", [None, "bfloat16"])
def test_einsum_attention_bf16_matches_jax(scores):
    q, k, v, mask, ab = _attn(3, 19, 19, 4, 16, 7, bias=True)
    ref = jattn.masked_attention(j16(q), j16(k), j16(v), jnp.asarray(mask), jnp.asarray(ab),
                                 scores_dtype=None if scores is None else jnp.bfloat16)
    out = pattn.masked_attention(p16(q), p16(k), p16(v), torch.from_numpy(mask),
                                 torch.from_numpy(ab), pattn.scores_dtype_from(scores))
    print(f"einsum attention scores_dtype={scores}: {ulps(f32(out), f32(ref)):.3g} ulps")
    assert out.dtype == BF16 and ulps(f32(out), f32(ref)) <= 1.0


def test_class_token_attention_bf16_matches_jax():
    q, k, v, mask, _ = _attn(3, 1, 40, 4, 8, 11)
    ref = jattn.class_token_attention(j16(q), j16(k), j16(v), jnp.asarray(mask))
    out = pattn.attention(p16(q), p16(k), p16(v), torch.from_numpy(mask), impl="class_token")
    print(f"class_token attention: {ulps(f32(out), f32(ref)):.3g} ulps")
    assert out.dtype == BF16 and ulps(f32(out), f32(ref)) <= 1.0


def test_attention_dispatch_passes_bf16_to_the_plain_versions_on_the_cpu():
    """On CPU tensors every impl takes the plain version in bfloat16: nothing
    is cast to float32 on the way, and no launch is counted."""
    q, k, v, mask, _ = _attn(2, 12, 12, 2, 16, 3)
    counts = [w.launches for w in (pshort.packed_short_attention_bf16,
                                   pshort.fused_short_attention_bf16,
                                   pflash.flash_masked_attention_bf16)]
    with torch.no_grad():
        for impl in ("einsum", "packed", "fused", "flash"):
            out = pattn.attention(p16(q), p16(k), p16(v), torch.from_numpy(mask), impl=impl)
            assert out.dtype == BF16, impl
    assert counts == [w.launches for w in (pshort.packed_short_attention_bf16,
                                           pshort.fused_short_attention_bf16,
                                           pflash.flash_masked_attention_bf16)]
