"""PyTorch port, the four bfloat16 kernels held against their plain versions
on the same bfloat16 inputs on the card: `epic_layer_bf16` against
`epic_layer_reference`, `packed_short_attention_bf16` against the packed
plain version's bfloat16 arithmetic (the Pallas `_packed_kernel`'s),
`fused_short_attention_bf16` and `flash_masked_attention_bf16` against
theirs (float32 on the upcast inputs, one rounding of the output).

Tolerance: 2 bfloat16 ulps of the largest |out| of the plain version
(`bf16_tol`). Kernel and plain version sum their float32 products in other
orders and take exp by other means; a value that lands next to a rounding
boundary of bfloat16 then rounds the other way, 1 ulp of that value, and an
intermediate that does (x1 in EPiC, P in packed) moves the output by a
fraction of that. Every test needs an NVIDIA GPU and skips without one.

This file imports no JAX, so it runs where JAX is not installed:

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_port_bf16_kernels.py

The EPiC kernel's local products run on wgmma and its per-set part takes
several sets a block; the flash kernel's class-token variant splits the keys
over whole waves of blocks and merges them in the same launch. Their edges
(tiles that span sets, padded and streamed widths, one and many splits,
key counts off every step, a fully masked set, offset operands) and their
launch reports against the wrappers' mirrors are tested here too. So are the
packed kernel's (one pass over Q . K^T for a group of heads, stopping at each
set's last real key): every mask kind at L up to 256, a bias, slices of one
fused QKV projection, offset operands, its launch report.
"""

from __future__ import annotations

import math

import pytest
import torch

from particle_fm_tpu_torch.ops import epic_layer as ops
from particle_fm_tpu_torch.ops import flash_attention as fa
from particle_fm_tpu_torch.ops import short_attention as sa

BF16 = torch.bfloat16


@pytest.fixture()
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU; the kernel has no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def bf16_tol(ref: torch.Tensor, ulps: int = 2) -> float:
    """`ulps` bfloat16 ulps of the largest |ref| (8 bits of mantissa)."""
    top = float(ref.float().abs().max())
    return ulps * 2.0 ** (math.floor(math.log2(top)) - 7) if top > 0 else 0.0


def assert_within(got: torch.Tensor, want: torch.Tensor) -> None:
    torch.cuda.synchronize()
    assert got.dtype == BF16 and got.shape == want.shape
    assert torch.isfinite(got.float()).all()
    err = float((got.float() - want.float()).abs().max())
    assert err <= bf16_tol(want), (err, bf16_tol(want))


def _epic_args(b, n, h, lat, tg, tl, cg, cl, seed, device):
    gen = torch.Generator().manual_seed(seed)
    r = lambda *s: torch.randn(*s, generator=gen) * 0.3
    w = lambda *s: torch.randn(*s, generator=gen) / s[0] ** 0.5
    s = max(tg, tl) + max(cg, cl)
    counts = torch.randint(1, n + 1, (b, 1), generator=gen)
    mask = (torch.arange(n)[None, :] < counts).float()
    args = [r(b, n, h), r(b, lat), mask, r(b, s),
            w(tg + 2 * h + lat + cg, h), r(h), w(tg + h + cg, lat), r(lat),
            w(h, h), w(tl + lat + cl, h), r(h), w(h, h), w(tl + cl, h), r(h)]
    args = [a.to(device) if i == 2 else a.to(device, BF16) for i, a in enumerate(args)]
    return [a.contiguous() for a in args], dict(sum_scale=1e-2, tg_dim=tg, tl_dim=tl, cg_dim=cg,
                                                cl_dim=cl)


@pytest.mark.cuda
@pytest.mark.parametrize("b,n,h,lat,tg,tl,cg,cl", [
    # the served flagship, lhco/bigPC, jetclass/jetclass_cond
    (640, 150, 128, 10, 32, 32, 2, 2), (128, 558, 256, 256, 32, 32, 10, 10),
    (512, 128, 300, 16, 32, 32, 12, 0),
    # tiles of 64 rows that span sets; widths off 16 and off 8; the cap
    (3, 17, 128, 10, 32, 32, 2, 2), (5, 41, 48, 10, 32, 0, 2, 0), (4, 70, 3, 16, 6, 6, 1, 1),
    (3, 33, 140, 7, 5, 5, 3, 3), (2, 1, 512, 512, 32, 32, 12, 12),
])
def test_epic_bf16_kernel_matches_plain_version(cuda, b, n, h, lat, tg, tl, cg, cl):
    args, dims = _epic_args(b, n, h, lat, tg, tl, cg, cl, b + n + h, cuda)
    before = ops.epic_layer_bf16.launches
    xo, go = ops.epic_layer(*args, **dims)
    assert ops.epic_layer_bf16.launches == before + 1
    rx, rg = ops.epic_layer_reference(*args, **dims)
    assert_within(xo, rx)
    assert_within(go, rg)


@pytest.mark.cuda
@pytest.mark.parametrize("h", [3, 48, 300, 512])
@pytest.mark.parametrize("n", [1, 17])
def test_epic_bf16_kernel_at_the_edges_of_its_tiles_and_widths(cuda, n, h):
    """64-row tiles that span sets (N=17: a tile holds parts of five sets;
    N=1: 64 sets), widths padded to 16 (3), to a column block (48: 64; 300:
    two blocks of 152, weights streamed) and the cap (512: one warpgroup)."""
    args, dims = _epic_args(7, n, h, 16, 32, 32, 12, 0 if h == 300 else 12, n + h, cuda)
    xo, go = ops.epic_layer(*args, **dims)
    rx, rg = ops.epic_layer_reference(*args, **dims)
    assert_within(xo, rx)
    assert_within(go, rg)


@pytest.mark.cuda
@pytest.mark.parametrize("b,n,h", [(5, 150, 128), (1000, 17, 128), (2048, 30, 300), (300, 1, 48)])
def test_epic_bf16_kernel_with_few_and_many_sets(cuda, b, n, h):
    """B below and far above the card's 132 SMs: the per-set kernel takes
    up to 8 sets a block, the persistent local blocks walk many tiles."""
    args, dims = _epic_args(b, n, h, 10, 32, 32, 2, 2, b + n, cuda)
    xo, go = ops.epic_layer(*args, **dims)
    rx, rg = ops.epic_layer_reference(*args, **dims)
    assert_within(xo, rx)
    assert_within(go, rg)


@pytest.mark.cuda
@pytest.mark.parametrize("b,n,h,lat,cg,cl", [
    (640, 150, 128, 10, 2, 2), (512, 128, 300, 16, 12, 0), (128, 558, 256, 256, 10, 10),
    (2, 70, 512, 512, 12, 12), (4, 70, 3, 16, 1, 1), (3, 33, 140, 7, 3, 3),
])
def test_epic_bf16_launch_report_matches_its_mirror(cuda, b, n, h, lat, cg, cl):
    report = ops.bf16_launch_report(b, n, h, lat, 32 + max(cg, cl), 32, 32, cg, cl)
    sms = torch.cuda.get_device_properties(cuda).multi_processor_count
    mirror = ops.bf16_geometry(b, n, h, lat, sms, 32, 32, cg, cl)
    assert {k: report[k] for k in mirror} == mirror
    assert report["instruction"] == (
        f"wgmma.mma_async.sync.aligned.m64n{mirror['column_block']}k16.f32.bf16.bf16")


def _attention_inputs(b, lq, lk, h, d, seed, device, masked=True, bias=False, fused_qkv=False):
    gen = torch.Generator().manual_seed(seed)
    if fused_qkv:
        qkv = torch.randn(b, lq, 3 * h * d, generator=gen).to(device, BF16)
        q, k, v = (t.view(b, lq, h, d) for t in qkv.chunk(3, dim=-1))
    else:
        q, k, v = (torch.randn(b, l, h, d, generator=gen).to(device, BF16) for l in (lq, lk, lk))
    mask = None
    if masked:
        counts = torch.randint(1, lk + 1, (b, 1), generator=gen)
        mask = (torch.arange(lk)[None, :] < counts).float().to(device)
    ab = torch.randn(b, h, lq, lk, generator=gen).to(device) if bias else None
    return q, k, v, mask, ab


@pytest.mark.cuda
@pytest.mark.parametrize("b,l,h,d,bias,fused_qkv", [
    (640, 150, 16, 16, False, True), (64, 150, 16, 16, True, False),
    (3, 1, 3, 8, False, False), (3, 15, 3, 12, True, False), (3, 16, 3, 32, False, False),
    (3, 17, 3, 64, True, False), (3, 256, 3, 64, False, False), (4, 37, 3, 33, False, False),
    # path A's slices of one QKV projection with a bias; the longest sets, 5 heads of 16 (a
    # group of 4 and one of 1), fused; 65 particles (10 register steps), unaligned d
    (8, 150, 16, 16, True, True), (4, 256, 5, 16, True, True), (5, 65, 6, 32, False, True),
    (3, 256, 2, 24, True, False), (2, 161, 4, 8, False, True), (3, 100, 3, 64, True, True),
])
def test_packed_bf16_kernel_matches_plain_version(cuda, b, l, h, d, bias, fused_qkv):
    q, k, v, mask, ab = _attention_inputs(b, l, l, h, d, l + d, cuda, bias=bias,
                                          fused_qkv=fused_qkv)
    before = sa.packed_short_attention_bf16.launches
    out = sa.packed_short_attention(q, k, v, mask, ab)
    assert sa.packed_short_attention_bf16.launches == before + 1
    assert_within(out, sa.packed_short_attention_reference(q, k, v, mask, ab))


@pytest.mark.cuda
@pytest.mark.parametrize("b,lq,lk,h,d,masked,bias", [
    (640, 4, 150, 16, 8, True, False), (640, 150, 4, 16, 8, False, False),
    (16, 37, 150, 16, 8, True, True), (3, 5, 5, 3, 12, True, True), (3, 17, 512, 3, 32, True, False),
    (3, 512, 17, 3, 64, True, True), (3, 1, 1, 3, 8, True, False), (3, 4, 7, 5, 6, True, False),
])
def test_fused_bf16_kernel_matches_plain_version(cuda, b, lq, lk, h, d, masked, bias):
    q, k, v, mask, ab = _attention_inputs(b, lq, lk, h, d, lq + lk + d, cuda, masked, bias)
    before = sa.fused_short_attention_bf16.launches
    with torch.no_grad():
        out = sa.fused_short_attention(q, k, v, mask, ab)
    assert sa.fused_short_attention_bf16.launches == before + 1
    assert_within(out, sa.fused_short_attention_reference(q, k, v, mask, ab))


@pytest.mark.cuda
@pytest.mark.parametrize("b,lq,lk,h,d,masked,fused_qkv", [
    (32, 1, 6000, 2, 128, True, False), (256, 279, 279, 16, 16, True, True),
    (4, 1500, 1500, 4, 128, True, False), (3, 5, 5, 3, 8, True, False),
    (3, 17, 17, 3, 12, True, False), (3, 558, 558, 3, 32, True, False),
    (3, 558, 558, 3, 64, False, False), (2, 3, 900, 3, 64, True, False),
])
def test_flash_bf16_kernel_matches_plain_version(cuda, b, lq, lk, h, d, masked, fused_qkv):
    q, k, v, mask, _ = _attention_inputs(b, lq, lk, h, d, lq + d, cuda, masked,
                                         fused_qkv=fused_qkv)
    before = fa.flash_masked_attention_bf16.launches
    with torch.no_grad():
        out = fa.flash_masked_attention(q, k, v, mask)
    assert fa.flash_masked_attention_bf16.launches == before + 1
    assert_within(out, fa.flash_masked_attention_reference(q, k, v, mask))


@pytest.mark.cuda
@pytest.mark.parametrize("b,lq,lk,h,d", [
    (32, 1, 6001, 2, 128), (3, 2, 997, 3, 64), (5, 3, 37, 2, 32), (2, 4, 1, 3, 16),
    (4, 4, 300, 3, 8), (3, 1, 129, 2, 12), (700, 1, 150, 1, 128),
])
def test_flash_bf16_class_token_kernel(cuda, b, lq, lk, h, d):
    """Class tokens (Lq 1-4) on key counts that are no multiple of a split
    or of a warp step, head dims 8 to 128 (12: element loads), from one
    split (700 (set, head) pairs fill the card) to many."""
    q, k, v, mask, _ = _attention_inputs(b, lq, lk, h, d, lq + lk + d, cuda)
    before = fa.flash_masked_attention_bf16.launches
    with torch.no_grad():
        out = fa.flash_masked_attention(q, k, v, mask)
        again = fa.flash_masked_attention(q, k, v, mask)  # the tickets were left at zero
    assert fa.flash_masked_attention_bf16.launches == before + 2
    assert_within(out, fa.flash_masked_attention_reference(q, k, v, mask))
    assert torch.equal(out, again)


@pytest.mark.cuda
def test_flash_bf16_class_token_fully_masked_set_and_offset_operands(cuda):
    """A set with no real key keeps the port's known behaviour (its weights
    spread over its Lk keys, as the plain version's); operands offset by one
    element from 16 bytes take element loads."""
    q, k, v, mask, _ = _attention_inputs(6, 1, 3000, 2, 128, 5, cuda)
    mask[2] = 0.0
    with torch.no_grad():
        out = fa.flash_masked_attention(q, k, v, mask)
    want = fa.flash_masked_attention_reference(q, k, v, mask)
    assert_within(out, want)
    gen = torch.Generator().manual_seed(6)
    flat = torch.randn(3 * 2 * 64 + 1, generator=gen).to(cuda, BF16)
    qo = flat[1:].view(3, 1, 2, 64)
    kv = torch.randn(2 * 3 * 500 * 2 * 64 + 1, generator=gen).to(cuda, BF16)
    ko = kv[1:1 + 3 * 500 * 128].view(3, 500, 2, 64)
    vo = kv[1 + 3 * 500 * 128:].view(3, 500, 2, 64)
    m = (torch.arange(500)[None, :] < torch.tensor([[500], [7], [260]])).float().to(cuda)
    with torch.no_grad():
        got = fa.flash_masked_attention(qo, ko, vo, m)
    assert_within(got, fa.flash_masked_attention_reference(qo, ko, vo, m))


@pytest.mark.cuda
@pytest.mark.parametrize("b,lq,lk,h,d", [(32, 1, 6000, 2, 128), (3, 4, 900, 3, 64),
                                         (700, 1, 150, 1, 128)])
def test_flash_bf16_token_launch_report_matches_its_mirror(cuda, b, lq, lk, h, d):
    report = fa.token_launch_report(b, lq, lk, h, d)
    sms = torch.cuda.get_device_properties(cuda).multi_processor_count
    mirror = fa.token_geometry(b, lk, h, sms)
    assert report["blocks"] == mirror["blocks"] and report["warps"] == mirror["warps"]
    # the split count assumes this many resident blocks on each SM
    assert report["resident_blocks_per_sm"] == mirror["resident_blocks_per_sm"]


@pytest.mark.cuda
def test_bf16_libraries_name_the_bf16_instruction(cuda):
    for lib_instruction in (sa.bf16_instruction, fa.bf16_instruction):
        assert lib_instruction() == "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32"
    assert ops.bf16_instruction() == "wgmma.mma_async.sync.aligned.m64nNk16.f32.bf16.bf16"


@pytest.mark.cuda
def test_bf16_wrappers_refuse_float32_and_no_float32_kernel_takes_bf16(cuda):
    q, k, v, mask, _ = _attention_inputs(2, 16, 16, 2, 16, 0, cuda)
    with pytest.raises(ValueError, match="bfloat16"):
        sa.packed_short_attention_bf16(q.float(), k.float(), v.float(), mask)
    with pytest.raises(TypeError, match="float32"):
        sa._launch("packed_short_attention_f32", q, k, v, mask, None, sa.MAX_PACKED_LEN)
    with pytest.raises(TypeError, match="bfloat16"):
        fa._launch("flash_masked_attention_bf16", q.float(), k.float(), v.float(), mask)


# The two kernels redesigned to stop at each set's last real key (flash with
# more than 4 query rows, the fused pair): masks of every kind, tiles and
# steps left ragged, head dims 8 to 64, offset operands, the launch reports.

MASK_KINDS = ("prefix", "holes", "only the last key", "all masked", "fractional only")


def _mask_of(kind: str, b: int, lk: int, device) -> torch.Tensor:
    """A (B, Lk) mask of one kind; set 0 has every key masked but in the last
    two kinds (every key masked, fractional values only: all Lk keys count)."""
    gen = torch.Generator().manual_seed(lk)
    keys = torch.arange(lk)[None, :]
    m = (keys < torch.randint(1, lk + 1, (b, 1), generator=gen)).float()
    if kind == "holes":
        m = m * (keys % 3 == 0).float()
    elif kind == "only the last key":
        m = (keys == lk - 1).float().expand(b, lk).clone()
    elif kind == "all masked":
        m = torch.zeros(b, lk)
    elif kind == "fractional only":
        m = 0.5 * m
    if kind not in ("all masked", "fractional only"):
        m[0] = 0.0
    return m.to(device)


KERNELS = {"flash": (fa.flash_masked_attention, fa.flash_masked_attention_reference),
           "fused": (sa.fused_short_attention, sa.fused_short_attention_reference),
           "packed": (sa.packed_short_attention, sa.packed_short_attention_reference)}


@pytest.mark.cuda
@pytest.mark.parametrize("kind", MASK_KINDS)
@pytest.mark.parametrize("kernel,lq,lk,d", [
    ("flash", 279, 279, 16), ("flash", 37, 600, 32), ("flash", 5, 17, 64),
    ("fused", 4, 150, 8), ("fused", 4, 17, 12), ("fused", 3, 512, 64),
    ("packed", 150, 150, 16), ("packed", 17, 17, 12), ("packed", 256, 256, 64),
    ("packed", 33, 33, 32),
])
def test_bf16_kernels_stop_at_the_last_real_key(cuda, kind, kernel, lq, lk, d):
    q, k, v, _, _ = _attention_inputs(3, lq, lk, 3, d, lq + lk, cuda, masked=False)
    mask = _mask_of(kind, 3, lk, cuda)
    fn, ref = KERNELS[kernel]
    with torch.no_grad():
        out = fn(q, k, v, mask)
        again = fn(q, k, v, mask)
    assert_within(out, ref(q, k, v, mask))
    assert torch.equal(out, again)


@pytest.mark.cuda
@pytest.mark.parametrize("d", [8, 12, 16, 32, 64])
@pytest.mark.parametrize("lq,lk", [(5, 5), (16, 31), (17, 33), (33, 290), (300, 20), (558, 558)])
def test_flash_bf16_off_every_tile_and_step(cuda, lq, lk, d):
    """Query rows off the 16-row tiles and the passes of a block, keys off the
    16- and 32-key steps and the staged tile (288, 256 or 128 keys: 290 and
    558 keys take the ring of two stages, and with few sets the keys split)."""
    q, k, v, mask, _ = _attention_inputs(2, lq, lk, 3, d, lq + lk + d, cuda)
    with torch.no_grad():
        out = fa.flash_masked_attention(q, k, v, mask)
    assert_within(out, fa.flash_masked_attention_reference(q, k, v, mask))


@pytest.mark.cuda
@pytest.mark.parametrize("d", [8, 12, 16, 32, 64])
@pytest.mark.parametrize("lq,lk,bias", [(4, 150, False), (150, 4, False), (37, 150, True),
                                        (7, 9, True), (9, 7, False), (1, 512, True)])
def test_fused_bf16_head_dims_and_bias(cuda, lq, lk, bias, d):
    q, k, v, mask, ab = _attention_inputs(3, lq, lk, 5, d, lq + lk + d, cuda, bias=bias)
    with torch.no_grad():
        out = sa.fused_short_attention(q, k, v, mask, ab)
    assert_within(out, sa.fused_short_attention_reference(q, k, v, mask, ab))


@pytest.mark.cuda
@pytest.mark.parametrize("kernel,lq,lk", [("flash", 37, 300), ("fused", 4, 150),
                                          ("fused", 150, 4), ("packed", 150, 150),
                                          ("packed", 17, 17)])
def test_redesigned_bf16_kernels_on_offset_operands(cuda, kernel, lq, lk):
    """Operands one element off 16 bytes take element loads."""
    gen = torch.Generator().manual_seed(lq + lk)
    h, d = 16, 8
    n = lambda l: 3 * l * h * d
    flat = torch.randn(n(lq) + 2 * n(lk) + 1, generator=gen).to(cuda, BF16)
    q = flat[1:1 + n(lq)].view(3, lq, h, d)
    k = flat[1 + n(lq):1 + n(lq) + n(lk)].view(3, lk, h, d)
    v = flat[1 + n(lq) + n(lk):].view(3, lk, h, d)
    mask = (torch.arange(lk)[None, :] < torch.tensor([[lk], [2], [lk // 2 + 1]])).float().to(cuda)
    fn, ref = KERNELS[kernel]
    with torch.no_grad():
        out = fn(q, k, v, mask)
    assert_within(out, ref(q, k, v, mask))


@pytest.mark.cuda
@pytest.mark.parametrize("b,lq,lk,h,d", [(256, 279, 279, 16, 16), (3, 558, 558, 3, 64),
                                         (3, 17, 17, 3, 8), (4, 1500, 1500, 4, 32),
                                         (2, 33, 290, 3, 12)])
def test_flash_bf16_launch_report_matches_its_mirror(cuda, b, lq, lk, h, d):
    report = fa.mma_bf16_launch_report(b, lq, lk, h, d)
    mirror = fa.mma_bf16_geometry(b, lq, lk, h, d)
    assert {key: report[key] for key in mirror} == mirror
    assert report["smem_bytes"] <= sa.MAX_SMEM
    assert report["pv_tf32_products"] == fa.BF16_PV_PRODUCTS
    assert report["instruction"] == "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32"
    assert report["pv_instruction"] == "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32"


@pytest.mark.cuda
@pytest.mark.parametrize("b,lq,lk,h,d,biased", [
    (640, 4, 150, 16, 8, False), (640, 150, 4, 16, 8, False), (64, 37, 150, 16, 8, True),
    (3, 17, 4, 3, 64, False), (3, 4, 17, 3, 12, True), (5, 9, 7, 33, 8, False),
])
def test_fused_bf16_launch_report_matches_its_mirror(cuda, b, lq, lk, h, d, biased):
    report = sa.fused_bf16_launch_report(b, lq, lk, h, d, biased)
    sms = torch.cuda.get_device_properties(cuda).multi_processor_count
    mirror = sa.fused_bf16_geometry(b, lq, lk, h, d, sms)
    assert {key: report[key] for key in mirror} == mirror


@pytest.mark.cuda
@pytest.mark.parametrize("b,l,h,d,biased", [
    (640, 150, 16, 16, False), (64, 150, 16, 16, True), (3, 256, 3, 64, False),
    (3, 256, 3, 64, True), (3, 1, 3, 8, False), (3, 17, 3, 12, True), (4, 37, 3, 33, False),
    (2, 65, 5, 32, False), (4, 256, 5, 16, True),
])
def test_packed_bf16_launch_report_matches_its_mirror(cuda, b, l, h, d, biased):
    report = sa.packed_bf16_launch_report(b, l, h, d, biased)
    mirror = sa.packed_bf16_geometry(b, l, h, d, biased)
    assert {key: report[key] for key in mirror} == mirror
    assert report["resident_blocks_per_sm"] >= report["min_blocks_per_sm"]
    assert report["instruction"] == "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32"
