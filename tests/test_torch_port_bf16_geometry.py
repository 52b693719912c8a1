"""PyTorch port, the Python mirrors of the redesigned bfloat16 kernels'
launch geometry, on the CPU (the card holds them against the libraries' own
reports: tests/test_torch_port_bf16_kernels.py, chip_smoke.py).

- `ops/epic_layer.py::bf16_geometry`: the EPiC layer's local kernels (wgmma
  column blocks; x and x1 in registers with the weights staged once up to
  H = 128, else streamed weight slices; warpgroups) and its per-set kernel
  (sets a block), at the served shapes and over every width the kernel
  takes: a block's shared memory within the card's 227 KB, the column
  blocks covering the padded width.
- `ops/flash_attention.py::token_splits`/`token_geometry`: the class-token
  kernel's split of the keys into whole waves of resident blocks.
- `ops/flash_attention.py::mma_bf16_geometry`: flash with more than 4 query
  rows in bfloat16, a block per (set, head, split) taking the set's query
  tiles in passes, K and V staged once (one tile) or through a ring of two
  stages, within the card's shared memory.
- `ops/short_attention.py::fused_bf16_geometry`: the bfloat16 fused kernels'
  blocks, rows and keys a lane holds, and the "to" kernel's runs of items
  over one wave of resident blocks.
- `ops/short_attention.py::packed_bf16_geometry`: the bfloat16 packed
  kernel, a block per (set, group of heads at least 32 columns wide), its
  warps taking the group's (head, row tile) pairs in turn, the steps of 16 keys whose scores a
  warp keeps in registers, Q, K and V of the group for every row within the
  card's shared memory, and the resident blocks its launch bounds ask for.
- The per-set products' split of a float32 input into three bfloat16
  pieces, whose sum is the input exactly, so that three bfloat16 products
  with float32 accumulation compute the float32 product on bfloat16 weights.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

from particle_fm_tpu_torch.ops import epic_layer as ops
from particle_fm_tpu_torch.ops import flash_attention as fa
from particle_fm_tpu_torch.ops import short_attention as sa

SMS = 132  # the H100 SXM's SMs


@pytest.mark.parametrize("b,n,h,lat,cg,cl,want", [
    # the flagship: x and x1 in registers, weights staged once, one column block of 128
    (640, 150, 128, 10, 2, 2, dict(warps=8, tile_rows=128, weights_resident=1,
                                   column_block=128, stages=8, sets_per_block=4,
                                   set_blocks=160)),
    # path E (jetclass_cond): H=300 as two column blocks of 152, the weights streamed
    (512, 128, 300, 16, 12, 0, dict(warps=8, tile_rows=128, weights_resident=0,
                                    column_block=152, stages=ops.BF16_RING)),
    # lhco/bigPC: two column blocks of 128, streamed
    (128, 558, 256, 256, 10, 10, dict(warps=8, weights_resident=0, column_block=128)),
    # the cap: one warpgroup
    (2, 70, 512, 512, 12, 12, dict(warps=4, tile_rows=64, weights_resident=0,
                                   column_block=128)),
])
def test_epic_bf16_geometry_at_served_and_edge_shapes(b, n, h, lat, cg, cl, want):
    geo = ops.bf16_geometry(b, n, h, lat, SMS, 32, 32, cg, cl)
    assert {k: geo[k] for k in want} == want
    assert geo["blocks"] == min(SMS, -(-(b * n) // geo["tile_rows"]))
    assert geo["smem_bytes"] <= ops.MAX_SMEM
    assert geo["set_blocks"] == -(-b // geo["sets_per_block"])


@pytest.mark.parametrize("h", list(range(1, 513, 7)) + [128, 256, 300, 512])
def test_epic_bf16_geometry_fits_every_width(h):
    lat, cg = 16, 12
    geo = ops.bf16_geometry(64, 70, h, lat, SMS, 32, 32, cg, cg)
    hp = -(-h // 16) * 16
    nb = geo["column_block"]
    assert nb in (64, 128, 152) and -(-hp // nb) * nb >= hp
    assert nb % 8 == 0 and nb <= 256  # a wgmma's N
    assert geo["smem_bytes"] <= ops.MAX_SMEM
    assert geo["warps"] in (4, 8) and geo["tile_rows"] == 16 * geo["warps"]
    if geo["weights_resident"]:  # x and x1 in registers, k padded to the one column block
        assert hp <= 128 and nb >= hp and geo["stages"] == 2 * nb // 32
    else:
        assert hp > 128 and geo["stages"] == ops.BF16_RING
    assert 1 <= geo["sets_per_block"] <= ops.BF16_SETS_PER_BLOCK
    assert ops._sets_smem_bytes(h, lat, geo["sets_per_block"], 32, 32, cg, cg) <= ops.MAX_SMEM


@pytest.mark.parametrize("b,h,lk,want", [
    (32, 2, 6000, 4),      # path C: 64 (set, head) pairs, one wave of 264 resident blocks
    (700, 1, 150, 1),      # the pairs alone fill a wave
    (4, 2, 300, 2),        # few keys: at least 128 a split
    (1, 1, 100, 1),
])
def test_token_splits_fill_whole_waves(b, h, lk, want):
    splits = fa.token_splits(b, h, lk, SMS)
    assert splits == want
    geo = fa.token_geometry(b, lk, h, SMS)
    assert geo["warps"] == fa.TOKEN_WARPS
    assert geo["blocks"] == b * h * -(-lk // geo["keys_per_split"])
    if splits > 1:  # within one wave of resident blocks
        assert geo["blocks"] <= SMS * fa.TOKEN_BLOCKS_PER_SM
        assert geo["keys_per_split"] >= 128


@pytest.mark.parametrize("b,lq,lk,h,d,want", [
    # path D: one block per (set, head), 18 query tiles in 3 passes of 6 warps, the whole
    # head (279 keys) one staged tile
    (256, 279, 279, 16, 16, dict(blocks=4096, warps=6, passes=3, tile_keys=288, stages=1,
                                 smem_bytes=42624)),
    # head dim 8 runs at 16; 17 rows: 2 tiles, one pass
    (3, 17, 17, 3, 8, dict(blocks=9, warps=2, passes=1, tile_keys=288, stages=1)),
    # 558 keys at head dim 64: split in 2 (few sets), each split's 279 keys a ring of 128-key
    # tiles
    (3, 558, 558, 3, 64, dict(blocks=18, warps=6, passes=6, tile_keys=128, stages=2,
                              smem_bytes=102912)),
    # the tests' 1,500 keys at head dim 32: 5 splits of 300 keys through the ring
    (4, 1500, 1500, 4, 32, dict(blocks=80, warps=6, passes=16, tile_keys=256, stages=2)),
    # 5 rows, the fewest the variant takes: one warp
    (1, 5, 40, 1, 12, dict(blocks=1, warps=1, passes=1, stages=1)),
])
def test_flash_bf16_geometry_at_served_and_edge_shapes(b, lq, lk, h, d, want):
    geo = fa.mma_bf16_geometry(b, lq, lk, h, d)
    assert {k: geo[k] for k in want} == want
    assert geo["smem_bytes"] <= sa.MAX_SMEM
    assert geo["warps"] * geo["passes"] * sa.MMA_ROWS >= lq  # every query row in a tile
    assert (geo["warps"] - 1) * geo["passes"] * sa.MMA_ROWS < lq  # no warp idle throughout


@pytest.mark.parametrize("lq", [5, 16, 17, 96, 97, 279, 558, 1500])
@pytest.mark.parametrize("d", [1, 8, 12, 16, 17, 32, 33, 64])
def test_flash_bf16_geometry_fits_every_shape(lq, d):
    for b, lk in ((1, 5), (3, lq), (256, 279), (2, 6000)):
        geo = fa.mma_bf16_geometry(b, lq, lk, 2, d)
        splits = fa.key_splits(b, lq, lk, 2)
        per_split = -(-lk // splits)
        assert geo["blocks"] == b * 2 * -(-lk // per_split)
        assert geo["stages"] == (1 if per_split <= geo["tile_keys"] else 2)
        assert geo["tile_keys"] % 32 == 0 and geo["smem_bytes"] <= sa.MAX_SMEM
        assert 1 <= geo["warps"] <= fa.BF16_WARPS


@pytest.mark.parametrize("b,lq,lk,h,d,want", [
    # path B's first half: a block per set, 4 query rows and 2 keys at a time a lane
    (640, 4, 150, 16, 8, dict(kernel="from", blocks=640, warps=4, rows=4, keys=2)),
    # its second half: 8 rows an item (two 256-byte rows a load, 4 loads), runs of 6 items
    # over one wave of 2 blocks of 8 warps on each of 132 SMs
    (640, 150, 4, 16, 8, dict(kernel="to", blocks=254, warps=8, rows=8, keys=4,
                              items_per_warp=6)),
    # 5 to 8 keys: 2 loads an item; 33 heads of 8 take two chunks of 32 lanes
    (5, 9, 7, 33, 8, dict(kernel="to", rows=2, keys=8)),
    # head dim 64: 8 lanes a head, 3 heads in 32 lanes, one row a load
    (3, 17, 4, 3, 64, dict(kernel="to", rows=4, keys=4)),
    (3, 4, 17, 3, 12, dict(kernel="from", blocks=3, rows=4, keys=2)),
    (2, 4, 150, 16, 64, dict(kernel="from", blocks=8)),  # 16 heads of 64: 4 chunks
])
def test_fused_bf16_geometry_at_served_and_edge_shapes(b, lq, lk, h, d, want):
    geo = sa.fused_bf16_geometry(b, lq, lk, h, d, SMS)
    assert {k: geo[k] for k in want} == want
    if geo["kernel"] == "to":  # every item dealt, within one wave of resident blocks
        rows, per_warp = geo["rows"], geo["items_per_warp"]
        chunks = -(-h * {8: 1, 12: 2, 16: 2, 64: 8}[d] // 32)
        items = b * chunks * -(-lq // rows)
        assert geo["blocks"] * sa.TO_WARPS * per_warp >= items
        assert geo["blocks"] <= SMS * sa.TO_BLOCKS_PER_SM


def test_packed_bf16_geometry_at_path_a():
    """640 sets of 150 at 16 heads of 16: 2 heads a block (rows of 64 bytes),
    5,120 blocks of 4 warps, 10 steps of scores in registers (80 floats a
    lane), four blocks an SM (16 warps at 128 registers a thread, 39 KB of
    shared memory each)."""
    assert sa.packed_bf16_geometry(640, 150, 16, 16) == dict(
        blocks=5120, warps=4, heads=2, register_steps=10, smem_bytes=39040, min_blocks_per_sm=4)


@pytest.mark.parametrize("biased", [False, True])
@pytest.mark.parametrize("d", [8, 16, 32, 64])
@pytest.mark.parametrize("l", [1, 15, 16, 17, 150, 256])
def test_packed_bf16_geometry_at_the_edges(l, d, biased):
    for b, h in ((3, 3), (640, 16), (2, 5)):
        geo = sa.packed_bf16_geometry(b, l, h, d, biased)
        dp = max(16, sa.padded_head_dim(d))
        cols = max(32, dp)  # rows of at least 64 bytes: 2 heads at head dim 16, else one
        group = cols // dp
        tiles = -(-l // 16)
        assert geo["heads"] == min(group, h)
        assert geo["blocks"] == b * -(-h // group)  # every head in one group
        assert geo["warps"] == min(4, geo["heads"] * tiles)  # no warp without a tile
        steps = geo["register_steps"]
        assert 16 * steps >= l and steps in (4, 10, 16)  # the registers hold every step
        assert steps == 4 or 16 * {10: 4, 16: 10}[steps] < l  # the smallest bound that does
        assert geo["smem_bytes"] == 2 * 3 * 16 * tiles * (cols + 8) + 4 * 16 * tiles
        # 16 warps an SM (128 registers a thread) where the scores, Q, O and a bias leave room
        room = 8 * steps + dp + (16 if biased else 0) <= 96
        assert geo["min_blocks_per_sm"] == (4 if room else 2)
        # the blocks the launch bounds ask for fit an SM's 228 KB, 1 KB a block reserved
        assert geo["min_blocks_per_sm"] * (geo["smem_bytes"] + 1024) <= 233472


def test_three_bfloat16_pieces_sum_to_the_float32_input():
    """hi = bf16(x), mid = bf16(x - hi), lo = bf16(x - hi - mid): x = hi +
    mid + lo exactly, and each piece times a bfloat16 weight is exact in
    float32, so the three products summed in float32 are the float32
    product on the bfloat16 weight, up to the order of the sum."""
    rs = np.random.RandomState(0)
    x = torch.from_numpy((rs.randn(4096) * np.exp(rs.uniform(-20, 20, 4096))).astype(np.float32))
    hi = x.to(torch.bfloat16).float()
    mid = (x - hi).to(torch.bfloat16).float()
    lo = (x - hi - mid).to(torch.bfloat16).float()
    assert torch.equal(hi + mid + lo, x)
    w = torch.from_numpy(rs.randn(4096).astype(np.float32)).to(torch.bfloat16).float()
    for piece in (hi, mid, lo):
        assert torch.equal((piece.double() * w.double()).float().double(), piece.double() * w.double())
    x2 = torch.from_numpy(rs.randn(16, 300).astype(np.float32))
    wm = torch.from_numpy(rs.randn(300, 128).astype(np.float32)).to(torch.bfloat16).float()
    h2 = x2.to(torch.bfloat16).float()
    m2 = (x2 - h2).to(torch.bfloat16).float()
    l2 = (x2 - h2 - m2).to(torch.bfloat16).float()
    three = (l2 @ wm + m2 @ wm) + h2 @ wm
    exact = x2.double() @ wm.double()
    # float32 summation error of a 300-term dot product, as the float32 product has
    scale = 2 * 300 * 2.0 ** -24 * (x2.abs().double() @ wm.abs().double())
    assert ((three.double() - exact).abs() <= scale).all()
    assert ((x2 @ wm).double() - exact).abs().max() <= scale.max()


@pytest.mark.parametrize("h", [3, 48, 128, 140, 300])
def test_bf16_local_slices_lay_the_weights_out_as_the_kernel_reads_them(h):
    """Element (k, n) of w1x (product 0) or w2x (product 1) sits in slice
    (product, n // nb, k // 32) at core matrix ((n % nb) // 8, (k % 32) // 8),
    row k % 8, column n % 8; every slot past H is zero."""
    rs = np.random.RandomState(h)
    w1, w2 = (torch.from_numpy(rs.randn(h, h).astype(np.float32)).to(torch.bfloat16)
              for _ in range(2))
    image = ops.bf16_local_slices(w1, w2)
    geo = ops.bf16_geometry(1, 1, h, 8, SMS)
    nb = geo["column_block"]
    hp = -(-h // 16) * 16
    ncb = -(-hp // nb)
    kp = nb if geo["weights_resident"] else -(-h // 32) * 32
    assert image.shape == (2 * kp * ncb * nb,) and image.dtype == torch.bfloat16
    k, n = np.meshgrid(np.arange(h), np.arange(h), indexing="ij")
    for prod, w in enumerate((w1, w2)):
        slice_ = (prod * ncb + n // nb) * (kp // 32) + k // 32
        at = (slice_ * 32 * nb + (((n % nb) // 8) * 4 + (k % 32) // 8) * 64 + (k % 8) * 8
              + n % 8)
        assert torch.equal(image[torch.from_numpy(at.reshape(-1))], w.reshape(-1))
    assert float(image.float().abs().sum()) == pytest.approx(
        float(w1.float().abs().sum() + w2.float().abs().sum()), rel=1e-6)


def test_bf16_weight_image_pads_the_per_set_weights_then_the_slices():
    """The per-set weights each padded to rows of 16 and a row distance of
    the width rounded to 16 plus 8 (zeros in the padding), one after
    another, then the local slices."""
    rs = np.random.RandomState(7)
    h, lat, t, c = 300, 16, 32, 12
    shapes = [(t + 2 * h + lat + c, h), (t + h + c, lat), (t + lat, h), (t, h), (h, h), (h, h)]
    ws = [torch.from_numpy(rs.randn(*sh).astype(np.float32)).to(torch.bfloat16) for sh in shapes]
    image = ops.bf16_weight_image(*ws)
    at = 0
    for w in ws[:4]:
        k, m = w.shape
        kp, ld = -(-k // 16) * 16, -(-m // 16) * 16 + 8
        block = image[at:at + kp * ld].view(kp, ld)
        assert torch.equal(block[:k, :m], w)
        assert not block[k:].any() and not block[:, m:].any()
        at += kp * ld
    assert torch.equal(image[at:], ops.bf16_local_slices(ws[4], ws[5]))


@pytest.mark.parametrize("dtype", [None, "bfloat16"])
def test_plain_epic_layer_stands_in_for_the_wrapper_in_a_folded_network(dtype):
    """The folded layer passes its weight image (None in float32) to
    `epic_layer`; the plain version takes and ignores it, so that a caller
    that swaps the wrapper for the plain version (chip_smoke.py's plain
    paths, scripts/profile_torch_port.py) samples the same sets."""
    from unittest import mock

    from particle_fm_tpu_torch.models.flow_matching import FlowMatchingModel

    m = FlowMatchingModel(model="epic", hidden_dim=16, layers=2, latent=4, features=3,
                          num_particles=8, t_global_cat=True, t_local_cat=True,
                          add_time_to_input=False, global_cond_dim=2, local_cond_dim=2,
                          frequencies=4, t_emb="cosine", dtype=dtype)
    net = m.init(seed=0, device="cpu")
    gen = torch.Generator().manual_seed(0)
    z, cond = torch.randn(2, 8, 3, generator=gen), torch.randn(2, 2, generator=gen)
    mask = torch.ones(2, 8, 1)
    with mock.patch.object(ops, "epic_layer", ops.epic_layer_reference):
        plain = m.integrate(net, z, cond, mask, "midpoint", 3)
    torch.testing.assert_close(plain, m.integrate(net, z, cond, mask, "midpoint", 3), rtol=0,
                               atol=0)
