"""Fused EPiC layer: the CUDA kernel's wrapper and its plain PyTorch version.

Counterpart of particle_fm_tpu/ops/pallas/epic_layer.py::epic_layer_fused_fwd.
One EPiC layer, forward only, weights already folded:

  1. masked mean and `sum_scale`-scaled sum pooling over the particles;
  2. global MLP1 on cat(t_g, mean, sum, g, cond_g);
  3. global MLP2 on cat(t_g, g1, cond_g) plus the residual g;
  4. per-set biases cat(t_l, g_new, cond_l) @ w1s and cat(t_l, cond_l) @ w2s;
  5. two H x H local matmuls with leaky_relu(0.01), the second with the
     residual x.

Weight layout ((in, out), as the JAX kernel takes it):
  wg1: (tg + 2H + L + cg, H)   bg1: (H,)
  wg2: (tg + H + cg, L)        bg2: (L,)
  w1x: (H, H)  w1s: (tl + L + cl, H)  b1: (H,)
  w2x: (H, H)  w2s: (tl + cl, H)      b2: (H,)
set_feat (B, S) is laid out [t_emb, cond]: t_g = set_feat[:, :tg],
t_l = set_feat[:, :tl]. The conditioning vector is C wide and feeds the
global MLPs when cg = C, the local biases when cl = C (each of cg and cl is 0
or C, as the JAX layer's global_cond_dim and local_cond_dim choose):
cond_g = set_feat[:, S-cg:], cond_l = set_feat[:, S-cl:]. The JAX kernel
takes one width for both; jetclass_cond feeds cond to the global path only.

`epic_layer` runs the plain version for a tensor on the CPU and launches
`csrc/epic_layer.cu` for a CUDA tensor; it never falls back from one to the
other. Both go through the custom ops `particle_fm::epic_layer` and
`particle_fm::epic_layer_bf16` (`torch.library`): a CUDA implementation that
launches the kernel and counts the launch, a CPU implementation that is the
plain version, and a fake one that gives the outputs' shapes, so that
`torch.export` traces a folded network on either device into the same op
nodes. The wrappers check the arguments before they call the op; the
CUDA implementations do what needs real tensors (the 16-byte start of
x_local, the scratch, the stream). The CUDA library is built with nvcc at
first use (ops/_build.py). The float32 kernel runs the two local matmuls on
the tensor cores, each float32 product as three TF32 products
(csrc/mma_tf32.cuh); `epic_layer_tf32` models that arithmetic on any
device, and `launch_report` asks the built library what its launcher gives
the kernel at a shape. The bfloat16 kernels (the
per-set part over several sets a block, then the local products on wgmma,
csrc/wgmma_bf16.cuh) have `bf16_launch_report`, which `bf16_geometry`
mirrors.
"""

from __future__ import annotations

import ctypes
from pathlib import Path

import torch
import torch.nn.functional as F

from particle_fm_tpu_torch.ops import _build
from particle_fm_tpu_torch.ops._build import OPS_NAMESPACE
from particle_fm_tpu_torch.ops._build import check_tensor as _check
from particle_fm_tpu_torch.ops.tf32 import product_tf32

SOURCE = _build.CSRC_DIR / "epic_layer.cu"
MAX_WIDTH = 512  # the largest H and L the kernel takes
# the bfloat16 kernels' constants (csrc/epic_layer.cu, bfloat16 section)
BF16_SETS_PER_BLOCK = 4  # kSetsPerBlock: sets of a per-set block, at most
BF16_CHUNK_BYTES, BF16_CHUNK_STAGES = 24576, 3  # kChunkBytes, kChunkStages: per-set weight chunks
BF16_TILE_ROWS = 64  # kTileRows: rows of a warpgroup's tile
BF16_SLICE_K = 32  # kSliceK: k rows of a weight slice
BF16_RING = 6  # kRing: slots of the streamed weights
MAX_SMEM = 232448  # kMaxSmem: bytes of shared memory a block may use


def _act(x: torch.Tensor) -> torch.Tensor:
    return F.leaky_relu(x, negative_slope=0.01)


def epic_layer_reference(
    x_local, x_global, mask, set_feat,
    wg1, bg1, wg2, bg2, w1x, w1s, b1, w2x, w2s, b2,
    sum_scale: float = 1e-2,
    tg_dim: int = 0,
    tl_dim: int = 0,
    cg_dim: int = 0,
    cl_dim: int = 0,
    local_matmul=torch.matmul,
    weight_image=None,
):
    """Plain PyTorch version of the fused layer. Returns (x_local, x_global)
    in x_local's dtype. `local_matmul(x, w)` computes the two H x H local
    products. `weight_image`, the bfloat16 kernels' layout of the same
    weights (`bf16_weight_image`), is taken and not used, so that the plain
    version stands in for `epic_layer` wherever a caller passes it.

    In bfloat16 it keeps the Pallas kernel's arithmetic: every product in
    float32 on the bfloat16 values (a bfloat16 product is exact in float32,
    so a float32 product on the values is the kernel's bfloat16 product with
    float32 accumulation), the mask, the pool, the biases and the residual
    in float32, and four roundings to bfloat16: g1 before the second global
    MLP, g_new (for the per-set bias and the output), x1 before the second
    local product, and the output. In float32 (and float64) every cast is a
    no-op."""
    lowp = x_local.dtype
    work = torch.promote_types(lowp, torch.float32)
    x, g = x_local.to(work), x_global.to(work)
    m = mask.to(work)
    sf = set_feat.to(work)
    wg1, bg1, wg2, bg2, w1x, w1s, b1, w2x, w2s, b2 = (
        w.to(work) for w in (wg1, bg1, wg2, bg2, w1x, w1s, b1, w2x, w2s, b2))
    pooled_sum = torch.sum(x * m[..., None], dim=1)
    count = torch.sum(m, dim=1, keepdim=True)
    pooled_mean = pooled_sum / count
    pooled_scaled = pooled_sum * sum_scale

    s = sf.shape[-1]
    t_g = sf[:, :tg_dim]
    t_l = sf[:, :tl_dim]
    cond_g = sf[:, s - cg_dim :]
    cond_l = sf[:, s - cl_dim :]

    def rounded(v):
        return v.to(lowp).to(work)

    g_in = torch.cat([t_g, pooled_mean, pooled_scaled, g, cond_g], dim=-1)
    g1 = rounded(_act(g_in @ wg1 + bg1))
    g_new = rounded(_act(torch.cat([t_g, g1, cond_g], dim=-1) @ wg2 + bg2 + g))

    bias1 = torch.cat([t_l, g_new, cond_l], dim=-1) @ w1s + b1
    bias2 = torch.cat([t_l, cond_l], dim=-1) @ w2s + b2  # zero-width inputs give b2

    x1 = rounded(_act(local_matmul(x, w1x) + bias1[:, None, :]))
    out = _act(local_matmul(x1, w2x) + bias2[:, None, :] + x)
    return out.to(lowp), g_new.to(lowp)


def epic_layer_tf32(*args, products: int = 3, **dims):
    """The kernel's arithmetic on any device: the plain version with its two
    local matmuls as `products` TF32 products per float32 product
    (ops/tf32.py); the pool, the per-set MLPs and the epilogues stay float32,
    as in the kernel. Not on any serving path."""
    matmul = lambda a, w: product_tf32("bnk,kh->bnh", a, w, products)
    return epic_layer_reference(*args, **dims, local_matmul=matmul)


def _declare(lib: ctypes.CDLL) -> None:
    fn = lib.epic_layer_fwd_f32
    fn.argtypes = [ctypes.c_void_p] * 16 + [ctypes.c_int] * 9 + [ctypes.c_float, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    geometry = lib.epic_layer_geometry
    geometry.argtypes = [ctypes.c_int] * 9 + [ctypes.POINTER(ctypes.c_int)]
    geometry.restype = ctypes.c_int
    lib.epic_layer_mma_instruction.argtypes = []
    lib.epic_layer_mma_instruction.restype = ctypes.c_char_p
    if hasattr(lib, "epic_layer_fwd_bf16"):  # an earlier source, timed beside, may lack it
        fn = lib.epic_layer_fwd_bf16
        fn.argtypes = ([ctypes.c_void_p] * 18 + [ctypes.c_int] * 9
                       + [ctypes.c_float, ctypes.c_void_p])
        fn.restype = ctypes.c_int
        lib.epic_layer_bf16_mma_instruction.argtypes = []
        lib.epic_layer_bf16_mma_instruction.restype = ctypes.c_char_p
    if hasattr(lib, "epic_layer_bf16_geometry"):
        geometry = lib.epic_layer_bf16_geometry
        geometry.argtypes = [ctypes.c_int] * 9 + [ctypes.POINTER(ctypes.c_int)]
        geometry.restype = ctypes.c_int


def launch_report(b: int, n: int, h: int, l: int, s: int, tg: int = 0, tl: int = 0,
                  cg: int = 0, cl: int = 0, source: Path | None = None) -> dict:
    """What the built library's launcher gives the kernel at this shape (the
    launcher's own code with a report in place of the launch; needs a CUDA
    device): blocks, warps, rows of a tile, bytes of shared memory, registers
    per thread, TF32 products per float32 product, whether the local weights
    sit in shared memory, and the instruction."""
    lib = load_library(source)
    report = (ctypes.c_int * 7)()
    err = lib.epic_layer_geometry(b, n, h, l, s, tg, tl, cg, cl, report)
    if err != 0:
        raise RuntimeError(f"epic_layer_geometry failed: cudaError {err}")
    names = ("blocks", "warps", "tile_rows", "smem_bytes", "registers_per_thread",
             "tf32_products_per_float32_product", "weights_in_shared_memory")
    return dict(zip(names, report), instruction=lib.epic_layer_mma_instruction().decode())


BF16_REPORT = ("blocks", "warps", "tile_rows", "stages", "smem_bytes", "registers_per_thread",
               "weights_resident", "column_block", "set_blocks", "sets_per_block")


def _sets_smem_bytes(h: int, l: int, sets: int, tg: int, tl: int, cg: int, cl: int) -> int:
    """A block's shared memory of the per-set kernel (SetsLayout in the
    source): the four dots' float32 inputs and results, the inputs split into
    three bfloat16 pieces, the weight chunks."""
    k = (tg + 2 * h + l + cg, tg + h + cg, tl + l + cl, tl + cl)
    kmax = -(-max(k[:3]) // 16) * 16
    res = -(-(sets * sum(k)) // 4) * 4
    wide = -(-max(h, l) // 16) * 16 + 8
    floats = -(-(res + sets * wide) // 4) * 4
    return 4 * (floats + 3 * (sets + 1) * (kmax + 8) // 2) + BF16_CHUNK_STAGES * BF16_CHUNK_BYTES


def _local_widths(h: int) -> tuple[int, int, int, int, bool]:
    """(hp, nb, ncb, kp, regs) of the local kernels at width h: H padded to
    16, the column block (a wgmma's N) and their count, k padded (to the
    column block where x and x1 live in registers, H <= 128; else to 32)."""
    hp = -(-h // 16) * 16
    regs = hp <= 128
    nb = 64 if hp <= 64 else 128 if (hp <= 128 or 152 < hp <= 256 or hp > 304) else 152
    return hp, nb, -(-hp // nb), nb if regs else -(-h // 32) * 32, regs


def bf16_local_slices(w1x: torch.Tensor, w2x: torch.Tensor) -> torch.Tensor:
    """w1x and w2x (H, H), bfloat16, as the local kernels stage them: per
    weight, column block and k slice of 32 rows, the slice's core matrices
    (8 rows of k by 8 columns, 128 bytes each, column blocks of 8 outer) one
    after another, zeros past H, so that a slice is one contiguous copy. The
    last part of `bf16_weight_image`."""
    h = w1x.shape[0]
    _, nb, ncb, kp, _ = _local_widths(h)
    out = []
    for w in (w1x, w2x):
        wp = w.new_zeros(kp, ncb * nb)
        wp[:h, :h] = w
        # k = 32 ks + 8 rg + ri, n = nb cb + 8 cg + ci -> (cb, ks, cg, rg, ri, ci)
        out.append(wp.view(kp // 32, 4, 8, ncb, nb // 8, 8).permute(3, 0, 4, 1, 2, 5).reshape(-1))
    return torch.cat(out)


def bf16_weight_image(wg1, wg2, w1s, w2s, w1x, w2x) -> torch.Tensor:
    """The bfloat16 kernels' image of a layer's weights (ImageLayout in the
    source), one bfloat16 vector: the per-set weights wg1, wg2, w1s and w2s,
    each with its rows padded with zeros to a multiple of 16 at a row
    distance of its width rounded up to 16 plus 8 (rows on 16 bytes, read by
    ldmatrix without bank conflicts), so that a chunk of rows is one
    contiguous copy; then `bf16_local_slices(w1x, w2x)`. `EPiCLayer.fold`
    lays it out once; `epic_layer_bf16` does at the call where it is given
    none."""
    parts = []
    for w in (wg1, wg2, w1s, w2s):
        k, m = w.shape
        wp = w.new_zeros(-(-k // 16) * 16, -(-m // 16) * 16 + 8)
        wp[:k, :m] = w
        parts.append(wp.reshape(-1))
    return torch.cat(parts + [bf16_local_slices(w1x, w2x)])


def bf16_geometry(b: int, n: int, h: int, l: int, sms: int, tg: int = 0, tl: int = 0,
                  cg: int = 0, cl: int = 0) -> dict:
    """What the launcher of `epic_layer_fwd_bf16` gives its kernels for b
    sets of n particles at widths h and l on a card of `sms` SMs (the
    library's report but the registers): the local kernel's persistent
    blocks, warps (one or two warpgroups of 4), the rows its warpgroups take
    at a time (64 each), the weight slices (32 rows of k by a column block)
    staged at once, a block's shared memory, whether x and x1 live in
    registers with both weights staged once (H <= 128; wider layers stage x
    and x1 in shared memory and stream the weights through a ring), the
    column block (the wgmma's N: H is padded to 16 and cut into blocks of 64,
    128 or 152 columns); the per-set kernel's blocks and sets a block (4, or
    fewer until its shared memory fits). The pool kernel before it takes one
    set a block."""
    hp, nb, ncb, kp, regs = _local_widths(h)
    tc = nb + 8 if regs else max(kp, ncb * nb)  # columns of a tile in shared memory
    slices, slice_bytes = 2 * ncb * (kp // BF16_SLICE_K), 2 * BF16_SLICE_K * nb
    slots = slices if regs else BF16_RING
    biases = (2 if regs else 1) * 4 * 2 * 2 * ncb * nb  # bytes of a warpgroup's bias buffers
    smem = lambda wgs: wgs * (2 * 2 * BF16_TILE_ROWS * tc + biases) + slots * slice_bytes
    wgs = 2 if smem(2) <= MAX_SMEM else 1
    unit = wgs * BF16_TILE_ROWS
    sets = BF16_SETS_PER_BLOCK
    while sets > 1 and _sets_smem_bytes(h, l, sets, tg, tl, cg, cl) > MAX_SMEM:
        sets //= 2
    return {"blocks": min(-(-(b * n) // unit), sms), "warps": 4 * wgs, "tile_rows": unit,
            "stages": slots, "smem_bytes": smem(wgs), "weights_resident": int(regs),
            "column_block": nb, "set_blocks": -(-b // sets), "sets_per_block": sets}


def bf16_launch_report(b: int, n: int, h: int, l: int, s: int, tg: int = 0, tl: int = 0,
                       cg: int = 0, cl: int = 0) -> dict:
    """What the built library's launcher gives the two bfloat16 kernels at
    this shape (needs a CUDA device): `BF16_REPORT`, and the instruction of
    the local products with N the column block."""
    report = (ctypes.c_int * len(BF16_REPORT))()
    err = load_library().epic_layer_bf16_geometry(b, n, h, l, s, tg, tl, cg, cl, report)
    if err != 0:
        raise RuntimeError(f"epic_layer_bf16_geometry failed: cudaError {err}")
    out = dict(zip(BF16_REPORT, report))
    out["instruction"] = bf16_instruction().replace("m64nNk16", f"m64n{out['column_block']}k16")
    return out


def build_library(source: Path | None = None) -> Path:
    """Compile `source` (default csrc/epic_layer.cu); see ops/_build.py."""
    return _build.build_library(source or SOURCE)


def load_library(source: Path | None = None) -> ctypes.CDLL:
    """The kernel library built from `source` (default: `SOURCE` as it is
    at the call), loaded once."""
    return _build.load_library(source or SOURCE, _declare)


def bf16_instruction() -> str:
    """The tensor-core instruction of the bfloat16 kernel's local products,
    as the built library names it, N standing for the column block (needs
    the library; no device)."""
    return load_library().epic_layer_bf16_mma_instruction().decode()


def _check_shapes(args, dims, dtype: torch.dtype) -> tuple[int, int, int, int, int]:
    """Raise unless the arguments are a shape the kernels take, every tensor
    of `dtype` but the float32 mask; (b, n, h, l, s)."""
    x_local, x_global, mask, set_feat = args[:4]
    tg_dim, tl_dim, cg_dim, cl_dim = (dims[k] for k in ("tg_dim", "tl_dim", "cg_dim", "cl_dim"))
    if x_local.ndim != 3:
        raise ValueError(f"x_local must be (B, N, H), got {tuple(x_local.shape)}")
    b, n, h = x_local.shape
    l = x_global.shape[-1]
    s = set_feat.shape[-1] if set_feat.ndim == 2 else -1
    if not (0 < h <= MAX_WIDTH and 0 < l <= MAX_WIDTH):
        raise ValueError(f"hidden width {h} or latent width {l} outside the kernel's 1..{MAX_WIDTH}")
    c = max(cg_dim, cl_dim)
    if min(tg_dim, tl_dim, cg_dim, cl_dim) < 0 or max(tg_dim, tl_dim) + c > s:
        raise ValueError(f"set_feat width {s} cannot hold t ({tg_dim}, {tl_dim}) and cond {c}")
    if cg_dim not in (0, c) or cl_dim not in (0, c):
        raise ValueError(f"cond widths {cg_dim} (global) and {cl_dim} (local) must each be 0 or C")
    dev = x_local.device
    for name, t, shape in (
        ("x_local", x_local, (b, n, h)),
        ("x_global", x_global, (b, l)),
        ("mask", mask, (b, n)),
        ("set_feat", set_feat, (b, s)),
        ("wg1", args[4], (tg_dim + 2 * h + l + cg_dim, h)),
        ("bg1", args[5], (h,)),
        ("wg2", args[6], (tg_dim + h + cg_dim, l)),
        ("bg2", args[7], (l,)),
        ("w1x", args[8], (h, h)),
        ("w1s", args[9], (tl_dim + l + cl_dim, h)),
        ("b1", args[10], (h,)),
        ("w2x", args[11], (h, h)),
        ("w2s", args[12], (tl_dim + cl_dim, h)),
        ("b2", args[13], (h,)),
    ):
        # the mask stays float32 in both kernels, as in the Pallas kernel
        _check(name, t, shape, dev, dtype=torch.float32 if name == "mask" else dtype)
    return b, n, h, l, s


def _check_start(x_local: torch.Tensor) -> None:
    if x_local.data_ptr() % 16:
        raise ValueError("x_local must start on 16 bytes (the kernel reads it in 16-byte pieces)")


def epic_layer_bf16(
    x_local, x_global, mask, set_feat,
    wg1, bg1, wg2, bg2, w1x, w1s, b1, w2x, w2s, b2,
    sum_scale: float = 1e-2,
    tg_dim: int = 0,
    tl_dim: int = 0,
    cg_dim: int = 0,
    cl_dim: int = 0,
    weight_image=None,
):
    """The bfloat16 kernel on CUDA tensors (`epic_layer_fwd_bf16`): every
    tensor bfloat16 but the float32 mask; arguments as in
    `epic_layer_reference`, whose bfloat16 arithmetic it computes, and
    `weight_image`, the weights as `bf16_weight_image` lays them out (laid
    out here when not given; the kernels read the weights from it only).
    Counts its launches in `epic_layer_bf16.launches`."""
    args = (x_local, x_global, mask, set_feat, wg1, bg1, wg2, bg2, w1x, w1s, b1, w2x, w2s, b2)
    dims = dict(tg_dim=tg_dim, tl_dim=tl_dim, cg_dim=cg_dim, cl_dim=cl_dim)
    if x_local.device.type != "cuda" or x_local.dtype != torch.bfloat16:
        raise ValueError(f"epic_layer_bf16 takes bfloat16 CUDA tensors, got {x_local.dtype} on "
                         f"{x_local.device}")
    _, _, h, _, _ = _check_shapes(args, dims, torch.bfloat16)
    if weight_image is None:
        weight_image = bf16_weight_image(wg1, wg2, w1s, w2s, w1x, w2x)
    _, nb, ncb, kp, _ = _local_widths(h)
    size = 2 * kp * ncb * nb + sum(-(-w.shape[0] // 16) * 16 * (-(-w.shape[1] // 16) * 16 + 8)
                                   for w in (wg1, wg2, w1s, w2s))
    _check("weight_image", weight_image, (size,), x_local.device, dtype=torch.bfloat16)
    return torch.ops.particle_fm.epic_layer_bf16(*args, float(sum_scale), tg_dim, tl_dim, cg_dim,
                                                 cl_dim, weight_image)


epic_layer_bf16.launches = 0


def epic_layer(
    x_local, x_global, mask, set_feat,
    wg1, bg1, wg2, bg2, w1x, w1s, b1, w2x, w2s, b2,
    sum_scale: float = 1e-2,
    tg_dim: int = 0,
    tl_dim: int = 0,
    cg_dim: int = 0,
    cl_dim: int = 0,
    weight_image=None,
):
    """One EPiC layer: for CUDA tensors the float32 kernel, or the bfloat16
    one (`epic_layer_bf16`, which takes `weight_image`) for bfloat16
    tensors; the plain version for CPU tensors. Arguments as in
    `epic_layer_reference`."""
    args = (x_local, x_global, mask, set_feat, wg1, bg1, wg2, bg2, w1x, w1s, b1, w2x, w2s, b2)
    dims = (float(sum_scale), tg_dim, tl_dim, cg_dim, cl_dim)
    if x_local.device.type == "cpu":
        if x_local.dtype == torch.bfloat16:
            return torch.ops.particle_fm.epic_layer_bf16(*args, *dims, weight_image)
        return torch.ops.particle_fm.epic_layer(*args, *dims)
    if x_local.device.type != "cuda":
        raise ValueError(f"epic_layer runs on cuda or cpu, got {x_local.device}")
    if x_local.dtype == torch.bfloat16:
        return epic_layer_bf16(*args, sum_scale=sum_scale, tg_dim=tg_dim, tl_dim=tl_dim,
                               cg_dim=cg_dim, cl_dim=cl_dim, weight_image=weight_image)
    _check_shapes(args, dict(tg_dim=tg_dim, tl_dim=tl_dim, cg_dim=cg_dim, cl_dim=cl_dim),
                  torch.float32)
    return torch.ops.particle_fm.epic_layer(*args, *dims)


epic_layer.launches = 0


# The custom ops. Their CUDA implementations launch the kernels on the current
# stream and count the launch in the public wrapper's `launches`, wherever the
# op is called from: the wrapper, or an exported program (serving.py).

_ARGS = ("Tensor x_local, Tensor x_global, Tensor mask, Tensor set_feat, Tensor wg1, Tensor bg1, "
         "Tensor wg2, Tensor bg2, Tensor w1x, Tensor w1s, Tensor b1, Tensor w2x, Tensor w2s, "
         "Tensor b2, float sum_scale, int tg_dim, int tl_dim, int cg_dim, int cl_dim")
_LIB = torch.library.Library(OPS_NAMESPACE, "FRAGMENT")
_LIB.define(f"epic_layer({_ARGS}) -> (Tensor, Tensor)")
_LIB.define(f"epic_layer_bf16({_ARGS}, Tensor? weight_image) -> (Tensor, Tensor)")


def _plain(*args):
    """The CPU implementation of both ops: the plain version."""
    sum_scale, tg, tl, cg, cl = args[14:19]
    return epic_layer_reference(*args[:14], sum_scale=sum_scale, tg_dim=tg, tl_dim=tl, cg_dim=cg,
                                cl_dim=cl)


def _fake(*args):
    return torch.empty_like(args[0]), torch.empty_like(args[1])


def _run(bf16: bool, *args) -> tuple[torch.Tensor, torch.Tensor]:
    """The CUDA implementation of either op: the library's launch on the
    current stream (the arguments as the wrapper checked them)."""
    x_local, x_global = args[:2]
    sum_scale, tg, tl, cg, cl = args[14:19]
    xo, go = torch.empty_like(x_local), torch.empty_like(x_global)
    b, n, h = x_local.shape
    if b == 0:
        return xo, go
    _check_start(x_local)
    dev = x_local.device
    lib = load_library()
    if bf16:
        # scratch between the library's three kernels, float32: the per-set
        # biases of the two local products (B, 2, H), the pooled sums (B, H),
        # the counts (B)
        biases = torch.empty(b * (3 * h + 1), dtype=torch.float32, device=dev)
        entry, extra = lib.epic_layer_fwd_bf16, (biases.data_ptr(), args[19].data_ptr())
    else:
        entry, extra = lib.epic_layer_fwd_f32, ()
    with torch.cuda.device(dev):
        err = entry(
            *(t.data_ptr() for t in args[:14]), xo.data_ptr(), go.data_ptr(), *extra,
            b, n, h, x_global.shape[-1], args[3].shape[-1], tg, tl, cg, cl, sum_scale,
            torch.cuda.current_stream(dev).cuda_stream,
        )
    if err != 0:
        raise RuntimeError(f"epic_layer{'_bf16' if bf16 else ''} kernel launch failed: "
                           f"cudaError {err}")
    return xo, go


def _register(name: str, wrapper, bf16: bool) -> None:
    def launch(*args):
        out = _run(bf16, *args)
        wrapper.launches += 1
        return out

    _LIB.impl(name, launch, "CUDA")
    _LIB.impl(name, _plain, "CPU")
    torch.library.register_fake(f"{OPS_NAMESPACE}::{name}", _fake, lib=_LIB)


_register("epic_layer", epic_layer, bf16=False)
_register("epic_layer_bf16", epic_layer_bf16, bf16=True)
