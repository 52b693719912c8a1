#!/usr/bin/env python3
"""Time design variants of the three bfloat16 attention kernels redesigned for
the H100 (packed at path A, flash at path D, the fused pair at path B)
against the committed ones, in turns, at their served shapes.

    python3 scripts/attention_bf16_variants.py [--rounds 3] [--kernels packed,flash,fused]
        [--out build/measurements/attention_bf16_variants.json]

A variant is a copy of csrc/short_attention.cu or csrc/flash_attention.cu
under build/variants/attn_<name>/ with lines replaced (and, where a variant
replaces lines of a header, a copy of the header beside it, which the
compiler then takes); the script fails if a line it wants to replace is no
longer there once:

  packed: all_keys            every key of a set stepped over, no extent
          two_passes          Q . K^T computed again for P (the first
                              version's two passes; the scores no longer
                              kept in registers)
          step_group_1, step_group_2   steps of 16 keys a straight-line
                              group (4 as committed; 1: a test before every
                              step)
          stage_all_keys      K and V of every key copied with Q, before
                              the mask is read (the extent then bounds the
                              steps only)
          ko_exp              knock-out (wrong results, for timing): p = s -
                              m, no exponential
          ko_qk_mma, ko_pv_mma   knock-outs: no tensor product for Q . K^T,
                              or for P . V (an integer operation on the same
                              registers in its place)
          ko_staging          knock-out: Q, K and V not staged (the steps
                              read whatever shared memory holds)
          ko_steps            knock-out: no warp computes a tile (what is
                              left: staging, the mask read, the output
                              written from shared memory)
          heads_4_warps_8     4 heads and 8 warps a block at head dim 16,
                              two blocks an SM (2 and 4 as committed, four
                              blocks an SM; the launch bounds ask for 16
                              warps an SM throughout)
          heads_4_warps_4, heads_2_warps_8, heads_1_warps_2   likewise
          warps_5_blocks_3    5 warps a block, three blocks an SM (at most
                              136 registers a thread)
          blocks_2, blocks_3  launch bounds of two or three blocks an SM (8
                              or 12 warps, up to 255 or 168 registers a
                              thread)
          step_group_8_blocks_3   groups of 8 steps, three blocks an SM
  flash: blocks_3, blocks_5   resident blocks an SM of the launch bounds (4
                              as committed: at most 85 registers a thread;
                              3: 113; 5: 68)
         step_16              softmax steps of 16 keys (32 as committed)
         all_keys             every key of a set stepped over, no extent
         pv_bf16_pieces       P . V as three exact bfloat16 pieces of P on
                              m16n8k16 (bfloat16 products, V read by
                              ldmatrix.trans as staged; no float32 copy of V)
                              in place of two TF32 products
         ko_pv_lo             knock-out (wrong results, for timing): P . V
                              without the TF32 product of P's remainder
         ko_exp               knock-out: p = s - m, no exponential
         ko_steps             knock-out: no softmax step (what is left: the
                              mask read, staging, conversion, Q, the stores)
         ko_steps_stage       knock-out: neither steps nor K and V staged
  fused: from_blocks_4, from_blocks_6   the "from" kernel's launch bounds at
                              4 or 6 blocks an SM (5 as committed: at most 102
                              registers a thread)
         from_keys_4          4 keys loaded at a time a lane (2 as committed)
         from_streaming_loads K and V loaded with the evict-first hint
         to_warps_4_blocks_4  the "to" kernel in blocks of 4 warps, 4 an SM

Each version is called through the wrapper (`packed_short_attention`,
`flash_masked_attention`, `fused_short_attention`), its module's SOURCE
pointed at the variant, on the served shapes: path A (B=640, L=150, 16 heads
of 16, slices of one QKV projection, 30-150 real keys), path D (B=256,
Lq=Lk=279, 16 heads of 16, slices of one QKV projection, 30-279 real keys),
path B's "from" (B=640, 4 queries on 150 masked keys) and "to" (150 queries
on 4 keys). Times: `cuda_ms` (utils/timing.py, through the wrapper: the
host's time to issue a call is in it where the host is slower) and
`device_ms` (the kernels' device time from torch.profiler), each the median
over `--rounds` rounds in turns (forwards, then backwards through the
versions). The maximum error against the plain version is printed, not
asserted. One JSON line per shape, with the card's name and power limit,
also written to --out.
"""

from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

from chip_smoke import attention_case  # noqa: E402
from particle_fm_tpu_torch.ops import _build  # noqa: E402
from particle_fm_tpu_torch.ops import flash_attention as fa  # noqa: E402
from particle_fm_tpu_torch.ops import short_attention as sa  # noqa: E402
from particle_fm_tpu_torch.utils.timing import cuda_ms, device_ms  # noqa: E402

FB_BLOCKS = "constexpr int kFbBlocksPerSm = 4;"
FB_STEP = "__host__ __device__ constexpr int fb_step_keys(int dp) { return dp <= 32 ? 32 : 16; }"
FB_EXTENT = "real_key_extent(mrow, lk, &sm_last)"
FB_PV_LO = ("      mma_tf32(t.o[2 * c], p_lo, b[0], b[1]);\n"
            "      mma_tf32(t.o[2 * c + 1], p_lo, b[2], b[3]);\n")
FB_EXP = "      const float p = exp2_neg((s[kt >> 1][kt & 1][i] - t.m[i >> 1]) * kLog2e);"
FB_COMPUTE = "      if (active) flash_bf16_keys(t, ks0, vf, madd, padded(keys_of(0)), scale);"
FB_STAGE = ("    stage(0, 0);\n    cp_async_wait_all();\n    __syncthreads();\n"
            "    convert(0, 0);\n")
# P . V as three exact bfloat16 pieces of P on m16n8k16, V read by ldmatrix.trans from the
# bfloat16 rows as staged (no float32 copy): the other design the kernel's note names
FB_PV_TF32 = """  const float4* vrow = reinterpret_cast<const float4*>(vf) + (key0 / 8) * (DP / 16) * 32 + lane;
#pragma unroll
  for (int kt = 0; kt < NT; ++kt) {
    uint32_t p_hi[4], p_lo[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float p = exp2_neg((s[kt >> 1][kt & 1][i] - t.m[i >> 1]) * kLog2e);
      t.l[i >> 1] += p;
      const int a = (i >> 1) + 2 * (i & 1);  // c0 c1 c2 c3 -> a0 a2 a1 a3
      const Tf32 x = split_tf32(p);
      p_hi[a] = x.hi;
      p_lo[a] = x.lo;
    }
#pragma unroll
    for (int c = 0; c < DP / 16; ++c) {
      const float4 w = vrow[(kt * (DP / 16) + c) * 32];
      const uint32_t b[4] = {__float_as_uint(w.x), __float_as_uint(w.y), __float_as_uint(w.z),
                             __float_as_uint(w.w)};
      mma_tf32(t.o[2 * c], p_lo, b[0], b[1]);
      mma_tf32(t.o[2 * c + 1], p_lo, b[2], b[3]);
      mma_tf32(t.o[2 * c], p_hi, b[0], b[1]);
      mma_tf32(t.o[2 * c + 1], p_hi, b[2], b[3]);
    }
  }
}"""
FB_PV_PIECES = """  const bf16* vrow = reinterpret_cast<const bf16*>(vf) + (key0 + (lane & 15)) * DP + 8 * (lane >> 4);
#pragma unroll
  for (int k16 = 0; k16 < NT / 2; ++k16) {
    uint32_t a[3][4];  // P's pieces as A: register j holds 8-key tile j >> 1, row half j & 1
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int half = j & 1;
      const float p0 = exp2_neg((s[k16][j >> 1][2 * half] - t.m[half]) * kLog2e);
      const float p1 = exp2_neg((s[k16][j >> 1][2 * half + 1] - t.m[half]) * kLog2e);
      t.l[half] += p0;
      t.l[half] += p1;
      const uint32_t hi = pack_bf16(p0, p1);
      const float r0 = p0 - __uint_as_float(hi << 16), r1 = p1 - __uint_as_float(hi & 0xffff0000u);
      const uint32_t mid = pack_bf16(r0, r1);
      a[0][j] = hi;
      a[1][j] = mid;
      a[2][j] = pack_bf16(r0 - __uint_as_float(mid << 16), r1 - __uint_as_float(mid & 0xffff0000u));
    }
#pragma unroll
    for (int np = 0; np < DP / 16; ++np) {
      uint32_t b[4];
      ldmatrix_x4_trans(b, vrow + 16 * k16 * DP + 16 * np);
#pragma unroll
      for (int piece = 2; piece >= 0; --piece) {  // the small pieces first
        mma_bf16(t.o[2 * np], a[piece], b[0], b[1]);
        mma_bf16(t.o[2 * np + 1], a[piece], b[2], b[3]);
      }
    }
  }
}"""
FB_CONVERT = "      for (int g = 0; g < 8; ++g) dst[16 * g] = f[g];"
FB_CALL_RING = "          flash_bf16_keys(t, ks0 + (i & 1) * KC * ST, vf, madd, padded(keys_of(i)), scale);"
FROM_LOADS = ("        kr[u] = load8_raw<false>(", "        vr[u] = load8_raw<false>(")
FROM_BLOCKS = "constexpr int kFromBlocksPerSm = 5;"
FROM_KEYS = "constexpr int kFromKeys = 2;"
TO_BLOCKS = "constexpr int kToBlocksPerSm = 2;"
TO_WARPS = "constexpr int kToWarps = 8;"
PK_EXTENT = "  const int kp = min(lp, (ext + kBfKeys - 1) / kBfKeys * kBfKeys);"
PK_PV = ("  for_steps<NS>(n_steps, [&](int j) { packed_bf16_pv<DP>(o, l, s[j], m, vrow + 16 * j * sw); "
         "});")
PK_TWO_PASSES = """  for_steps<NS>(n_steps, [&](int j) {
    float sj[2][4];
    packed_bf16_scores<DP>(sj, q, krow + 16 * j * sw, madd + 16 * j, 16 * j, scale, bias);
    packed_bf16_pv<DP>(o, l, sj, m, vrow + 16 * j * sw);
  });"""
PK_EXP = "      p[kt][i] = exp2_neg((s[kt][i] - m[i >> 1]) * kLog2e);"
PK_GROUP = "constexpr int kPackedStepGroup = 4;"
PK_TASKS = "  for (int task = threadIdx.x >> 5; task < nh * tiles; task += blockDim.x >> 5) {"
PK_WARPS = "constexpr int kPackedBf16Warps = 4;"
PK_COLS = "constexpr int kPackedBf16Cols = 32;"
PK_STAGE_ORDER = """  stage_group_bf16<DP>(qs, q.p + b * q.bs + col0, q.ld, l, lp, nh, d, wide);
  const int ext = stage_mask_extent(madd, mask ? mask + (long long)b * l : nullptr, l, lp,
                                    &sm_last);
  const int kp = min(lp, (ext + kBfKeys - 1) / kBfKeys * kBfKeys);
  stage_group_bf16<DP>(ks, k.p + b * k.bs + col0, k.ld, l, kp, nh, d, wide);
  stage_group_bf16<DP>(vs, v.p + b * v.bs + col0, v.ld, l, kp, nh, d, wide);"""
PK_STAGE_ALL = """  stage_group_bf16<DP>(qs, q.p + b * q.bs + col0, q.ld, l, lp, nh, d, wide);
  stage_group_bf16<DP>(ks, k.p + b * k.bs + col0, k.ld, l, lp, nh, d, wide);
  stage_group_bf16<DP>(vs, v.p + b * v.bs + col0, v.ld, l, lp, nh, d, wide);
  const int ext = stage_mask_extent(madd, mask ? mask + (long long)b * l : nullptr, l, lp,
                                    &sm_last);
  const int kp = min(lp, (ext + kBfKeys - 1) / kBfKeys * kBfKeys);"""
PK_MIN_BLOCKS = "  return ((ns * 8 + dp + (bias ? 16 : 0) <= 96 ? 16 : 8) + kPackedBf16Warps - 1) /"
PK_QK_MMA = ("    mma_bf16(s[0], q[kk], b[0], b[1]);\n"
             "    mma_bf16(s[1], q[kk], b[2], b[3]);\n")
PK_PV_MMA = ("    mma_bf16(o[2 * np], a, b[0], b[1]);\n"
             "    mma_bf16(o[2 * np + 1], a, b[2], b[3]);\n")
MMA = "attention_mma.cuh"  # a replacement in the header beside the source
MIN_BLOCKS_AS = lambda n: ("  return %d + 0 * ((ns * 8 + dp + (bias ? 16 : 0) <= 96 ? 16 : 8) + "
                           "kPackedBf16Warps - 1) /" % n)
PACKED_VARIANTS = {
    "committed": [],
    "all_keys": [(PK_EXTENT, "  const int kp = lp + 0 * ext;")],
    "two_passes": [(PK_PV, PK_TWO_PASSES, MMA)],
    "step_group_1": [(PK_GROUP, PK_GROUP.replace("4;", "1;"), MMA)],
    "step_group_2": [(PK_GROUP, PK_GROUP.replace("4;", "2;"), MMA)],
    "stage_all_keys": [(PK_STAGE_ORDER, PK_STAGE_ALL)],
    "ko_exp": [(PK_EXP, PK_EXP.replace("exp2_neg(", "("), MMA)],
    "ko_qk_mma": [(PK_QK_MMA, "    s[0][0] += __uint_as_float(q[kk][0] & b[0]);\n"
                              "    s[1][0] += __uint_as_float(q[kk][1] & b[2]);\n", MMA)],
    "ko_pv_mma": [(PK_PV_MMA, "    o[2 * np][0] += __uint_as_float(a[0] & b[0]);\n"
                              "    o[2 * np + 1][0] += __uint_as_float(a[1] & b[2]);\n", MMA)],
    "ko_staging": [(PK_STAGE_ORDER, "\n".join(PK_STAGE_ORDER.splitlines()[1:4]))],
    "ko_steps": [(PK_TASKS, PK_TASKS.replace("task < nh", "task < 0 * nh"))],
    "heads_4_warps_8": [(PK_COLS, PK_COLS.replace("32;", "64;")),
                        (PK_WARPS, PK_WARPS.replace("4;", "8;"))],
    "heads_4_warps_4": [(PK_COLS, PK_COLS.replace("32;", "64;"))],
    "heads_2_warps_8": [(PK_WARPS, PK_WARPS.replace("4;", "8;"))],
    "heads_1_warps_2": [(PK_COLS, PK_COLS.replace("32;", "16;")),
                        (PK_WARPS, PK_WARPS.replace("4;", "2;"))],
    "warps_5_blocks_3": [(PK_WARPS, PK_WARPS.replace("4;", "5;")), (PK_MIN_BLOCKS, MIN_BLOCKS_AS(3))],
    "blocks_2": [(PK_MIN_BLOCKS, MIN_BLOCKS_AS(2))],
    "blocks_3": [(PK_MIN_BLOCKS, MIN_BLOCKS_AS(3))],
    "step_group_8_blocks_3": [(PK_GROUP, PK_GROUP.replace("4;", "8;"), MMA),
                              (PK_MIN_BLOCKS, MIN_BLOCKS_AS(3))],
}
FLASH_VARIANTS = {
    "committed": [],
    "blocks_3": [(FB_BLOCKS, FB_BLOCKS.replace("4;", "3;"))],
    "blocks_5": [(FB_BLOCKS, FB_BLOCKS.replace("4;", "5;"))],
    "step_16": [(FB_STEP, FB_STEP.replace("dp <= 32 ? 32 : 16", "16"))],
    "all_keys": [(FB_EXTENT, "lk")],
    "ko_pv_lo": [(FB_PV_LO, "")],
    "pv_bf16_pieces": [
        (FB_PV_TF32, FB_PV_PIECES), (FB_CONVERT, "      (void)dst;"),
        (FB_COMPUTE, FB_COMPUTE.replace("vf,", "reinterpret_cast<const float*>(vr0),")),
        (FB_CALL_RING, FB_CALL_RING.replace(
            "vf,", "reinterpret_cast<const float*>(vr0 + (i & 1) * KC * DP),"))],
    "ko_exp": [(FB_EXP, FB_EXP.replace("exp2_neg(", "("))],
    "ko_steps": [(FB_COMPUTE, "")],
    "ko_steps_stage": [(FB_COMPUTE, ""), (FB_STAGE, "")],
}
FUSED_VARIANTS = {
    "committed": [],
    "from_blocks_4": [(FROM_BLOCKS, FROM_BLOCKS.replace("5;", "4;"))],
    "from_blocks_6": [(FROM_BLOCKS, FROM_BLOCKS.replace("5;", "6;"))],
    "from_keys_4": [(FROM_KEYS, FROM_KEYS.replace("2;", "4;"))],
    "from_streaming_loads": [(x, x.replace("<false>", "")) for x in FROM_LOADS],
    "to_warps_4_blocks_4": [(TO_WARPS, TO_WARPS.replace("8;", "4;")),
                            (TO_BLOCKS, TO_BLOCKS.replace("2;", "4;"))],
}


def variant_source(source: Path, name: str, reps) -> Path:
    """The variant's copy of `source` (and of any header a replacement names,
    beside it) with each (old, new[, header]) replacement made once."""
    out = ROOT / "build" / "variants" / f"attn_{name}"
    out.mkdir(parents=True, exist_ok=True)
    texts = {source.name: source.read_text()}
    for old, new, *header in reps:
        fname = header[0] if header else source.name
        if fname not in texts:
            texts[fname] = (source.parent / fname).read_text()
        if texts[fname].count(old) != 1:
            raise SystemExit(f"variant {name}: the line to replace is not in {fname} once")
        texts[fname] = texts[fname].replace(old, new)
    for fname, text in texts.items():
        (out / fname).write_text(text)
    return out / source.name


def in_turns(fns: dict, rounds: int, reading=cuda_ms) -> dict:
    times = {k: [] for k in fns}
    order = list(fns)
    for _ in range(rounds):
        for key in order + order[::-1]:
            times[key].append(reading(fns[key]))
    return {k: {"ms": statistics.median(v), "readings": v} for k, v in times.items()}


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--rounds", type=int, default=3)
    ap.add_argument("--kernels", default="packed,flash,fused",
                    help="comma-separated: which kernels' variants to build and time")
    ap.add_argument("--out", default=str(ROOT / "build" / "measurements" /
                                         "attention_bf16_variants.json"))
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("attention_bf16_variants: needs an NVIDIA GPU")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip()
    print(card, flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda", 0)
    kernels = set(args.kernels.split(","))
    bf = lambda c: (*(x.to(torch.bfloat16) for x in c[:3]), c[3])
    shapes = {}
    if "packed" in kernels:
        shapes["packed, path A"] = (
            sa, {k: variant_source(sa.SOURCE, f"packed_{k}", r) for k, r in PACKED_VARIANTS.items()},
            sa.packed_short_attention, sa.packed_short_attention_reference,
            bf(attention_case(torch, dev, 60, 640, 150, 150, 16, 16, masked=True, fused_qkv=True)))
    if "flash" in kernels:
        shapes["flash, path D"] = (
            fa, {k: variant_source(fa.SOURCE, k, r) for k, r in FLASH_VARIANTS.items()},
            fa.flash_masked_attention, fa.flash_masked_attention_reference,
            bf(attention_case(torch, dev, 65, 256, 279, 279, 16, 16, masked=True, fused_qkv=True)))
    if "fused" in kernels:
        fused_src = {k: variant_source(sa.SOURCE, k, r) for k, r in FUSED_VARIANTS.items()}
        shapes["fused from, path B"] = (
            sa, fused_src, sa.fused_short_attention, sa.fused_short_attention_reference,
            bf(attention_case(torch, dev, 62, 640, 4, 150, 16, 8, masked=True)))
        shapes["fused to, path B"] = (
            sa, fused_src, sa.fused_short_attention, sa.fused_short_attention_reference,
            bf(attention_case(torch, dev, 63, 640, 150, 4, 16, 8, masked=False)))
    _build.build_libraries(sorted({src for x in shapes.values() for src in x[1].values()}))
    lines = []
    with torch.no_grad():
        for shape, (module, sources, fn, ref, inputs) in shapes.items():
            committed = module.SOURCE
            want = ref(*inputs).float()

            def call(src, fn=fn, inputs=inputs, module=module):
                def run():
                    module.SOURCE = src
                    return fn(*inputs)
                return run
            fns = {k: call(src) for k, src in sources.items()}
            errs = {k: float((f().float() - want).abs().max()) for k, f in fns.items()}
            times = in_turns(fns, args.rounds)
            dev_times = in_turns(fns, args.rounds, device_ms)
            module.SOURCE = committed
            lines.append({"card": card, "shape": shape,
                          **{k: {**times[k], "device_ms": dev_times[k]["ms"],
                                 "device_readings": dev_times[k]["readings"],
                                 "max_abs_err": errs[k]} for k in fns}})
            print(json.dumps(lines[-1]), flush=True)
    Path(args.out).parent.mkdir(parents=True, exist_ok=True)
    Path(args.out).write_text("\n".join(json.dumps(x) for x in lines) + "\n")


if __name__ == "__main__":
    main()
