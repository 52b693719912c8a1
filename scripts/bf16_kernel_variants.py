#!/usr/bin/env python3
"""Time design variants of the two bfloat16 kernels redesigned for the H100
(the EPiC layer, the class-token flash attention) against the committed ones,
in turns, at their served shapes.

    python3 scripts/bf16_kernel_variants.py [--out build/measurements/bf16_kernel_variants.json]

A variant is a copy of csrc/epic_layer.cu or csrc/flash_attention.cu under
build/variants/bf16_<name>/ with lines replaced (the script fails if a line it
wants to replace is no longer there):

  epic: sets_2, sets_8, sets_16  sets a block of the per-set kernel (4 as
                                 committed; 16 is one mma tile of sets)
        no_chunks                the per-set kernel copies no weight chunk
                                 (wrong: what the copies cost)
        no_set_mma               the per-set kernel issues no mma (wrong)
        no_split                 the per-set inputs are not split into three
                                 bfloat16 pieces (wrong)
  flash: warps_4_blocks_4        4 warps a block, 4 blocks an SM (8 and 2 as
                                 committed), 8 splits at path C
         blocks_3_keys_12        4 warps, 3 blocks an SM, 12 keys in flight a
                                 lane group, 6 splits
         splits_9                the committed kernel over 9 splits: more
                                 blocks than one wave holds

Each EPiC variant is called through the library's C entry with the wrapper's
arguments at the flagship (B=640, N=150, H=128, L=10, cond 2 on both paths)
and path E (jetclass_cond: B=512, N=128, H=300, L=16, cond 12 on the global
path), t=32; each flash variant at path C's class token (B=32, Lq=1,
Lk=6000, 2 heads of 128, 1000-6000 real keys), beside bf16
`scaled_dot_product_attention` on the same tensors. Times: CUDA events, the
median of `cuda_ms` (utils/timing.py) over three rounds in turns (forwards,
then backwards through the list), and each kernel's device time from
torch.profiler. The maximum error against the plain version is printed, not
asserted. Prints one JSON line per shape, with the card's name and power
limit, and writes them to --out.
"""

from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
from pathlib import Path

import torch
import torch.nn.functional as F

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

from particle_fm_tpu_torch.ops import _build  # noqa: E402
from particle_fm_tpu_torch.ops import epic_layer as ops  # noqa: E402
from particle_fm_tpu_torch.ops import flash_attention as fa  # noqa: E402
from particle_fm_tpu_torch.utils.timing import cuda_ms  # noqa: E402

SETS = "inline int sets_per_block(const ParamsBf16& p) {\n  int sets = kSetsPerBlock;"
EPIC_VARIANTS = {
    "committed": [],
    "sets_2": [(SETS, SETS.replace("kSetsPerBlock;", "2;"))],
    "sets_8": [(SETS, SETS.replace("kSetsPerBlock;", "8;"))],
    "sets_16": [(SETS, SETS.replace("kSetsPerBlock;", "16;"))],
    "no_chunks": [("    if (c + kChunkStages - 1 < chunks) stage(c + kChunkStages - 1);",
                   "    if (c + kChunkStages - 1 < 0) stage(c + kChunkStages - 1);"),
                  ("    if (c < chunks) stage(c);", "    if (c < 0) stage(c);")],
    "no_set_mma": [("        mma_bf16(acc[i], a[2], b[0], b[1]);  // the small pieces first\n"
                    "        mma_bf16(acc[i], a[1], b[0], b[1]);\n"
                    "        mma_bf16(acc[i], a[0], b[0], b[1]);\n",
                    "        if (kk < 0) mma_bf16(acc[i], a[2], b[0], b[1]);\n")],
    "no_split": [("  for (int e = threadIdx.x; e < ar * geo.kp; e += kSetThreads) {",
                  "  for (int e = threadIdx.x; e < 0; e += kSetThreads) {")],
}
WARPS, BLOCKS = "constexpr int kTokWarps = 8;", "constexpr int kTokBlocksPerSm = 2;"
UNROLL = "__host__ __device__ constexpr int tok_unroll(int lq) { return 8 / lq; }"
# name -> (replacements, splits at path C)
FLASH_VARIANTS = {
    "committed": ([], None),
    "warps_4_blocks_4": ([(WARPS, "constexpr int kTokWarps = 4;"),
                          (BLOCKS, "constexpr int kTokBlocksPerSm = 4;")], 8),
    "blocks_3_keys_12": ([(WARPS, "constexpr int kTokWarps = 4;"),
                          (BLOCKS, "constexpr int kTokBlocksPerSm = 3;"),
                          (UNROLL, UNROLL.replace("return 8 / lq;",
                                                  "return lq == 1 ? 12 : 8 / lq;"))], 6),
    "splits_9": ([], 9),
}


def variant_source(source: Path, name: str, reps) -> Path:
    text = source.read_text()
    for old, new in reps:
        if text.count(old) != 1:
            raise SystemExit(f"variant {name}: the line to replace is not in {source.name} once")
        text = text.replace(old, new)
    out = ROOT / "build" / "variants" / f"bf16_{name}" / source.name
    out.parent.mkdir(parents=True, exist_ok=True)
    out.write_text(text)
    return out


def device_ms(fn, n: int = 20) -> dict:
    """Device time a call by kernel name (torch.profiler)."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
    out = {}
    for e in prof.key_averages():
        t = getattr(e, "device_time_total", 0) or getattr(e, "cuda_time_total", 0)
        if t:
            name = e.key.replace("(anonymous namespace)::", "").replace("void ", "")
            out[name.split("(")[0][:60]] = t / n / 1e3
    return out


def in_turns(fns: dict, rounds: int = 3) -> dict:
    times = {k: [] for k in fns}
    order = list(fns)
    for _ in range(rounds):
        for key in order + order[::-1]:
            times[key].append(cuda_ms(fns[key]))
    return {k: {"ms": statistics.median(v), "readings": v} for k, v in times.items()}


def epic_args(b, n, h, lat, c, local, seed, dev):
    gen = torch.Generator().manual_seed(seed)
    t, cl = 32, c if local else 0
    k1, k2, k3, k4 = t + 2 * h + lat + c, t + h + c, t + lat + cl, t + cl
    w = lambda fan, *shape: (torch.rand(*shape, generator=gen) * 2 - 1) * fan ** -0.5
    counts = torch.randint(30, n + 1, (b, 1), generator=gen)
    mask = (torch.arange(n)[None, :] < counts).float()
    args = [torch.randn(b, n, h, generator=gen), torch.randn(b, lat, generator=gen), mask,
            torch.randn(b, t + c, generator=gen), w(k1, k1, h), w(k1, h), w(k2, k2, lat),
            w(k2, lat), w(k3, h, h), w(k3, k3, h), w(k3, h), w(k4, h, h), w(k4, k4, h), w(k4, h)]
    args = [a.to(dev) if i == 2 else a.to(dev, torch.bfloat16) for i, a in enumerate(args)]
    return [a.contiguous() for a in args], dict(sum_scale=1e-2, tg_dim=t, tl_dim=t, cg_dim=c,
                                                cl_dim=cl)


def epic_call(lib, args, dims):
    """The library's entry with the wrapper's arguments (ops.epic_layer_bf16)."""
    x = args[0]
    b, n, h = x.shape
    xo, go = torch.empty_like(x), torch.empty_like(args[1])
    scratch = torch.empty(b * (3 * h + 1), dtype=torch.float32, device=x.device)
    image = ops.bf16_weight_image(*(args[i] for i in (4, 6, 9, 12, 8, 11)))
    stream = torch.cuda.current_stream().cuda_stream

    def call():
        err = lib.epic_layer_fwd_bf16(
            *(a.data_ptr() for a in args), xo.data_ptr(), go.data_ptr(), scratch.data_ptr(),
            image.data_ptr(), b, n, h, args[1].shape[-1], args[3].shape[-1], dims["tg_dim"],
            dims["tl_dim"], dims["cg_dim"], dims["cl_dim"], dims["sum_scale"], stream)
        if err:
            raise RuntimeError(f"epic_layer_fwd_bf16: cudaError {err}")
        return xo
    return call


def flash_call(lib, q, k, v, mask, splits):
    """The library's entry with the wrapper's arguments (ops.flash_attention._launch)."""
    b, lq, h, d = q.shape
    out = torch.empty_like(q)
    scratch = torch.empty(splits * b * lq * h * (d + 2), dtype=torch.float32, device=q.device)
    counters = torch.zeros(b * h, dtype=torch.int32, device=q.device)
    stream = torch.cuda.current_stream().cuda_stream

    def call():
        err = lib.flash_masked_attention_bf16(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), mask.data_ptr(), out.data_ptr(),
            scratch.data_ptr(), counters.data_ptr(), b, lq, k.shape[1], h, d, splits,
            q.stride(0), q.stride(1), k.stride(0), k.stride(1), v.stride(0), v.stride(1), stream)
        if err:
            raise RuntimeError(f"flash_masked_attention_bf16: cudaError {err}")
        return out
    return call


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default=str(ROOT / "build" / "measurements" /
                                         "bf16_kernel_variants.json"))
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("needs an NVIDIA GPU")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True).stdout.strip()
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    epic_src = {k: variant_source(ops.SOURCE, k, r) for k, r in EPIC_VARIANTS.items()}
    flash_src = {k: variant_source(fa.SOURCE, k, r) for k, (r, _) in FLASH_VARIANTS.items()}
    _build.build_libraries(list(epic_src.values()) + list(flash_src.values()))
    lines = []
    for shape, (b, n, h, lat, c, local) in {"flagship": (640, 150, 128, 10, 2, True),
                                            "path E": (512, 128, 300, 16, 12, False)}.items():
        a, dims = epic_args(b, n, h, lat, c, local, 0, dev)
        want = ops.epic_layer_reference(*a, **dims)[0].float()
        fns = {k: epic_call(_build.load_library(src, ops._declare), a, dims)
               for k, src in epic_src.items()}
        errs = {k: float((f().float() - want).abs().max()) for k, f in fns.items()}
        times = in_turns(fns)
        lines.append({"card": card, "kernel": "epic_layer_bf16", "shape": shape,
                      **{k: {**times[k], "max_abs_err": errs[k], "device_ms": device_ms(fns[k])}
                         for k in fns}})
        print(json.dumps(lines[-1]), flush=True)
    gen = torch.Generator().manual_seed(1)
    q, k, v = (torch.randn(32, lq, 2, 128, generator=gen).to(dev, torch.bfloat16)
               for lq in (1, 6000, 6000))
    counts = torch.randint(1000, 6001, (32, 1), generator=gen)
    mask = (torch.arange(6000)[None, :] < counts).float().to(dev)
    want = fa.flash_masked_attention_reference(q, k, v, mask).float()
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    fns = {}
    for name, (_, splits) in FLASH_VARIANTS.items():
        lib = _build.load_library(flash_src[name], fa._declare)
        fns[name] = flash_call(lib, q, k, v, mask, splits or fa.token_splits(32, 2, 6000, sms))
    add = ((mask - 1.0) * 1e9)[:, None, None, :].to(torch.bfloat16)
    qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
    fns["scaled_dot_product_attention"] = lambda: F.scaled_dot_product_attention(
        qt, kt, vt, attn_mask=add).transpose(1, 2)
    with torch.no_grad():
        errs = {key: float((f().float() - want).abs().max()) for key, f in fns.items()}
        times = in_turns(fns)
        lines.append({"card": card, "kernel": "flash_masked_attention_bf16 (class token)",
                      "shape": "path C",
                      **{key: {**times[key], "max_abs_err": errs[key],
                               "device_ms": device_ms(fns[key])} for key in fns}})
    print(json.dumps(lines[-1]), flush=True)
    Path(args.out).parent.mkdir(parents=True, exist_ok=True)
    Path(args.out).write_text("\n".join(json.dumps(x) for x in lines) + "\n")


if __name__ == "__main__":
    main()
