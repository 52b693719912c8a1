#!/usr/bin/env python3
"""Where the time goes in the PyTorch port's sampler on one NVIDIA GPU.

    python3 scripts/profile_torch_port.py
        [--config epic|transformer|crossattention|mdma|lhco_transformer|jetclass_cond]
        [--nfe-steps 6] [--out build/measurements/profile_torch_port_<config>.json]

Builds one of the served networks at full width with seeded random weights,
as chip_smoke.py builds them: `epic` is fm_tops150_cond (fused EPiC layer),
`transformer` is fm_droid_transformer with attn_impl=packed (packed short-set
attention), `crossattention` is fm_droid_crossattention with attn_impl=fused
(fused short-set attention), `mdma` is calo/mdma_calo with 2 heads of 128
(flash attention, one class-token query on 6000 hits) and `lhco_transformer`
is lhco/jets_transformer with attn_impl=flash (flash attention on 279
particles), `jetclass_cond` is jetclass/jetclass_cond (fused EPiC layer at
hidden 300, 20 layers, cond on the global path only). Then for each path -- the configuration's CUDA kernel and that
kernel's plain PyTorch version -- it serves one batch (640 jets; 32 showers
for `mdma`, 256 events for `lhco_transformer`, 512 jets for
`jetclass_cond`; midpoint, `--nfe-steps` grid
points) once without and once under torch.profiler, after a warm-up.
Prints, per path, the wall time per network evaluation (both runs; the
profiler slows the host), the device's busy share (summed kernel time over
each wall time) and the kernels by device time, and writes the same
as JSON to `--out`.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from pathlib import Path
from unittest import mock

import numpy as np
import torch
from torch.autograd import DeviceType

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

from chip_smoke import droid_net_config, redraw_parameters  # noqa: E402
from particle_fm_tpu_torch.models.flow_matching import FlowMatchingModel  # noqa: E402
from particle_fm_tpu_torch.ops import epic_layer as epic_ops  # noqa: E402
from particle_fm_tpu_torch.ops import flash_attention as flash_ops  # noqa: E402
from particle_fm_tpu_torch.ops import short_attention as attention_ops  # noqa: E402
from particle_fm_tpu_torch.serving import make_serve_fn  # noqa: E402

JETS = dict(features=3, frequencies=16, t_emb="cosine", loss_type="FM-OT")
JETNET = dict(JETS, num_particles=150, global_cond_dim=2)
# name -> (model arguments, module and name of the kernel's wrapper, batch,
# fewest real particles of a set)
CONFIGS = {
    "epic": (dict(model="epic", hidden_dim=128, layers=6, latent=10, t_global_cat=True,
                  t_local_cat=True, add_time_to_input=False, local_cond_dim=2, **JETNET),
             epic_ops, "epic_layer", 640, 30),
    "transformer": (dict(model="droid_fulltransformer", add_time_to_input=True,
                         net_config=droid_net_config("te_config", 256, 3, "packed"), **JETNET),
                    attention_ops, "packed_short_attention", 640, 30),
    "crossattention": (dict(model="droid_fullcrossattention", add_time_to_input=True,
                            net_config=droid_net_config("cae_config", 128, 8, "fused",
                                                        dense_hddn=256), **JETNET),
                       attention_ops, "fused_short_attention", 640, 30),
    "mdma": (dict(model="mdma", features=4, num_particles=6000, global_cond_dim=1, frequencies=16,
                  t_emb="cosine", add_time_to_input=False, loss_type="CFM",
                  net_config=dict(latent=16, hidden_dim=256, layers=8, num_heads=2,
                                  t_local_cat=True, t_global_cat=True, global_cond_dim=1)),
             flash_ops, "flash_masked_attention", 32, 1000),
    "lhco_transformer": (dict(model="droid_fulltransformer", add_time_to_input=True,
                              num_particles=279, global_cond_dim=5,
                              net_config=droid_net_config("te_config", 256, 3, "flash"), **JETS),
                         flash_ops, "flash_masked_attention", 256, 30),
    "jetclass_cond": (dict(model="epic", features=13, num_particles=128, global_cond_dim=12,
                           local_cond_dim=0, hidden_dim=300, layers=20, latent=16,
                           t_global_cat=True, t_local_cat=True, add_time_to_input=False,
                           frequencies=16, t_emb="cosine", loss_type="FM-OT"),
                      epic_ops, "epic_layer", 512, 30),
}


def profile_path(fn, cond, mask, nfe: int) -> dict:
    fn(0, cond, mask)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn(1, cond, mask)
    torch.cuda.synchronize()
    plain_wall = time.perf_counter() - t0
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        fn(1, cond, mask)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    rows = []
    for e in prof.key_averages():
        # kernels only: an aten op's self device time is that of the kernels
        # it launched, which would count them twice
        if e.device_type != DeviceType.CUDA:
            continue
        self_dev = getattr(e, "self_device_time_total", None)
        if self_dev is None:
            self_dev = e.self_cuda_time_total
        if self_dev > 0:
            rows.append({"name": e.key[:90], "calls": e.count, "device_ms": self_dev / 1e3})
    rows.sort(key=lambda r: -r["device_ms"])
    busy_ms = sum(r["device_ms"] for r in rows)
    return {
        "wall_ms_per_nfe_unprofiled": plain_wall * 1e3 / nfe,
        "wall_ms": wall * 1e3,
        "wall_ms_per_nfe": wall * 1e3 / nfe,
        "device_busy_ms": busy_ms,
        "device_ms_per_nfe": busy_ms / nfe,
        "device_busy_share": busy_ms / (wall * 1e3),
        "device_busy_share_unprofiled": busy_ms / (plain_wall * 1e3),
        "kernels": rows[:15],
    }


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--config", choices=list(CONFIGS), default="epic")
    ap.add_argument("--nfe-steps", type=int, default=6, help="ode_steps of the profiled run")
    ap.add_argument("--out", default=None)
    args = ap.parse_args()
    out = Path(args.out or ROOT / "build" / "measurements" / f"profile_torch_port_{args.config}.json")
    if not torch.cuda.is_available():
        sys.exit("profile_torch_port: CUDA is not available")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip()

    model_args, owner, wrapper, batch, fewest = CONFIGS[args.config]
    model = FlowMatchingModel(**model_args)
    net = model.init(seed=0, device="cuda")
    if model.model.startswith("droid"):  # these configurations zero-initialise their attention
        redraw_parameters(torch, net, seed=1)
    fn = make_serve_fn(model, net, batch_size=batch, ode_solver="midpoint",
                       ode_steps=args.nfe_steps, has_cond=True, has_mask=True)
    rs = np.random.RandomState(0)
    n = model.num_particles
    counts = rs.randint(fewest, n + 1, size=(batch, 1))
    mask = (np.arange(n)[None, :] < counts).astype(np.float32)[..., None]
    cond = rs.randn(batch, model.global_cond_dim).astype(np.float32)
    nfe = 2 * (args.nfe_steps - 1)

    owner.load_library()
    result = {"card": card, "config": args.config, "kernel": wrapper, "batch": batch, "nfe": nfe}
    result["kernel_path"] = profile_path(fn, cond, mask, nfe)
    with mock.patch.object(owner, wrapper, getattr(owner, wrapper + "_reference")):
        result["plain_path"] = profile_path(fn, cond, mask, nfe)
    out.parent.mkdir(parents=True, exist_ok=True)
    out.write_text(json.dumps(result, indent=1))
    print(card, args.config)
    for path in ("kernel_path", "plain_path"):
        r = result[path]
        print(f"{path}: {r['wall_ms_per_nfe_unprofiled']:.3f} ms/NFE wall unprofiled, "
              f"{r['wall_ms_per_nfe']:.3f} profiled; kernels {r['device_ms_per_nfe']:.3f} "
              f"ms/NFE, busy share {r['device_busy_share_unprofiled']:.3f} of the unprofiled "
              f"wall, {r['device_busy_share']:.3f} of the profiled")
        for k in r["kernels"][:12]:
            print(f"  {k['device_ms']:9.3f} ms  {k['calls']:5d}x  {k['name']}")


if __name__ == "__main__":
    main()
