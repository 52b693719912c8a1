"""Serving the sampler; counterpart of particle_fm_tpu/serving.py.

`make_serve_fn` binds a model, its network and the sampling protocol into
fn(seed, [cond], [mask]) -> samples in physical units (the datamodule-level
inverse z-score x * std / sigma + mean, then the mask re-applied), and
`serve_batches` answers a request of any size with padded fixed-size
batches, one seed per batch derived as the JAX package derives it (hash_v1:
SeedSequence([seed, chunk])). The seed starts a `torch.Generator` on the
network's device. A model built with `dtype="bfloat16"` serves in it: the
network computes in bfloat16, while the noise, cond, mask, the solver's
state and the output stay float32.

The served artifact (`export_sampler`, `save_exported`, `load_exported`) is
the same program as one `torch.export` graph, with the weights folded and
baked in as constants and the kernels as their custom ops
(`particle_fm::*`, ops/): a directory of

    sampler.pt2   the ExportedProgram (`torch.export.save`), exported for
                  the device of the network ("cuda" or "cpu", meta
                  `platforms`), where it runs
    meta.yaml     the calling convention, the sampling protocol and the
                  output units, with the JAX package's keys, and `noise`

Every solver of `models/flow_matching.py::SOLVERS` exports (the fixed-step
ones, the Adams loops, DOPRI5 with one step size or one a set, em, ddim, and
the self-conditioned loop of a `self_cond` model), each loop as one
`while_loop` of one step (samplers/ode.py::exported_loops): the program's
graph does not grow with the steps.

A generator cannot be an input of an exported program, so the program takes
the prior noise z (B, N, F) float32, and the function `load_exported`
returns draws it from the seed as `models/flow_matching.py::draw_noise`
does: the artifact gives what `make_serve_fn` gives for the same seed, bit
for bit on the same device. An em artifact also takes its step noise eps
(n_transforms * ode_steps, B, N, F), meta `step_noise`: the function draws
it from the same generator after z, one `torch.randn` of z's shape a step,
as the live sampler draws it (`sde_noise`). A DOPRI5 artifact returns its
statistics beside the samples; the function keeps the last call's on
itself (`fn.stats`: attempts, and for dopri5_per_sample the loop's passes)
and warns as the live solver warns where the step budget ran out short of
t = 0. Loading imports this module, the samplers' and the op registrations,
and no model, network, config or training code.

    fn, meta = load_exported("runs/<run>/exported")
    x = fn(seed, cond_batch, mask_batch)   # physical-space particle clouds
"""

from __future__ import annotations

import copy
import os
from typing import Any, Callable, Optional

import numpy as np
import torch

ARTIFACT_NAME = "sampler.pt2"
META_NAME = "meta.yaml"
NOISE = "torch.randn(shape, generator=torch.Generator(device).manual_seed(seed), dtype=float32)"
STEP_NOISE = ("torch.randn(shape[1:], generator=<noise's generator, after noise>, "
              "dtype=float32, out=eps[k]) for k in range(shape[0])")
ADAPTIVE = ("dopri5", "dopri5_zuko", "dopri5_per_sample")


def prior_noise(seed: int, shape: tuple[int, ...], device: torch.device) -> torch.Tensor:
    """The prior draw of one batch: what `FlowMatchingModel.sample` draws
    from `torch.Generator(device).manual_seed(seed)` (`draw_noise`)."""
    gen = torch.Generator(device).manual_seed(int(seed))
    return torch.randn(shape, generator=gen, device=device, dtype=torch.float32)


def sde_noise(seed: int, shape: tuple[int, ...], n_steps: int, device: torch.device
              ) -> tuple[torch.Tensor, torch.Tensor]:
    """(z, eps) of one em batch from one generator seeded by `seed`: z as
    `prior_noise` draws it, then each step's draw of z's shape in the live
    sampler's order (samplers/sde.py::_normal), each into its slice of one
    buffer (n_steps, *shape): one large draw would be another stream."""
    gen = torch.Generator(device).manual_seed(int(seed))
    z = torch.randn(shape, generator=gen, device=device, dtype=torch.float32)
    eps = torch.empty((n_steps,) + tuple(shape), device=device, dtype=torch.float32)
    for k in range(n_steps):
        torch.randn(shape, generator=gen, dtype=torch.float32, out=eps[k])
    return z, eps


def make_serve_fn(
    model,
    net,
    *,
    batch_size: int,
    ode_solver: str = "midpoint",
    ode_steps: int = 100,
    num_points: Optional[int] = None,
    has_cond: bool = False,
    has_mask: bool = False,
    means=None,
    stds=None,
    normalize_sigma: float = 5.0,
    guidance_scale: Optional[float] = None,
) -> Callable:
    """fn(seed, [cond (B, C)], [mask (B, N, 1)]) -> (B, N, F) float32 tensor
    on the network's device. `fn.meta` describes the calling convention for
    `serve_batches`."""
    if guidance_scale is not None and not has_cond:
        raise ValueError("guidance_scale requires a conditional sampler (has_cond)")
    device = next(net.parameters()).device

    def as_tensor(a):
        return torch.as_tensor(a, dtype=torch.float32, device=device)

    means_t = None if means is None else as_tensor(means)
    stds_t = None if stds is None else as_tensor(stds)

    def serve(seed, *args):
        idx = 0
        cond = mask = None
        if has_cond:
            cond, idx = as_tensor(args[idx]), idx + 1
        if has_mask:
            mask = as_tensor(args[idx])
        gen = torch.Generator(device).manual_seed(int(seed))
        x = model.sample(
            net,
            gen,
            n_samples=batch_size,
            cond=cond,
            mask=mask,
            ode_solver=ode_solver,
            ode_steps=ode_steps,
            num_points=num_points,
            guidance_scale=guidance_scale,
        )
        if means_t is not None:
            x = x * (stds_t / normalize_sigma) + means_t
        if mask is not None:
            x = x * mask
        return x

    serve.meta = {
        "batch_size": int(batch_size),
        "cond_dim": int(model.global_cond_dim) if has_cond else 0,
        "use_mask": bool(has_mask),
        "ode_solver": str(ode_solver),
        "ode_steps": int(ode_steps),
        "guidance_scale": None if guidance_scale is None else float(guidance_scale),
        "seed_scheme": "hash_v1",
    }
    return serve


class SamplerProgram(torch.nn.Module):
    """What `export_sampler` traces: forward(z, [eps], [cond], [mask]) ->
    samples, the rest of `make_serve_fn`'s function after the prior draw: z
    scaled for droid's prior and masked, every flow integrated on the folded
    network (`FlowMatchingModel.integrate_folded`, guidance baked in; em
    reading its step noise from eps), the inverse z-score and the mask. The
    DOPRI5 solvers return (samples, [each flow's statistics])."""

    def __init__(self, model, net, *, has_cond: bool, has_mask: bool, ode_solver: str,
                 ode_steps: int, means, stds, normalize_sigma: float,
                 guidance_scale: Optional[float]):
        super().__init__()
        self.model, self.net = model, net
        self.has_cond, self.has_mask = has_cond, has_mask
        self.ode_solver, self.ode_steps = ode_solver, ode_steps
        self.normalize_sigma, self.guidance_scale = normalize_sigma, guidance_scale
        device = next(net.parameters()).device
        for name, v in (("means", means), ("stds", stds)):
            self.register_buffer(name, None if v is None else torch.as_tensor(
                v, dtype=torch.float32, device=device), persistent=False)

    def forward(self, z, *args):
        eps = None
        if self.ode_solver == "em":
            eps, args = args[0], args[1:]
        cond = args[0] if self.has_cond else None
        mask = args[-1] if self.has_mask else None
        x = z
        if self.model.loss_type == "droid":
            x = x * self.model.droid_t_max
        if mask is not None:
            x = x * mask
        from particle_fm_tpu_torch.samplers.ode import exported_loops

        stats = []
        with exported_loops():
            x = self.model.integrate_folded(self.net, x, cond, mask, self.ode_solver,
                                            self.ode_steps, self.guidance_scale, stats=stats,
                                            eps=eps)
        if self.means is not None:
            x = x * (self.stds / self.normalize_sigma) + self.means
        if mask is not None:
            x = x * mask
        return (x, stats) if self.ode_solver in ADAPTIVE else x


def export_sampler(
    model,
    net,
    *,
    batch_size: int,
    num_points: int,
    features: int,
    cond_dim: Optional[int] = None,
    use_mask: bool = True,
    ode_solver: str = "midpoint",
    ode_steps: int = 100,
    means=None,
    stds=None,
    normalize_sigma: float = 5.0,
    guidance_scale: Optional[float] = None,
    device=None,
    out_dir: Optional[str] = None,
) -> tuple[torch.export.ExportedProgram, dict]:
    """Fold weight norm, trace the sampling program (`SamplerProgram`) with
    `torch.export.export` under no_grad for `device` (default: the network's;
    another device exports a copy of the network moved there), and return
    (ExportedProgram, meta); with `out_dir`, also write the artifact there
    (`save_exported`). The network is left as it was given."""
    from particle_fm_tpu_torch.models.flow_matching import SOLVERS, is_folded

    if ode_solver not in SOLVERS:
        raise NotImplementedError(f"Solver {ode_solver} not implemented")
    has_cond = cond_dim is not None and cond_dim > 0
    if guidance_scale is not None and not has_cond:
        raise ValueError("guidance_scale requires a conditional artifact (cond_dim > 0)")
    own = next(net.parameters()).device
    dev = own if device is None else torch.device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    if dev != own:
        net = copy.deepcopy(net).to(dev)
    folded = is_folded(net)
    program = SamplerProgram(model, net, has_cond=has_cond, has_mask=use_mask,
                             ode_solver=ode_solver, ode_steps=ode_steps, means=means, stds=stds,
                             normalize_sigma=normalize_sigma, guidance_scale=guidance_scale)
    inputs = [torch.zeros(batch_size, num_points, features, device=dev)]
    step_noise = None
    if ode_solver == "em":
        step_noise = [int(model.n_transforms * ode_steps), int(batch_size), int(num_points),
                      int(features)]
        inputs.append(torch.zeros(step_noise, device=dev))
    if has_cond:
        inputs.append(torch.zeros(batch_size, cond_dim, device=dev))
    if use_mask:
        inputs.append(torch.ones(batch_size, num_points, 1, device=dev))
    model.fold_weight_norm(net)
    try:
        with torch.no_grad():
            exported = torch.export.export(program, tuple(inputs))
    finally:
        if not folded:
            model.unfold_weight_norm(net)
    # the example inputs are no part of the program (em's step noise alone is
    # 230 MB at B=640, 200 steps), and the Python stack of every node, kept
    # for debugging, is most of the serialised program and of its load time
    exported.example_inputs = None
    for gm in exported.graph_module.modules():
        if isinstance(gm, torch.fx.GraphModule):
            for node in gm.graph.nodes:
                node.meta.pop("stack_trace", None)
    meta = {
        "batch_size": int(batch_size),
        "num_points": int(num_points),
        "features": int(features),
        "cond_dim": int(cond_dim) if has_cond else 0,
        "use_mask": bool(use_mask),
        "ode_solver": str(ode_solver),
        "ode_steps": int(ode_steps),
        "normalize_sigma": float(normalize_sigma),
        "guidance_scale": float(guidance_scale) if guidance_scale is not None else None,
        "output_units": "physical" if means is not None else "model",
        "seed_scheme": "hash_v1",
        "platforms": [dev.type],
        "args": ["seed:uint32[]"]
        + (["cond:float32[%d,%d]" % (batch_size, cond_dim)] if has_cond else [])
        + (["mask:float32[%d,%d,1]" % (batch_size, num_points)] if use_mask else []),
        # the program's first input, drawn from the seed by load_exported's function
        "noise": {"shape": [int(batch_size), int(num_points), int(features)],
                  "draw": NOISE},
    }
    if step_noise is not None:  # em's second input, drawn after `noise` from its generator
        meta["step_noise"] = {"shape": step_noise, "draw": STEP_NOISE}
    if out_dir is not None:
        save_exported(out_dir, exported, meta)
    return exported, meta


def save_exported(out_dir: str, exported: torch.export.ExportedProgram, meta: dict) -> str:
    """Write `sampler.pt2` and `meta.yaml` into `out_dir`; returns it."""
    import yaml

    os.makedirs(out_dir, exist_ok=True)
    torch.export.save(exported, os.path.join(out_dir, ARTIFACT_NAME))
    with open(os.path.join(out_dir, META_NAME), "w") as f:
        yaml.safe_dump(meta, f, sort_keys=False)
    return out_dir


def load_exported(path: str) -> tuple[Callable, dict]:
    """Load an artifact directory for serving. Returns (fn, meta);
    fn(seed, [cond], [mask]) draws the prior noise (and em's step noise)
    from the seed (`prior_noise`, `sde_noise`, on the artifact's device) and
    runs the program there. A DOPRI5 artifact's statistics of the last call
    stay on `fn.stats`, and a run that spent its step budget warns (one step
    size for the batch, as the live solver). A CUDA artifact raises where no
    card is present."""
    import yaml

    # the kernels' custom ops, which the program calls
    from particle_fm_tpu_torch.ops import epic_layer, flash_attention, short_attention  # noqa: F401
    from particle_fm_tpu_torch.samplers.ode import truncation_warning

    with open(os.path.join(path, META_NAME)) as f:
        meta: dict[str, Any] = yaml.safe_load(f)
    if "cuda" in meta["platforms"]:
        if not torch.cuda.is_available():
            raise RuntimeError(f"the artifact at {path!r} was exported for CUDA and no CUDA "
                               "device is available; it does not run on the CPU")
        device = torch.device("cuda", torch.cuda.current_device())
    else:
        device = torch.device("cpu")
    exported = torch.export.load(os.path.join(path, ARTIFACT_NAME))
    program = exported.module()
    shape = tuple(meta["noise"]["shape"])
    n_steps = meta["step_noise"]["shape"][0] if "step_noise" in meta else None
    solver = meta["ode_solver"]

    def fn(seed, *args):
        noise = ((prior_noise(seed, shape, device),) if n_steps is None else
                 sde_noise(seed, shape, n_steps, device))
        with torch.no_grad():
            out = program(*noise, *(torch.as_tensor(a, dtype=torch.float32, device=device)
                                    for a in args))
        if solver not in ADAPTIVE:
            return out
        out, fn.stats = out
        if solver != "dopri5_per_sample":  # as the live solvers: no warning per set
            for st in fn.stats:
                if not bool(st["reached"]):
                    truncation_warning(int(st["steps"]), float(st["t"]), 0.0)
        return out

    fn.stats = None
    fn.exported = exported
    fn.meta = meta
    return fn, meta


def chunk_seed(seed: int, chunk: int, scheme: str = "hash_v1") -> int:
    """The seed of one fixed-size batch of a request. Only the JAX
    package's current scheme, hash_v1, is carried: the port reads no legacy
    artifact."""
    if scheme == "hash_v1":
        return int(np.random.SeedSequence([int(seed) % (2**64), chunk]).generate_state(1)[0])
    raise ValueError(f"unknown seed_scheme {scheme!r}")


def serve_batches(
    fn: Callable,
    meta: dict,
    n_samples: int,
    cond: Optional[np.ndarray] = None,
    mask: Optional[np.ndarray] = None,
    seed: int = 0,
) -> np.ndarray:
    """Answer a request of `n_samples` sets in padded batches of
    meta["batch_size"]; the last batch is padded with copies of its first
    row, so padding never makes an empty set."""
    bs = int(meta["batch_size"])
    scheme = meta.get("seed_scheme", "hash_v1")
    chunks = []
    for i, lo in enumerate(range(0, n_samples, bs)):
        hi = min(lo + bs, n_samples)
        n_real = hi - lo

        def pad(a):
            sl = a[lo:hi]
            if n_real == bs:
                return sl
            return np.concatenate([sl] + [sl[:1]] * (bs - n_real), axis=0)

        args = [chunk_seed(seed, i, scheme)]
        if meta.get("cond_dim", 0):
            args.append(pad(cond).astype(np.float32))
        if meta.get("use_mask", False):
            args.append(pad(mask).astype(np.float32))
        chunks.append(fn(*args)[:n_real].cpu().numpy())
    return np.concatenate(chunks, axis=0)
