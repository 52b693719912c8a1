"""Carry a flax parameter tree into the port's modules.

The inverse of particle_fm_tpu/utils/torch_import.py: the flax
`variables["params"]` tree (numpy arrays, e.g. from `jax.device_get`) becomes
the port's `state_dict`. Names map one to one, with `flows_{k}` becoming the
ModuleList entry `flows.{k}`; a weight-norm Dense's `kernel (in, out)`
becomes `weight_v (out, in)` (a plain Dense's becomes `weight`), a
LayerNorm's `scale` becomes `weight`, and `g`, `bias` and bare parameters
such as `global_tokens` and ParT's `cls_token` are copied. The module names
of the transformer family (`lin_0`, `nrm_0`, `layer_0`, ...), of MDMA
(`embed`, `block_0`, `ln`, ...), of the classifiers (`fc_d1`, `pair_embed`,
`cls_layer_0`, ...), of the flat model (`flow_0.net.mlp1.lin_0`, ...) and
flax's automatic names in ParticleNet (`EdgeConvBlock_0.Dense_0`,
`LayerNorm_0`, ...) are the same on both sides. The mixture of experts keeps
its stacked `w1`/`b1`/`w2`/`b2` in their (E, ...) layouts (bare leaves are
copied); only its `router` Dense kernel is transposed. The gaussian time
embedding's `gfp.W` is copied, its `gfp_dense` and `gfp_out` are Dense
layers. The flax "norm_stats" collection of a
model with `use_normaliser` (`normaliser` and `ctxt_normaliser`, each with
`means`, `m2`, `vars`, `n`) becomes the buffers of the same names. The
mapping is shape-checked both ways: every flax leaf must land on a parameter
or buffer of the same shape, and every parameter and persistent buffer must
be covered, so nothing keeps its initial value.

`load_flax_train_state` carries a whole JAX `TrainState` (params, norm_stats,
ema_params, the Adam moments `mu`/`nu` and count of the optax chain, step)
into the port's `training/step.py::TrainState`, so that a JAX run can go on
in the port. The JAX state is read through its attributes and numpy; nothing
of JAX is imported.
"""

from __future__ import annotations

import re
from typing import Any, Mapping

import numpy as np
import torch
from torch import nn


def _flatten(tree: Mapping[str, Any], prefix: str = "") -> dict[str, np.ndarray]:
    out = {}
    for k, v in tree.items():
        name = re.sub(r"^flows_(\d+)$", r"flows.\1", k)
        path = f"{prefix}{name}"
        if isinstance(v, Mapping):
            out.update(_flatten(v, path + "."))
        else:
            out[path] = np.asarray(v)
    return out


def state_dict_from_flax(params: Mapping[str, Any]) -> dict[str, torch.Tensor]:
    """flax params tree -> port state_dict (names and layouts only)."""
    flat = _flatten(params)
    sd = {}
    for path, arr in flat.items():
        head, _, leaf = path.rpartition(".")
        prefix = f"{head}." if head else ""
        if leaf == "kernel":
            has_g = f"{prefix}g" in flat
            sd[f"{prefix}{'weight_v' if has_g else 'weight'}"] = torch.tensor(arr.T)
        elif leaf == "scale":
            sd[f"{prefix}weight"] = torch.tensor(arr)
        else:
            sd[path] = torch.tensor(arr)
    return sd


def load_flax_params(module: nn.Module, params: Mapping[str, Any],
                     norm_stats: Mapping[str, Any] | None = None) -> nn.Module:
    """Copy a flax params tree, and the "norm_stats" collection of a model
    with normalisers, into `module` in place; returns it."""
    sd = state_dict_from_flax(params)
    sd.update({k: torch.tensor(v) for k, v in _flatten(norm_stats or {}).items()})
    own = module.state_dict()
    missing = sorted(set(own) - set(sd))
    extra = sorted(set(sd) - set(own))
    if missing or extra:
        raise ValueError(f"param tree mismatch: only-in-port={missing} only-in-flax={extra}")
    for k, v in sd.items():
        if tuple(own[k].shape) != tuple(v.shape):
            raise ValueError(f"shape mismatch at {k}: port {tuple(own[k].shape)} vs flax {tuple(v.shape)}")
    module.load_state_dict({k: v.to(own[k].dtype) for k, v in sd.items()})
    return module


def _adam_state(opt_state):
    """The optax ScaleByAdamState (count, mu, nu) inside a chain's state."""
    if hasattr(opt_state, "mu") and hasattr(opt_state, "nu") and hasattr(opt_state, "count"):
        return opt_state
    if isinstance(opt_state, (tuple, list)):
        for sub in opt_state:
            found = _adam_state(sub)
            if found is not None:
                return found
    return None


def _by_parameter(module: nn.Module, tree: Mapping[str, Any]) -> list[torch.Tensor]:
    """A params-shaped flax tree as tensors in the order of module.parameters()."""
    sd = state_dict_from_flax(tree)
    names = [name for name, _ in module.named_parameters()]
    if sorted(sd) != sorted(names):
        raise ValueError(f"param tree mismatch: port {sorted(names)} vs flax {sorted(sd)}")
    return [sd[name] for name in names]


def load_flax_train_state(state, jax_state) -> Any:
    """Copy a JAX TrainState into the port's TrainState `state` in place;
    returns it."""
    net = state.net
    load_flax_params(net, jax_state.params, getattr(jax_state, "norm_stats", None) or None)
    with torch.no_grad():
        for e, v in zip(state.ema_params, _by_parameter(net, jax_state.ema_params), strict=True):
            e.copy_(v.to(e.device, e.dtype))
    adam = _adam_state(jax_state.opt_state)
    if adam is None:
        raise ValueError("the JAX optimizer state holds no Adam moments")
    count = float(np.asarray(adam.count))
    params = list(net.parameters())
    mus, nus = _by_parameter(net, adam.mu), _by_parameter(net, adam.nu)
    opt = state.opt_state
    for p, mu, nu in zip(params, mus, nus, strict=True):
        opt.state[p] = {"step": torch.tensor(count, dtype=torch.float32),
                        "exp_avg": mu.to(p.device, p.dtype),
                        "exp_avg_sq": nu.to(p.device, p.dtype)}
    state.step = int(np.asarray(jax_state.step))
    return state
