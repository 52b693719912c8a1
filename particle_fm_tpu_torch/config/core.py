"""YAML config composition and instantiation; counterpart of
particle_fm_tpu/config/core.py, composing the same `configs/`.

Hydra-style, yaml only:

  - a root config with a `defaults` list of {group: name} entries
  - experiment overlays that may `override /group: name` selections and
    deep-merge their body into the composed config
  - ${a.b} interpolation (resolved after composition)
  - dotlist overrides: "model.hidden_dim=64", "experiment=jetnet/fm_tops30"
  - `_target_` instantiation with `_partial_` support. The shipped configs
    name the JAX package's classes: `particle_fm_tpu.X` is built as the
    port's `particle_fm_tpu_torch.X`, and a target the port lacks raises
    `NotImplementedError`; the JAX package is never imported.

Every run saves its resolved config (save_config).
"""

from __future__ import annotations

import functools
import importlib
import importlib.util
import os
import re
from typing import Any

import yaml


# ------------------------------------------------------------------ merge


def deep_merge(base: dict, overlay: dict) -> dict:
    """Recursive dict merge; overlay wins. Lists replace wholesale."""
    out = dict(base)
    for k, v in overlay.items():
        if k in out and isinstance(out[k], dict) and isinstance(v, dict):
            out[k] = deep_merge(out[k], v)
        else:
            out[k] = v
    return out


def load_config(path: str) -> dict:
    with open(path) as f:
        return yaml.safe_load(f) or {}


def _group_file(config_dir: str, group: str, name: str) -> str:
    name = name.lstrip("/")
    if not name.endswith(".yaml"):
        name = name + ".yaml"
    return os.path.join(config_dir, group, name)


# ------------------------------------------------------------ composition


def compose(config_dir: str, config_name: str = "train", overrides: list[str] = ()) -> dict:
    """Compose the config tree like hydra: root defaults -> groups ->
    experiment overlay -> dotlist overrides -> interpolation."""
    root = load_config(os.path.join(config_dir, f"{config_name}.yaml"))
    defaults = root.pop("defaults", [])

    # parse group selections from defaults + overrides
    selections: dict[str, str | None] = {}
    order: list[str] = []
    for entry in defaults:
        if entry == "_self_":
            continue
        if isinstance(entry, dict):
            ((group, name),) = entry.items()
            selections[group] = name
            order.append(group)

    dot_overrides = []
    cli_selections: dict[str, str | None] = {}
    for ov in overrides:
        if "=" not in ov:
            raise ValueError(f"override must be key=value, got {ov!r}")
        key, value = ov.split("=", 1)
        if key in selections and "." not in key:
            cli_selections[key] = None if value in ("null", "None") else value
        else:
            dot_overrides.append((key, value))

    # the experiment overlay may itself override group selections...
    exp_cfg = None
    exp_name = cli_selections.get("experiment", selections.get("experiment"))
    if exp_name:
        exp_cfg = load_config(_group_file(config_dir, "experiment", str(exp_name)))
        for entry in exp_cfg.pop("defaults", []):
            if isinstance(entry, dict):
                ((group, name),) = entry.items()
                group = re.sub(r"^override\s+/?", "", group)
                selections[group] = name
                if group not in order:
                    order.append(group)
    # ...but explicit CLI group selections always win (hydra semantics)
    selections.update(cli_selections)

    cfg = dict(root)
    for group in order:
        if group == "experiment":
            continue
        name = selections.get(group)
        if not name:
            continue
        group_cfg = load_config(_group_file(config_dir, group, str(name)))
        cfg[group] = deep_merge(cfg.get(group, {}), group_cfg)

    if exp_cfg:
        cfg = deep_merge(cfg, exp_cfg)

    set_overrides(cfg, dot_overrides)

    return _resolve_interpolations(cfg)


def set_overrides(cfg: dict, pairs) -> None:
    """Set each (dotted key, value string) pair, the value read by YAML's
    scalar rules: the dotlist overrides of every CLI."""
    for key, value in pairs:
        _set_dotted(cfg, key, yaml.safe_load(value))


def _set_dotted(cfg: dict, key: str, value: Any) -> None:
    parts = key.split(".")
    node = cfg
    for p in parts[:-1]:
        node = node.setdefault(p, {})
    node[parts[-1]] = value


def _get_dotted(cfg: dict, key: str) -> Any:
    node = cfg
    for p in key.split("."):
        node = node[p]
    return node


_INTERP = re.compile(r"\$\{([a-zA-Z0-9_.]+)\}")


def _resolve_interpolations(cfg: dict) -> dict:
    def resolve(node, path=()):
        if isinstance(node, dict):
            return {k: resolve(v, path + (k,)) for k, v in node.items()}
        if isinstance(node, list):
            return [resolve(v, path) for v in node]
        if isinstance(node, str):
            m = _INTERP.fullmatch(node)
            if m:  # whole-value interpolation keeps the referent's type
                return resolve(_get_dotted(cfg, m.group(1)), path)
            return _INTERP.sub(lambda mm: str(_get_dotted(cfg, mm.group(1))), node)
        return node

    return resolve(cfg)


# ---------------------------------------------------------- instantiation


_JAX_PACKAGE = "particle_fm_tpu"
_PORT = "particle_fm_tpu_torch"


def port_target(target: str) -> str:
    """The port's counterpart of a `_target_` that names the JAX package."""
    head = target.split(".", 1)[0]
    if head == _JAX_PACKAGE:
        return _PORT + target[len(_JAX_PACKAGE):]
    return target


def _import_target(target: str):
    ported = port_target(target)
    module, _, attr = ported.rpartition(".")
    if ported != target:
        try:
            found = importlib.util.find_spec(module) is not None
        except ModuleNotFoundError:
            found = False
        if not found or not hasattr(importlib.import_module(module), attr):
            raise NotImplementedError(f"{target} is not ported: the port has no {ported}")
    return getattr(importlib.import_module(module), attr)


def instantiate(cfg: Any, **kwargs):
    """Build the object described by a config node with `_target_`.

    Nested dicts containing `_target_` are instantiated recursively;
    `_partial_: true` returns functools.partial instead of calling."""
    if isinstance(cfg, list):
        return [instantiate(c) for c in cfg]
    if not isinstance(cfg, dict):
        return cfg
    if "_target_" not in cfg:
        return {k: instantiate(v) for k, v in cfg.items()}
    cfg = dict(cfg)
    target = _import_target(cfg.pop("_target_"))
    partial = cfg.pop("_partial_", False)
    args = {k: instantiate(v) for k, v in cfg.items()}
    args.update(kwargs)
    if partial:
        return functools.partial(target, **args)
    return target(**args)


# -------------------------------------------------------------- persistence


def save_config(cfg: dict, path: str) -> None:
    os.makedirs(os.path.dirname(path), exist_ok=True)
    with open(path, "w") as f:
        yaml.safe_dump(cfg, f, sort_keys=False)

