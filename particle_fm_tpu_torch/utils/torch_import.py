"""Import trained reference (ewencedr/particle_fm) checkpoints into the port;
counterpart of particle_fm_tpu/utils/torch_import.py.

The reference's `SetFlowMatchingLitModule` stores its vector-field networks
as `flows.{k}.net.*` in the Lightning checkpoint's state_dict. The port's
networks have the same topology under the same `flows.{k}.net.` prefix and
store weight-norm Linears as PyTorch does (`weight_v (out, in)`, the norm as
`g`), so a reference state dict maps onto the port's state dict by renaming
alone, plus flattening `weight_g (out, 1)` into `g (out,)`:

  weight_norm Linear {weight_v, weight_g (out, 1), bias} -> WNDense {weight_v, g (out,), bias}
  plain Linear {weight, bias} -> Dense {weight, bias}; LayerNorm {weight, bias} -> the same

Supported architectures: epic, droid_fulltransformer,
droid_fullcrossattention and mdma (every vector-field network of the
reference's SetFlowMatchingLitModule), with the parameter-free time
embeddings (sincos and cosine). The renaming per family:

  EPiC: weight-norm Linears only (fc_l*, fc_g*, nn_list.{i}.* -> epic_layer_{i}.*).
  Droid: the DenseNetwork MLP blocks' interleaved `block.{i}` list (Linear
    and LayerNorm told apart by the weight's rank, renamed lin_{n} and
    nrm_{n} in order), the attention's q/k/v or fused all_linear, and the
    reference's `ctxt_emdb` attribute typo mapped to `ctxt_embd`.
  MDMA: nn.MultiheadAttention's in_proj split into attn_q/attn_k/attn_v, the
    `embbed_cls` typo mapped to `embed_cls`; each block's `cond_cls` Linear
    is dead reference code (used only under `self.glu`, which the reference
    hard-sets False) and is dropped.

`state_dict_from_reference(sd, model)` checks the mapping against the port's
network of `model` both ways (every parameter covered, every shape equal)
and raises ValueError naming the path of the first mismatch.
"""

from __future__ import annotations

from typing import Any, Mapping

import numpy as np
import torch


def _np(t) -> np.ndarray:
    if isinstance(t, torch.Tensor):
        return t.detach().cpu().numpy()
    return np.asarray(t)


def graft(template: Mapping[str, torch.Tensor], donor: Mapping[str, np.ndarray]
          ) -> dict[str, torch.Tensor]:
    """The donor arrays as a state dict of `template`'s dtypes, shape-checked:
    every donor key must be a template key with the same shape, and every
    template key must be covered, so nothing keeps its initial value."""
    if set(donor) != set(template):
        raise ValueError(
            "param tree mismatch: "
            f"only-in-port={sorted(set(template) - set(donor))} "
            f"only-in-reference={sorted(set(donor) - set(template))}"
        )
    out = {}
    for k, v in donor.items():
        if tuple(template[k].shape) != tuple(v.shape):
            raise ValueError(f"shape mismatch at {k}: port {tuple(template[k].shape)} "
                             f"vs reference {tuple(v.shape)}")
        out[k] = torch.tensor(np.ascontiguousarray(v)).to(template[k].dtype)
    return out


def wn_dense_from_sd(sd: Mapping[str, Any], prefix: str, dst: str) -> dict:
    """weight_norm(nn.Linear) tensors at `prefix` -> WNDense at `dst`, from the
    legacy `nn.utils.weight_norm` spelling (weight_g / weight_v, what the
    reference uses) or the parametrizations one (original0 / original1)."""
    if f"{prefix}.weight_v" in sd:
        g, v = sd[f"{prefix}.weight_g"], sd[f"{prefix}.weight_v"]
    elif f"{prefix}.parametrizations.weight.original1" in sd:
        g = sd[f"{prefix}.parametrizations.weight.original0"]
        v = sd[f"{prefix}.parametrizations.weight.original1"]
    else:
        raise KeyError(f"no weight-norm tensors under {prefix!r}")
    return {f"{dst}.weight_v": _np(v), f"{dst}.g": _np(g).reshape(-1),
            f"{dst}.bias": _np(sd[f"{prefix}.bias"])}


def dense_from_sd(sd: Mapping[str, Any], prefix: str, dst: str) -> dict:
    return {f"{dst}.weight": _np(sd[f"{prefix}.weight"]), f"{dst}.bias": _np(sd[f"{prefix}.bias"])}


layernorm_from_sd = dense_from_sd  # LayerNorm {weight, bias}: the same names on both sides


def epic_encoder_from_sd(sd: Mapping[str, Any], prefix: str = "", dst: str = "") -> dict:
    """EPiC_encoder tensors under `prefix` -> the port's EPiCEncoder under `dst`."""
    out = {}
    for name in ("fc_l1", "fc_l2", "fc_g1", "fc_g2", "fc_l3"):
        out.update(wn_dense_from_sd(sd, f"{prefix}{name}", f"{dst}{name}"))
    i = 0
    while f"{prefix}nn_list.{i}.fc_global1.bias" in sd or (
        f"{prefix}nn_list.{i}.fc_global1.parametrizations.weight.original0" in sd
    ):
        for fc in ("fc_global1", "fc_global2", "fc_local1", "fc_local2"):
            out.update(wn_dense_from_sd(sd, f"{prefix}nn_list.{i}.{fc}",
                                        f"{dst}epic_layer_{i}.{fc}"))
        i += 1
    if i == 0:
        raise KeyError(f"no EPiC layers found under {prefix!r}nn_list.*")
    return out


def _child_indices(sd: Mapping[str, Any], prefix: str) -> list[int]:
    """Sorted integer child indices of a ModuleList at `prefix`."""
    idx = set()
    for k in sd:
        if k.startswith(prefix):
            head = k[len(prefix):].split(".", 1)[0]
            if head.isdigit():
                idx.add(int(head))
    return sorted(idx)


def _has(sd: Mapping[str, Any], prefix: str) -> bool:
    return any(k.startswith(prefix) for k in sd)


def mlp_block_from_sd(sd: Mapping[str, Any], prefix: str, dst: str) -> dict:
    """Reference MLPBlock: Linear (2-D weight) and LayerNorm (1-D weight) in
    one interleaved `block` list, renamed lin_{n} / nrm_{n} in order."""
    out, n_lin, n_nrm = {}, 0, 0
    for i in _child_indices(sd, f"{prefix}block."):
        w = sd.get(f"{prefix}block.{i}.weight")
        if w is None:
            continue
        if _np(w).ndim == 2:
            out.update(dense_from_sd(sd, f"{prefix}block.{i}", f"{dst}lin_{n_lin}"))
            n_lin += 1
        else:
            out.update(layernorm_from_sd(sd, f"{prefix}block.{i}", f"{dst}nrm_{n_nrm}"))
            n_nrm += 1
    if not out:
        raise KeyError(f"no MLPBlock parameters under {prefix!r}block.*")
    return out


def dense_network_from_sd(sd: Mapping[str, Any], prefix: str, dst: str) -> dict:
    """Reference DenseNetwork -> the port's DenseNetwork."""
    out = mlp_block_from_sd(sd, f"{prefix}input_block.", f"{dst}input_block.")
    for j in _child_indices(sd, f"{prefix}hidden_blocks."):
        out.update(mlp_block_from_sd(sd, f"{prefix}hidden_blocks.{j}.",
                                     f"{dst}hidden_block_{j}."))
    if _has(sd, f"{prefix}output_block."):
        out.update(mlp_block_from_sd(sd, f"{prefix}output_block.", f"{dst}output_block."))
    return out


def mha_block_from_sd(sd: Mapping[str, Any], prefix: str, dst: str) -> dict:
    """Reference MultiHeadedAttentionBlock."""
    out = {}
    if f"{prefix}all_linear.weight" in sd:
        out.update(dense_from_sd(sd, f"{prefix}all_linear", f"{dst}all_linear"))
    else:
        for name in ("q_linear", "k_linear", "v_linear"):
            out.update(dense_from_sd(sd, f"{prefix}{name}", f"{dst}{name}"))
    out.update(dense_from_sd(sd, f"{prefix}out_linear", f"{dst}out_linear"))
    if f"{prefix}layer_norm.weight" in sd:
        out.update(layernorm_from_sd(sd, f"{prefix}layer_norm", f"{dst}layer_norm"))
    return out


def _embedders(sd: Mapping[str, Any], prefix: str, dst: str) -> dict:
    out = {**dense_network_from_sd(sd, f"{prefix}node_embd.", f"{dst}node_embd."),
           **dense_network_from_sd(sd, f"{prefix}outp_embd.", f"{dst}outp_embd.")}
    # the reference attribute is misspelled `ctxt_emdb`
    if _has(sd, f"{prefix}ctxt_emdb."):
        out.update(dense_network_from_sd(sd, f"{prefix}ctxt_emdb.", f"{dst}ctxt_embd."))
    return out


def full_transformer_from_sd(sd: Mapping[str, Any], prefix: str = "", dst: str = "") -> dict:
    """FullTransformerEncoder -> the port's FullTransformerEncoder."""
    out = layernorm_from_sd(sd, f"{prefix}te.final_norm", f"{dst}te.final_norm")
    for i in _child_indices(sd, f"{prefix}te.layers."):
        lp, lq = f"{prefix}te.layers.{i}.", f"{dst}te.layer_{i}."
        out.update(layernorm_from_sd(sd, f"{lp}norm1", f"{lq}norm1"))
        out.update(layernorm_from_sd(sd, f"{lp}norm2", f"{lq}norm2"))
        out.update(mha_block_from_sd(sd, f"{lp}self_attn.", f"{lq}self_attn."))
        out.update(dense_network_from_sd(sd, f"{lp}dense.", f"{lq}dense."))
    out.update(_embedders(sd, prefix, dst))
    return out


def full_crossattention_from_sd(sd: Mapping[str, Any], prefix: str = "", dst: str = "") -> dict:
    """FullCrossAttentionEncoder -> the port's FullCrossAttentionEncoder."""

    def cross_layer(lp: str, lq: str) -> dict:
        out = {}
        for norm in ("norm0", "norm1", "norm2"):
            out.update(layernorm_from_sd(sd, f"{lp}{norm}", f"{lq}{norm}"))
        out.update(mha_block_from_sd(sd, f"{lp}cross_attn.", f"{lq}cross_attn."))
        out.update(dense_network_from_sd(sd, f"{lp}dense.", f"{lq}dense."))
        return out

    out = {f"{dst}cae.global_tokens": _np(sd[f"{prefix}cae.global_tokens"])}
    for i in _child_indices(sd, f"{prefix}cae.from_layers."):
        out.update(cross_layer(f"{prefix}cae.from_layers.{i}.", f"{dst}cae.from_layer_{i}."))
        out.update(cross_layer(f"{prefix}cae.to_layers.{i}.", f"{dst}cae.to_layer_{i}."))
    out.update(_embedders(sd, prefix, dst))
    return out


def mdma_from_sd(sd: Mapping[str, Any], prefix: str = "", dst: str = "") -> dict:
    """MDMA -> the port's MDMA: in_proj's rows split into attn_q/k/v, the
    `embbed_cls` typo mapped to `embed_cls`, the dead `cond_cls` dropped."""
    out = {**dense_from_sd(sd, f"{prefix}embed", f"{dst}embed"),
           **dense_from_sd(sd, f"{prefix}embbed_cls", f"{dst}embed_cls"),
           **dense_from_sd(sd, f"{prefix}cond", f"{dst}cond"),
           **dense_from_sd(sd, f"{prefix}out", f"{dst}out")}
    for i in _child_indices(sd, f"{prefix}encoder."):
        bp, bq = f"{prefix}encoder.{i}.", f"{dst}block_{i}."
        for fc in ("fc0", "fc0_cls", "fc1", "fc1_cls", "fc2_cls"):
            out.update(dense_from_sd(sd, f"{bp}{fc}", f"{bq}{fc}"))
        out.update(layernorm_from_sd(sd, f"{bp}ln", f"{bq}ln"))
        in_w = _np(sd[f"{bp}attn.in_proj_weight"])
        in_b = _np(sd[f"{bp}attn.in_proj_bias"])
        h = in_w.shape[0] // 3
        for j, name in enumerate(("attn_q", "attn_k", "attn_v")):
            out[f"{bq}{name}.weight"] = in_w[j * h:(j + 1) * h]
            out[f"{bq}{name}.bias"] = in_b[j * h:(j + 1) * h]
        out.update(dense_from_sd(sd, f"{bp}attn.out_proj", f"{bq}attn_out"))
    return out


_NET_CONVERTERS = {
    "epic": epic_encoder_from_sd,
    "droid_fulltransformer": full_transformer_from_sd,
    "droid_fullcrossattention": full_crossattention_from_sd,
    "mdma": mdma_from_sd,
}


def state_dict_from_reference(sd: Mapping[str, Any], model) -> dict[str, torch.Tensor]:
    """Reference SetFlowMatchingLitModule state_dict -> the port's state dict
    of `model`'s network (float tensors on the CPU).

    `model` is the matching FlowMatchingModel (same dims and conditioning);
    its freshly built network is the shape-checked template, so a
    hyperparameter mismatch raises instead of giving a wrong network.
    Refused as in the JAX package, with its exception types: another
    architecture, the gaussian time embedding and the in-model normaliser
    (NotImplementedError), a state dict without `flows.{k}.net.` keys
    (KeyError). `loss.flows.*` aliases of the same tensors are ignored."""
    if model.model not in _NET_CONVERTERS:
        raise NotImplementedError(
            f"checkpoint import supports {sorted(_NET_CONVERTERS)} (got model={model.model!r})")
    if model.t_emb == "gaussian":
        raise NotImplementedError(
            "t_emb='gaussian' carries trainable projection weights in the reference CNF; "
            "import supports the parameter-free sincos/cosine embeddings")
    if model.use_normaliser:
        raise NotImplementedError(
            "use_normaliser=True: IterativeNormLayer buffer import is not wired; disable the "
            "in-model normaliser for imported runs")

    convert = _NET_CONVERTERS[model.model]
    donor = {}
    for k in range(model.n_transforms):
        pre = f"flows.{k}.net."
        if not any(key.startswith(pre) for key in sd):
            raise KeyError(
                f"state_dict has no {pre}* keys — is this a SetFlowMatchingLitModule "
                "checkpoint? For a bare network state_dict use the *_from_sd converters "
                "directly")
        donor.update(convert(sd, pre, pre))
    template = model.init(seed=0, device="cpu").state_dict()
    return graft(template, donor)


_TO_REFERENCE = (  # port name pieces -> the reference's, applied in order
    (r"\.epic_layer_(\d+)\.", r".nn_list.\1."),
    (r"\.te\.layer_(\d+)\.", r".te.layers.\1."),
    (r"\.cae\.(from|to)_layer_(\d+)\.", r".cae.\1_layers.\2."),
    (r"\.hidden_block_(\d+)\.", r".hidden_blocks.\1."),
    (r"\.ctxt_embd\.", r".ctxt_emdb."),
    (r"\.block_(\d+)\.attn_out\.", r".encoder.\1.attn.out_proj."),
    (r"\.block_(\d+)\.", r".encoder.\1."),
    (r"\.embed_cls\.", r".embbed_cls."),
)


def reference_state_dict(port_sd: Mapping[str, torch.Tensor]) -> dict[str, torch.Tensor]:
    """The inverse relayout: a port state dict of a supported architecture
    under the reference's key names (weight-norm `g` as `weight_g (out, 1)`;
    MLP blocks' Linear n and LayerNorm n at `block.{4n}` and `block.{4n+2}`
    of the interleaved list; MDMA's attn_q/k/v rows stacked into
    `attn.in_proj_*`), which `state_dict_from_reference` maps back exactly.
    Writes reference-layout checkpoints from port weights."""
    import re

    out, qkv = {}, {}
    for key, v in port_sd.items():
        ref = key
        for pat, rep in _TO_REFERENCE:
            ref = re.sub(pat, rep, ref)
        ref = re.sub(r"\.lin_(\d+)\.", lambda m: f".block.{4 * int(m[1])}.", ref)
        ref = re.sub(r"\.nrm_(\d+)\.", lambda m: f".block.{4 * int(m[1]) + 2}.", ref)
        m = re.match(r"(.*\.encoder\.\d+\.)attn_([qkv])\.(weight|bias)$", ref)
        if m:
            qkv.setdefault((m[1], m[3]), {})[m[2]] = v
            continue
        if ref.endswith(".g"):
            ref, v = ref[:-2] + ".weight_g", v.reshape(-1, 1)
        out[ref] = v.detach().clone()
    for (block, leaf), parts in qkv.items():
        out[f"{block}attn.in_proj_{leaf}"] = torch.cat([parts[c] for c in "qkv"]).detach().clone()
    return out


def load_reference_checkpoint(path: str) -> dict:
    """A reference .ckpt/.pt file's flat state_dict, read with
    `weights_only=True` (tensors and containers only: the pickle cannot run
    code, and no hydra or lightning classes are needed)."""
    obj = torch.load(path, map_location="cpu", weights_only=True)
    if isinstance(obj, dict) and "state_dict" in obj:
        obj = obj["state_dict"]
    return dict(obj)
