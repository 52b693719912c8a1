"""PC-Droid transformer family; counterpart of particle_fm_tpu/nets/transformer.py.

Normformer-style encoder layers (pre-LN residual attention + residual
context-conditioned dense block) and perceiver-style cross-attention to a few
learnable global tokens, with dense embedders around them. Class, module and
parameter names follow the JAX modules (`lin_0`, `nrm_0`, `input_block`,
`self_attn`, `all_linear`, `layer_0`, `global_tokens`, ...), so
utils/from_jax.py maps one parameter tree onto the other by name.

Differences from the flax modules, all of form: a module is given its input
width at construction (flax infers it at the first call); the time embedding
reaches the full encoders as the per-set (B, T) tensor, where the JAX
modules take (B, N, T) and slice its first particle. With `moe_config` an
encoder layer's dense block is the expert-choice mixture of experts
(nets/moe.py), named `moe` as in the flax module. Dropout (`drp`) sits where
the JAX modules put it and draws only inside
`nets/common.py::dropout_generator`. All attention goes through
`ops.attention.attention`; LayerNorms use eps 1e-5.

`dtype` (None or bfloat16) is the compute type of every Dense and
LayerNorm, as the flax modules' `dtype` (nets/common.py); the parameters
stay float32, and attention takes q, k, v in the projections' type.

Under sequence parallelism (parallel/mesh.py::sequence_parallel) each rank
holds its part of every set's tokens: the encoder gathers the key mask over
the model axis once, and each self-attention block gathers its normed input
(one all-gather, whose backward sums and slices) and projects every token's
keys and values itself, so this rank's queries attend to every key. Lq then
differs from Lk and attention takes the einsum path (the packed kernel
needs Lq = Lk). The cross-attention
encoder (global tokens) and the mixture of experts couple tokens across the
split in other ways and refuse it.
"""

from __future__ import annotations

from typing import Any, Mapping, Sequence

import torch
from torch import nn

from particle_fm_tpu_torch.nets.common import (Dropout, LayerNorm, WNDense, WNDenseSplit, cat,
                                               get_act)
from particle_fm_tpu_torch.nets.moe import ExpertChoiceMoE
from particle_fm_tpu_torch.ops import attention as attention_ops
from particle_fm_tpu_torch.parallel.mesh import refuse_under_sp, seq_gather, sequence_axis

_LN_EPS = 1e-5


def _broadcast_ctxt(ctxt: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """Expand a (B, C) context to the rank of x."""
    while ctxt.ndim < x.ndim:
        ctxt = ctxt[..., None, :]
    return ctxt.expand(*x.shape[:-1], ctxt.shape[-1])


class MLPBlock(nn.Module):
    """Linear -> act -> (norm) -> (dropout), `n_layers` deep, optional
    residual. Context is concatenated to the input of the first layer only."""

    def __init__(
        self,
        inpt_dim: int,
        outp_dim: int,
        ctxt_dim: int = 0,
        n_layers: int = 1,
        act: str = "lrlu",
        nrm: str = "none",
        drp: float = 0.0,
        do_res: bool = False,
        init_zeros: bool = False,
        generator: torch.Generator | None = None,
        dtype: torch.dtype | None = None,
    ):
        super().__init__()
        if nrm not in ("none", "layer"):
            raise ValueError(f"No normalisation with name: {nrm}")
        self.inpt_dim, self.outp_dim, self.ctxt_dim = inpt_dim, outp_dim, ctxt_dim
        self.n_layers, self.act, self.nrm = n_layers, act, nrm
        self.do_res = do_res and inpt_dim == outp_dim
        # A per-set (B, C) context against (B, N, F) tokens goes through the
        # first layer as x @ W_x + broadcast(ctxt @ W_c): the same parameters
        # as a Dense on the concat, without the (B, N, F + C) tensor. A
        # zero-initialised single layer keeps the plain Dense, as in JAX.
        self.split_ctxt = bool(ctxt_dim) and not (init_zeros and n_layers == 1)
        for n in range(n_layers):
            zeros = init_zeros and n == n_layers - 1
            if n == 0 and self.split_ctxt:
                lin = WNDenseSplit([(inpt_dim, "particle"), (ctxt_dim, "set")], outp_dim,
                                   use_weight_norm=False, generator=generator, dtype=dtype)
            else:
                fan_in = inpt_dim + ctxt_dim if n == 0 else outp_dim
                lin = WNDense(fan_in, outp_dim, use_weight_norm=False, init_zeros=zeros,
                              generator=generator, dtype=dtype)
            self.add_module(f"lin_{n}", lin)
            if nrm == "layer":
                self.add_module(f"nrm_{n}", LayerNorm(outp_dim, eps=_LN_EPS, dtype=dtype))
        self.drop = Dropout(drp)

    def forward(self, x: torch.Tensor, ctxt: torch.Tensor | None = None) -> torch.Tensor:
        inpt = x
        act = get_act(self.act)
        per_set = False
        if self.ctxt_dim:
            if ctxt is None:
                raise ValueError("Was expecting contextual information but none given!")
            per_set = self.split_ctxt and ctxt.ndim < x.ndim
            if not per_set:
                x = cat(x, _broadcast_ctxt(ctxt, x))
        for n in range(self.n_layers):
            lin = getattr(self, f"lin_{n}")
            if n == 0 and per_set:
                x = lin([(x, "particle"), (ctxt, "set")])
            else:
                x = WNDense.forward(lin, x)
            if self.act != "none":
                x = act(x)
            if self.nrm == "layer":
                x = getattr(self, f"nrm_{n}")(x)
            x = self.drop(x)
        if self.do_res:
            x = x + inpt
        return x


class DenseNetwork(nn.Module):
    """Input block -> hidden blocks -> output block, with context injection.
    `out_dim` is the width of what it returns."""

    def __init__(
        self,
        inpt_dim: int,
        outp_dim: int = 0,
        ctxt_dim: int = 0,
        hddn_dim: int | Sequence[int] = 32,
        num_blocks: int = 1,
        n_lyr_pbk: int = 1,
        act_h: str = "lrlu",
        act_o: str = "none",
        do_out: bool = True,
        nrm: str = "none",
        drp: float = 0.0,
        drp_on_output: bool = False,
        nrm_on_output: bool = False,
        do_res: bool = False,
        ctxt_in_inpt: bool = True,
        ctxt_in_hddn: bool = False,
        output_init_zeros: bool = False,
        generator: torch.Generator | None = None,
        dtype: torch.dtype | None = None,
    ):
        super().__init__()
        if ctxt_dim and not (ctxt_in_inpt or ctxt_in_hddn):
            raise ValueError("Network has context inputs but nowhere to use them!")
        hddn = num_blocks * [hddn_dim] if isinstance(hddn_dim, int) else list(hddn_dim)
        self.do_out = do_out
        self.out_dim = (outp_dim or inpt_dim) if do_out else hddn[-1]
        self.input_block = MLPBlock(
            inpt_dim, hddn[0], ctxt_dim=ctxt_dim if ctxt_in_inpt else 0, act=act_h, nrm=nrm,
            drp=drp, generator=generator, dtype=dtype,
        )
        self.num_hidden = len(hddn) - 1
        for i, (h1, h2) in enumerate(zip(hddn[:-1], hddn[1:])):
            self.add_module(
                f"hidden_block_{i}",
                MLPBlock(h1, h2, ctxt_dim=ctxt_dim if ctxt_in_hddn else 0, n_layers=n_lyr_pbk,
                         act=act_h, nrm=nrm, drp=drp, do_res=do_res, generator=generator,
                         dtype=dtype),
            )
        if do_out:
            self.output_block = MLPBlock(
                hddn[-1], self.out_dim, act=act_o, init_zeros=output_init_zeros,
                nrm=nrm if nrm_on_output else "none", drp=drp if drp_on_output else 0.0,
                generator=generator, dtype=dtype,
            )

    def forward(self, x: torch.Tensor, ctxt: torch.Tensor | None = None) -> torch.Tensor:
        x = self.input_block(x, ctxt)
        for i in range(self.num_hidden):
            x = getattr(self, f"hidden_block_{i}")(x, ctxt)
        if self.do_out:
            x = self.output_block(x)
        return x


class MultiHeadedAttentionBlock(nn.Module):
    """Generic MHA, self- or cross-attention, with a key-side padding mask.

    `scores_dtype` ("float32", "bfloat16" or None) is the storage type of the
    score tensors on the einsum path; `attn_impl` picks the attention
    (`ops.attention.attention`): "auto", "packed" / "fused" for the
    short-set CUDA kernels, or "flash" for the blockwise one, which takes
    sets of any length (the 279-particle sets of the LHCO configurations are
    beyond the packed kernel's 256).
    """

    def __init__(
        self,
        model_dim: int,
        num_heads: int = 1,
        drp: float = 0.0,
        init_zeros: bool = False,
        do_selfattn: bool = False,
        do_layer_norm: bool = False,
        scores_dtype: str | None = None,
        attn_impl: str = "auto",
        generator: torch.Generator | None = None,
        dtype: torch.dtype | None = None,
    ):
        super().__init__()
        if model_dim % num_heads:
            raise ValueError("Model dimension must be divisible by number of heads!")
        self.model_dim, self.num_heads = model_dim, num_heads
        self.do_selfattn = do_selfattn
        self.scores_dtype = attention_ops.scores_dtype_from(scores_dtype)
        self.attn_impl = attn_impl
        dense = dict(use_weight_norm=False, generator=generator, dtype=dtype)
        if do_selfattn:
            self.all_linear = WNDense(model_dim, 3 * model_dim, **dense)
        else:
            self.q_linear = WNDense(model_dim, model_dim, **dense)
            self.k_linear = WNDense(model_dim, model_dim, **dense)
            self.v_linear = WNDense(model_dim, model_dim, **dense)
        self.drop = Dropout(drp)
        self.layer_norm = LayerNorm(model_dim, eps=_LN_EPS, dtype=dtype) if do_layer_norm else None
        self.out_linear = WNDense(model_dim, model_dim, init_zeros=init_zeros, **dense)

    def forward(self, q, k=None, v=None, kv_mask=None, attn_bias=None) -> torch.Tensor:
        if k is None:
            k = q
        if v is None:
            v = k
        if self.do_selfattn:
            # three views of one projection output: the kernels read them in place
            seq = sequence_axis()
            if seq is None:
                q_out, k_out, v_out = self.all_linear(q).chunk(3, dim=-1)
            else:  # every rank's tokens, projected here: half the bytes of their keys and values
                n = q.shape[1]
                q_out, k_out, v_out = self.all_linear(seq_gather(q, seq)).chunk(3, dim=-1)
                q_out = q_out[:, seq.rank * n:(seq.rank + 1) * n]
        else:
            q_out, k_out, v_out = self.q_linear(q), self.k_linear(k), self.v_linear(v)

        def split_heads(t):
            return t.view(*t.shape[:-1], self.num_heads, self.model_dim // self.num_heads)

        a_out = attention_ops.attention(
            split_heads(q_out), split_heads(k_out), split_heads(v_out), kv_mask, attn_bias,
            impl=self.attn_impl, scores_dtype=self.scores_dtype,
        )
        a_out = self.drop(a_out.reshape(*a_out.shape[:-2], self.model_dim))
        if self.layer_norm is not None:
            a_out = self.layer_norm(a_out)
        return self.out_linear(a_out)


class TransformerEncoderLayer(nn.Module):
    """Pre-LN residual self-attention + residual ctxt-conditioned dense; with
    `moe_config` the dense block is an ExpertChoiceMoE (`moe`)."""

    def __init__(
        self,
        model_dim: int,
        mha_config: Mapping[str, Any] | None = None,
        dense_config: Mapping[str, Any] | None = None,
        ctxt_dim: int = 0,
        moe_config: Mapping[str, Any] | None = None,
        generator: torch.Generator | None = None,
        dtype: torch.dtype | None = None,
    ):
        super().__init__()
        self.norm1 = LayerNorm(model_dim, eps=_LN_EPS, dtype=dtype)
        self.self_attn = MultiHeadedAttentionBlock(
            model_dim, do_selfattn=True, generator=generator, dtype=dtype, **dict(mha_config or {})
        )
        self.norm2 = LayerNorm(model_dim, eps=_LN_EPS, dtype=dtype)
        if moe_config is not None:
            self.moe = ExpertChoiceMoE(model_dim, model_dim, ctxt_dim=ctxt_dim,
                                       generator=generator, dtype=dtype, **dict(moe_config))
        else:
            self.dense = DenseNetwork(
                model_dim, outp_dim=model_dim, ctxt_dim=ctxt_dim, generator=generator,
                dtype=dtype, **dict(dense_config or {}),
            )

    def forward(self, x, mask=None, ctxt=None, attn_bias=None) -> torch.Tensor:
        x = x + self.self_attn(self.norm1(x), kv_mask=mask, attn_bias=attn_bias)
        if hasattr(self, "moe"):
            return x + self.moe(self.norm2(x), mask=mask, ctxt=ctxt)
        return x + self.dense(self.norm2(x), ctxt)


class TransformerCrossAttentionLayer(nn.Module):
    """Pre-LN residual cross-attention + residual dense."""

    def __init__(
        self,
        model_dim: int,
        mha_config: Mapping[str, Any] | None = None,
        dense_config: Mapping[str, Any] | None = None,
        ctxt_dim: int = 0,
        generator: torch.Generator | None = None,
        dtype: torch.dtype | None = None,
    ):
        super().__init__()
        self.norm0 = LayerNorm(model_dim, eps=_LN_EPS, dtype=dtype)
        self.norm1 = LayerNorm(model_dim, eps=_LN_EPS, dtype=dtype)
        self.cross_attn = MultiHeadedAttentionBlock(
            model_dim, do_selfattn=False, generator=generator, dtype=dtype,
            **dict(mha_config or {})
        )
        self.norm2 = LayerNorm(model_dim, eps=_LN_EPS, dtype=dtype)
        self.dense = DenseNetwork(
            model_dim, outp_dim=model_dim, ctxt_dim=ctxt_dim, generator=generator, dtype=dtype,
            **dict(dense_config or {}),
        )

    def forward(self, q_seq, kv_seq, kv_mask=None, ctxt=None) -> torch.Tensor:
        kv_n = self.norm0(kv_seq)
        q_seq = q_seq + self.cross_attn(self.norm1(q_seq), kv_n, kv_mask=kv_mask)
        return q_seq + self.dense(self.norm2(q_seq), ctxt)


class TransformerEncoder(nn.Module):
    """Stack of encoder layers + final LayerNorm."""

    def __init__(
        self,
        model_dim: int = 64,
        num_layers: int = 3,
        mha_config: Mapping[str, Any] | None = None,
        dense_config: Mapping[str, Any] | None = None,
        ctxt_dim: int = 0,
        moe_config: Mapping[str, Any] | None = None,
        generator: torch.Generator | None = None,
        dtype: torch.dtype | None = None,
    ):
        super().__init__()
        self.num_layers = num_layers
        for i in range(num_layers):
            self.add_module(
                f"layer_{i}",
                TransformerEncoderLayer(model_dim, mha_config, dense_config, ctxt_dim,
                                        moe_config=moe_config, generator=generator, dtype=dtype),
            )
        self.final_norm = LayerNorm(model_dim, eps=_LN_EPS, dtype=dtype)

    def run_layers(self, x, mask=None, ctxt=None, attn_bias=None,
                   layers: range | None = None) -> torch.Tensor:
        """The encoder layers `layers` (default: all) in turn, without the
        final LayerNorm: the loop that the pipeline splits by stage
        (parallel/pp.py)."""
        for i in range(self.num_layers) if layers is None else layers:
            x = getattr(self, f"layer_{i}")(x, mask, ctxt, attn_bias)
        return x

    def forward(self, x, mask=None, ctxt=None, attn_bias=None) -> torch.Tensor:
        seq = sequence_axis()
        if seq is not None and mask is not None:  # the keys' mask, every rank's
            mask = seq.all_gather(mask, 1)
        return self.final_norm(self.run_layers(x, mask, ctxt, attn_bias))


def resolve_fte_configs(
    te_config: Mapping[str, Any],
    node_embd_config: Mapping[str, Any],
    outp_embd_config: Mapping[str, Any],
    ctxt_embd_config: Mapping[str, Any],
) -> tuple[dict, dict, dict, dict, int]:
    """The sub-configurations of a full encoder (te_config or cae_config,
    node, outp, ctxt) with the embedder and dense widths defaulting to
    2 * model_dim, and the model width."""
    te_config = dict(te_config)
    node_cfg, outp_cfg, ctxt_cfg = dict(node_embd_config), dict(outp_embd_config), dict(ctxt_embd_config)
    te_config["dense_config"] = dict(te_config.get("dense_config", {}))
    if "model_dim" in te_config:
        for cfg in (node_cfg, ctxt_cfg, outp_cfg, te_config["dense_config"]):
            cfg.setdefault("hddn_dim", 2 * te_config["model_dim"])
    return te_config, node_cfg, outp_cfg, ctxt_cfg, te_config.get("model_dim", 64)


class _FullEncoder(nn.Module):
    """Node, context and output embedders around an encoder (`self.core`).

    Call: (t_set (B, T), x (B, N, inpt_dim), cond (B, C) | None,
    mask (B, N, 1) | None) -> (B, N, outp_dim). The per-set context is
    cat(t_set, cond) through `ctxt_embd`.
    """

    core_name = ""

    def __init__(self, inpt_dim, outp_dim, ctxt_dim, core_cls, core_config, node_embd_config,
                 outp_embd_config, ctxt_embd_config, generator, dtype=None):
        super().__init__()
        core_cfg, node_cfg, outp_cfg, ctxt_cfg, model_dim = resolve_fte_configs(
            core_config or {}, node_embd_config or {}, outp_embd_config or {},
            ctxt_embd_config or {},
        )
        self.ctxt_dim = ctxt_dim
        ctxt_out = 0
        if ctxt_dim:
            self.ctxt_embd = DenseNetwork(ctxt_dim, generator=generator, dtype=dtype, **ctxt_cfg)
            ctxt_out = self.ctxt_embd.out_dim
        self.node_embd = DenseNetwork(inpt_dim, outp_dim=model_dim, ctxt_dim=ctxt_out,
                                      generator=generator, dtype=dtype, **node_cfg)
        self.add_module(self.core_name, core_cls(ctxt_dim=ctxt_out, generator=generator,
                                                 dtype=dtype, **core_cfg))
        self.outp_embd = DenseNetwork(model_dim, outp_dim=outp_dim, ctxt_dim=ctxt_out,
                                      generator=generator, dtype=dtype, **outp_cfg)

    def context(self, t_set, cond=None) -> torch.Tensor | None:
        """The per-set context cat(t_set, cond) through `ctxt_embd` (None
        without one)."""
        return self.ctxt_embd(cat(t_set, cond)) if self.ctxt_dim else None

    def forward(self, t_set, x, cond=None, mask=None) -> torch.Tensor:
        kv_mask = mask[..., 0] if mask is not None else None
        ctxt = self.context(t_set, cond)
        x = self.node_embd(x, ctxt)
        x = getattr(self, self.core_name)(x, mask=kv_mask, ctxt=ctxt)
        return self.outp_embd(x, ctxt)


class FullTransformerEncoder(_FullEncoder):
    """Node/ctxt/output embedders around a TransformerEncoder (`te`)."""

    core_name = "te"

    def __init__(self, inpt_dim: int, outp_dim: int, ctxt_dim: int = 0, te_config=None,
                 node_embd_config=None, outp_embd_config=None, ctxt_embd_config=None,
                 generator: torch.Generator | None = None, dtype: torch.dtype | None = None):
        super().__init__(inpt_dim, outp_dim, ctxt_dim, TransformerEncoder, te_config,
                         node_embd_config, outp_embd_config, ctxt_embd_config, generator, dtype)


class CrossAttentionEncoder(nn.Module):
    """Perceiver-style: `num_tokens` learnable global tokens, cross-attention
    from the set to the tokens and back in every layer."""

    def __init__(
        self,
        model_dim: int = 64,
        num_tokens: int = 4,
        num_layers: int = 5,
        mha_config: Mapping[str, Any] | None = None,
        dense_config: Mapping[str, Any] | None = None,
        ctxt_dim: int = 0,
        generator: torch.Generator | None = None,
        dtype: torch.dtype | None = None,
    ):
        super().__init__()
        self.num_layers = num_layers
        self.global_tokens = nn.Parameter(torch.randn(1, num_tokens, model_dim, generator=generator))
        for i in range(num_layers):
            for name in ("from", "to"):
                self.add_module(
                    f"{name}_layer_{i}",
                    TransformerCrossAttentionLayer(model_dim, mha_config, dense_config, ctxt_dim,
                                                   generator=generator, dtype=dtype),
                )

    def forward(self, seq, mask=None, ctxt=None) -> torch.Tensor:
        refuse_under_sp("the cross-attention encoder (global tokens)")
        g = self.global_tokens.expand(seq.shape[0], -1, -1).to(seq.dtype)
        for i in range(self.num_layers):
            g = getattr(self, f"from_layer_{i}")(g, seq, mask, ctxt)
            seq = getattr(self, f"to_layer_{i}")(seq, g, None, ctxt)
        return seq


class FullCrossAttentionEncoder(_FullEncoder):
    """Node/ctxt/output embedders around a CrossAttentionEncoder (`cae`)."""

    core_name = "cae"

    def __init__(self, inpt_dim: int, outp_dim: int, ctxt_dim: int = 0, cae_config=None,
                 node_embd_config=None, outp_embd_config=None, ctxt_embd_config=None,
                 generator: torch.Generator | None = None, dtype: torch.dtype | None = None):
        super().__init__(inpt_dim, outp_dim, ctxt_dim, CrossAttentionEncoder, cae_config,
                         node_embd_config, outp_embd_config, ctxt_embd_config, generator, dtype)
