"""Expert-choice mixture-of-experts dense block for the droid transformer;
counterpart of particle_fm_tpu/nets/moe.py.

The dense block of an encoder layer becomes E expert MLPs with
expert-choice routing (Zhou et al. 2022, arXiv:2202.09368): within each set,
each expert takes the C tokens with its highest router scores,
C = clip(ceil(N * capacity_factor / E), 1, N). Dispatch and combine are the
JAX module's one-hot einsums, (B, E, C, N) wide; a token no expert picks
returns 0 and rides the encoder layer's residual connection.

The router runs in float32 whatever the compute type. Padded tokens' scores
sink to -1 before the top-k, so an expert reaches them only in a set with
fewer than C real tokens, and their gates are clamped to 0 there. The top-k
(`expert_choice`) is a stable descending sort, which orders ties by token
index as `lax.top_k` does. The choice is discrete: two computations whose
router scores differ in the last bits (the card against the CPU, bfloat16)
can pick other tokens where an expert's C-th and C+1-th scores nearly tie.

The stacked expert parameters keep the flax layouts, `w1` (E, D_in, H),
`b1` (E, H), `w2` (E, H, D_out), `b2` (E, D_out), and their init, U(-1/sqrt
(fan_in), 1/sqrt(fan_in)) with the fan-in of the matrix they belong to; the
router is a Dense (its kernel transposed by utils/from_jax.py) with a zero
bias. `dtype` is the compute type of the expert MLPs (nets/common.py).

Under trainer.strategy=dp_ep (parallel/tp.py) each model rank holds E/model
contiguous experts (`shard_experts`): it takes its experts' columns of the
replicated router's scores, computes their share of the combine in float32
and sums it over the model group (`reduce_from`); the scores and the
tokens pass `copy_to` first, so their gradients gather every rank's
experts. The experts choose tokens within a set, so the block refuses
sequence parallelism.
"""

from __future__ import annotations

import math

import torch
from torch import nn

from particle_fm_tpu_torch.nets.common import WNDense, _uniform_, cat, check_compute_dtype, get_act
from particle_fm_tpu_torch.parallel.mesh import copy_to, reduce_from, refuse_under_sp


def expert_choice(scores: torch.Tensor, capacity: int) -> torch.Tensor:
    """Indices (B, E, C) of the `capacity` tokens each expert takes, from
    scores (B, E, N): descending, ties to the lower index (a stable sort),
    as `lax.top_k` orders them."""
    return torch.sort(scores, dim=-1, descending=True, stable=True).indices[..., :capacity]


def expert_capacity(n_tokens: int, num_experts: int, capacity_factor: float) -> int:
    """Tokens each expert takes from a set of `n_tokens`."""
    c = int(math.ceil(n_tokens * capacity_factor / num_experts))
    return max(1, min(c, n_tokens))


class ExpertChoiceMoE(nn.Module):
    """(x (B, N, D), mask (B, N) | None, ctxt (B, C) | None) -> (B, N, outp_dim)."""

    def __init__(self, inpt_dim: int, outp_dim: int, num_experts: int = 4, hddn_dim: int = 64,
                 capacity_factor: float = 2.0, ctxt_dim: int = 0, act: str = "lrlu",
                 generator: torch.Generator | None = None, dtype: torch.dtype | None = None):
        super().__init__()
        check_compute_dtype(dtype)
        self.num_experts, self.capacity_factor = num_experts, capacity_factor
        self.ctxt_dim, self.act, self.dtype = ctxt_dim, act, dtype
        d_in = inpt_dim + ctxt_dim
        self.router = WNDense(d_in, num_experts, use_weight_norm=False, generator=generator)
        with torch.no_grad():
            self.router.bias.zero_()
        shapes = {"w1": ((num_experts, d_in, hddn_dim), d_in), "b1": ((num_experts, hddn_dim), d_in),
                  "w2": ((num_experts, hddn_dim, outp_dim), hddn_dim),
                  "b2": ((num_experts, outp_dim), hddn_dim)}
        for name, (shape, fan_in) in shapes.items():
            p = torch.empty(shape)
            _uniform_(p, fan_in, generator)
            setattr(self, name, nn.Parameter(p))
        self.ep = None  # the ModelAxis the experts are split over (dp_ep)

    def shard_experts(self, axis) -> None:
        """Compute this rank's E/model experts (the parameters already hold
        them, parallel/tp.py) and sum the combine over `axis`."""
        self.ep = axis

    def forward(self, x: torch.Tensor, mask: torch.Tensor | None = None,
                ctxt: torch.Tensor | None = None) -> torch.Tensor:
        refuse_under_sp("the mixture-of-experts block")
        b, n, _ = x.shape
        c = expert_capacity(n, self.num_experts, self.capacity_factor)
        if self.ctxt_dim:
            if ctxt is None:
                raise ValueError("ExpertChoiceMoE expects ctxt but none given")
            x = cat(x, ctxt[:, None, :].expand(b, n, ctxt.shape[-1]))
        scores = torch.softmax(self.router(x.float()), dim=-1)  # (B, N, E), float32
        if mask is not None:
            scores = torch.where(mask[..., None] > 0, scores, -1.0)
        scores = scores.transpose(1, 2)  # (B, E, N)
        if self.ep is not None:  # this rank's experts
            e_loc = self.w1.shape[0]
            scores = copy_to(scores, self.ep)[:, self.ep.rank * e_loc:(self.ep.rank + 1) * e_loc]
            x = copy_to(x, self.ep)
        idx = expert_choice(scores, c)
        g = torch.clamp(torch.gather(scores, -1, idx), min=0.0)  # (B, E, C)
        dispatch = nn.functional.one_hot(idx, n).to(x.dtype)  # (B, E, C, N)
        w1, b1, w2, b2 = self.w1, self.b1, self.w2, self.b2
        if self.dtype is not None:
            x, dispatch = x.to(self.dtype), dispatch.to(self.dtype)
            w1, b1, w2, b2 = (p.to(self.dtype) for p in (w1, b1, w2, b2))
        x_e = torch.einsum("becn,bnd->becd", dispatch, x)
        h = get_act(self.act)(torch.einsum("becd,edh->bech", x_e, w1) + b1[None, :, None])
        y_e = torch.einsum("bech,ehd->becd", h, w2) + b2[None, :, None]
        weighted = dispatch * g[..., None].to(dispatch.dtype)
        if self.ep is None:
            return torch.einsum("becn,becd->bnd", weighted, y_e)
        share = torch.einsum("becn,becd->bnd", weighted.float(), y_e.float())
        return reduce_from(share, self.ep).to(y_e.dtype)
