"""Classifier models of the gen-vs-real tests; counterpart of
particle_fm_tpu/models/classifiers.py.

`SetClassifierModel` classifies padded sets (x, mask) with the labels in
`cond`: arch "epic" (nets/epic.py::EPiCDiscriminator), "transformer"
(`TransformerClassifierNet`), "part" (nets/part.py) or "particlenet"
(nets/particlenet.py); `n_classes` 1 is binary on one logit (BCE), more is
softmax cross-entropy. `HLClassifierModel` is the cathode MLP on flat
high-level features (x (B, F), no mask).

The port's model protocol, as the flow-matching model's: `init(seed,
device)` builds the network on the device; `loss(net, generator, x, mask,
cond, train)` is the mean loss tensor, and in training every dropout of the
network draws from `generator` (nets/common.py::dropout_generator);
`predict(net, x, mask)` gives probabilities: sigmoid of the logit (binary)
or the softmax, and under `num_sup_sets` S the event's probability repeated
onto each of its S rows, from the network as it is given.
`inference_network(copy)` folds weight norm into a copy of an EPiC network,
so that its EPiC layers run the fused kernel on CUDA tensors
(`ops/epic_layer.py`; the plain version on the CPU); the live training
network stays unfolded. `binary_metrics` computes accuracy and AUROC on the
host without sklearn.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Mapping

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from particle_fm_tpu_torch.models.flow_matching import FlowMatchingModel, compute_dtype, is_folded
from particle_fm_tpu_torch.nets.common import dropout_generator
from particle_fm_tpu_torch.nets.epic import EPiCDiscriminator
from particle_fm_tpu_torch.nets.mlp import CathodeClassifier
from particle_fm_tpu_torch.nets.part import ParTClassifierNet
from particle_fm_tpu_torch.nets.particlenet import ParticleNetClassifierNet
from particle_fm_tpu_torch.nets.transformer import DenseNetwork, TransformerEncoder
from particle_fm_tpu_torch.ops.masked import masked_mean
from particle_fm_tpu_torch.utils.device import resolve_device

# the modules `reinit_head` draws anew, by architecture
HEADS = {"epic": ("fc_d1", "fc_d2", "fc_out"), "transformer": ("head",), "part": ("head",),
         "particlenet": ("particle_net.head",)}


class TransformerClassifierNet(nn.Module):
    """Normformer encoder + masked mean pooling + dense head (n_classes)."""

    def __init__(self, in_feats: int, n_classes: int = 10,
                 te_config: Mapping[str, Any] | None = None,
                 head_config: Mapping[str, Any] | None = None,
                 generator: torch.Generator | None = None, dtype: torch.dtype | None = None):
        super().__init__()
        te_cfg = dict(te_config or {}) or {"model_dim": 128, "num_layers": 3}
        model_dim = te_cfg.get("model_dim", 128)
        self.embed = DenseNetwork(in_feats, outp_dim=model_dim, generator=generator, dtype=dtype)
        self.encoder = TransformerEncoder(generator=generator, dtype=dtype, **te_cfg)
        self.head = DenseNetwork(model_dim, outp_dim=n_classes, generator=generator, dtype=dtype,
                                 **dict(head_config or {}))

    def forward(self, x, mask=None, cond=None) -> torch.Tensor:
        h = self.encoder(self.embed(x), mask=mask[..., 0] if mask is not None else None)
        return self.head(masked_mean(h, mask))


def _tuples(cfg: Mapping[str, Any]) -> dict:
    return {k: tuple(v) if isinstance(v, list) else v for k, v in dict(cfg).items()}


def _on_device(net: nn.Module, device) -> nn.Module:
    return net.to(resolve_device(device)).eval()


@dataclasses.dataclass(eq=False)
class SetClassifierModel:
    """Set classifier (binary or multiclass) over (x, mask), labels in cond."""

    arch: str = "epic"
    n_classes: int = 1
    num_particles: int = 150
    features: int = 3
    net_config: Mapping[str, Any] = dataclasses.field(default_factory=dict)
    dtype: Any = None

    def __post_init__(self):
        self.compute_dtype = compute_dtype(self.dtype)
        self.sup_sets = int(dict(self.net_config).get("num_sup_sets", 1))
        if self.sup_sets > 1 and self.arch != "epic":
            raise ValueError("num_sup_sets > 1 is only supported for arch='epic'")
        if self.arch not in HEADS:
            raise ValueError(f"unknown classifier arch {self.arch}")

    def build(self, generator: torch.Generator | None = None) -> nn.Module:
        """The network, parameters drawn from `generator`, on the CPU."""
        out = max(self.n_classes, 1)
        kw = dict(generator=generator, dtype=self.compute_dtype)
        cfg = dict(self.net_config)
        if self.arch == "epic":
            for key, default in (("hid_dim", 128), ("latent_dim", 10), ("equiv_layers", 3)):
                cfg.setdefault(key, default)
            cfg["out_dim"] = out
            return EPiCDiscriminator(self.features, **kw, **cfg)
        if self.arch == "transformer":
            return TransformerClassifierNet(self.features, n_classes=out, **kw, **cfg)
        if self.arch == "part":
            return ParTClassifierNet(self.features, n_classes=out, **kw, **_tuples(cfg))
        point_indices = cfg.pop("point_indices", (0, 1))
        return ParticleNetClassifierNet(self.features, n_classes=out,
                                        point_indices=tuple(point_indices), net_config=cfg, **kw)

    def init(self, seed: int = 0, device: str | torch.device = "cuda") -> nn.Module:
        """The network, its parameters drawn from `seed`, on `device`."""
        return _on_device(self.build(torch.Generator().manual_seed(seed)), device)

    def reinit_head(self, net: nn.Module, seed: int = 0) -> nn.Module:
        """Draw the classification head anew from `seed`, keeping the trunk
        (the fine-tune hook); in place, returns `net`. Heads: epic
        fc_d1/fc_d2/fc_out, transformer and part `head`, particlenet
        `particle_net.head`."""
        fresh = self.build(torch.Generator().manual_seed(seed))
        for name in HEADS[self.arch]:
            net.get_submodule(name).load_state_dict(fresh.get_submodule(name).state_dict())
        return net

    def logits(self, net: nn.Module, x, mask=None) -> torch.Tensor:
        return net(x, mask=mask)

    def loss_accum_weight(self, x: torch.Tensor, mask: torch.Tensor | None) -> torch.Tensor:
        """A microbatch's weight under gradient accumulation: its size."""
        return torch.tensor(float(x.shape[0]), device=x.device)

    def loss(self, net: nn.Module, generator: torch.Generator, x, mask=None, cond=None,
             train: bool = False) -> torch.Tensor:
        """Mean BCE on one logit, or softmax cross-entropy, of the labels in
        `cond` ((B, 1), or one-hot (B, n_classes)); under `num_sup_sets` the
        label of each event's first row. In training, dropout draws from
        `generator`."""
        if is_folded(net):
            raise RuntimeError("loss needs the unfolded network (call unfold_weight_norm first)")
        with dropout_generator(net, generator if train else None):
            logits = net(x, mask=mask)
        labels = cond
        if self.sup_sets > 1:
            labels = labels.reshape(-1, self.sup_sets, *labels.shape[1:])[:, 0]
        if self.n_classes == 1:
            labels = labels.reshape(logits.shape).to(logits.dtype)
            return F.binary_cross_entropy_with_logits(logits, labels)
        if labels.ndim == 2 and labels.shape[-1] == self.n_classes:
            labels = torch.argmax(labels, dim=-1)
        return F.cross_entropy(logits, labels.reshape(-1).long())

    def inference_network(self, net: nn.Module) -> nn.Module:
        """`net` (a copy to evaluate with) made ready for predictions, in
        place: an EPiC network folded, so that every `predict` on it runs the
        fused layer."""
        if self.arch == "epic":
            FlowMatchingModel.fold_weight_norm(net)
        return net

    @torch.no_grad()
    def predict(self, net: nn.Module, x, mask=None) -> torch.Tensor:
        """Probabilities (B,) binary or (B, n_classes)."""
        logits = net(x, mask=mask)
        if self.sup_sets > 1:
            logits = torch.repeat_interleave(logits, self.sup_sets, dim=0)
        if self.n_classes == 1:
            return torch.sigmoid(logits)[..., 0]
        return torch.softmax(logits, dim=-1)


@dataclasses.dataclass(eq=False)
class HLClassifierModel:
    """Cathode MLP classifier on flat high-level features (binary)."""

    features: int = 4
    layers: tuple = (64, 64, 64)
    dtype: Any = None

    def __post_init__(self):
        self.compute_dtype = compute_dtype(self.dtype)

    def init(self, seed: int = 0, device: str | torch.device = "cuda") -> nn.Module:
        return _on_device(CathodeClassifier(self.features, tuple(self.layers),
                                            generator=torch.Generator().manual_seed(seed),
                                            dtype=self.compute_dtype), device)

    def inference_network(self, net: nn.Module) -> nn.Module:
        return net

    def loss_accum_weight(self, x: torch.Tensor, mask: torch.Tensor | None) -> torch.Tensor:
        return torch.tensor(float(x.shape[0]), device=x.device)

    def loss(self, net: nn.Module, generator: torch.Generator, x, mask=None, cond=None,
             train: bool = False) -> torch.Tensor:
        logits = net(x)
        labels = cond.reshape(logits.shape).to(logits.dtype)
        return F.binary_cross_entropy_with_logits(logits, labels)

    @torch.no_grad()
    def predict(self, net: nn.Module, x, mask=None) -> torch.Tensor:
        return torch.sigmoid(net(x))[..., 0]


def roc_auc(labels, scores) -> float:
    """Area under the ROC curve by the Mann-Whitney statistic on average
    ranks (ties share their mean rank), which is what sklearn's
    roc_auc_score computes; the larger of the two label values is the
    positive class. Raises where only one class is present."""
    from scipy.stats import rankdata

    labels = np.asarray(labels).reshape(-1)
    scores = np.asarray(scores, dtype=np.float64).reshape(-1)
    classes = np.unique(labels)
    if len(classes) != 2:
        raise ValueError(f"ROC AUC needs two classes in the labels, got {classes.tolist()}")
    pos = labels == classes[1]
    n_pos, n_neg = int(pos.sum()), int((~pos).sum())
    ranks = rankdata(scores)
    return float((ranks[pos].sum() - n_pos * (n_pos + 1) / 2.0) / (n_pos * n_neg))


def binary_metrics(probs, labels) -> dict:
    """Accuracy (threshold 0.5) and AUROC on the host."""
    probs = np.asarray(probs)
    labels = np.asarray(labels).reshape(-1)
    acc = float(((probs > 0.5) == (labels > 0.5)).mean())
    return {"accuracy": acc, "auroc": roc_auc(labels, probs)}
