"""Pipeline parallelism (GPipe) over the droid transformer's layers;
counterpart of particle_fm_tpu/parallel/pp.py.

The JAX package stacks the L encoder layers' parameters on a 'pipe' mesh
axis of S devices, runs M microbatches through M + S - 1 ticks of a scan
that rotates the activations forward with `ppermute`, and differentiates
through it (the transpose of the rotation is the backward pipeline). The
port runs one process a stage:

- **Layout** (`pipe_axis`). W = D x S ranks, rank r at (r // S, r % S), as
  parallel/mesh.py places the (data, model) mesh, with the pipe axis in the
  model axis's place: a pipeline's stages are consecutive ranks, and D
  pipelines (dp_pp) each train their rows of the global batch. Stage s
  holds layers [s L/S, (s + 1) L/S); L % S != 0 raises ValueError, as in JAX.
- **Forward** (`PipelinedField`, the training loss's field,
  models/flow_matching.py). Every rank computes the time embedding and the
  context embedder (their gradients are each rank's own uses of the
  context); stage 0 embeds the nodes, its rows split into M contiguous
  microbatches. Microbatch m goes through each stage's layers in turn, each
  stage receiving it from the stage before and sending its output on (the
  side inputs, the key mask and the context, are microbatch m's on every
  stage, as JAX picks them by `clip(t - stage, 0, M - 1)`). The last stage
  concatenates the outputs and applies the final LayerNorm and the output
  embedder; the field's value (B, N, F) reaches every stage by a broadcast
  over the pipe group (JAX's masked psum of the output buffer), so every
  rank computes the same loss. The bubble ticks of JAX's scan compute
  nothing here.
- **Backward** (`PipelinedField.backward`), GPipe: all forwards, then all
  backwards, in reverse microbatch order. The last stage backpropagates the
  loss through the head to its microbatch outputs, every other stage
  receives each output's gradient from the stage after; each stage runs
  `torch.autograd.backward` on microbatch m's output and sends its input's
  gradient to the stage before; then the context's and (stage 0) the node
  embedding's gradients go back through their embedders once. Every
  parameter's gradient on a rank is that rank's part: a layer's on its
  stage only, the output embedder's and the final norm's on the last stage
  only, the node embedder's on stage 0 only, the context embedder's from
  each rank's own uses of it. So the step sums the gradients over every
  rank once (training/step.py), which also adds the D pipelines' rows.

The hops are `torch.distributed` send and recv between neighbours, each
under the torch.profiler range `particle_fm.pipe`. NCCL (one rank a card)
moves CUDA tensors directly; gloo (two ranks sharing one card, or the CPU)
stages CUDA tensors through host buffers. Tests emulate a pipe axis with
threads (`PipeAxis` takes any send, recv and broadcast).
"""

from __future__ import annotations

import dataclasses
from typing import Callable

import torch
import torch.distributed as tdist

PIPE_RANGE = "particle_fm.pipe"  # torch.profiler's name of a pipeline hop
MODEL = "droid_fulltransformer"


@dataclasses.dataclass(frozen=True)
class PipeAxis:
    """This rank's stage on the pipe axis (`stage` of `size`) and the hops
    over its pipeline: `send(t, j)` to stage j, `recv(buf, j)` from stage j
    into buf (returned), `broadcast(t, j)` stage j's t into every stage's t
    (returned)."""

    stage: int
    size: int
    send: Callable[[torch.Tensor, int], None]
    recv: Callable[[torch.Tensor, int], torch.Tensor]
    broadcast: Callable[[torch.Tensor, int], torch.Tensor]

    @property
    def first(self) -> bool:
        return self.stage == 0

    @property
    def last(self) -> bool:
        return self.stage == self.size - 1


def _no_hop(*_):
    raise RuntimeError("a one-stage pipeline has no neighbour")


def single_stage() -> PipeAxis:
    """The pipe axis of one stage (one process, or S = 1): no hops."""
    return PipeAxis(0, 1, _no_hop, _no_hop, lambda t, j: t)


def group_axis(ranks: list[int], stage: int, group) -> PipeAxis:
    """The pipe axis over the process `group` of `ranks` (global ranks in
    stage order); this rank is stage `stage`."""
    staged = tdist.get_backend() == "gloo"

    def host(t: torch.Tensor) -> bool:  # gloo moves host memory only
        return staged and t.is_cuda

    def send(t: torch.Tensor, j: int) -> None:
        buf = t.detach().contiguous()
        with torch.profiler.record_function(PIPE_RANGE):
            tdist.send(buf.cpu() if host(buf) else buf, dst=ranks[j])

    def recv(buf: torch.Tensor, j: int) -> torch.Tensor:
        with torch.profiler.record_function(PIPE_RANGE):
            into = torch.empty(buf.shape, dtype=buf.dtype) if host(buf) else buf
            tdist.recv(into, src=ranks[j])
            if into is not buf:
                buf.copy_(into)
        return buf

    def broadcast(t: torch.Tensor, j: int) -> torch.Tensor:
        with torch.profiler.record_function(PIPE_RANGE):
            tdist.broadcast(t, src=ranks[j], group=group)
        return t

    return PipeAxis(stage, len(ranks), send, recv, broadcast)


def pipe_axis(mesh) -> PipeAxis:
    """This rank's pipeline on a ProcessMesh (parallel/mesh.py) whose model
    axis is the pipe axis: the ranks of its data coordinate's row."""
    ranks = [mesh.data_rank * mesh.model + j for j in range(mesh.model)]
    return group_axis(ranks, mesh.model_rank, mesh.model_group)


def check_pipelined(model, stages: int) -> None:
    """JAX's refusals of a pipelined model (`make_pp_vector_field`,
    `pipeline_layers`, the loss's vf_fn): NotImplementedError for another
    family, n_transforms != 1 and the gaussian time embedding; ValueError
    for self_cond and for layers that the stages do not divide."""
    family = getattr(model, "model", None)
    if family != MODEL:
        raise NotImplementedError("pipeline parallelism is implemented for the deep droid "
                                  f"transformer stack (got model={family!r})")
    if model.n_transforms != 1:
        raise NotImplementedError("pp supports n_transforms=1")
    if model.t_emb == "gaussian":
        raise NotImplementedError("pp supports the parameter-free t embeddings")
    if model.self_cond:
        raise ValueError("self_cond is not supported with a vf_fn override (pp)")
    layers = dict(dict(model.net_config).get("te_config") or {}).get("num_layers", 3)
    check_layers(layers, stages)


def check_layers(layers: int, stages: int) -> None:
    if layers % stages:
        raise ValueError(
            f"num_layers ({layers}) must be divisible by pipeline stages ({stages})")


def check_batch(batch: int, microbatches: int, data: int) -> None:
    """A global batch the D pipelines and their M microbatches share evenly."""
    if batch % (microbatches * data):
        raise ValueError(
            f"batch ({batch}) must be divisible by microbatches*data ({microbatches}*{data})")


def _leaf(t: torch.Tensor | None) -> torch.Tensor | None:
    """t cut from its graph: a leaf that collects its gradient where t had one."""
    if t is None:
        return None
    return t.detach().requires_grad_(t.requires_grad)


class PipelinedField:
    """The vector field of a droid full transformer (`net`, a CNFStack of
    one flow) with its layer stack pipelined over `axis` in `microbatches`
    microbatches; `data` pipelines share the global batch. Called once, as
    the training loss's field (module docstring); then `backward(loss)`
    leaves this rank's part of every gradient in the parameters' `.grad`."""

    def __init__(self, net, axis: PipeAxis, microbatches: int, data: int = 1):
        self.cnf = net.flows[0]
        self.enc = self.cnf.net
        te = self.enc.te
        check_layers(te.num_layers, axis.size)
        per = te.num_layers // axis.size
        self.layers = range(axis.stage * per, (axis.stage + 1) * per)
        self.axis, self.microbatches, self.data = axis, microbatches, data
        self._run = None

    def __call__(self, t, y, cond=None, mask=None) -> torch.Tensor:
        if self._run is not None:
            raise RuntimeError("a PipelinedField runs one forward (one loss) a step")
        axis, enc, te, m = self.axis, self.enc, self.enc.te, self.microbatches
        b = y.shape[0]
        check_batch(b * self.data, m, self.data)
        emb, x = self.cnf.net_inputs(t, y)
        kv_mask = mask[..., 0] if mask is not None else None
        ctxt = enc.context(emb, cond)
        ctxt_in = _leaf(ctxt)
        if axis.first:
            h = enc.node_embd(x, ctxt)
        else:  # the shape and type of the activations received
            with torch.no_grad():
                h = enc.node_embd(x, ctxt)
        h_in = _leaf(h)
        rows = [slice(i * (b // m), (i + 1) * (b // m)) for i in range(m)]
        ins, outs = [], []
        for r in rows:
            if axis.first:
                xin = h_in[r]
            else:
                xin = axis.recv(torch.empty_like(h[r]), axis.stage - 1)
                xin.requires_grad_(torch.is_grad_enabled())
            out = te.run_layers(xin, None if kv_mask is None else kv_mask[r],
                                None if ctxt_in is None else ctxt_in[r], layers=self.layers)
            if not axis.last:
                axis.send(out, axis.stage + 1)
            ins.append(xin)
            outs.append(out)
        head_in = None
        if axis.last:
            head_in = _leaf(torch.cat(outs) if m > 1 else outs[0])
            v = enc.outp_embd(te.final_norm(head_in), ctxt_in)
            axis.broadcast(v.detach(), axis.size - 1)
        else:
            v = axis.broadcast(torch.empty(y.shape, dtype=h.dtype, device=y.device),
                               axis.size - 1)
        self._run = dict(rows=rows, ins=ins, outs=outs, head_in=head_in, h=h, h_in=h_in,
                         ctxt=ctxt, ctxt_in=ctxt_in)
        return v

    def backward(self, loss: torch.Tensor) -> None:
        """The backward pipeline of the forward's loss (every rank calls,
        with the loss its field gave)."""
        run, axis = self._run, self.axis
        if run is None:
            raise RuntimeError("PipelinedField.backward before its forward")
        if axis.last:
            loss.backward()  # the head: into its parameters, the context and head_in
        for i in reversed(range(self.microbatches)):
            out = run["outs"][i]
            if axis.last:
                g = run["head_in"].grad[run["rows"][i]]
            else:
                g = axis.recv(torch.empty_like(out), axis.stage + 1)
            out.backward(g)
            if not axis.first:
                xin = run["ins"][i]
                axis.send(xin.grad if xin.grad is not None else torch.zeros_like(xin),
                          axis.stage - 1)
        roots, grads = [], []
        if axis.first and run["h_in"].grad is not None:
            roots.append(run["h"])
            grads.append(run["h_in"].grad)
        if run["ctxt"] is not None and run["ctxt_in"].grad is not None:
            roots.append(run["ctxt"])
            grads.append(run["ctxt_in"].grad)
        if roots:
            torch.autograd.backward(roots, grads)
        self._run = None
