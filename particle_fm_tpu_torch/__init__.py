"""PyTorch/CUDA port of particle_fm_tpu.

The package mirrors the JAX package's module paths (`nets/common.py` here is
the counterpart of `particle_fm_tpu/nets/common.py`, and so on). It imports
torch, numpy and the standard library only: nothing of JAX and nothing of
`particle_fm_tpu`.

Ported so far: the flow-matching samplers of the EPiC, PC-Droid transformer
and MDMA families (FM-OT, CFM, CFM-OT; fixed-step ODE solvers) and their
serving entry points, with the TPU kernels as hand-written CUDA kernels
(`csrc/`, wrappers in `ops/`, each entry point a `torch.library` custom op);
and single-device training of FM-OT and CFM models (`train.py`,
`training/`, `losses/`, `data/`, `config/`). Later slices added every loss
family, dataset and experiment, evaluation, the classifiers, the served
artifact with its HTTP server (`serving.py`, `server.py`) and ReFlow and
consistency distillation (`training/reflow.py`, `training/consistency.py`).

Entry points run on the card (`device="cuda"`) unless the caller passes
`device="cpu"`; without CUDA they raise rather than move work to the CPU.
"""
