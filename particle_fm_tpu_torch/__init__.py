"""PyTorch/CUDA port of particle_fm_tpu.

The package mirrors the JAX package's module paths (`nets/common.py` here is
the counterpart of `particle_fm_tpu/nets/common.py`, and so on). It imports
torch, numpy and the standard library only: nothing of JAX and nothing of
`particle_fm_tpu`.

Ported so far: the EPiC flow-matching sampler (FM-OT family, fixed-step ODE
solvers) and its serving entry points, with the fused EPiC layer as a hand-written
CUDA kernel (`csrc/epic_layer.cu`, wrapper in `ops/epic_layer.py`).

Entry points run on the card (`device="cuda"`) unless the caller passes
`device="cpu"`; without CUDA they raise rather than move work to the CPU.
"""
