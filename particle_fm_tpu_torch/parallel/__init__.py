"""Data-parallel and fully-sharded training across processes; counterpart of
particle_fm_tpu/parallel/ (the `dp` and `fsdp` strategies).

`dist.py`: the process group, ranks, rank-split batches and draws, and the
collectives; `fsdp.py`: FSDP2 placement by the JAX package's rule.
"""
