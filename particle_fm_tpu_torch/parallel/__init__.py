"""Training across processes; counterpart of particle_fm_tpu/parallel/
(the `dp`, `fsdp`, `dp_tp`, `sp` and `dp_ep` strategies).

`dist.py`: the process group, ranks, rank-split batches and draws, and the
collectives; `fsdp.py`: FSDP2 placement by the JAX package's rule;
`mesh.py`: the (data, model) mesh and the model axis's differentiable
collectives; `tp.py`: the tensor and expert placements (`epic_tp_rules`,
`moe_ep_rules`).
"""
