"""Parallelism over several devices: the mesh (`mesh.py`), the
multi-process runtime (`distributed.py`), tensor parallelism over channels
(`sharding_rules.py`), H-sharded inference (`spatial.py`,
`spatial_model.py`) and the GPipe pipeline over stacks (`pipeline.py`).

The counterpart of the JAX package's `parallel/`. Training runs one
process per card (`torchrun`), joined by a `torch.distributed` process
group, over a ("data",) or a ("data", "model") mesh; evaluation and
serving run one process that keeps a model replica per device, and
`spatial_apply` one process that splits the rows of each map over its
devices. The pipeline runs one process over the P devices of a ("pipe",)
mesh, stage p on device p, or one process per data index of a
("data", "pipe") mesh, each over its own P devices.
"""
