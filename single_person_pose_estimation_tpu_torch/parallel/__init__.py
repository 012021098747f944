"""Parallelism over several devices: the mesh (`mesh.py`), the
multi-process runtime (`distributed.py`), tensor parallelism over channels
(`sharding_rules.py`) and H-sharded inference (`spatial.py`,
`spatial_model.py`).

The counterpart of the JAX package's `parallel/`. Training runs one
process per card (`torchrun`), joined by a `torch.distributed` process
group, over a ("data",) or a ("data", "model") mesh; evaluation and
serving run one process that keeps a model replica per device, and
`spatial_apply` one process that splits the rows of each map over its
devices. The GPipe pipeline (JAX `parallel/pipeline.py`, a "pipe" axis) is
not ported (ROADMAP Queue 1, the other parallel/ modules).
"""
