"""Data parallelism over several devices: the mesh (`mesh.py`) and the
multi-process runtime (`distributed.py`).

The counterpart of the JAX package's `parallel/{mesh,distributed}.py`.
Training runs one process per card (`torchrun`), joined by a
`torch.distributed` process group; evaluation and serving run one process
that keeps a model replica per device. The tensor-parallel, pipeline and
spatial modules of the JAX package's `parallel/` are not ported (ROADMAP
Queue 1, the other parallel/ modules).
"""
