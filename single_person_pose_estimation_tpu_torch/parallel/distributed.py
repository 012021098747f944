"""Multi-process initialization, input sharding and metric aggregation.

The counterpart of the JAX package's `parallel/distributed.py`. Training
on several cards runs one process per card: launch it with `torchrun`
(which sets RANK, WORLD_SIZE, LOCAL_RANK, MASTER_ADDR and MASTER_PORT), call
`initialize()` once per process before building the mesh, feed each
process its own disjoint subset of record shards
(`shard_files_for_process`, through `DatasetBuilder(..., process_index,
process_count)`), and combine per-process validation means with
`aggregate_metrics`.

The per-FILE round-robin split mirrors the reference's shard-file layout
(file_{split}_%02i-%i.tfrec, ~2048 examples each), so processes stay
balanced to within one shard.
"""

from __future__ import annotations

import os
from datetime import timedelta
from typing import Dict, List, Optional, Sequence

import torch
import torch.distributed as dist

_CLUSTER_ENV = ("RANK", "WORLD_SIZE", "MASTER_ADDR", "MASTER_PORT")


def is_initialized() -> bool:
    return dist.is_available() and dist.is_initialized()


def initialize(coordinator_address: Optional[str] = None,
               num_processes: Optional[int] = None,
               process_id: Optional[int] = None,
               backend: Optional[str] = None,
               timeout_s: float = 300.0) -> bool:
    """Join the process group; returns whether this process is in one.

    A no-op (False) when the group already exists, or when no coordinator
    is named and the environment names no cluster (no WORLD_SIZE). With
    `coordinator_address` ("host:port") the caller gives `num_processes`
    and `process_id`; otherwise they come from `torchrun`'s environment.
    Failing to join a named coordinator or a cluster environment raises:
    it is never a quiet single-process run. `backend` defaults to "nccl"
    with CUDA and "gloo" without; with CUDA the process's current device
    becomes cuda:LOCAL_RANK.
    """
    if is_initialized():
        return True
    if coordinator_address is None:
        if "WORLD_SIZE" not in os.environ:
            return False
        missing = [k for k in _CLUSTER_ENV if k not in os.environ]
        if missing:
            raise RuntimeError(f"the cluster environment lacks {missing}; "
                               "launch with torchrun")
        init_method = "env://"
        num_processes = int(os.environ["WORLD_SIZE"])
        process_id = int(os.environ["RANK"])
    else:
        if num_processes is None or process_id is None:
            raise ValueError("a named coordinator needs num_processes and "
                             "process_id")
        init_method = f"tcp://{coordinator_address}"
    if backend is None:
        backend = "nccl" if torch.cuda.is_available() else "gloo"
    if torch.cuda.is_available():
        torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", process_id))
                              % torch.cuda.device_count())
    dist.init_process_group(backend, init_method=init_method,
                            world_size=num_processes, rank=process_id,
                            timeout=timedelta(seconds=timeout_s))
    return True


def shard_files_for_process(filenames: Sequence[str],
                            process_index: Optional[int] = None,
                            process_count: Optional[int] = None,
                            allow_replicate: bool = False) -> List[str]:
    """Disjoint round-robin file subset for this process (by default the
    rank and world size of the process group, or 0 and 1 without one).

    Every shard file holds (up to) the same number of examples, so a
    round-robin split keeps per-process example counts within one shard
    of each other. With fewer files than processes, some processes would
    receive no files: raise instead, since a process contributing empty
    batches would deadlock the collectives, unless `allow_replicate`
    (validation), where every process reads every file.
    """
    if process_index is None:
        process_index = dist.get_rank() if is_initialized() else 0
    if process_count is None:
        process_count = dist.get_world_size() if is_initialized() else 1
    if process_count == 1:
        return list(filenames)
    if len(filenames) < process_count:
        if allow_replicate:
            return list(filenames)
        raise ValueError(
            f"{len(filenames)} shard files cannot feed {process_count} "
            "processes; regenerate records with more shards "
            "(smaller num_examples_per_record)")
    return list(filenames)[process_index::process_count]


def aggregate_metrics(metrics: Dict[str, float], weight: float = 1.0,
                      group=None) -> Dict[str, float]:
    """Weighted mean of scalar metrics across the processes of `group`
    (default: the whole process group).

    When each process evaluates its own record shards, the per-process
    means must be combined by example count before any decision is taken
    on them; otherwise processes with uneven shards disagree on val_loss
    and the best-checkpoint promotion diverges across the cluster.

    A COLLECTIVE: every process calls it with the same keys (values and
    weights may differ). `weight` is the number of examples behind this
    process's means. Every process returns the same dict, sum_p(w_p *
    v_p) / sum_p(w_p) per key, from one all_reduce. Without a group (or
    with one process): the metrics as floats.
    """
    if not is_initialized() or dist.get_world_size(group) == 1:
        return {k: float(v) for k, v in metrics.items()}
    keys = sorted(metrics)
    device = torch.device("cuda", torch.cuda.current_device()) \
        if dist.get_backend(group) == "nccl" else torch.device("cpu")
    w = float(weight)
    buf = torch.tensor([w] + [float(metrics[k]) * w for k in keys],
                       dtype=torch.float64, device=device)
    dist.all_reduce(buf, group=group)
    sums = buf.cpu().tolist()
    if sums[0] <= 0:
        raise ValueError("aggregate_metrics: total weight must be > 0")
    return {k: sums[1 + i] / sums[0] for i, k in enumerate(keys)}


class _AllReduceSum(torch.autograd.Function):
    """y = sum over the group of x; the backward sums the cotangents over
    the group too, so each rank's gradient reaches every rank's input."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        y = x.clone()
        dist.all_reduce(y, group=group)
        return y

    @staticmethod
    def backward(ctx, g):
        g = g.clone()
        dist.all_reduce(g, group=ctx.group)
        return g, None


def all_reduce_sum(x: torch.Tensor, group) -> torch.Tensor:
    """The sum of `x` over the processes of `group`, differentiable: what
    each rank's loss owes to the sum flows back to every rank's `x`."""
    return _AllReduceSum.apply(x, group)
