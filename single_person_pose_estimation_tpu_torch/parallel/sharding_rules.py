"""Tensor parallelism over channels: the rule that splits a leaf over the
"model" axis, the collectives of the model group, and the sharding of a
train state.

The counterpart of the JAX package's `parallel/sharding_rules.py`, leaf
for leaf (`leaf_spec` is JAX `_leaf_spec`): a 4-D conv weight is split on
its output channels when the model axis size m divides them; a 1-D vector
of length >= 16 that m divides (a bias, a BN scale, shift or running
statistic, and the Adam moments and EMA copy of any of these) is split;
every other leaf is replicated (the 17-channel predict conv, scalars, the
generator). Torch's conv weight is (O, I, kH, kW) and the depthwise
weight (C, 1, k, k), so the split dimension is 0 here where flax's is the
last.

JAX shards the state and lets GSPMD place the collectives. Here
`shard_state` keeps on each rank only its slice of every split leaf (the
parameter, so also its `.grad` and its Adam moments, and its EMA copy) and
hands the model a `TensorParallel`, with which it runs column-parallel, as
Megatron-LM's MLP does:

* a conv whose weight is split computes this rank's output channels from
  the whole input; its bias, ReLU and BN act on that channel slice
  (train-mode BN statistics are per channel, so they reduce over the data
  group only), and `gather` rebuilds every channel before the next layer;
* `gather`'s backward keeps the rank's slice of the cotangent, because
  everything after it runs replicated; `enter`, the identity at a split
  conv's input, all-reduces that input's gradient over the model group;
* a conv whose output channels m does not divide runs replicated on every
  rank of the model group, from the same inputs; its gradients come out
  equal there only up to the order of the library's sums (cuDNN's
  float32 weight gradients may add in any order), so the train step
  takes them from the group's first rank (`reduce_grads`);
* a vector that the rule replicates but whose conv is split (length < 16)
  is read through `view`, the rank's slice: its gradient is nonzero only
  on that slice, and the train step sums it over the model group
  (`partial`). Its running statistics take the statistics gathered over
  the model group.

The gather is an all_reduce of a zero-filled full tensor into which each
rank writes its slice (a sum whose other terms are zero is exact), on
every backend: gloo has no reduce_scatter, torch's gloo backend lists no
all_gather of CUDA tensors, and NCCL refuses two ranks on one card, so
the tests (gloo on the CPU) and a one-card machine (gloo on cuda:0) reach
the model axis through all_reduce alone, and the path under test is the
path that runs. An unsupported backend or device raises.
"""

from __future__ import annotations

import itertools
from dataclasses import dataclass, field
from typing import Any, Callable, Optional, Sequence

import torch
import torch.distributed as dist

BACKENDS = ("gloo", "nccl")


def leaf_spec(leaf, axis_size: int) -> Optional[int]:
    """The dimension of `leaf` split over a model axis of `axis_size`
    ranks, or None when the leaf is replicated (JAX `_leaf_spec`, with
    torch's output-channel dimension 0)."""
    shape = tuple(getattr(leaf, "shape", ()))
    if len(shape) == 4 and shape[0] % axis_size == 0:
        return 0        # conv weight (O, I, kH, kW): output channels
    if len(shape) == 1 and shape[0] % axis_size == 0 and shape[0] >= 16:
        return 0        # channel vectors and their Adam moments
    return None


def _dense(t: torch.Tensor) -> torch.Tensor:
    """`t`, or its NHWC view when it is an NCHW tensor in channels_last:
    a tensor contiguous in the default sense, for an in-place
    collective."""
    if t.is_contiguous():
        return t
    if t.dim() == 4 and t.is_contiguous(memory_format=torch.channels_last):
        return t.permute(0, 2, 3, 1)
    raise ValueError(f"a collective needs a dense tensor, got strides "
                     f"{t.stride()} of shape {tuple(t.shape)}")


def _zeros(shape, like: torch.Tensor) -> torch.Tensor:
    cl = like.dim() == 4 and not like.is_contiguous() \
        and like.is_contiguous(memory_format=torch.channels_last)
    return torch.empty(shape, dtype=like.dtype, device=like.device,
                       memory_format=torch.channels_last if cl
                       else torch.contiguous_format).zero_()


@dataclass(frozen=True, eq=False)
class TensorParallel:
    """This rank's place in its model group and the collectives over it.

    `size` ranks split the channels; this one holds slice `index`.
    `split`: the state_dict names of the split leaves. `partial`: the
    parameter names that the rule replicates but the forward reads
    through `view`, whose gradients `reduce_grads` sums over the group.
    `traffic`: the all_reduce calls this rank made over the group and the
    bytes of the tensors they reduced, since the state was sharded."""

    group: Any
    size: int
    index: int
    split: frozenset = frozenset()
    partial: frozenset = frozenset()
    traffic: dict = field(default_factory=lambda: {"calls": 0, "bytes": 0})

    def __post_init__(self):
        backend = dist.get_backend(self.group)
        if backend not in BACKENDS:
            raise ValueError(f"tensor parallelism runs over {BACKENDS}, "
                             f"not {backend!r}")

    def is_split(self, name: str) -> bool:
        return name in self.split

    def local(self, t: torch.Tensor, dim: int = 0) -> torch.Tensor:
        """This rank's 1/size of `t` along `dim` (a view)."""
        n = t.shape[dim] // self.size
        return t.narrow(dim, self.index * n, n)

    def view(self, t: torch.Tensor, name: str) -> torch.Tensor:
        """The slice of leaf `name` that this rank's channels read: the
        leaf itself when it is split, else its local slice."""
        return t if name in self.split else self.local(t)

    def sum_(self, t: torch.Tensor) -> torch.Tensor:
        """All-reduce `t` in place over the model group (no autograd)."""
        backend = dist.get_backend(self.group)
        if t.device.type not in ("cpu", "cuda") or (
                backend == "nccl" and t.device.type != "cuda"):
            raise ValueError(f"the {backend} model group cannot reduce a "
                             f"tensor on {t.device}")
        dist.all_reduce(_dense(t), group=self.group)
        self.traffic["calls"] += 1
        self.traffic["bytes"] += t.numel() * t.element_size()
        return t

    def gather_(self, t: torch.Tensor, dim: int = 0) -> torch.Tensor:
        """Every rank's `t` side by side along `dim`, in rank order (no
        autograd): an all_reduce of a zero-filled tensor in which each
        rank wrote its own."""
        shape = list(t.shape)
        shape[dim] *= self.size
        full = _zeros(shape, t)
        self.local(full, dim).copy_(t)
        return self.sum_(full)

    def gather_list_(self, ts: Sequence[torch.Tensor]) -> list:
        """gather_ along dim 0 of every tensor of `ts`, in one all_reduce
        of a flat buffer a dtype (a state holds thousands of split
        leaves)."""
        out = list(ts)
        for dtype in {t.dtype for t in ts}:
            idx = [i for i, t in enumerate(ts) if t.dtype == dtype]
            sizes = [ts[i].numel() * self.size for i in idx]
            flat = ts[idx[0]].new_zeros(sum(sizes))
            for i, part in zip(idx, flat.split(sizes)):
                out[i] = part.view(-1, *ts[i].shape[1:])
                self.local(out[i]).copy_(ts[i])
            self.sum_(flat)
        return [t.clone() for t in out]

    def local_list(self, ts: Sequence[torch.Tensor]) -> list:
        """A copy of this rank's slice along dim 0 of every tensor."""
        return [self.local(t).clone() for t in ts]

    def gather(self, t: torch.Tensor, dim: int = 1) -> torch.Tensor:
        """gather_ under autograd: the backward keeps this rank's slice."""
        return _Gather.apply(t, self, dim)

    def enter(self, t: torch.Tensor) -> torch.Tensor:
        """The identity at a split conv's input; the backward sums the
        input's gradient over the model group."""
        return _Enter.apply(t, self)

    def on_first(self, t: torch.Tensor) -> torch.Tensor:
        """`t` on the group's first rank and zeros on the others, so that
        a sum over the group counts it once."""
        return t if self.index == 0 else torch.zeros_like(t)

    def reduce_grads(self, named_params) -> None:
        """Give every rank of the model group the same gradient of each
        replicated parameter, in one all_reduce of a flat buffer: a
        `partial` one summed over the group (each rank's is nonzero only
        on its slice, so the sum is exact), any other the group's first
        rank's (the others add zeros)."""
        grads = [(n in self.partial, p.grad) for n, p in named_params
                 if n not in self.split and p.grad is not None]
        if not grads:
            return
        flat = self.sum_(torch.cat([
            (g if part else self.on_first(g)).reshape(-1)
            for part, g in grads]))
        grads = [g for _, g in grads]
        for g, part in zip(grads, flat.split([g.numel() for g in grads])):
            g.copy_(part.view_as(g))


class _Gather(torch.autograd.Function):

    @staticmethod
    def forward(ctx, t, tp, dim):
        ctx.tp, ctx.dim = tp, dim
        return tp.gather_(t, dim)

    @staticmethod
    def backward(ctx, g):
        return ctx.tp.local(g, ctx.dim), None, None


class _Enter(torch.autograd.Function):

    @staticmethod
    def forward(ctx, t, tp):
        ctx.tp = tp
        return t.view_as(t)

    @staticmethod
    def backward(ctx, g):
        return ctx.tp.sum_(g.clone()), None


def map_split_leaves(payload: dict, param_names: Sequence[str],
                     tp: TensorParallel, fn: Callable) -> dict:
    """A copy of a state payload (training/checkpoint.py's layout) in
    which the leaves that `tp` splits, the model's split entries, the Adam
    moments of split parameters (`param_names` in the optimizer's order)
    and their EMA copies, take the values `fn` maps their list to, in one
    call. Nothing in `payload` is changed."""
    opt = payload["optimizer"]
    model = dict(payload["model"])
    moments = {i: dict(s) for i, s in opt["adam"]["state"].items()}
    ema = None if opt["ema"] is None else dict(opt["ema"])
    slots = [(model, n) for n in model if n in tp.split]
    slots += [(s, k) for i, s in moments.items() if param_names[i] in tp.split
              for k, v in s.items() if torch.is_tensor(v) and v.dim()]
    slots += [(ema, n) for n in ema or () if n in tp.split]
    for (d, k), v in zip(slots, fn([d[k] for d, k in slots])):
        d[k] = v
    return {**payload, "model": model,
            "optimizer": {**opt, "adam": {**opt["adam"], "state": moments},
                          "ema": ema}}


def shard_state(state, mesh, model_axis: Optional[str] = "model"):
    """Keep on this rank only its slice of every leaf that `leaf_spec`
    splits over `mesh`'s model axis (the model's parameters and buffers,
    their Adam moments and EMA copies) and hand the model its
    `TensorParallel`. Changes `state` in place and returns it.
    model_axis None leaves the state replicated, as the JAX package's
    does; an axis that the mesh lacks raises ValueError."""
    if model_axis is None:
        return state
    if model_axis not in mesh.axis_names:
        raise ValueError(f"model_axis {model_axis!r} not in mesh axes "
                         f"{mesh.axis_names}")
    model, opt = state.model, state.optimizer
    if model.tensor_parallel is not None:
        raise ValueError("the state is sharded already")
    m = mesh.model_size
    sd = model.state_dict()
    split = frozenset(n for n, t in sd.items()
                      if leaf_spec(t, m) is not None)
    partial = frozenset(n for n, p in model.named_parameters()
                        if n not in split and p.dim() == 1
                        and p.shape[0] % m == 0)
    tp = TensorParallel(mesh.model_group, m, mesh.model_index, split,
                        partial)
    local = map_split_leaves(
        {"model": sd, "optimizer": opt.state_dict()}, list(opt.params), tp,
        tp.local_list)
    with torch.no_grad():
        for n, t in itertools.chain(model.named_parameters(),
                                    model.named_buffers()):
            if n in split:
                t.data = local["model"][n]
    opt.adam.load_state_dict(local["optimizer"]["adam"])
    opt.ema = local["optimizer"]["ema"]
    model.tensor_parallel = tp
    return state
