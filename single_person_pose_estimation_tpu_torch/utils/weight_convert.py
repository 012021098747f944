"""JAX/flax variables (as numpy arrays) -> the port's `state_dict`.

Accepts either the nested `{"params": {...}, "batch_stats": {...}}` tree
that `model.init` returns (leaves may be any array convertible by numpy),
or the flat `var/params/<layer>/<leaf>` keys of the golden fixtures
(`tests/fixtures/golden_ref_*.npz`).

  conv  kernel (kh, kw, in, out) HWIO -> weight (out, in, kh, kw) OIHW
        bias                           -> bias
  separable (mobile) depthwise/kernel (k, k, 1, C) -> depthwise.weight
        (C, 1, k, k); pointwise/kernel (1, 1, C, out) -> pointwise.weight
        (out, C, 1, 1); pointwise/bias -> pointwise.bias
  BN    scale / bias                   -> weight / bias
        mean / var (batch_stats)       -> running_mean / running_var

A tree without `batch_stats` (a gradient, or an optimizer moment, shaped
like `params`) converts to the parameters' entries alone.
`load_train_state` loads a JAX `TrainState` (its `params` and
`batch_stats`), so a test starts both packages from the same numbers.

`init_variables` makes flax-layout variables with numpy alone, so a machine
without JAX can build a model of any size from a seed.
"""

from __future__ import annotations

from typing import Mapping

import numpy as np
import torch

from single_person_pose_estimation_tpu_torch.models.hourglass import (
    hourglass_specs,
)


def unflatten(flat: Mapping[str, np.ndarray]) -> dict:
    """Flat `var/<collection>/<layer>/<leaf>` keys -> nested variables."""
    out: dict = {}
    for key, value in flat.items():
        if not key.startswith("var/"):
            continue
        node = out
        *path, leaf = key[len("var/"):].split("/")
        for part in path:
            node = node.setdefault(part, {})
        node[leaf] = np.asarray(value)
    return out


def _conv_entries(sd: dict, prefix: str, leaves: Mapping):
    k = np.asarray(leaves["kernel"], np.float32)
    sd[f"{prefix}.weight"] = torch.from_numpy(
        np.ascontiguousarray(k.transpose(3, 2, 0, 1)))
    if "bias" in leaves:
        sd[f"{prefix}.bias"] = torch.from_numpy(
            np.asarray(leaves["bias"], np.float32).copy())


def to_state_dict(variables: Mapping) -> dict:
    """Flax variables (nested or flat fixture keys) -> torch state_dict."""
    if "params" not in variables:
        variables = unflatten(variables)
    params = variables["params"]
    stats = variables.get("batch_stats", {})
    sd = {}
    for layer, leaves in params.items():
        if "kernel" in leaves:
            _conv_entries(sd, layer, leaves)
        elif set(leaves) == {"depthwise", "pointwise"}:
            _conv_entries(sd, f"{layer}.depthwise", leaves["depthwise"])
            _conv_entries(sd, f"{layer}.pointwise", leaves["pointwise"])
        elif "scale" in leaves:
            sd[f"{layer}.weight"] = torch.from_numpy(
                np.asarray(leaves["scale"], np.float32).copy())
            sd[f"{layer}.bias"] = torch.from_numpy(
                np.asarray(leaves["bias"], np.float32).copy())
            st = stats.get(layer)
            if st is not None:
                sd[f"{layer}.running_mean"] = torch.from_numpy(
                    np.asarray(st["mean"], np.float32).copy())
                sd[f"{layer}.running_var"] = torch.from_numpy(
                    np.asarray(st["var"], np.float32).copy())
        else:
            raise ValueError(f"unsupported layer {layer!r}: leaves "
                             f"{sorted(leaves)}")
    return sd


def to_variables(state_dict: Mapping) -> dict:
    """The port's `state_dict` (or a model) -> flax variables as float32
    numpy arrays: the inverse of `to_state_dict`. Entries other than
    weights, biases and running statistics (`num_batches_tracked`) are
    left out."""
    if isinstance(state_dict, torch.nn.Module):
        state_dict = state_dict.state_dict()
    params: dict = {}
    stats: dict = {}
    arr = lambda t: t.detach().float().cpu().numpy().copy()
    for key, t in state_dict.items():
        layer, _, leaf = key.rpartition(".")
        if leaf in ("running_mean", "running_var"):
            stats.setdefault(layer, {})[leaf[len("running_"):]] = arr(t)
            continue
        if leaf not in ("weight", "bias"):
            continue
        layer, _, part = layer.partition(".")
        node = params.setdefault(layer, {})
        if part:                       # a separable conv's two convs
            node = node.setdefault(part, {})
        if t.dim() == 4:
            node["kernel"] = np.ascontiguousarray(
                arr(t).transpose(2, 3, 1, 0))
        elif leaf == "weight":         # a BN's scale
            node["scale"] = arr(t)
        else:
            node["bias"] = arr(t)
    return {"params": params, "batch_stats": stats}


def load_variables(model: torch.nn.Module, variables: Mapping):
    """Load flax variables into `model`; every parameter and running
    statistic must be covered, and nothing extra may be given."""
    sd = to_state_dict(variables)
    missing, unexpected = model.load_state_dict(sd, strict=False)
    missing = [k for k in missing if not k.endswith("num_batches_tracked")]
    if missing or unexpected:
        raise KeyError(f"variables do not fit the model: missing {missing}, "
                       f"unexpected {unexpected}")
    return model


def load_train_state(model: torch.nn.Module, state):
    """Load a JAX `TrainState`'s params and BN statistics into `model`
    (any object with `params` and `batch_stats` trees of arrays)."""
    return load_variables(model, {"params": state.params,
                                  "batch_stats": state.batch_stats})


def init_variables(num_stacks: int, num_channels: int, seed: int = 0,
                   num_classes: int = 17, mobile: bool = False) -> dict:
    """Flax-layout variables of the standard (or mobile) model, made with
    numpy: test data, for both packages to load.

    Conv kernels are glorot-uniform and biases zero, as flax initialises
    the JAX model; BN scale is 1 and bias 0; the running mean and variance
    are drawn uniformly from [0.5, 1.5] so the BN fold is exercised. A
    separable conv's pointwise kernel is a 1x1 conv's. Its depthwise kernel
    (k, k, 1, C) is NOT drawn as flax draws it: it is glorot-uniform per
    channel (fan-in and fan-out k*k). Flax's glorot counts fan-out k*k*C,
    which draws the 1x1 depthwise scales within +-0.15 at C=256 and
    shrinks every bottleneck's share of the residual stream; a random
    mobile S4/256 drawn that way puts out last-stack heatmap channels that
    are each a constant 0 or 1.
    """
    rng = np.random.default_rng(seed)

    def glorot(k, cin, cout):
        lim = np.sqrt(6.0 / (k * k * (cin + cout)))
        return rng.uniform(-lim, lim, (k, k, cin, cout)).astype(np.float32)

    params, stats = {}, {}
    for name, kind, cin, cout, k in hourglass_specs(num_stacks, num_channels,
                                                    num_classes, mobile):
        if kind == "conv":
            params[name] = {"kernel": glorot(k, cin, cout),
                            "bias": np.zeros(cout, np.float32)}
        elif kind == "sep":
            lim = np.sqrt(3.0 / (k * k))
            params[name] = {
                "depthwise": {"kernel": rng.uniform(-lim, lim, (k, k, 1, cin))
                                           .astype(np.float32)},
                "pointwise": {"kernel": glorot(1, cin, cout),
                              "bias": np.zeros(cout, np.float32)}}
        else:
            params[name] = {"scale": np.ones(cout, np.float32),
                            "bias": np.zeros(cout, np.float32)}
            stats[name] = {
                "mean": rng.uniform(0.5, 1.5, cout).astype(np.float32),
                "var": rng.uniform(0.5, 1.5, cout).astype(np.float32)}
    return {"params": params, "batch_stats": stats}
