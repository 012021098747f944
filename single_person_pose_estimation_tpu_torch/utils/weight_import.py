"""TF/Keras weights -> the flax-layout variables the port loads.

The counterpart of the JAX package's `utils/weight_import.py`. The
reference publishes Keras weights (S4_E120_Adam_IOU etc.); these functions
read a Keras model, a `.weights.h5` file, a TF checkpoint (both object-graph
layouts) or a SavedModel into the `{"params": ..., "batch_stats": ...}`
tree of numpy arrays that `utils/weight_convert.load_variables` loads into
the port's StackedHourglass unchanged (and that the JAX package's model
takes as it is). TensorFlow and Keras are imported inside the functions
that need them, never when this module is imported: a machine without
TensorFlow (the card's) imports it and uses the rest of the port.

Mapping rules (the model mirrors the reference's layer names exactly):
  * Conv2D `name`            -> params[name] {kernel (H,W,I,O), bias} —
                                identical layouts, no transpose needed;
  * SeparableConv2D `name`   -> params[name]{depthwise{kernel}, pointwise
                                {kernel, bias}}; Keras depthwise kernel is
                                (k, k, C, 1) vs flax's (k, k, 1, C);
  * BatchNormalization       -> named `<preceding conv>_bn` here; Keras
                                auto-names them, but each BN directly
                                follows its conv in layer-creation order,
                                so pairing by order is exact;
  * gamma/beta               -> params[bn]{scale, bias};
    moving mean/variance     -> batch_stats[bn]{mean, var}.
"""

from __future__ import annotations

from typing import Any, Dict, Tuple

import numpy as np


def _np(a) -> np.ndarray:
    return np.asarray(a, np.float32)


def _producing_layer(tensor):
    """The layer that produced `tensor` (Keras 2 and 3 compatible)."""
    hist = tensor._keras_history
    op = getattr(hist, "operation", None)
    if op is not None:
        return op
    return hist[0]


def keras_to_flax_variables(keras_model) -> Dict[str, Any]:
    """Convert a Keras hourglass (reference architecture + naming) into
    flax-layout variables {"params": ..., "batch_stats": ...} of numpy
    arrays, for `weight_convert.load_variables`.

    Each BatchNormalization is paired with the conv that PRODUCES ITS INPUT
    (graph edge, not layer-list order — Keras' topological layer ordering
    interleaves bottleneck skip convs between a conv and its BN)."""
    params: Dict[str, Any] = {}
    batch_stats: Dict[str, Any] = {}

    for layer in keras_model.layers:
        cls = type(layer).__name__
        if cls == "Conv2D":
            kernel, bias = layer.get_weights()
            params[layer.name] = {"kernel": _np(kernel),
                                  "bias": _np(bias)}
        elif cls == "SeparableConv2D":
            dw, pw, bias = layer.get_weights()
            params[layer.name] = {
                "depthwise": {"kernel": _np(
                    np.transpose(dw, (0, 1, 3, 2)))},
                "pointwise": {"kernel": _np(pw),
                              "bias": _np(bias)},
            }
        elif cls == "BatchNormalization":
            src = _producing_layer(layer.input)
            if type(src).__name__ not in ("Conv2D", "SeparableConv2D"):
                raise ValueError(
                    f"BN {layer.name} input produced by {src.name!r}, "
                    "expected a conv")
            gamma, beta, mean, var = layer.get_weights()
            bn = src.name + "_bn"
            params[bn] = {"scale": _np(gamma),
                          "bias": _np(beta)}
            batch_stats[bn] = {"mean": _np(mean),
                               "var": _np(var)}
    return {"params": params, "batch_stats": batch_stats}


def flax_to_keras_weights(variables: Dict[str, Any], keras_model) -> None:
    """Write flax-layout variables back into a Keras model (the inverse
    mapping), e.g. `weight_convert.to_variables(model)` of trained port
    weights, for TF serving."""
    params = variables["params"]
    stats = variables["batch_stats"]
    for layer in keras_model.layers:
        cls = type(layer).__name__
        if cls == "Conv2D":
            p = params[layer.name]
            layer.set_weights([np.asarray(p["kernel"]), np.asarray(p["bias"])])
        elif cls == "SeparableConv2D":
            p = params[layer.name]
            layer.set_weights([
                np.transpose(np.asarray(p["depthwise"]["kernel"]),
                             (0, 1, 3, 2)),
                np.asarray(p["pointwise"]["kernel"]),
                np.asarray(p["pointwise"]["bias"]),
            ])
        elif cls == "BatchNormalization":
            bn = _producing_layer(layer.input).name + "_bn"
            layer.set_weights([
                np.asarray(params[bn]["scale"]),
                np.asarray(params[bn]["bias"]),
                np.asarray(stats[bn]["mean"]),
                np.asarray(stats[bn]["var"]),
            ])


# ---------------------------------------------------------------------------
# Checkpoint FILE loaders.
#
# The reference publishes weights as real files: TF-checkpoint-format
# weight files written by Keras-2 `model.save_weights('....ckpt')`
# (reference trainer.py:63-64, utilities/model_utils.py:5-21) and
# SavedModel exports (save_model.ipynb cells 3-5, loaded at
# evaluation.ipynb cell 6). The loaders below read those artifacts from
# the FILE PATH into flax-layout variables.
#
# Mapping strategy: conv layers carry the reference's explicit names
# (hourglass.py:59,193-200) and map directly; BatchNormalization layers
# are auto-named by Keras ('batch_normalization_N'), so they are ordered
# by their numeric suffix — Keras's name counter increments at layer
# CREATION, so suffix order == creation order — and zipped against
# `bn_conv_sequence`, the architecture's deterministic creation-order
# list of BN-carrying convs (derived from the reference source's layer
# creation order, hourglass.py:54-231). Every pairing is cross-checked
# by channel count (BN gamma dim == conv output channels).
# ---------------------------------------------------------------------------


def bn_conv_sequence(num_stacks: int) -> list:
    """Creation-order list of conv layer names followed by a
    BatchNormalization, for the reference architecture at `num_stacks`
    (channel count does not affect the order). Mirrors the Python
    execution order of the reference's create_hourglass_model
    (hourglass.py:5-32): front module, then per stack downsample f1-f8,
    bottom f8_1-3, upsample f8/f4/f2/f1 (short then merged), head.
    Skip convs (hourglass.py:193) and the 1x1 head convs after the first
    (hourglass.py:83-88) have no BN."""
    seq = ["front_conv_1x1_1"]

    def bneck(name):
        seq.extend([name + "_conv_1x1_1", name + "_conv_3x3_2",
                    name + "_conv_1x1_3"])

    bneck("front_bottleneck_1")
    bneck("front_bottleneck_2")
    bneck("front_bottleneck_3")
    for i in range(num_stacks):
        n = f"hg{i}"
        for lvl in ("f1", "f2", "f4", "f8"):
            bneck(f"{n}_downsample_{lvl}")
        for j in (1, 2, 3):
            bneck(f"{n}_downsample_f8_{j}")
        for lvl in ("f8", "f4", "f2", "f1"):
            bneck(f"{n}_upsample_{lvl}_short")
            bneck(f"{n}_upsample_{lvl}_merged")
        seq.append(f"{n}_conv_1x1_1")
    return seq


def _bn_suffix(name: str) -> int:
    """'batch_normalization' -> -1, 'batch_normalization_12' -> 12."""
    tail = name.rsplit("_", 1)[-1]
    return int(tail) if tail.isdigit() else -1


def _infer_num_stacks(conv_names) -> int:
    import re

    stacks = [int(m.group(1)) for m in
              (re.match(r"hg(\d+)_", n) for n in conv_names) if m]
    if not stacks:
        raise ValueError("no hg<i>_* conv layers found — not a stacked-"
                         "hourglass weight file?")
    return max(stacks) + 1


def _conv_entry(ws):
    """Keras conv weight list -> flax param dict. 2 tensors = Conv2D
    (kernel, bias); 3 = SeparableConv2D (depthwise (k,k,C,1) -> flax
    (k,k,1,C), pointwise, bias)."""
    if len(ws) == 2:
        return {"kernel": _np(ws[0]), "bias": _np(ws[1])}
    if len(ws) == 3:
        return {
            "depthwise": {"kernel": _np(
                np.transpose(ws[0], (0, 1, 3, 2)))},
            "pointwise": {"kernel": _np(ws[1]),
                          "bias": _np(ws[2])},
        }
    raise ValueError(f"unexpected conv weight count {len(ws)}")


def _out_channels(entry) -> int:
    if "kernel" in entry:
        return int(entry["kernel"].shape[-1])
    return int(entry["pointwise"]["kernel"].shape[-1])


def _assemble_variables(convs: Dict[str, list],
                        bns: Dict[str, list]) -> Dict[str, Any]:
    """convs: layer name -> Keras-order weight list; bns: BN layer name
    (auto-numbered) -> [gamma, beta, moving_mean, moving_variance].
    Pairs BNs to convs by creation order and cross-checks channels."""
    params: Dict[str, Any] = {}
    batch_stats: Dict[str, Any] = {}
    for name, ws in convs.items():
        params[name] = _conv_entry(ws)
    seq = bn_conv_sequence(_infer_num_stacks(convs))
    bn_names = sorted(bns, key=_bn_suffix)
    if len(bn_names) != len(seq):
        raise ValueError(
            f"expected {len(seq)} BatchNormalization layers for this "
            f"architecture, file has {len(bn_names)}")
    for bn_name, conv in zip(bn_names, seq):
        gamma, beta, mean, var = bns[bn_name]
        if conv not in params:
            raise ValueError(f"BN pairing: conv {conv!r} missing from file")
        if int(np.shape(gamma)[0]) != _out_channels(params[conv]):
            raise ValueError(
                f"BN pairing mismatch: {bn_name} has "
                f"{np.shape(gamma)[0]} channels but {conv} outputs "
                f"{_out_channels(params[conv])}")
        params[conv + "_bn"] = {"scale": _np(gamma),
                                "bias": _np(beta)}
        batch_stats[conv + "_bn"] = {"mean": _np(mean),
                                     "var": _np(var)}
    return {"params": params, "batch_stats": batch_stats}


def load_keras_weights_h5(path: str, keras_model) -> Dict[str, Any]:
    """Load a Keras 3 `model.save_weights('*.weights.h5')` file into
    flax-layout variables.

    The h5 layout keys layers by save-time auto names in topological
    order ('conv2d_17', ...) — the user-given layer names are NOT stored
    and the topological tie-breaking is a Keras implementation detail
    (skip convs sort after their bottleneck's branch) — so the file is
    restored through Keras' own structural loader into `keras_model`
    (the architecture, built with the reference's create_hourglass_model
    or tests/keras_oracle.py) and converted via the graph-edge mapping
    of keras_to_flax_variables."""
    keras_model.load_weights(path)
    return keras_to_flax_variables(keras_model)


def load_saved_model(path: str) -> Dict[str, Any]:
    """Load a TF SavedModel directory (the reference's published
    `trained_models/S4_E120_Adam_IOU` format, save_model.ipynb cells 3-5;
    also Keras 3 `model.export(dir)`) into flax-layout variables via
    tf.saved_model.load — variable names carry the reference's explicit
    conv layer names; BNs pair by creation order."""
    import tensorflow as tf

    loaded = tf.saved_model.load(path)
    groups: Dict[str, Dict[str, np.ndarray]] = {}
    for v in loaded.variables:
        name = v.name.split(":")[0]
        if "/" not in name:
            continue
        layer, attr = name.rsplit("/", 1)
        groups.setdefault(layer, {})[attr] = np.asarray(v.numpy())
    convs: Dict[str, list] = {}
    bns: Dict[str, list] = {}
    for layer, attrs in groups.items():
        if layer.split("/")[-1].startswith("batch_normalization"):
            bns[layer.split("/")[-1]] = [
                attrs["gamma"], attrs["beta"],
                attrs["moving_mean"], attrs["moving_variance"]]
        elif "depthwise_kernel" in attrs:
            convs[layer.split("/")[-1]] = [
                attrs["depthwise_kernel"], attrs["pointwise_kernel"],
                attrs["bias"]]
        elif "kernel" in attrs or "_kernel" in attrs:
            convs[layer.split("/")[-1]] = [
                attrs.get("kernel", attrs.get("_kernel")), attrs["bias"]]
    return _assemble_variables(convs, bns)


def load_keras_checkpoint(path: str, keras_model) -> Dict[str, Any]:
    """Restore a TF-checkpoint-format weight file (path + '.index' /
    '.data-*') into `keras_model`, then convert to flax-layout variables.

    Handles BOTH object-graph layouts found in the wild:
      * 'layer_with_weights-N/<attr>/.ATTRIBUTES/VARIABLE_VALUE' — what
        Keras 2 `model.save_weights('....ckpt')` wrote; the format of the
        reference's published checkpoints (trainer.py:63,
        model_utils.py:5-21). N indexes the model's weighted layers in
        `model.layers` order.
      * 'model/...' — `tf.train.Checkpoint(model=m).write(path)` (the
        way to produce this format under Keras 3).

    `keras_model` supplies the architecture (build it with the reference's
    own create_hourglass_model, or tests/keras_oracle.py)."""
    import tensorflow as tf

    reader = tf.train.load_checkpoint(path)
    keys = reader.get_variable_to_shape_map()
    if any(k.startswith("model/") for k in keys):
        tf.train.Checkpoint(model=keras_model).read(path).expect_partial()
        return keras_to_flax_variables(keras_model)

    attr_names = {
        "Conv2D": ["kernel", "bias"],
        "SeparableConv2D": ["depthwise_kernel", "pointwise_kernel", "bias"],
        "BatchNormalization": ["gamma", "beta", "moving_mean",
                               "moving_variance"],
    }
    weighted = [l for l in keras_model.layers if l.weights]
    n_prefixes = len({k.split("/")[0] for k in keys
                      if k.startswith("layer_with_weights-")})
    if n_prefixes != len(weighted):
        raise ValueError(
            f"checkpoint has {n_prefixes} weighted layers, model has "
            f"{len(weighted)} — architecture mismatch")
    for n, layer in enumerate(weighted):
        attrs = attr_names.get(type(layer).__name__)
        if attrs is None:
            raise ValueError(
                f"unsupported weighted layer {type(layer).__name__}")
        ws = []
        for attr in attrs:
            key = f"layer_with_weights-{n}/{attr}/.ATTRIBUTES/VARIABLE_VALUE"
            if key not in keys:
                raise ValueError(f"missing key {key!r} in checkpoint")
            ws.append(reader.get_tensor(key))
        for w, have in zip(ws, layer.get_weights()):
            if tuple(np.shape(w)) != tuple(np.shape(have)):
                raise ValueError(
                    f"shape mismatch at layer_with_weights-{n} "
                    f"({layer.name}): {np.shape(w)} vs {np.shape(have)}")
        layer.set_weights(ws)
    return keras_to_flax_variables(keras_model)


def validate_import(variables: Dict[str, Any], model,
                    input_shape=(1, 256, 256, 3)) -> Tuple[bool, str]:
    """Check that imported variables fill the port model exactly: every
    parameter and running statistic of `model.state_dict()` (a
    StackedHourglass) present, nothing extra, every shape equal, through
    `weight_convert.to_state_dict`. input_shape is the JAX signature's; the
    port's layers need no input to build."""
    from single_person_pose_estimation_tpu_torch.utils.weight_convert import (
        to_state_dict,
    )

    del input_shape
    try:
        got = {k: tuple(v.shape) for k, v in to_state_dict(variables).items()}
    except (KeyError, ValueError) as e:
        return False, f"unreadable variables: {e!r}"
    ref = {k: tuple(v.shape) for k, v in model.state_dict().items()
           if not k.endswith("num_batches_tracked")}
    missing = set(ref) - set(got)
    extra = set(got) - set(ref)
    mismatched = {k for k in set(got) & set(ref) if got[k] != ref[k]}
    if missing or extra or mismatched:
        return False, (f"missing={sorted(missing)[:5]} "
                       f"extra={sorted(extra)[:5]} "
                       f"shape-mismatch={sorted(mismatched)[:5]}")
    return True, "ok"
