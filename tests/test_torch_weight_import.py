"""Keras weight import in the port (`utils/weight_import.py`), on the CPU
with TensorFlow, against the JAX package's importer and Keras itself.

Keras models come from tests/keras_oracle.py (the reference architecture
and names): S1/C32 and the S2/C16 mobile variant at 64x64, with random
weights and BN statistics. Every weight file is written here, as
tests/test_weight_import_files.py writes them: a Keras 3 `.weights.h5`,
a TF checkpoint in both object-graph layouts (Keras 2's
`layer_with_weights-N`, fabricated key for key through a compat.v1 Saver,
and `tf.train.Checkpoint(model=...)`'s) and a SavedModel. TensorFlow and
torch share this process.

Tolerances: the imported variables equal the JAX importer's leaf for leaf
(both read the same Keras arrays); the port's heatmaps lie within 1e-4
of Keras' (the JAX tests' parity tolerance); a round trip through Keras
is exact.
"""

import numpy as np
import pytest
import torch

tf = pytest.importorskip("tensorflow")

from single_person_pose_estimation_tpu.utils import (  # noqa: E402
    weight_import as jweight_import,
)
from single_person_pose_estimation_tpu_torch.models.hourglass import (  # noqa: E402
    StackedHourglass,
)
from single_person_pose_estimation_tpu_torch.utils import (  # noqa: E402
    weight_import,
)
from single_person_pose_estimation_tpu_torch.utils.weight_convert import (  # noqa: E402
    load_variables,
    to_variables,
)
from keras_oracle import (  # noqa: E402
    build_keras_hourglass,
    randomize_keras_weights,
)

SIZE = 64
ATOL = 1e-4
CASES = {"s1c32": dict(num_stacks=1, num_channels=32, mobile=False),
         "s2_mobile": dict(num_stacks=2, num_channels=16, mobile=True)}
_ATTRS = {
    "Conv2D": ["kernel", "bias"],
    "SeparableConv2D": ["depthwise_kernel", "pointwise_kernel", "bias"],
    "BatchNormalization": ["gamma", "beta", "moving_mean",
                           "moving_variance"],
}


def _write_keras2_ckpt(keras_model, path):
    """The model's weights as a TF checkpoint with Keras 2's key layout
    ('layer_with_weights-N/<attr>/.ATTRIBUTES/VARIABLE_VALUE'), which
    Keras 3 cannot write, through a compat.v1 Saver."""
    entries = []
    weighted = [layer for layer in keras_model.layers if layer.weights]
    for n, layer in enumerate(weighted):
        for attr, w in zip(_ATTRS[type(layer).__name__],
                           layer.get_weights()):
            entries.append((n, attr, np.asarray(w)))
    g = tf.Graph()
    with g.as_default():
        var_list = {f"layer_with_weights-{n}/{attr}/.ATTRIBUTES/"
                    "VARIABLE_VALUE": tf.Variable(w, name=f"v{n}_{attr}")
                    for n, attr, w in entries}
        saver = tf.compat.v1.train.Saver(var_list=var_list)
        with tf.compat.v1.Session(graph=g) as sess:
            sess.run(tf.compat.v1.global_variables_initializer())
            saver.save(sess, str(path), write_meta_graph=False)
    return str(path)


def _keras_heatmaps(m, x):
    outs = m(x, training=False)
    return [np.asarray(o) for o in (outs if isinstance(outs, list)
                                    else [outs])]


def _port_model(kw, variables):
    return load_variables(StackedHourglass(**kw), variables)


def _heatmaps(model, x):
    with torch.no_grad():
        return [o.numpy() for o in model(torch.from_numpy(x))]


@pytest.fixture(scope="module")
def cases():
    out = {}
    for i, (name, kw) in enumerate(CASES.items()):
        m = build_keras_hourglass(input_size=SIZE, **kw)
        randomize_keras_weights(m, seed=20 + i)
        x = np.random.default_rng(30 + i).uniform(
            0, 1, (2, SIZE, SIZE, 3)).astype(np.float32)
        outs = _keras_heatmaps(m, x)
        out[name] = (m, x, outs)
    return out


@pytest.fixture(scope="module")
def files(cases, tmp_path_factory):
    m, _, _ = cases["s1c32"]
    d = tmp_path_factory.mktemp("keras_files")
    h5 = str(d / "m.weights.h5")
    m.save_weights(h5)
    ck3 = str(d / "m_keras3.ckpt")
    tf.train.Checkpoint(model=m).write(ck3)
    sm = str(d / "saved_model")
    m.export(sm, verbose=False)
    return {"h5": h5, "ck3": ck3, "ck2": _write_keras2_ckpt(
        m, d / "m_keras2.ckpt"), "sm": sm,
        "fresh": build_keras_hourglass(input_size=SIZE, **CASES["s1c32"])}


def _assert_parity(variables, kw, x, outs):
    ok, msg = weight_import.validate_import(variables, StackedHourglass(**kw))
    assert ok, msg
    got = _heatmaps(_port_model(kw, variables), x)
    assert len(got) == len(outs)
    for i, (a, b) in enumerate(zip(got, outs)):
        np.testing.assert_allclose(a, b, atol=ATOL, err_msg=f"stack {i}")


@pytest.mark.parametrize("name", list(CASES))
def test_keras_model_import_matches_jax_and_keras(cases, name):
    m, x, outs = cases[name]
    got = weight_import.keras_to_flax_variables(m)
    want = jweight_import.keras_to_flax_variables(m)
    assert got.keys() == want.keys()
    for col in got:
        assert got[col].keys() == want[col].keys()
        for layer, leaves in got[col].items():
            flat = lambda t: [v for k in sorted(t) for v in (
                flat(t[k]) if isinstance(t[k], dict) else [t[k]])]
            for a, b in zip(flat(leaves), flat(want[col][layer])):
                assert isinstance(a, np.ndarray) and a.dtype == np.float32
                np.testing.assert_array_equal(a, np.asarray(b))
    _assert_parity(got, CASES[name], x, outs)


@pytest.mark.parametrize("fmt", ["h5", "ck2", "ck3", "sm"])
def test_weight_files_import(cases, files, fmt):
    """Each file read back from its path into a Keras model of other
    weights (the SavedModel standalone) and on into the port."""
    kw = CASES["s1c32"]
    _, x, outs = cases["s1c32"]
    fresh = files["fresh"]
    randomize_keras_weights(fresh, seed=40)
    if fmt == "h5":
        variables = weight_import.load_keras_weights_h5(files["h5"], fresh)
    elif fmt == "sm":
        variables = weight_import.load_saved_model(files["sm"])
    else:
        variables = weight_import.load_keras_checkpoint(files[fmt], fresh)
    _assert_parity(variables, kw, x, outs)


def test_checkpoint_of_another_architecture_raises(cases, files):
    with pytest.raises(ValueError, match="architecture mismatch"):
        weight_import.load_keras_checkpoint(files["ck2"],
                                            cases["s2_mobile"][0])


def test_round_trip_through_keras(cases):
    """port variables -> Keras -> port variables is exact, and Keras then
    predicts the port model's heatmaps. The Keras model is the case's own,
    given other weights first; the round trip gives its weights back."""
    kw = CASES["s2_mobile"]
    target, x, _ = cases["s2_mobile"]
    model = _port_model(kw, weight_import.keras_to_flax_variables(target))
    exported = to_variables(model)
    randomize_keras_weights(target, seed=41)
    weight_import.flax_to_keras_weights(exported, target)
    back = weight_import.keras_to_flax_variables(target)
    for col in exported:
        for layer in exported[col]:
            a, b = exported[col][layer], back[col][layer]
            for k in a:
                if isinstance(a[k], dict):
                    for leaf in a[k]:
                        np.testing.assert_array_equal(a[k][leaf], b[k][leaf])
                else:
                    np.testing.assert_array_equal(a[k], b[k])
    for a, b in zip(_heatmaps(model, x), _keras_heatmaps(target, x)):
        np.testing.assert_allclose(a, np.asarray(b), atol=ATOL)


def test_validate_import_catches_missing_and_misshapen(cases):
    kw = CASES["s1c32"]
    variables = weight_import.keras_to_flax_variables(cases["s1c32"][0])
    del variables["params"]["front_conv_1x1_1"]["bias"]
    ok, msg = weight_import.validate_import(variables, StackedHourglass(**kw))
    assert not ok and "front_conv_1x1_1.bias" in msg
    ok, msg = weight_import.validate_import(
        weight_import.keras_to_flax_variables(cases["s1c32"][0]),
        StackedHourglass(num_stacks=1, num_channels=16))
    assert not ok and "shape-mismatch" in msg and "'" in msg
    seq = weight_import.bn_conv_sequence(2)
    assert seq == jweight_import.bn_conv_sequence(2)
