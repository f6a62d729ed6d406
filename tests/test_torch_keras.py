"""The port's Keras ResNet import and export (`pddl_tpu_torch/ckpt/
keras_import.py`) against genuine Keras and the JAX package's
`pddl_tpu/ckpt/keras_import.py` on the CPU.

One `tf_keras.applications.ResNet50(weights=None)` is built per module
(the `keras` fixture): its `.h5` and its logits on a seeded image are the
oracle.

- `keras_layer_map` equals the JAX map for ResNet-50, -101 and -152;
- the JAX import of the `.h5` (into the flax-layout tree of a port model,
  made by `bridge.resnet_params_to_jax`), carried over by
  `bridge.resnet_params_from_jax`, is bitwise the port's import, for the
  Keras stem and the space-to-depth stem;
- the port's logits match Keras's within `tests/test_keras_parity.py`'s
  1e-5 (rtol and atol), and a space-to-depth model's from the same file
  within 1e-4 (the same function, its 4x4 convolution summing the 7x7
  taps in another order);
- the port's export loads into genuine Keras `by_name` within that file's
  5e-3, and has the JAX export's `layer_names`, `weight_names` and
  byte-equal datasets for the same weights; a space-to-depth model's
  export loads back into a Keras-stem model through the inverse kernel;
- a `model.save` archive (`model_weights`) with a `probs` head loads as
  the weights-only file does, in both packages;
- notop weights leave a fresh head as it was, and `require_head=True`
  raises; the "only N of ~M layers matched" and the shape-mismatch errors
  are the JAX package's words;
- the mapping layer (no h5py) round-trips a model bitwise.
"""

import copy
import os

import h5py
import numpy as np
import pytest
import torch

from pddl_tpu.ckpt import keras_import as jk
from pddl_tpu_torch.bridge import resnet_params_from_jax, resnet_params_to_jax
from pddl_tpu_torch.ckpt import keras_import as tk
from pddl_tpu_torch.models.resnet import ResNet50, s2d_stem_kernel_inverse

tf_keras = pytest.importorskip("tf_keras")

# One torch thread a process under xdist: the suite's workers share the
# host's cores, and a torch thread pool in each worker oversubscribes them.
if os.environ.get("PYTEST_XDIST_WORKER"):
    torch.set_num_threads(1)

PARITY = dict(rtol=1e-5, atol=1e-5)   # tests/test_keras_parity.py:42
EXPORT = dict(rtol=5e-3, atol=5e-3)   # tests/test_keras_parity.py:72


def _keras_resnet():
    return tf_keras.applications.ResNet50(
        weights=None, include_top=True, classes=1000,
        classifier_activation=None)


@pytest.fixture(scope="module")
def keras(tmp_path_factory):
    """(genuine Keras model, its weight file, an image, Keras's logits)."""
    tf_keras.utils.set_random_seed(0)
    model = _keras_resnet()
    h5 = str(tmp_path_factory.mktemp("keras") / "resnet50.h5")
    model.save_weights(h5)
    x = np.random.RandomState(0).rand(1, 224, 224, 3).astype(np.float32)
    return model, h5, x, np.asarray(model(x, training=False))


@pytest.fixture(scope="module")
def ports():
    """Seeded port models, built once (a full ResNet-50's seeded init takes
    seconds on the CPU); each test takes copies."""
    built = {"keras": dict(seed=7), "space_to_depth": dict(
        seed=8, stem="space_to_depth"), "head10": dict(seed=9,
                                                        num_classes=10)}
    return {name: ResNet50(device="cpu", **{"num_classes": 1000, **kw}).eval()
            for name, kw in built.items()}


def _logits(model, x):
    with torch.no_grad():
        return model(torch.from_numpy(x), train=False).numpy()


def _jax_vars(model):
    params, stats = resnet_params_to_jax(model.state_dict())
    return {"params": params, "batch_stats": stats}


def _assert_state_equal(a, b):
    assert a.keys() == b.keys()
    for key in a:
        assert torch.equal(a[key], b[key]), key


@pytest.mark.parametrize("stages", [(3, 4, 6, 3), (3, 4, 23, 3),
                                    (3, 8, 36, 3)])
def test_layer_map_equals_jax(stages):
    assert tk.keras_layer_map(stages) == jk.keras_layer_map(stages)


@pytest.mark.parametrize("stem", ["keras", "space_to_depth"])
def test_import_is_bitwise_the_jax_import(keras, ports, stem):
    _, h5, _, _ = keras
    ours = tk.load_keras_resnet50_h5(h5, copy.deepcopy(ports[stem]),
                                     require_head=True)
    theirs = jk.load_keras_resnet50_h5(h5, _jax_vars(ports[stem]),
                                       require_head=True)
    _assert_state_equal(
        ours.state_dict(),
        resnet_params_from_jax(theirs["params"], theirs["batch_stats"]))


def test_logits_match_keras(keras, ports):
    _, h5, x, ref = keras
    model = tk.load_keras_resnet50_h5(h5, copy.deepcopy(ports["keras"]),
                                      require_head=True)
    np.testing.assert_allclose(_logits(model, x), ref, **PARITY)
    # The space-to-depth stem computes the same function from the
    # transformed kernel, up to the convolution's summation order.
    s2d = tk.load_keras_resnet50_h5(
        h5, copy.deepcopy(ports["space_to_depth"]))
    np.testing.assert_allclose(_logits(s2d, x), ref, rtol=1e-4, atol=1e-4)


def test_export_loads_into_keras_and_equals_the_jax_export(keras, ports,
                                                          tmp_path):
    model, h5, x, ref = keras
    port = ports["keras"]  # its seeded init, not the oracle's weights
    ours = str(tmp_path / "port.h5")
    tk.export_keras_style_h5(ours, port)
    theirs = str(tmp_path / "jax.h5")
    jk.export_keras_style_h5(theirs, _jax_vars(port))
    with h5py.File(ours, "r") as a, h5py.File(theirs, "r") as b:
        assert list(a.attrs["layer_names"]) == list(b.attrs["layer_names"])
        assert a.attrs["backend"] == b.attrs["backend"]
        assert list(a) == list(b)
        for name in a:
            assert (list(a[name].attrs["weight_names"])
                    == list(b[name].attrs["weight_names"]))
            for wname in a[name][name]:
                da, db = a[name][name][wname], b[name][name][wname]
                assert da.dtype == db.dtype and da.shape == db.shape
                assert np.asarray(da).tobytes() == np.asarray(db).tobytes()
    model.load_weights(ours, by_name=True)
    got = np.asarray(model(x, training=False))
    want = _logits(port, x)
    np.testing.assert_allclose(want, got, **EXPORT)
    # by_name must not have skipped every layer: the oracle's own logits
    # are far from the exported model's.
    assert np.abs(ref - want).max() > 1.0


def test_s2d_export_loads_back_into_the_keras_stem(ports, tmp_path):
    s2d = ports["space_to_depth"]
    path = str(tmp_path / "s2d.h5")
    tk.export_keras_style_h5(path, s2d)
    ours = tk.load_keras_resnet50_h5(path, copy.deepcopy(ports["keras"]))
    theirs = jk.load_keras_resnet50_h5(path, _jax_vars(ports["keras"]))
    _assert_state_equal(
        ours.state_dict(),
        resnet_params_from_jax(theirs["params"], theirs["batch_stats"]))
    k2 = s2d.stem_conv.weight.detach().permute(2, 3, 1, 0)  # [4, 4, 12, F]
    assert torch.equal(ours.stem_conv.weight.detach().permute(2, 3, 1, 0),
                       s2d_stem_kernel_inverse(k2))


def _copy_without(src, dst, drop):
    with h5py.File(src, "r") as f, h5py.File(dst, "w") as g:
        for name in f:
            if name not in drop:
                f.copy(f[name], g, name)


def test_model_save_archive_and_probs_head(keras, ports, tmp_path):
    """A full ``model.save`` archive (layers under ``model_weights``) with
    the head named ``probs`` loads as the weights-only file does."""
    _, h5, _, _ = keras
    archive = str(tmp_path / "archive.h5")
    with h5py.File(h5, "r") as f, h5py.File(archive, "w") as g:
        root = g.create_group("model_weights")
        for name in f:
            f.copy(f[name], root, "probs" if name == "predictions" else name)
    want = tk.load_keras_resnet50_h5(h5, copy.deepcopy(ports["keras"]))
    ours = tk.load_keras_resnet50_h5(archive, copy.deepcopy(ports["keras"]),
                                     require_head=True)
    _assert_state_equal(ours.state_dict(), want.state_dict())
    theirs = jk.load_keras_resnet50_h5(archive, _jax_vars(ports["keras"]),
                                       require_head=True)
    _assert_state_equal(
        ours.state_dict(),
        resnet_params_from_jax(theirs["params"], theirs["batch_stats"]))


def test_notop_keeps_the_head_and_require_head_raises(keras, ports,
                                                     tmp_path):
    _, h5, _, _ = keras
    notop = str(tmp_path / "notop.h5")
    _copy_without(h5, notop, {"predictions"})
    full = tk.load_keras_resnet50_h5(h5, copy.deepcopy(ports["keras"]))
    model = copy.deepcopy(ports["head10"])
    head = {k: v.clone() for k, v in model.head.state_dict().items()}
    assert tk.load_keras_resnet50_h5(notop, model) is model
    for key, value in model.state_dict().items():
        want = (head[key[len("head."):]] if key.startswith("head.")
                else full.state_dict()[key])
        assert torch.equal(value, want), key
    errors = []
    for load, target in ((tk.load_keras_resnet50_h5,
                          copy.deepcopy(ports["head10"])),
                         (jk.load_keras_resnet50_h5,
                          _jax_vars(ports["head10"]))):
        with pytest.raises(ValueError, match="no classifier head") as info:
            load(notop, target, require_head=True)
        errors.append(str(info.value))
    assert errors[0] == errors[1]


@pytest.mark.parametrize("case", ["too_few_layers", "shape_mismatch"])
def test_errors_are_the_jax_texts(keras, ports, tmp_path, case):
    _, h5, _, _ = keras
    if case == "too_few_layers":
        path = str(tmp_path / "partial.h5")
        _copy_without(h5, path, {"conv1_bn", "conv2_block1_1_conv"})
        model, match = ports["keras"], "only 105 of ~106 layers matched"
    else:
        path, model, match = h5, ports["head10"], "shape"
    errors = []
    for load, target in ((tk.load_keras_resnet50_h5, copy.deepcopy(model)),
                         (jk.load_keras_resnet50_h5, _jax_vars(model))):
        with pytest.raises(ValueError, match=match) as info:
            load(path, target)
        errors.append(str(info.value))
    assert errors[0] == errors[1]


def test_mapping_layer_round_trips_without_h5py():
    src = ResNet50(num_classes=10, width_multiplier=0.25, device="cpu",
                   seed=1)
    dst = ResNet50(num_classes=10, width_multiplier=0.25, device="cpu",
                   seed=2)
    weights = tk.keras_weights_from_resnet(src)
    assert list(weights) == [n for n in tk.keras_layer_map() if n != "probs"]
    assert set(weights["conv1_bn"]) == {"gamma", "beta", "moving_mean",
                                        "moving_variance"}
    tk.keras_weights_to_resnet(weights, dst, require_head=True)
    _assert_state_equal(src.state_dict(), dst.state_dict())
