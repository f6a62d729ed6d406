"""Keras ResNet weights in and out of the port's ResNet (the port of
:mod:`pddl_tpu.ckpt.keras_import`).

The reference's pretrained mode builds the backbone with
``ResNet50(weights='imagenet')``: Keras loads a ``.h5`` weight file by
layer name. Its final ``model.save(...h5)`` writes one back. This module
does both for :class:`pddl_tpu_torch.models.resnet.ResNet`, whose
modules mirror the Keras v1 architecture one to one.

It has two layers:

- **the mapping** (no h5py, so it runs on any host):
  :func:`keras_weights_to_resnet` loads a plain ``{keras layer: {weight
  name: ndarray}}`` dict into a model, and :func:`keras_weights_from_resnet`
  is its inverse;
- **the file** (h5py, imported at call time):
  :func:`load_keras_resnet50_h5` and :func:`export_keras_style_h5`.

Names, as in the JAX package (:func:`keras_layer_map`):

==============================  =================================
``conv1_conv`` / ``conv1_bn``   ``stem_conv`` / ``stem_bn``
``conv{s}_block{b}_0_conv/bn``  ``stage{s-1}_block{b}/shortcut_conv|bn``
``conv{s}_block{b}_{i}_conv``   ``stage{s-1}_block{b}/conv{i}``
``conv{s}_block{b}_{i}_bn``     ``stage{s-1}_block{b}/bn{i}``
``predictions`` (``probs``)     ``head``
==============================  =================================

A Keras layer's weights are the flax module's (conv/dense ``kernel`` and
``bias``; BatchNorm ``gamma``/``beta`` as ``scale``/``bias`` and
``moving_mean``/``moving_variance`` as the ``batch_stats``' ``mean``/
``var``), so the mapping goes through the flax layout and leaves the
layouts to :mod:`pddl_tpu_torch.bridge` (conv ``(kh, kw, in, out)`` to
``(out, in, kh, kw)``, dense ``(in, out)`` to ``(out, in)``). A 7x7
Keras stem kernel loads into a ``space_to_depth`` model through
:func:`~pddl_tpu_torch.models.resnet.s2d_stem_kernel`, and a 4x4x(4C)
one into a Keras-stem model through its inverse.

Both weight-file flavours load: the weights-only file (layer groups at
the root) and a full ``model.save`` archive (under ``model_weights``).
"""

from __future__ import annotations

from typing import Dict, Mapping, Optional, Sequence, Tuple

import numpy as np
import torch

from pddl_tpu_torch.bridge import resnet_params_from_jax, resnet_params_to_jax
from pddl_tpu_torch.models.resnet import (
    s2d_stem_kernel,
    s2d_stem_kernel_inverse,
)

KerasWeights = Dict[str, Dict[str, np.ndarray]]

# Keras BN weight name -> (collection, flax leaf name)
_BN_WEIGHTS = {
    "gamma": ("params", "scale"),
    "beta": ("params", "bias"),
    "moving_mean": ("batch_stats", "mean"),
    "moving_variance": ("batch_stats", "var"),
}


def keras_layer_map(
    stage_sizes: Sequence[int] = (3, 4, 6, 3),
) -> Dict[str, Tuple[str, Tuple[str, ...]]]:
    """Keras layer name -> (kind, flax module path) for a ResNet-v1
    topology."""
    m: Dict[str, Tuple[str, Tuple[str, ...]]] = {
        "conv1_conv": ("conv", ("stem_conv",)),
        "conv1_bn": ("bn", ("stem_bn",)),
    }
    for s, n_blocks in enumerate(stage_sizes):
        for b in range(n_blocks):
            keras_pre = f"conv{s + 2}_block{b + 1}"
            ours = f"stage{s + 1}_block{b + 1}"
            if b == 0:
                m[f"{keras_pre}_0_conv"] = ("conv", (ours, "shortcut_conv"))
                m[f"{keras_pre}_0_bn"] = ("bn", (ours, "shortcut_bn"))
            for i in (1, 2, 3):
                m[f"{keras_pre}_{i}_conv"] = ("conv", (ours, f"conv{i}"))
                m[f"{keras_pre}_{i}_bn"] = ("bn", (ours, f"bn{i}"))
    # The include_top head: `predictions` in keras.applications, `probs`
    # in some exported variants.
    m["predictions"] = ("dense", ("head",))
    m["probs"] = ("dense", ("head",))
    return m


def _stem_kernel(value: np.ndarray, old_shape: Tuple[int, ...]):
    """``value`` as a stem kernel of ``old_shape`` across the two stems,
    or None when it is no such pair of shapes."""
    shape = tuple(value.shape)
    if shape[:2] == (7, 7) and old_shape == (4, 4, 4 * shape[2], shape[3]):
        return s2d_stem_kernel(torch.from_numpy(value)).numpy()
    if shape[:2] == (4, 4) and old_shape == (7, 7, shape[2] // 4, shape[3]):
        return s2d_stem_kernel_inverse(torch.from_numpy(value)).numpy()
    return None


def _set_leaf(tree: dict, path: Tuple[str, ...], leaf_name: str,
              value: np.ndarray, source: str) -> None:
    node = tree
    for key in path:
        if key not in node:
            raise KeyError(
                f"importing {source}: module path {'/'.join(path)} not in "
                f"model tree (have: {sorted(node)})"
            )
        node = node[key]
    if leaf_name not in node:
        raise KeyError(
            f"importing {source}: weight {leaf_name!r} not in "
            f"{'/'.join(path)} (have: {sorted(node)})"
        )
    old = node[leaf_name]
    value = np.asarray(value)
    if tuple(old.shape) != tuple(value.shape):
        stem = (_stem_kernel(value, tuple(old.shape))
                if leaf_name == "kernel" else None)
        if stem is None:
            raise ValueError(
                f"importing {source} -> {'/'.join(path)}/{leaf_name}: shape "
                f"{tuple(value.shape)} != model's {tuple(old.shape)} — "
                "architecture mismatch (wrong depth/width or not a v1 "
                "ResNet?)"
            )
        value = stem
    node[leaf_name] = value


def _module(tree: dict, path: Tuple[str, ...]) -> dict:
    for key in path:
        tree = tree[key]
    return tree


def _put(tree: dict, path: Tuple[str, ...], leaves: dict) -> None:
    for key in path[:-1]:
        tree = tree.setdefault(key, {})
    tree[path[-1]] = leaves


@torch.no_grad()
def keras_weights_to_resnet(
    layers: Mapping[str, Mapping[str, np.ndarray]],
    model: torch.nn.Module,
    stage_sizes: Sequence[int] = (3, 4, 6, 3),
    require_head: Optional[bool] = None,
    source: str = "keras weights",
) -> torch.nn.Module:
    """Load ``{keras layer name: {weight name: array}}`` (weight names
    without their ``:0``) into ``model`` in place and return it.

    Every matched tensor is replaced, cast to the model tensor's own
    dtype; the model's other tensors stay as they are (with notop
    weights, the head keeps its initialisation). ``require_head``: True
    raises when the weights have no classifier head; None imports it when
    present. Raises ``ValueError`` when fewer layers match than the
    topology has (``source`` names the weights in the message) or a shape
    differs, ``KeyError`` when the model lacks a mapped module.
    """
    params, stats = resnet_params_to_jax(model.state_dict())
    trees = {"params": params, "batch_stats": stats}
    layer_map = keras_layer_map(stage_sizes)
    imported, saw_head, touched = [], False, []

    for layer_name, weights in layers.items():
        if layer_name not in layer_map or not weights:
            continue
        kind, module_path = layer_map[layer_name]
        if kind in ("conv", "dense"):
            _set_leaf(params, module_path, "kernel", weights["kernel"],
                      layer_name)
            if "bias" in weights:
                _set_leaf(params, module_path, "bias", weights["bias"],
                          layer_name)
            saw_head |= kind == "dense"
        else:  # bn
            for keras_name, (coll, ours) in _BN_WEIGHTS.items():
                if keras_name in weights:
                    _set_leaf(trees[coll], module_path, ours,
                              weights[keras_name], layer_name)
        imported.append(layer_name)
        touched.append((kind, module_path))

    expected = len(layer_map) - 2  # the head counts once
    if len(imported) < expected - (0 if saw_head else 1):
        missing = sorted(set(layer_map) - set(imported) - {"predictions", "probs"})
        raise ValueError(
            f"{source}: only {len(imported)} of ~{expected} layers matched; "
            f"first missing: {missing[:5]} — is this a v1 ResNet-{sum(s * 3 for s in stage_sizes) + 2} "
            "weight file?"
        )
    if require_head and not saw_head:
        raise ValueError(f"{source} has no classifier head (notop weights)")

    # Only the touched modules go back, through the bridge's layouts.
    sub_params: dict = {}
    sub_stats: dict = {}
    for kind, path in touched:
        _put(sub_params, path, _module(params, path))
        if kind == "bn":
            _put(sub_stats, path, _module(stats, path))
    current = model.state_dict()
    for key, value in resnet_params_from_jax(sub_params, sub_stats).items():
        target = current[key]
        target.copy_(value.to(target.dtype))
    return model


def keras_weights_from_resnet(
    model: torch.nn.Module,
    stage_sizes: Sequence[int] = (3, 4, 6, 3),
) -> KerasWeights:
    """``model``'s weights as ``{keras layer name: {weight name: array}}``
    (host numpy in the flax layout, bf16 as f32), in Keras's layer order;
    the inverse of :func:`keras_weights_to_resnet`. A headless model
    gives no ``predictions``; a ``space_to_depth`` model gives its 4x4x12
    stem kernel, which loads back into either stem."""
    params, stats = resnet_params_to_jax(model.state_dict())
    out: KerasWeights = {}
    for layer_name, (kind, module_path) in keras_layer_map(
            stage_sizes).items():
        if layer_name == "probs":  # alias of predictions
            continue
        try:
            node = _module(params, module_path)
        except KeyError:
            continue
        if kind in ("conv", "dense"):
            weights = {"kernel": node["kernel"]}
            if "bias" in node:
                weights["bias"] = node["bias"]
        else:
            stat = _module(stats, module_path)
            weights = {"gamma": node["scale"], "beta": node["bias"],
                       "moving_mean": stat["mean"],
                       "moving_variance": stat["var"]}
        out[layer_name] = weights
    return out


def _h5py(caller: str):
    try:
        import h5py  # noqa: PLC0415
    except ImportError as e:
        raise ImportError(f"{caller} requires h5py") from e
    return h5py


def _collect_datasets(group, h5py) -> Dict[str, np.ndarray]:
    """All datasets under an h5 group, keyed by base name ('kernel',...)."""
    out: Dict[str, np.ndarray] = {}

    def visit(name, obj):
        if isinstance(obj, h5py.Dataset):
            out[name.split("/")[-1].split(":")[0]] = np.asarray(obj)

    group.visititems(visit)
    return out


def load_keras_resnet50_h5(
    path: str,
    model: torch.nn.Module,
    stage_sizes: Sequence[int] = (3, 4, 6, 3),
    require_head: Optional[bool] = None,
) -> torch.nn.Module:
    """Load a Keras ResNet ``.h5`` (a keras.applications weight file, with
    or without top, or a full ``model.save`` archive) into ``model`` in
    place and return it; see :func:`keras_weights_to_resnet`."""
    h5py = _h5py("load_keras_resnet50_h5")
    layer_map = keras_layer_map(stage_sizes)
    with h5py.File(path, "r") as f:
        root = f["model_weights"] if "model_weights" in f else f
        layers = {name: _collect_datasets(root[name], h5py)
                  for name in root if name in layer_map}
    return keras_weights_to_resnet(layers, model, stage_sizes,
                                   require_head=require_head, source=path)


def export_keras_style_h5(path: str, model: torch.nn.Module,
                          stage_sizes: Sequence[int] = (3, 4, 6, 3)) -> None:
    """Write ``model`` as a Keras legacy ``.h5`` weight file (the
    reference's final ``model.save``): the root ``layer_names`` and
    ``backend`` attributes and each layer's ``weight_names``, so it loads
    back through :func:`load_keras_resnet50_h5` and through Keras's
    ``Model.load_weights(path, by_name=True)``."""
    h5py = _h5py("export_keras_style_h5")
    layers = keras_weights_from_resnet(model, stage_sizes)
    with h5py.File(path, "w") as f:
        for layer_name, weights in layers.items():
            top = f.create_group(layer_name)
            g = top.create_group(layer_name)
            for wname, value in weights.items():
                g.create_dataset(f"{wname}:0", data=value)
            top.attrs["weight_names"] = np.array(
                [f"{layer_name}/{w}:0".encode() for w in weights]
            )
        f.attrs["layer_names"] = np.array([n.encode() for n in layers])
        f.attrs["backend"] = b"tensorflow"
