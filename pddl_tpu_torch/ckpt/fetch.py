"""Pretrained-weight acquisition, the ``weights='imagenet'`` analogue (the
port of :mod:`pddl_tpu.ckpt.fetch`, its own copy).

The reference downloads Keras's ResNet-50 ImageNet weights inside
``tf.keras.applications.ResNet50(weights='imagenet')``. Here acquisition
is explicit:

- :func:`fetch_keras_resnet50_weights` resolves the official
  keras-applications weight file from a local cache, downloads it only
  on explicit opt-in, and verifies the published MD5;
- when the file is missing and downloading is off, the error message is
  the offline procedure: the one ``curl`` command to run on any machine
  with network access, and where to put the file.

The cache is the JAX package's (``$PDDL_TPU_CACHE``, default
``~/.cache/pddl_tpu``, then ``keras/``), so one cached file serves both
packages. The URLs and hashes are the ones keras-applications publishes
(``tf_keras/src/applications/resnet.py``, ``BASE_WEIGHTS_PATH`` and
``WEIGHTS_HASHES``); Keras's ``get_file`` checks the same MD5 values.
"""

from __future__ import annotations

import hashlib
import os
from typing import Optional

BASE_WEIGHTS_URL = (
    "https://storage.googleapis.com/tensorflow/keras-applications/resnet/"
)

# model -> variant -> (file name, MD5 as published by keras-applications).
KERAS_RESNET_WEIGHTS: dict[str, dict[str, tuple[str, str]]] = {
    "resnet50": {
        "top": ("resnet50_weights_tf_dim_ordering_tf_kernels.h5",
                "2cb95161c43110f7111970584f804107"),
        "notop": ("resnet50_weights_tf_dim_ordering_tf_kernels_notop.h5",
                  "4d473c1dd8becc155b73f8504c6f6626"),
    },
    "resnet101": {
        "top": ("resnet101_weights_tf_dim_ordering_tf_kernels.h5",
                "f1aeb4b969a6efcfb50fad2f0c20cfc5"),
        "notop": ("resnet101_weights_tf_dim_ordering_tf_kernels_notop.h5",
                  "88cf7a10940856eca736dc7b7e228a21"),
    },
    "resnet152": {
        "top": ("resnet152_weights_tf_dim_ordering_tf_kernels.h5",
                "100835be76be38e30d865e96f2aaae62"),
        "notop": ("resnet152_weights_tf_dim_ordering_tf_kernels_notop.h5",
                  "ee4c566cf9a93f14d82f913c2dc6dd0c"),
    },
}


def default_cache_dir() -> str:
    """``$PDDL_TPU_CACHE`` or ``~/.cache/pddl_tpu/keras``."""
    root = os.environ.get(
        "PDDL_TPU_CACHE",
        os.path.join(os.path.expanduser("~"), ".cache", "pddl_tpu"),
    )
    return os.path.join(root, "keras")


def _md5(path: str, chunk: int = 1 << 20) -> str:
    h = hashlib.md5()
    with open(path, "rb") as f:
        while block := f.read(chunk):
            h.update(block)
    return h.hexdigest()


def fetch_keras_resnet50_weights(
    variant: str = "notop",
    *,
    model: str = "resnet50",
    cache_dir: Optional[str] = None,
    download: bool = False,
    verify: bool = True,
) -> str:
    """Return the local path of the official Keras ResNet weight file.

    Args:
      variant: ``"notop"`` (backbone only, what the reference's
        ``include_top=False`` uses)
        or ``"top"`` (with the original 1000-way classifier).
      model: ``resnet50`` (default) / ``resnet101`` / ``resnet152``.
      cache_dir: where the file lives; default :func:`default_cache_dir`.
      download: explicit opt-in to fetch over the network. Off by default:
        training hosts often have no egress, and implicit downloads from N
        hosts at once are a thundering herd; run the printed command once
        instead.
      verify: check the keras-published MD5 of the file (cached or fresh).

    Returns the path to a verified ``.h5`` for
    :func:`pddl_tpu_torch.ckpt.load_keras_resnet50_h5`.
    Raises ``FileNotFoundError`` (with the exact acquisition command) when
    the file is absent and ``download=False``, and ``ValueError`` on hash
    mismatch.
    """
    try:
        file_name, md5 = KERAS_RESNET_WEIGHTS[model][variant]
    except KeyError:
        raise ValueError(
            f"unknown weights {model!r}/{variant!r}; known models "
            f"{sorted(KERAS_RESNET_WEIGHTS)}, variants ('top', 'notop')"
        ) from None
    cache_dir = cache_dir or default_cache_dir()
    path = os.path.join(cache_dir, file_name)
    url = BASE_WEIGHTS_URL + file_name

    if not os.path.exists(path):
        if not download:
            raise FileNotFoundError(
                f"pretrained weights not found at {path}.\n"
                f"Acquire them once (any machine with network access):\n"
                f"  curl -fL --create-dirs -o {path} {url}\n"
                f"or re-run with download enabled "
                f"(--download-weights / download=True). "
                f"Expected MD5: {md5}"
            )
        os.makedirs(cache_dir, exist_ok=True)
        # Per-process temp name: N hosts sharing one cache (NFS home) must
        # not clobber each other's in-flight downloads; the atomic replace
        # means last-writer-wins on identical content.
        import tempfile
        from urllib.request import urlretrieve

        fd, tmp = tempfile.mkstemp(
            prefix=file_name + ".", suffix=".part", dir=cache_dir
        )
        os.close(fd)
        try:
            urlretrieve(url, tmp)  # noqa: S310 - https URL constant above
            os.replace(tmp, path)
        finally:
            if os.path.exists(tmp):
                os.remove(tmp)

    if verify:
        got = _md5(path)
        if got != md5:
            raise ValueError(
                f"MD5 mismatch for {path}: got {got}, expected {md5} "
                f"(the keras-applications published hash). Delete the file "
                f"and re-download from {url}."
            )
    return path
