"""The port's native loader (`pddl_tpu_torch/data/native_loader.py`, its
library built from `pddl_tpu_torch/data/csrc/`) against the JAX package's
`pddl_tpu/data/native_loader.py` on the same packed files:

- `write_packed` and `PackedWriter` write the JAX writer's bytes;
- batches are byte-equal to the JAX loader's over two epochs across
  shuffle, seed, shards, `drop_remainder` and a float32 cast, in the same
  order with one worker (as `tests/test_native_loader.py` holds an order
  there), and as the same samples per epoch with four;
- a missing file raises `FileNotFoundError`;
- the library is built under `build/`, named by a digest, and is not the
  JAX package's `native/libpddl_io.so`;
- the port's `Trainer` fits `tiny_resnet` on the CPU from the loader and
  lowers the loss.

Every loader is closed on the way out of its test, failed or not.
"""

import contextlib
import os

import numpy as np
import pytest
import torch

from pddl_tpu.data import native_loader as jnl
from pddl_tpu_torch.data import native_loader as tnl
from pddl_tpu_torch.ops._kernels import BUILD_DIR


def _samples(n, h=8, w=8, c=3, seed=0):
    rng = np.random.default_rng(seed)
    images = rng.integers(0, 256, (n, h, w, c), np.uint8)
    labels = np.arange(n, dtype=np.int32) * 3 - 7
    return images, labels


@pytest.fixture(scope="module")
def packed(tmp_path_factory):
    """Two packed shards of 20 and 17 samples, written by the JAX writer."""
    root = tmp_path_factory.mktemp("packed")
    paths = []
    for i, n in enumerate((20, 17)):
        images, labels = _samples(n, seed=i)
        paths.append(str(root / f"shard{i}.pdl"))
        jnl.write_packed(paths[-1], images, labels + 1000 * i)
    return paths


def test_writers_write_the_jax_bytes(tmp_path):
    images, labels = _samples(9, h=5, w=7, c=2)
    tnl.write_packed(str(tmp_path / "port.pdl"), images, labels)
    jnl.write_packed(str(tmp_path / "jax.pdl"), images, labels)
    with tnl.PackedWriter(str(tmp_path / "stream.pdl"), 5, 7, 2) as w:
        for image, label in zip(images, labels):
            w.add(image, label)
    want = (tmp_path / "jax.pdl").read_bytes()
    assert (tmp_path / "port.pdl").read_bytes() == want
    assert (tmp_path / "stream.pdl").read_bytes() == want
    assert tnl._MAGIC == jnl._MAGIC
    assert tnl._HEADER.format == jnl._HEADER.format
    with pytest.raises(ValueError, match="sample shape"):
        with tnl.PackedWriter(str(tmp_path / "bad.pdl"), 5, 7, 2) as w:
            w.add(images[0, :4], 0)


def _epochs(loader, n=2):
    with contextlib.closing(loader):
        return loader.num_samples, loader.batches_per_epoch, [
            [(b["image"], b["label"]) for b in loader] for _ in range(n)]


def _by_sample(epoch):
    """An epoch's samples as sorted (label, image bytes) pairs, and its
    batch sizes."""
    rows = [(int(label), image.tobytes()) for images, labels in epoch
            for image, label in zip(images, labels)]
    return sorted(rows), sorted(len(labels) for _, labels in epoch)


CASES = {
    "ordered": dict(batch_size=4, shuffle=False, num_workers=1),
    "shuffled": dict(batch_size=4, shuffle=True, seed=7, num_workers=1),
    "other_seed": dict(batch_size=6, shuffle=True, seed=8, num_workers=1,
                       prefetch_depth=1),
    "shard_1_of_3": dict(batch_size=3, shuffle=True, seed=5, shard_index=1,
                         shard_count=3, num_workers=1),
    "remainder": dict(batch_size=5, shuffle=False, drop_remainder=False,
                      num_workers=1),
    "float32": dict(batch_size=4, shuffle=True, seed=2, num_workers=1,
                    dtype="float32"),
    "four_workers": dict(batch_size=4, shuffle=True, seed=3, num_workers=4,
                         prefetch_depth=8, drop_remainder=False),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_batches_equal_the_jax_loader(packed, case):
    kw = CASES[case]
    ours = _epochs(tnl.NativeLoader(packed, **kw))
    theirs = _epochs(jnl.NativeLoader(packed, **kw))
    assert ours[:2] == theirs[:2]
    for mine, want in zip(ours[2], theirs[2]):
        if kw["num_workers"] > 1:  # order depends on the threads
            assert _by_sample(mine) == _by_sample(want)
            continue
        assert len(mine) == len(want)
        for (ia, la), (ib, lb) in zip(mine, want):
            assert ia.dtype == ib.dtype == np.dtype(kw.get("dtype", "uint8"))
            assert ia.tobytes() == ib.tobytes()
            assert la.dtype == lb.dtype == np.int32
            np.testing.assert_array_equal(la, lb)
    if kw["shuffle"]:  # the second epoch is reshuffled
        assert not all(np.array_equal(a[1], b[1])
                       for a, b in zip(ours[2][0], ours[2][1]))


def test_missing_file_raises(tmp_path):
    with pytest.raises(FileNotFoundError, match="failed to open"):
        tnl.NativeLoader([str(tmp_path / "nope.pdl")], batch_size=4)


def test_library_is_built_from_the_port_sources():
    path = tnl.build_native()
    assert tnl.native_available()
    assert path == tnl.library_path()
    assert path.parent == BUILD_DIR and path.exists()
    assert path.name.startswith("libpddl_io-") and path.suffix == ".so"
    assert os.path.realpath(path) != os.path.realpath(jnl._LIB_PATH)
    assert tnl._load_lib()._name == str(path)
    assert (tnl._CSRC / "pddl_io.cpp").exists()


def test_trainer_fits_tiny_resnet_from_the_loader(tmp_path):
    from pddl_tpu_torch.models.resnet import tiny_resnet
    from pddl_tpu_torch.train.loop import Trainer

    rng = np.random.default_rng(0)
    n, classes = 64, 4
    labels = rng.integers(0, classes, n).astype(np.int32)
    # A class-dependent mean, so the model can fit.
    images = (rng.normal(64, 8, (n, 16, 16, 3)) + labels[:, None, None, None]
              * 40).clip(0, 255).astype(np.uint8)
    path = str(tmp_path / "train.pdl")
    tnl.write_packed(path, images, labels)
    torch.manual_seed(0)
    with tnl.NativeLoader([path], batch_size=16, shuffle=True, seed=0,
                          num_workers=2) as loader:
        tr = Trainer(tiny_resnet(num_classes=classes, device="cpu"),
                     learning_rate=3e-3, device="cpu")
        hist = tr.fit(loader, epochs=3, verbose=0)
    assert hist.history["loss"][-1] < hist.history["loss"][0]
