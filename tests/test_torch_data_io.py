"""The port's data modules against the JAX package's on the same files:
the TFRecord layer (``data/tfrecord.py`` and its C++ reader), the token
corpus (``data/text.py``), the ImageNet pipeline (``data/imagenet.py``,
TensorFlow as a CPU input library, over JPEG TFRecords, image folders and
a stand-in TFDS module) and the packer (``data/pack.py``). Records,
batches and packed files are held equal exactly."""

import dataclasses
import os
import struct
import sys
import types

import numpy as np
import pytest
import torch

from pddl_tpu.data import imagenet as jax_imagenet
from pddl_tpu.data import pack as jax_pack
from pddl_tpu.data import text as jax_text
from pddl_tpu.data import tfrecord as jax_tfr

from pddl_tpu_torch.data import imagenet as port_imagenet
from pddl_tpu_torch.data import pack as port_pack
from pddl_tpu_torch.data import text as port_text
from pddl_tpu_torch.data import tfrecord as port_tfr

from conftest import native_build_error

# One torch thread a process under xdist: the suite's workers share the
# host's cores, and a torch thread pool in each worker oversubscribes them.
if os.environ.get("PYTEST_XDIST_WORKER"):
    torch.set_num_threads(1)


@pytest.fixture(scope="module")
def native():
    """Both packages' native libraries, built; the native cases skip only
    where one cannot be built."""
    error = native_build_error(tfrecord=True)
    if not error:
        try:
            port_tfr._tfr_lib()
        except Exception as e:  # noqa: BLE001 - any failure means "skip"
            error = str(e)
    if error:
        pytest.skip(f"native library unbuildable: {error}")


def _records(n, seed=0, empty_every=7):
    """Seeded records of mixed lengths, every ``empty_every``-th empty."""
    rng = np.random.default_rng(seed)
    return [b"" if i % empty_every == 0 else rng.bytes(int(k))
            for i, k in enumerate(rng.integers(1, 400, size=n))]


def _files(tmp_path, recs, n_files=3):
    paths, per = [], -(-len(recs) // n_files)
    for f in range(n_files):
        p = str(tmp_path / f"part-{f}.tfrecord")
        # Both packages' writers give the same bytes.
        port_tfr.write_tfrecord(p, recs[f * per:(f + 1) * per])
        q = str(tmp_path / f"jax-{f}.tfrecord")
        jax_tfr.write_tfrecord(q, recs[f * per:(f + 1) * per])
        with open(p, "rb") as a, open(q, "rb") as b:
            assert a.read() == b.read()
        paths.append(p)
    return paths


def test_crc_and_python_framing_match_jax():
    for data in (b"", b"a", b"123456789", bytes(range(256)) * 7):
        assert port_tfr.crc32c(data) == jax_tfr.crc32c(data)
        assert port_tfr.masked_crc32c(data) == jax_tfr.masked_crc32c(data)
    assert port_tfr.crc32c(b"123456789") == 0xE3069283


def test_native_crc_matches_python(native):
    for data in (b"", b"a", b"123456789", bytes(range(256)) * 7):
        assert port_tfr.native_crc32c(data) == port_tfr.crc32c(data)
        assert (port_tfr.native_masked_crc32c(data)
                == jax_tfr.native_masked_crc32c(data))


@pytest.mark.parametrize("mode", ["sequential", "shards", "shuffled"])
def test_native_reader_matches_jax(tmp_path, native, mode):
    """The same records, in the same order, epoch after epoch: the same
    C++ source, so shards and seeded shuffles agree record for record."""
    recs = _records(90)
    paths = _files(tmp_path, recs)
    if mode == "sequential":
        kws = [{}]
    elif mode == "shards":
        kws = [dict(shard_index=i, shard_count=4) for i in range(4)]
    else:
        kws = [dict(shuffle=True, seed=s) for s in (3, 11)]
    seen = []
    for kw in kws:
        port = port_tfr.TFRecordReader(paths, **kw)
        ref = jax_tfr.TFRecordReader(paths, **kw)
        assert (port.num_records, port.total_records) == (
            ref.num_records, ref.total_records)
        for _ in range(2):  # a second epoch (reshuffled when shuffling)
            got = list(port)
            assert got == list(ref)
            seen.append(got)
        port.close()
        ref.close()
    if mode == "sequential":
        assert seen[0] == recs
    elif mode == "shards":
        # Disjoint and complete: shard i is every 4th record from i.
        for i in range(4):
            assert seen[2 * i] == recs[i::4]
    else:
        assert sorted(seen[0]) == sorted(recs) and seen[0] != recs
        assert seen[1] != seen[0]


def test_python_reader_and_counts_match_jax(tmp_path):
    recs = _records(30)
    paths = _files(tmp_path, recs, n_files=2)
    for p in paths:
        assert (list(port_tfr.read_tfrecord(p))
                == list(jax_tfr.read_tfrecord(p)))
        assert port_tfr.count_records(p) == jax_tfr.count_records(p)
    py = port_tfr.open_tfrecords(paths, native=False)
    assert list(py) == recs
    assert len(py) == py.num_records == py.total_records == len(recs)
    assert list(port_tfr.open_tfrecords(paths)) == recs
    for pkg in (port_tfr, jax_tfr):
        with pytest.raises(RuntimeError, match="sequential/unsharded"):
            pkg.open_tfrecords(paths, native=False, shuffle=True)


def _corrupt(path, offset, data):
    with open(path, "r+b") as f:
        f.seek(offset)
        f.write(data)


def test_corruption_errors_match_jax(tmp_path, native):
    recs = [b"abcdef" * 3, b"xyz" * 5, b"", b"q" * 9]
    payload = str(tmp_path / "payload.tfrecord")
    port_tfr.write_tfrecord(payload, recs)
    _corrupt(payload, 12 + 2, b"\x00")  # inside record 0's payload
    for pkg in (port_tfr, jax_tfr):
        with pytest.raises(IOError, match="payload CRC"):
            list(pkg.read_tfrecord(payload))
        with pytest.raises(IOError, match="TFRecord read error"):
            list(pkg.TFRecordReader([payload]))
    # verify=False lets the flipped byte through, in both.
    got = list(port_tfr.TFRecordReader([payload], verify=False))
    assert got == list(jax_tfr.TFRecordReader([payload], verify=False))
    assert got[1:] == recs[1:] and got[0] != recs[0]

    length = str(tmp_path / "length.tfrecord")
    port_tfr.write_tfrecord(length, recs)
    _corrupt(length, 0, struct.pack("<Q", 1 << 40))
    for pkg in (port_tfr, jax_tfr):
        with pytest.raises(FileNotFoundError, match="corrupt framing"):
            pkg.TFRecordReader([length])
        with pytest.raises(IOError, match="length CRC"):
            list(pkg.read_tfrecord(length))


# ------------------------------------------------------------ token corpus
def _corpus(root, n_bytes=6000, with_val=True):
    rng = np.random.default_rng(5)
    words = [b"tpu", b"gpu", b"hopper", b"ring", b"flash", b"ps", b"mesh"]
    text = b" ".join(words[i] for i in rng.integers(0, len(words), 2000))
    os.makedirs(root, exist_ok=True)
    with open(os.path.join(root, "train.txt"), "wb") as f:
        f.write(text[:n_bytes])
    if with_val:
        with open(os.path.join(root, "val.txt"), "wb") as f:
            f.write(text[n_bytes // 2:n_bytes // 2 + 1500])
    return root


def test_encode_text_file_matches_jax(tmp_path):
    port_dir = _corpus(str(tmp_path / "port"))
    jax_dir = _corpus(str(tmp_path / "jax"))
    got = port_text.encode_text_file(os.path.join(port_dir, "train.txt"),
                                     os.path.join(port_dir, "train.bin"))
    want = jax_text.encode_text_file(os.path.join(jax_dir, "train.txt"),
                                     os.path.join(jax_dir, "train.bin"))
    assert got == want
    for name in ("train.bin", "meta.json"):
        with open(os.path.join(port_dir, name), "rb") as a, \
                open(os.path.join(jax_dir, name), "rb") as b:
            assert a.read() == b.read()
    assert port_text.read_meta(port_dir) == jax_text.read_meta(jax_dir)


@pytest.mark.parametrize("procs", [1, 2])
def test_token_batches_match_jax_across_shards_and_epochs(tmp_path, procs):
    """Element for element: train (shuffled, reshuffled per epoch) and val
    (file order), for every process's shard."""
    root = _corpus(str(tmp_path / "c"))
    for rank in range(procs):
        kw = dict(seq_len=16, train_batch_size=4 * procs,
                  val_batch_size=2 * procs, seed=3, process_index=rank,
                  process_count=procs)
        port = port_text.load_token_corpus(root, **kw)
        ref = jax_text.load_token_corpus(root, **kw)
        for p_ds, j_ds in zip(port, ref):
            assert p_ds.batches_per_epoch == j_ds.batches_per_epoch > 0
            assert p_ds.max_token() == j_ds.max_token()
            for _ in range(2):
                got, want = list(p_ds), list(j_ds)
                assert len(got) == len(want) == p_ds.batches_per_epoch
                for g, w in zip(got, want):
                    for key in ("tokens", "targets"):
                        assert g[key].dtype == w[key].dtype == np.int32
                        np.testing.assert_array_equal(g[key], w[key])


def test_token_corpus_errors_match_jax(tmp_path):
    empty = str(tmp_path / "empty")
    os.makedirs(empty)
    for pkg in (port_text, jax_text):
        with pytest.raises(FileNotFoundError, match="no train.bin"):
            pkg.load_token_corpus(empty, seq_len=8, train_batch_size=2,
                                  val_batch_size=2)
    root = _corpus(str(tmp_path / "c"), with_val=False)
    for pkg in (port_text, jax_text):
        with pytest.raises(ValueError, match="not divisible"):
            pkg.load_token_corpus(root, seq_len=8, train_batch_size=3,
                                  val_batch_size=2, process_count=2)


# ------------------------------------------------------------- ImageNet
@pytest.fixture(scope="module")
def tf():
    """TensorFlow, the ImageNet path's CPU input library; the tests that
    take it skip where it is not installed."""
    return pytest.importorskip("tensorflow")


def _example(image, label):
    import tensorflow as tf

    jpeg = tf.io.encode_jpeg(tf.constant(image), quality=90).numpy()
    return tf.train.Example(features=tf.train.Features(feature={
        "image/encoded": tf.train.Feature(
            bytes_list=tf.train.BytesList(value=[jpeg])),
        "image/class/label": tf.train.Feature(
            int64_list=tf.train.Int64List(value=[label])),
    })).SerializeToString(), jpeg


def _images(n, size, seed=0):
    rng = np.random.default_rng(seed)
    return rng.integers(0, 256, (n, size, size, 3), dtype=np.uint8)


def _write_jpeg_tfrecords(root, split, n=24, size=12, shards=3):
    os.makedirs(root, exist_ok=True)
    images = _images(n, size, seed=len(split))
    paths = []
    for s in range(shards):
        path = os.path.join(root, f"{split}-{s:05d}-of-{shards:05d}")
        port_tfr.write_tfrecord(path, [
            _example(images[i], i % 7)[0]
            for i in range(s * n // shards, (s + 1) * n // shards)])
        paths.append(path)
    return paths


def _write_jpeg_folders(root, split, classes=3, per_class=5, size=12):
    images = _images(classes * per_class, size, seed=7)
    for c in range(classes):
        d = os.path.join(root, split, f"n{c:08d}")
        os.makedirs(d, exist_ok=True)
        for i in range(per_class):
            with open(os.path.join(d, f"img_{i}.JPEG"), "wb") as f:
                f.write(_example(images[c * per_class + i], c)[1])


def _assert_same_batches(got, want):
    assert len(got) == len(want) > 0
    for g, w in zip(got, want):
        assert set(g) == set(w) == {"image", "label"}
        assert g["image"].dtype == w["image"].dtype == np.float32
        assert g["label"].dtype == w["label"].dtype == np.int32
        np.testing.assert_array_equal(g["image"], w["image"])
        np.testing.assert_array_equal(g["label"], w["label"])
        # uint8-valued f32 pixels
        assert np.array_equal(g["image"], np.round(g["image"]))


@pytest.mark.parametrize("layout", ["tfrecords", "folders"])
@pytest.mark.parametrize("shard", ["data", "batch", "none"])
def test_imagenet_batches_match_jax(tmp_path, tf, layout, shard):
    """Every ``shard`` mode over both on-disk layouts: each process's
    train batches (shuffled by the seed) and validation batches equal the
    JAX pipeline's."""
    root = str(tmp_path)
    for split in ("train", "validation"):
        if layout == "tfrecords":
            _write_jpeg_tfrecords(root, split)
        else:
            _write_jpeg_folders(root, split)
    for rank in range(2):
        kw = dict(train_batch_size=4, val_batch_size=4, shard=shard,
                  process_index=rank, process_count=2, image_size=10,
                  seed=5)
        port = port_imagenet.load_imagenet(root, **kw)
        ref = jax_imagenet.load_imagenet(root, **kw)
        for p_ds, j_ds in zip(port, ref):
            assert (dataclasses.asdict(p_ds.config)
                    == dataclasses.asdict(j_ds.config))
            _assert_same_batches(list(p_ds), list(j_ds))
            assert p_ds.cardinality() == j_ds.cardinality()


def _fake_tfds(tf, n=12, size=10):
    """A stand-in ``tensorflow_datasets`` with ``load``'s call surface,
    returning a real tf.data.Dataset of decoded (image, label) pairs."""
    mod = types.ModuleType("tensorflow_datasets")
    mod.calls = []

    class ReadConfig:
        def __init__(self, shuffle_seed=None):
            self.shuffle_seed = shuffle_seed

    def load(name, *, split, data_dir, shuffle_files, as_supervised,
             read_config):
        mod.calls.append((name, split, data_dir, shuffle_files,
                          as_supervised, read_config.shuffle_seed))
        images = _images(n, size, seed=3)
        return tf.data.Dataset.from_tensor_slices(
            (images, np.arange(n, dtype=np.int64)))

    mod.load, mod.ReadConfig = load, ReadConfig
    return mod


@pytest.mark.parametrize("shard", ["data", "batch", "none"])
def test_imagenet_tfds_path_matches_jax(tmp_path, monkeypatch, tf, shard):
    (tmp_path / "imagenet2012").mkdir()
    calls = []
    for rank in range(2):
        batches = []
        for mod in (port_imagenet, jax_imagenet):
            fake = _fake_tfds(tf)
            monkeypatch.setitem(sys.modules, "tensorflow_datasets", fake)
            cfg = mod.ImageNetConfig(
                data_dir=str(tmp_path), global_batch_size=4, image_size=8,
                shuffle=True, seed=7, shard=shard, process_index=rank,
                process_count=2)
            batches.append(list(mod.ImageNetDataset(cfg)))
            calls.append(fake.calls)
        _assert_same_batches(*batches)
    assert all(c == calls[0] for c in calls)
    assert calls[0][0][:2] == ("imagenet2012", "train")


def test_imagenet_missing_source_raises_like_jax(tmp_path, tf):
    for mod in (port_imagenet, jax_imagenet):
        ds = mod.ImageNetDataset(mod.ImageNetConfig(
            data_dir=str(tmp_path / "nope")))
        with pytest.raises(FileNotFoundError, match="no ImageNet source"):
            ds.build()


# ------------------------------------------------------------------ pack
def test_pack_matches_jax_and_loads(tmp_path, tf, native):
    """Packing the same JPEG TFRecords gives byte-identical PDL1 files
    (whole and per shard), which the port's NativeLoader reads."""
    from pddl_tpu_torch.data.native_loader import NativeLoader

    paths = _write_jpeg_tfrecords(str(tmp_path / "rec"), "train", n=12,
                                  size=20, shards=2)
    for kw in (dict(), dict(shard_index=1, shard_count=2),
               dict(label_offset=-1, limit=5)):
        out_port = str(tmp_path / "port.pdl1")
        out_jax = str(tmp_path / "jax.pdl1")
        n = port_pack.pack_imagenet_tfrecords(paths, out_port,
                                              image_size=16, **kw)
        assert n == jax_pack.pack_imagenet_tfrecords(paths, out_jax,
                                                     image_size=16, **kw)
        with open(out_port, "rb") as a, open(out_jax, "rb") as b:
            assert a.read() == b.read()
    port_pack.main([*paths, "-o", out_port, "--image-size", "16"])
    with NativeLoader([out_port], batch_size=4, shuffle=False,
                      num_workers=1, drop_remainder=False) as loader:
        batches = list(loader)
    labels = [int(x) for b in batches for x in b["label"]]
    assert labels == [i % 7 for i in range(12)]
    assert batches[0]["image"].shape == (4, 16, 16, 3)
