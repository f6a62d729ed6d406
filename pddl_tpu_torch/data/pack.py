"""Offline packing: ImageNet TFRecord shards → PDL1 packed files (the port
of :mod:`pddl_tpu.data.pack`: the same packed bytes for the same records).

The reference decodes + resizes JPEGs inside tf.data on every epoch of
every run (``imagenet-resnet50.py:36-49``). Here that work is one-time:
stream the TFDS/ImageNet TFRecords through the native record layer
(:class:`pddl_tpu_torch.data.tfrecord.TFRecordReader` — CRC-checked,
shardable), decode + statically resize each JPEG once on the host, and
write fixed-shape uint8 samples
(:class:`pddl_tpu_torch.data.native_loader.PackedWriter`). Training then
runs on the pure-native :class:`NativeLoader` (threaded reads, ring-buffer
prefetch, per-epoch shuffle) with zero per-epoch decode cost — the random
crop/flip augmentation stays on the device inside the train step
(``pddl_tpu_torch/ops/augment.py``), where the reference ran it too (Keras
preprocessing layers, ``imagenet-resnet50.py:53-55``).

Per-host usage (each host packs its own shard of the record sequence)::

    pack_imagenet_tfrecords(files, f"train-{proc}.pdl1",
                            shard_index=proc, shard_count=n_procs)

TensorFlow (CPU) is used only here, only for JPEG decode + resize.
"""

from __future__ import annotations

import os
from typing import Optional, Sequence

from pddl_tpu_torch.data.native_loader import PackedWriter
from pddl_tpu_torch.data.tfrecord import TFRecordReader


def pack_imagenet_tfrecords(
    files: Sequence[str],
    out_path: str,
    *,
    image_size: int = 224,
    shard_index: int = 0,
    shard_count: int = 1,
    label_offset: int = 0,
    limit: Optional[int] = None,
    verify: bool = True,
) -> int:
    """Pack this process's shard of ``files`` into one PDL1 file.

    Records must carry the standard ImageNet schema (``image/encoded``
    JPEG bytes, ``image/class/label`` int64 — the TFDS layout the
    reference loads, ``imagenet-resnet50.py:20-34``). Images are resized
    with crop-or-pad to ``image_size`` (the reference's map-time
    preprocess, ``:36-41``) and stored uint8 RGB. Returns the number of
    samples written. ``label_offset`` is added to stored labels (use -1
    for 1-indexed ImageNet label sets).
    """
    import tensorflow as tf  # CPU-only decode/resize, import-heavy

    feature_spec = {
        "image/encoded": tf.io.FixedLenFeature([], tf.string),
        "image/class/label": tf.io.FixedLenFeature([], tf.int64),
    }

    reader = TFRecordReader(
        files, shard_index=shard_index, shard_count=shard_count, verify=verify
    )
    n = 0
    try:
        with PackedWriter(out_path, image_size, image_size, 3) as writer:
            for payload in reader:
                ex = tf.io.parse_single_example(payload, feature_spec)
                image = tf.io.decode_image(
                    ex["image/encoded"], channels=3, expand_animations=False
                )
                image = tf.image.resize_with_crop_or_pad(
                    image, image_size, image_size
                )
                writer.add(
                    image.numpy(),
                    int(ex["image/class/label"]) + label_offset,
                )
                n += 1
                if limit is not None and n >= limit:
                    break
    finally:
        reader.close()
    return n


def main(argv: Optional[Sequence[str]] = None) -> None:
    """CLI: ``python -m pddl_tpu_torch.data.pack <tfrecord>... -o out.pdl1``."""
    import argparse

    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("files", nargs="+", help="input TFRecord shards")
    p.add_argument("-o", "--out", required=True, help="output .pdl1 path")
    p.add_argument("--image-size", type=int, default=224)
    p.add_argument("--shard-index", type=int, default=0)
    p.add_argument("--shard-count", type=int, default=1)
    p.add_argument("--label-offset", type=int, default=0)
    p.add_argument("--limit", type=int, default=None)
    args = p.parse_args(argv)
    n = pack_imagenet_tfrecords(
        args.files, args.out, image_size=args.image_size,
        shard_index=args.shard_index, shard_count=args.shard_count,
        label_offset=args.label_offset, limit=args.limit,
    )
    print(f"packed {n} samples -> {os.path.abspath(args.out)}")


if __name__ == "__main__":
    main()
