"""ImageNet-2012 ingest: a CPU tf.data pipeline feeding host numpy batches
(the port of :mod:`pddl_tpu.data.imagenet`: the same sources, sharding and
batches; ``Trainer`` moves each batch to the card).

Parity surface (SURVEY.md §2a C7/C8): the reference loads ``imagenet2012``
via TFDS from pre-downloaded tars (``imagenet-resnet50.py:12-34``), maps a cast→``resize_with_crop_or_pad(224)`` preprocess with
``num_parallel_calls=AUTOTUNE`` (``:36-45``), then ``.batch(B,
drop_remainder=True).prefetch(AUTOTUNE)`` (``:46-49``). Distribution modes
differ only in *sharding*:

- ``MultiWorkerMirroredStrategy``: ``AutoShardPolicy.DATA`` — each worker
  keeps every ``n``-th *example* (``imagenet-resnet50-multiworkers.py:66-69``).
- Horovod: ``.shard(size, rank)`` applied **after** batching — each rank
  keeps every ``n``-th *batch* (``imagenet-resnet50-hvd.py:77-81``).
- single/mirrored: no sharding.

This module reproduces all three as the ``shard`` knob (``"data"`` /
``"batch"`` / ``"none"``). Split of responsibilities: the host pipeline
only decodes/crops/batches uint8→float32 tensors; normalization and random
augmentation run **on the device** inside the train step
(:mod:`pddl_tpu_torch.ops.augment`), so host CPU work is minimal.

TensorFlow is used strictly as a CPU input-pipeline library (accelerators
are hidden from it, so it never takes the card's memory); every TF import
is local so the rest of the framework works without TF installed.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Any, Dict, Iterator, Optional, Tuple

import numpy as np

IMAGE_SIZE = 224  # the reference's fixed input (imagenet-resnet50.py:40)
NUM_CLASSES = 1000


def _tf():
    """Import TensorFlow lazily, CPU-pinned (it must never grab the card)."""
    try:
        import tensorflow as tf  # noqa: PLC0415
    except ImportError as e:  # pragma: no cover - env without TF
        raise ImportError(
            "pddl_tpu_torch.data.imagenet needs TensorFlow (CPU) for the "
            "tf.data pipeline; install tensorflow-cpu or use "
            "pddl_tpu_torch.data.SyntheticImageClassification"
        ) from e
    for kind in ("GPU", "TPU"):
        try:
            tf.config.set_visible_devices([], kind)
        except Exception:
            pass
    return tf


@dataclasses.dataclass
class ImageNetConfig:
    """Pipeline configuration (the reference's hard-coded choices, exposed).

    ``global_batch_size`` is the *global* batch; with ``shard="data"`` each
    host batches ``global/process_count`` examples, with ``shard="batch"``
    each host batches the full global size and keeps every ``n``-th batch,
    with ``shard="none"`` every host sees identical global batches.
    """

    data_dir: str = ""
    split: str = "train"
    global_batch_size: int = 32  # reference default (imagenet-resnet50.py:46)
    image_size: int = IMAGE_SIZE
    num_classes: int = NUM_CLASSES
    shard: str = "data"  # "data" | "batch" | "none"
    process_index: int = 0
    process_count: int = 1
    shuffle: bool = True
    shuffle_buffer: int = 2048
    seed: int = 0
    drop_remainder: bool = True  # reference batches drop_remainder=True (:46)
    # .repeat()ed streams à la the PS script (:118-119). Usually
    # unnecessary: under steps_per_epoch the Trainer already re-iterates a
    # finite dataset when it drains (fresh __iter__ per pass). With
    # repeat=True the tf.data stream is endless, so the trainer-level
    # re-iteration never engages and epoch-boundary reshuffling is tf's
    # reshuffle_each_iteration instead of a fresh pipeline pass.
    repeat: bool = False
    cache: bool = False
    dtype: str = "float32"

    @property
    def local_batch_size(self) -> int:
        if self.shard == "data":
            if self.global_batch_size % self.process_count:
                raise ValueError(
                    f"global batch {self.global_batch_size} not divisible by "
                    f"{self.process_count} processes"
                )
            return self.global_batch_size // self.process_count
        return self.global_batch_size


class ImageNetDataset:
    """Re-iterable dataset of ``{"image": f32[B,H,W,3], "label": i32[B]}``.

    Sources, tried in order:

    1. **TFDS** (``tfds.load('imagenet2012')``) when tensorflow_datasets is
       importable and ``data_dir`` holds a prepared TFDS tree — the
       reference's own ingest path (``imagenet-resnet50.py:20-34``).
    2. **TFRecords** matching ``<data_dir>/<split>*`` in the standard
       ImageNet TFRecord schema (``image/encoded``, ``image/class/label``).
    3. **Image folders** ``<data_dir>/<split>/<class_name>/*.JPEG`` with
       classes sorted lexicographically → label ids.

    The pipeline yields host-local numpy batches; hand the iterable to
    ``Trainer.fit``, which takes this process's rows through the
    strategy's ``distribute_batch`` and moves them to the device.
    """

    def __init__(self, config: ImageNetConfig):
        self.config = config
        self._ds = None  # built lazily; re-iterable once built

    # ------------------------------------------------------------- sources
    def _load_source(self):
        """Return an unbatched tf.data.Dataset of (encoded_or_image, label)."""
        cfg = self.config
        tf = _tf()

        # 1. TFDS tree.
        try:
            import tensorflow_datasets as tfds  # noqa: PLC0415

            if cfg.data_dir and os.path.isdir(
                os.path.join(cfg.data_dir, "imagenet2012")
            ):
                # Seeded file shuffling: every process must see the SAME
                # file order or the downstream per-example ds.shard() keeps
                # overlapping/dropped subsets across hosts.
                ds = tfds.load(
                    "imagenet2012",
                    split=cfg.split,
                    data_dir=cfg.data_dir,
                    shuffle_files=cfg.shuffle,
                    as_supervised=True,  # (image, label), reference :33
                    read_config=tfds.ReadConfig(shuffle_seed=cfg.seed),
                )
                return ds, True  # already-decoded images
        except ImportError:
            pass

        # 2. TFRecord shards.
        pattern = os.path.join(cfg.data_dir, f"{cfg.split}*")
        files = sorted(tf.io.gfile.glob(pattern)) if cfg.data_dir else []
        files = [f for f in files if not os.path.isdir(f)]
        if files:
            file_ds = tf.data.Dataset.from_tensor_slices(files)
            if cfg.shuffle:
                file_ds = file_ds.shuffle(len(files), seed=cfg.seed)
            ds = file_ds.interleave(
                tf.data.TFRecordDataset,
                cycle_length=min(16, len(files)),
                num_parallel_calls=tf.data.AUTOTUNE,
            )

            feature_spec = {
                "image/encoded": tf.io.FixedLenFeature([], tf.string),
                "image/class/label": tf.io.FixedLenFeature([], tf.int64),
            }

            def _parse(record):
                ex = tf.io.parse_single_example(record, feature_spec)
                return ex["image/encoded"], tf.cast(ex["image/class/label"], tf.int64)

            return ds.map(_parse, num_parallel_calls=tf.data.AUTOTUNE), False

        # 3. Image-folder layout.
        split_dir = os.path.join(cfg.data_dir, cfg.split)
        if os.path.isdir(split_dir):
            classes = sorted(
                d for d in os.listdir(split_dir)
                if os.path.isdir(os.path.join(split_dir, d))
            )
            paths, labels = [], []
            for idx, cls in enumerate(classes):
                for fname in sorted(os.listdir(os.path.join(split_dir, cls))):
                    paths.append(os.path.join(split_dir, cls, fname))
                    labels.append(idx)
            if paths:
                ds = tf.data.Dataset.from_tensor_slices(
                    (paths, np.asarray(labels, np.int64))
                )

                def _read(path, label):
                    return tf.io.read_file(path), label

                return ds.map(_read, num_parallel_calls=tf.data.AUTOTUNE), False

        raise FileNotFoundError(
            f"no ImageNet source found under {cfg.data_dir!r} "
            f"(tried TFDS tree, TFRecords {cfg.split}*, and image folders "
            f"{cfg.split}/<class>/); for ImageNet-free runs use "
            "pddl_tpu_torch.data.SyntheticImageClassification"
        )

    # ------------------------------------------------------------ pipeline
    def build(self):
        """Construct the tf.data pipeline (idempotent)."""
        if self._ds is not None:
            return self._ds
        cfg = self.config
        tf = _tf()
        ds, decoded = self._load_source()

        # DATA auto-shard analogue: every process keeps its n-th example
        # (imagenet-resnet50-multiworkers.py:66-69).
        if cfg.shard == "data" and cfg.process_count > 1:
            ds = ds.shard(cfg.process_count, cfg.process_index)

        if cfg.cache:
            ds = ds.cache()
        if cfg.shuffle:
            ds = ds.shuffle(cfg.shuffle_buffer, seed=cfg.seed,
                            reshuffle_each_iteration=True)
        if cfg.repeat:
            ds = ds.repeat()

        size = cfg.image_size

        def _preprocess(image_or_bytes, label):
            # Reference map step: cast float32 + crop/pad to 224
            # (imagenet-resnet50.py:36-41). Decode first for raw sources.
            img = image_or_bytes
            if not decoded:
                img = tf.io.decode_image(
                    img, channels=3, expand_animations=False
                )
            img = tf.cast(img, tf.float32)
            img = tf.image.resize_with_crop_or_pad(img, size, size)
            img.set_shape((size, size, 3))
            return img, tf.cast(label, tf.int32)

        ds = ds.map(_preprocess, num_parallel_calls=tf.data.AUTOTUNE)
        ds = ds.batch(cfg.local_batch_size, drop_remainder=cfg.drop_remainder)

        # Horovod scheme: shard AFTER batching — each rank keeps every n-th
        # global-size batch (imagenet-resnet50-hvd.py:77-81). Global batch is
        # then B×n with per-rank step count shrunk by n, exactly the
        # reference's (quirky) arithmetic.
        if cfg.shard == "batch" and cfg.process_count > 1:
            ds = ds.shard(cfg.process_count, cfg.process_index)

        ds = ds.prefetch(tf.data.AUTOTUNE)
        self._ds = ds
        return ds

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        ds = self.build()
        for image, label in ds.as_numpy_iterator():
            yield {"image": image, "label": label}

    def cardinality(self) -> int:
        """Known batch count, or -1 (unknown/infinite)."""
        tf = _tf()
        n = int(tf.data.experimental.cardinality(self.build()).numpy())
        return n if n >= 0 else -1


def load_imagenet(
    data_dir: str,
    train_batch_size: int,
    val_batch_size: Optional[int] = None,
    shard: str = "data",
    process_index: int = 0,
    process_count: int = 1,
    image_size: int = IMAGE_SIZE,
    seed: int = 0,
    **kwargs: Any,
) -> Tuple[ImageNetDataset, ImageNetDataset]:
    """Train + validation pipelines, the reference's two splits
    (``imagenet-resnet50.py:33``). Validation never shuffles; with
    ``shard="batch"`` validation is rank-sharded too, reproducing the
    Horovod script's per-rank val metrics (``imagenet-resnet50-hvd.py:81``,
    averaged via ``MetricAverageCallback``)."""
    val_batch_size = val_batch_size or train_batch_size
    common = dict(
        data_dir=data_dir, image_size=image_size, shard=shard,
        process_index=process_index, process_count=process_count, seed=seed,
    )
    # kwargs may override any config field; validation shuffling stays off
    # regardless (reference semantics: the validation split is never
    # shuffled — only `shuffle_files` on train, imagenet-resnet50.py:28-33).
    train_cfg = {**common, "shuffle": True, **kwargs,
                 "split": "train", "global_batch_size": train_batch_size}
    val_cfg = {**common, **kwargs, "shuffle": False,
               "split": "validation", "global_batch_size": val_batch_size}
    train = ImageNetDataset(ImageNetConfig(**train_cfg))
    val = ImageNetDataset(ImageNetConfig(**val_cfg))
    return train, val
