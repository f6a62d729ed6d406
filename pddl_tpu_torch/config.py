"""Experiment configuration + the 8 reference-script presets (the port of
:mod:`pddl_tpu.config`: the same dataclass, the same presets, the same
field values).

The reference has essentially no config system (SURVEY.md §5 "Config / flag
system"): hard-coded paths and batch sizes, one commented-out argparse
(``imagenet-resnet50-hvd.py:17-23``) and one with broken
flag names ``' -- ps'``/``' -- worker'`` (``imagenet-resnet50-ps.py:21-27``).
This module replaces all of that with one dataclass and a preset per
reference script, so every experiment the reference expresses as a separate
file is here a named configuration over the same library.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional

# Reference batch arithmetic, cited per script (SURVEY.md §6):
#   single/mirrored: 32/replica (imagenet-resnet50.py:46, -mirror.py:54)
#   multiworker scratch: 128/replica train, 256 val (-multiworkers.py:70-72)
#   multiworker pretrained: 32/replica both (-pretrained-...-multiworkers.py:63-65)
#   hvd: 32/replica, post-batch shard (-hvd.py:77-81)
#   ps: 32 global, repeat + fixed steps (-ps.py:118-119,142-143)


@dataclasses.dataclass
class ExperimentConfig:
    """Everything a reference script hard-codes, as data."""

    name: str = "experiment"
    # model
    model: str = "resnet50"
    num_classes: int = 1000
    pretrained_h5: Optional[str] = None  # weights='imagenet' analogue: local .h5
    # The reference's weights='imagenet' itself
    # (imagenet-pretrained-resnet50.py:56): when set and pretrained_h5 is
    # not, the official keras-applications file is resolved from the local
    # cache (ckpt/fetch.py), downloading only with download_weights=True —
    # training hosts can't be assumed to have egress.
    weights: Optional[str] = None
    download_weights: bool = False  # explicit opt-in (--download-weights)
    bn_mode: str = "train"  # "frozen" reproduces the reference's training=False
    # ResNet stem: "keras" (exact keras.applications shape) or
    # "space_to_depth" (MLPerf-style throughput variant, same function —
    # models/resnet.py; pretrained .h5 stems import via the exact kernel
    # transform either way).
    stem: str = "keras"
    compute_dtype: str = "bfloat16"
    # The dtypes stay strings; run.py maps them to torch.bfloat16 /
    # torch.float32. Parameter (and thus optimizer-moment) STORAGE dtype:
    # "bfloat16" halves weight+optimizer memory, but bf16 Adam moments are
    # a convergence hazard; see docs/CONVERGENCE.md's f32-vs-bf16
    # comparison before using it for quality-critical training.
    param_dtype: str = "float32"
    # Update rule for bf16 param storage: "plain" (round-to-nearest,
    # measured +2.4% val loss at 304M), "stochastic_round" (unbiased,
    # same memory — the default recipe fix), or "f32_master" (exact
    # master copy). Ignored for float32 params.
    # See train/mixed_precision.py and docs/CONVERGENCE.md.
    param_update: str = "plain"
    # transformer families only: activation rematerialization policy
    # ("none" | "dots" | "full" — models/vit.py REMAT_POLICIES)
    remat: Optional[str] = None
    # data
    data_dir: Optional[str] = None  # None → synthetic
    image_size: int = 224
    # synthetic image task only: class-mean separation in noise-std units
    # (data/synthetic.py signal_strength). The default 1.0 is a WEAK
    # per-pixel signal — a finite replayed epoch lets a big model
    # memorize instead of generalize and val sits at chance; raise it
    # (e.g. 4.0) when a run needs the val metrics to really track
    # learning, as real ImageNet's do (examples/workflow_rehearsal.py).
    synthetic_signal: float = 1.0
    # ResNet family: BatchNorm moving-average momentum override. None →
    # the Keras-parity 0.99. Lower (e.g. 0.9) for short synthetic runs so
    # inference-mode val metrics converge within the run — see
    # models/resnet.py bn_momentum.
    bn_momentum: Optional[float] = None
    per_replica_batch: int = 32
    val_per_replica_batch: Optional[int] = None
    data_shard: str = "data"  # "data" | "batch" | "none"
    # language-model runs (models named gpt_*): sequence length of the
    # synthetic next-token task; vocab comes from num_classes.
    seq_len: int = 64
    # pad the LM embed/head vocab dim to a multiple (Megatron convention;
    # needed for vocab-parallel TP on real vocab sizes)
    vocab_multiple: int = 1
    # strategy
    strategy: str = "single"  # single|mirrored|multiworker|ps|
    #                           tensor_parallel|expert_parallel|pipeline
    strategy_options: Dict[str, Any] = dataclasses.field(default_factory=dict)
    # optimizer / schedule
    optimizer: str = "adam"
    learning_rate: float = 1e-3  # Keras Adam default (compile at :62)
    scale_lr: bool = False  # Horovod's 0.1*size rule (-hvd.py:99)
    # compiled step->LR schedule (train/state.py make_schedule); None keeps
    # the reference's callback-driven LR control
    lr_schedule: Optional[str] = None
    lr_schedule_options: Dict[str, Any] = dataclasses.field(default_factory=dict)
    ema_decay: Optional[float] = None  # EMA of params; eval uses the shadow
    # average gradients over k micro-batches per optimizer update (large
    # effective batch without the HBM)
    gradient_accumulation_steps: Optional[int] = None
    epochs: int = 50  # reference (imagenet-resnet50.py:67)
    steps_per_epoch: Optional[int] = None
    warmup_epochs: int = 0  # hvd preset: 3 (-hvd.py:114)
    # reference callbacks (imagenet-resnet50.py:64-65)
    reduce_lr_on_plateau: bool = True
    early_stopping: bool = True
    # augmentation (model-graph layers :53-55; crop 160 in hvd :89)
    crop: Optional[int] = None  # None → image_size
    flip: bool = True
    # persistence
    checkpoint_dir: Optional[str] = None
    resume: bool = False
    # Step-granular verified checkpointing cadence (CheckpointEveryN):
    # None keeps epoch-granular saves only. With --resume, a killed run
    # restarts MID-epoch from the newest verified save.
    checkpoint_every_steps: Optional[int] = None
    save_path: Optional[str] = None  # final export (model.save analogue :69-72)
    # observability
    # torch.profiler traces, CUDA and CPU activity (utils/profiling)
    profile_dir: Optional[str] = None
    # misc
    seed: int = 0
    verbose: int = 2  # reference verbose=2 (:67)

    def replace(self, **kw) -> "ExperimentConfig":
        return dataclasses.replace(self, **kw)


# One preset per reference script. The pretrained variants carry
# weights="imagenet" like the reference; the file resolves from the local
# cache (or --pretrained-h5 / --download-weights — a training host does not
# download Keras weights implicitly).
PRESETS: Dict[str, ExperimentConfig] = {
    # imagenet-resnet50.py — single device, from scratch
    "single": ExperimentConfig(
        name="ResNet50_ImageNet", strategy="single", per_replica_batch=32,
    ),
    # imagenet-pretrained-resnet50.py — single device, frozen-BN fine-tune
    "single-pretrained": ExperimentConfig(
        name="ResNet50_ImageNet_pretrained", weights="imagenet", strategy="single",
        per_replica_batch=32, bn_mode="frozen",
    ),
    # imagenet-resnet50-mirror.py — single-host sync DP, 32×replicas
    "mirrored": ExperimentConfig(
        name="ResNet50_ImageNet_mirror", strategy="mirrored",
        per_replica_batch=32,
    ),
    # imagenet-pretrained-resnet50-mirror.py
    "mirrored-pretrained": ExperimentConfig(
        name="ResNet50_ImageNet_mirror_pretrained", weights="imagenet", strategy="mirrored",
        per_replica_batch=32, bn_mode="frozen",
    ),
    # imagenet-resnet50-multiworkers.py — multi-host DP, 128×n train/256×n val
    "multiworker": ExperimentConfig(
        name="ResNet50_ImageNet_multiworker", strategy="multiworker",
        per_replica_batch=128, val_per_replica_batch=256, data_shard="data",
    ),
    # imagenet-pretrained-resnet50-multiworkers.py — 32×n both, frozen BN
    "multiworker-pretrained": ExperimentConfig(
        name="ResNet50_ImageNet_multiworker_pretrained", weights="imagenet", strategy="multiworker",
        per_replica_batch=32, bn_mode="frozen",
    ),
    # imagenet-resnet50-hvd.py — DP with hvd semantics: LR 0.1×size,
    # 3-epoch warmup, post-batch sharding, crop 160 (:89,99,114,77-81).
    # ReduceLROnPlateau + EarlyStopping run alongside the warmup callbacks
    # exactly as in the reference's callback list (:106-107); warmup owns
    # the LR for epochs 0-2 (it re-sets it every batch), plateau reductions
    # stick only once warmup releases — see
    # tests/test_callbacks.py::test_warmup_and_plateau_compose.
    "hvd": ExperimentConfig(
        name="ResNet50_ImageNet_hvd", strategy="multiworker",
        per_replica_batch=32, data_shard="batch", learning_rate=0.1,
        scale_lr=True, warmup_epochs=3, crop=160,
    ),
    # imagenet-resnet50-ps.py — sharded-state PS analogue, repeated stream
    # with fixed steps/epoch (:118-119,142-143 — we default to data-derived
    # steps rather than the reference's wrong 312500). The reference PS
    # script keeps both val_loss callbacks too (:139-140).
    "ps": ExperimentConfig(
        name="ResNet50_ImageNet_ps", strategy="ps", per_replica_batch=32,
    ),
}


def get_preset(name: str, **overrides) -> ExperimentConfig:
    try:
        cfg = PRESETS[name]
    except KeyError:
        raise ValueError(
            f"unknown preset {name!r}; known: {sorted(PRESETS)}"
        ) from None
    return cfg.replace(**overrides) if overrides else cfg
