"""Experiment runner + CLI: the reference's 8 scripts as one entry point
(the port of :mod:`pddl_tpu.run`: the same flags, choices, defaults and
refusals, over the port's registry, strategies, trainer and callbacks).

Each reference script is ``python imagenet-resnet50-<variant>.py`` with
everything hard-coded (``imagenet-resnet50.py:1-72`` et al.). Here the
equivalent is::

    python -m pddl_tpu_torch --preset mirrored --data-dir /data/imagenet
    python -m pddl_tpu_torch --preset hvd --synthetic --epochs 2   # smoke run
    python -m pddl_tpu_torch --preset single --synthetic --device cpu \\
        --model tiny_resnet --image-size 32 --steps-per-epoch 2

with working flags (the reference's own argparse attempt used broken names
``' -- ps'``/``' -- worker'``, ``imagenet-resnet50-ps.py:21-27``). The run
trains on the card (``cuda:{local_rank}``) unless ``--device cpu`` asks for
the host; with no card and no ``--device cpu`` it raises before any model
is built. Under ``torchrun`` (or the ``PDDL_*`` environment) each process
drives its own card and the strategies read their ranks from the
environment.
"""

from __future__ import annotations

import argparse
import contextlib
import sys
from typing import Optional

from pddl_tpu_torch.config import ExperimentConfig, PRESETS, get_preset


def _strategy_device(device):
    """The strategies' ``device`` for a requested one: ``None`` (each
    process's own card, ``cuda:{local_rank}``) for ``cuda``, else the
    device itself. Raises when the card is asked for and there is none."""
    import torch

    from pddl_tpu_torch.device import resolve_device

    dev = resolve_device(device)
    return None if dev == torch.device("cuda") else dev


def build_trainer(cfg: ExperimentConfig, strategy=None, device=None):
    """Construct (trainer, callbacks) from a config. Import-heavy, so local.

    Without a ``strategy`` the config's is built on ``device`` (``None``
    means the card); with one, the trainer runs on the strategy's."""
    import torch

    from pddl_tpu_torch.models import registry
    from pddl_tpu_torch.ops.augment import (standard_augment,
                                            standard_eval_transform)
    from pddl_tpu_torch.parallel import get_strategy
    from pddl_tpu_torch.train import callbacks as cb
    from pddl_tpu_torch.train.loop import Trainer

    if strategy is None:
        strategy = get_strategy(cfg.strategy, device=_strategy_device(device),
                                **_strategy_options(cfg))
    dev = strategy.setup().device
    model_kwargs = dict(
        num_classes=cfg.num_classes,
        dtype=(torch.bfloat16 if cfg.compute_dtype == "bfloat16"
               else torch.float32),
        param_dtype=(torch.bfloat16 if cfg.param_dtype == "bfloat16"
                     else torch.float32),
        bn_mode=cfg.bn_mode,
        device=dev,
        seed=cfg.seed,
    )
    # Transformer families only; an explicit "none" is the default and is
    # not forwarded. Other families fail HERE with guidance, not with a
    # model-constructor TypeError.
    if cfg.vocab_multiple > 1:
        if not _is_lm(cfg.model):
            raise ValueError(
                f"--vocab-multiple applies to language models "
                f"(gpt*/llama*), not {cfg.model!r}"
            )
        model_kwargs["vocab_multiple"] = cfg.vocab_multiple
    if cfg.remat and cfg.remat != "none":
        from pddl_tpu_torch.models.registry import REMAT_MODELS

        if cfg.model not in REMAT_MODELS:
            raise ValueError(
                f"--remat applies to transformer models "
                f"({sorted(REMAT_MODELS)}), not {cfg.model!r}"
            )
        model_kwargs["remat"] = cfg.remat
    if cfg.stem != "keras":
        if "resnet" not in cfg.model:
            raise ValueError(
                f"--stem applies to the resnet family, not {cfg.model!r}"
            )
        model_kwargs["stem"] = cfg.stem
    if cfg.bn_momentum is not None:
        if "resnet" not in cfg.model:
            raise ValueError(
                f"--bn-momentum applies to the resnet family (the only "
                f"BatchNorm models), not {cfg.model!r}"
            )
        model_kwargs["bn_momentum"] = cfg.bn_momentum
    # Crop never exceeds the input (the reference's RandomCrop(244) on
    # 224 inputs is the documented bug we deliberately fix — SURVEY.md
    # §0); a preset crop (hvd: 160) shrinks proportionally if
    # image_size is overridden smaller.
    crop = min(cfg.crop or cfg.image_size, cfg.image_size)
    if "vit" in cfg.model:
        # The port's ViT sizes its patch grid at construction (flax infers
        # it at init): the augment's and the eval transform's crop.
        model_kwargs["image_size"] = crop
    model = registry.get_model(cfg.model, **model_kwargs)

    lr = cfg.learning_rate
    if cfg.scale_lr:  # Horovod's 0.1*size (imagenet-resnet50-hvd.py:99)
        lr = strategy.scale_learning_rate(lr)

    schedule_options = dict(cfg.lr_schedule_options)
    if cfg.lr_schedule and "decay_steps" not in schedule_options:
        if cfg.steps_per_epoch:
            # Default horizon: the full run, counted in OPTIMIZER updates —
            # with --grad-accum k, the schedule advances once per k
            # micro-batches, so the micro-step total over-counts the
            # horizon k-fold.
            accum = cfg.gradient_accumulation_steps or 1
            schedule_options["decay_steps"] = max(
                1, cfg.steps_per_epoch * cfg.epochs // accum
            )
        elif cfg.lr_schedule not in ("constant", "piecewise"):
            # Fail here with guidance, not deep inside the schedule: with
            # real data the per-epoch step count isn't known until
            # iteration.
            raise ValueError(
                f"--lr-schedule {cfg.lr_schedule} needs a decay horizon: "
                "pass --lr-decay-steps, or set --steps-per-epoch so it "
                "defaults to epochs*steps_per_epoch"
            )

    if _is_lm(cfg.model):
        # Language models: token batches, no image augmentation.
        trainer = Trainer(
            model, optimizer=cfg.optimizer, learning_rate=lr,
            strategy=strategy, seed=cfg.seed,
            input_key="tokens", target_key="targets",
            metrics=["accuracy", "perplexity"],  # the standard LM pair
            lr_schedule=cfg.lr_schedule,
            lr_schedule_options=schedule_options,
            ema_decay=cfg.ema_decay,
            gradient_accumulation_steps=cfg.gradient_accumulation_steps,
            param_update=cfg.param_update,
        )
    else:
        trainer = Trainer(
            model,
            optimizer=cfg.optimizer,
            learning_rate=lr,
            strategy=strategy,
            seed=cfg.seed,
            augment=standard_augment(crop=crop, flip=cfg.flip),
            eval_transform=standard_eval_transform(crop=crop),
            lr_schedule=cfg.lr_schedule,
            lr_schedule_options=schedule_options,
            ema_decay=cfg.ema_decay,
            gradient_accumulation_steps=cfg.gradient_accumulation_steps,
            param_update=cfg.param_update,
        )

    callbacks = []
    # A compiled schedule owns the LR; callback-driven LR control would be
    # overwritten every step, so it is disabled alongside one.
    if cfg.reduce_lr_on_plateau and not cfg.lr_schedule:  # reference's (:64)
        callbacks.append(cb.ReduceLROnPlateau())
    if cfg.early_stopping:  # (:65)
        callbacks.append(cb.EarlyStopping())
    if cfg.warmup_epochs and not cfg.lr_schedule:
        callbacks.append(cb.LearningRateWarmup(warmup_epochs=cfg.warmup_epochs))
    if cfg.verbose:
        # The reference's rank-0 print(model.summary())
        # (imagenet-resnet50-hvd.py:95-96), for every preset.
        callbacks.append(cb.ModelSummary())
    callbacks.append(cb.Timing())
    if cfg.profile_dir:
        from pddl_tpu_torch.utils.profiling import Profiler

        callbacks.append(Profiler(cfg.profile_dir))
    if cfg.checkpoint_dir:
        # Writers only — restore is fit(resume=...)'s job (wired in
        # run_experiment), which restores the newest VERIFIED save and
        # repositions the data stream mid-epoch; a second restoring
        # callback could resurrect a corrupt latest save the resume
        # path deliberately skipped. Keep >= 2 saves so the torn-latest
        # fallback always has somewhere to land.
        # Preemption (SIGTERM) -> consistent save + clean stop; the next
        # --resume run continues from it.
        from pddl_tpu_torch.utils.preemption import PreemptionCheckpoint

        if cfg.checkpoint_every_steps:
            # Step-granular verified saves subsume the epoch backup —
            # two managers retaining different step lists on one
            # directory would race each other's GC — and the grace
            # save DELEGATES to the same manager for the same reason.
            from pddl_tpu_torch.ckpt import CheckpointEveryN

            cen = CheckpointEveryN(
                cfg.checkpoint_dir,
                every_n_steps=cfg.checkpoint_every_steps)
            callbacks.append(cen)
            callbacks.append(PreemptionCheckpoint(delegate=cen))
        else:
            from pddl_tpu_torch.ckpt import ModelCheckpoint

            mc = ModelCheckpoint(cfg.checkpoint_dir, max_to_keep=2)
            callbacks.append(mc)
            callbacks.append(PreemptionCheckpoint(delegate=mc))
    return trainer, callbacks


def _is_lm(model_name: str) -> bool:
    """Language-model registry names (token batches, no augmentation).

    Exact membership in the registry's ``is_lm`` set — never substring
    matching, so a future vision entry whose name merely contains 'gpt'
    can't silently be fed token batches."""
    from pddl_tpu_torch.models.registry import LM_MODELS

    return model_name in LM_MODELS


def _strategy_options(cfg: ExperimentConfig) -> dict:
    """``cfg.strategy_options``, with the family-correct TP rule table.

    The Llama family's SwiGLU/embed leaves live under their own names
    (``mlp_gate``/``mlp_up``/``mlp_down``, ``embed``), which the default
    ``VIT_TP_RULES`` never match — a tensor-parallel Llama would silently
    replicate the bulk of each block. Explicit ``rules`` in the config
    still win.
    """
    opts = dict(cfg.strategy_options)
    if (cfg.strategy == "tensor_parallel" and "llama" in cfg.model
            and "rules" not in opts):
        from pddl_tpu_torch.parallel.tensor_parallel import LLAMA_TP_RULES

        opts["rules"] = LLAMA_TP_RULES
    return opts


def build_data(cfg: ExperimentConfig, strategy):
    """Train/val iterables: real data when ``data_dir`` is set (ImageNet,
    or a token corpus for a language model), else synthetic (same
    shapes/dtypes). Host numpy batches; the trainer moves them."""
    global_batch = strategy.scale_batch_size(cfg.per_replica_batch)
    val_global = strategy.scale_batch_size(
        cfg.val_per_replica_batch or cfg.per_replica_batch
    )
    if _is_lm(cfg.model):
        if cfg.data_dir:
            from pddl_tpu_torch.data.text import load_token_corpus, read_meta

            n_procs = strategy.data_process_count
            corpus = load_token_corpus(
                cfg.data_dir, seq_len=cfg.seq_len,
                train_batch_size=global_batch, val_batch_size=val_global,
                seed=cfg.seed,
                process_index=strategy.process_index if n_procs > 1 else 0,
                process_count=n_procs,
            )
            # Check AFTER loading: first runs from a raw train.txt only
            # have a meta.json once preparation wrote it. A .bin dropped
            # in without a sidecar is bounded by scanning its ids once.
            meta = read_meta(cfg.data_dir)
            vocab = (meta["vocab_size"] if meta and "vocab_size" in meta
                     else corpus[0].max_token() + 1)
            if vocab > cfg.num_classes:
                raise ValueError(
                    f"corpus vocab size {vocab} exceeds model vocab "
                    f"(--num-classes {cfg.num_classes})"
                )
            return corpus
        from pddl_tpu_torch.data.synthetic import SyntheticLanguageModeling

        n_procs = strategy.data_process_count
        common = dict(
            seq_len=cfg.seq_len, vocab_size=cfg.num_classes or 64,
            seed=cfg.seed,
            process_index=strategy.process_index if n_procs > 1 else 0,
            process_count=n_procs,
        )
        return (SyntheticLanguageModeling(batch_size=global_batch, **common),
                SyntheticLanguageModeling(batch_size=val_global,
                                          index_offset=1 << 20, **common))
    if cfg.data_dir:
        from pddl_tpu_torch.data.imagenet import load_imagenet

        return load_imagenet(
            cfg.data_dir,
            train_batch_size=global_batch,
            val_batch_size=val_global,
            shard=cfg.data_shard,
            process_index=strategy.process_index,
            process_count=strategy.data_process_count,
            image_size=cfg.image_size,
            seed=cfg.seed,
        )
    from pddl_tpu_torch.data.synthetic import SyntheticImageClassification

    n_procs = strategy.data_process_count
    train = SyntheticImageClassification(
        batch_size=global_batch, image_size=cfg.image_size,
        num_classes=cfg.num_classes, seed=cfg.seed,
        signal_strength=cfg.synthetic_signal,
        process_index=strategy.process_index if n_procs > 1 else 0,
        process_count=n_procs,
    )
    val = SyntheticImageClassification(
        batch_size=val_global, image_size=cfg.image_size,
        num_classes=cfg.num_classes, seed=cfg.seed,
        signal_strength=cfg.synthetic_signal,
        process_index=strategy.process_index if n_procs > 1 else 0,
        process_count=n_procs, index_offset=1 << 20,
    )
    return train, val


@contextlib.contextmanager
def _export_weights(trainer):
    """The weights a final save exports: with EMA enabled, the shadow
    weights are what eval ran on — export those (standard EMA serving
    practice), together with the EMA-shadowed BN statistics they were
    evaluated against. The shadows are copied into the model for the
    save and the live weights put back after it."""
    import torch

    if trainer.ema is None or not trainer.eval_with_ema:
        yield trainer.model
        return
    live = trainer._floating_state()
    with torch.no_grad():
        saved = {n: t.detach().clone() for n, t in live.items()}
        for n, t in live.items():
            t.copy_(trainer.ema[n])
    try:
        yield trainer.model
    finally:
        with torch.no_grad():
            for n, t in live.items():
                t.copy_(saved[n])


def run_experiment(cfg: ExperimentConfig, steps_per_epoch: Optional[int] = None,
                   validation_steps: Optional[int] = None, device=None):
    """The whole reference-script skeleton (SURVEY.md §0 steps 1-5):
    data → model → strategy → fit(callbacks) → save. Returns the History.
    Runs on the card unless ``device="cpu"``; with no card it raises
    first."""
    strategy_device = _strategy_device(device)

    # weights='imagenet' mode: an explicit local .h5 wins; otherwise the
    # preset's weights="imagenet" resolves the official keras-applications
    # file for cfg.model from the cache (ckpt/fetch.py — download only on
    # explicit opt-in, with the offline procedure in the error text
    # otherwise). Resolved before the processes join and the model is
    # built: a missing file must fail in under a second.
    h5_path = cfg.pretrained_h5
    if not h5_path and cfg.weights == "imagenet":
        from pddl_tpu_torch.ckpt.fetch import fetch_keras_resnet50_weights

        h5_path = fetch_keras_resnet50_weights(
            model=cfg.model, download=cfg.download_weights
        )

    # The strategy bootstraps FIRST: it opens the process group (torchrun
    # or the PDDL_* environment) that the model's BatchNorm and the
    # checkpoint callbacks' saves bind to.
    from pddl_tpu_torch.parallel import get_strategy

    strategy = get_strategy(cfg.strategy, device=strategy_device,
                            **_strategy_options(cfg))
    strategy.setup()
    trainer, callbacks = build_trainer(cfg, strategy)
    train, val = build_data(cfg, strategy)

    if h5_path:
        _load_pretrained(trainer, cfg, train, h5_path)

    # Crash-resume is fit(resume=...): restores the newest VERIFIED
    # checkpoint (torn/corrupt latest skipped), repositions the data
    # stream from the saved loader metadata, and continues MID-epoch.
    # An empty checkpoint directory starts fresh, so the same --resume
    # command line serves the first launch and every restart.
    resume = cfg.checkpoint_dir if (cfg.resume and cfg.checkpoint_dir) \
        else None

    spe = steps_per_epoch or cfg.steps_per_epoch
    if cfg.data_dir is None and spe is None:
        raise ValueError(
            "synthetic data is an infinite stream: set --steps-per-epoch "
            "(or provide --data-dir for a finite ImageNet epoch)"
        )
    history = trainer.fit(
        train,
        epochs=cfg.epochs,
        steps_per_epoch=spe,
        validation_data=val,
        validation_steps=validation_steps or (spe and max(1, spe // 4)),
        callbacks=callbacks,
        verbose=cfg.verbose,
        resume=resume,
    )

    if cfg.save_path:
        # Final save, the model.save moment (imagenet-resnet50.py:69-72) —
        # with the Horovod script's rank-gating (and its str+int crash :127
        # fixed by construction). A strategy that shards the weights
        # gathers them first, on every process (a collective).
        _save(cfg, trainer, strategy)
    return history


def _save(cfg: ExperimentConfig, trainer, strategy) -> None:
    gather = getattr(strategy, "gather_state_dict", None)
    with _export_weights(trainer) as model:
        state = gather(model) if gather is not None else model.state_dict()
        if not strategy.is_coordinator:
            return
        if cfg.save_path.endswith(".shlo"):
            # The serving artifact (ckpt/export.py): the eval forward
            # itself, through torch.export, loadable without this
            # package's Python model code.
            import torch

            from pddl_tpu_torch.ckpt.export import save_inference_artifact

            if _is_lm(cfg.model):
                shape: tuple = (1, cfg.seq_len)
                dtype = torch.int32
            else:
                shape = (1, cfg.image_size, cfg.image_size, 3)
                dtype = torch.float32
            save_inference_artifact(cfg.save_path, model, state, shape,
                                    input_dtype=dtype)
        elif cfg.save_path.endswith(".h5") and cfg.model.startswith("resnet"):
            from pddl_tpu_torch.ckpt.keras_import import export_keras_style_h5

            export_keras_style_h5(cfg.save_path, model,
                                  stage_sizes=_stage_sizes(cfg))
        else:
            from pddl_tpu_torch.ckpt.checkpoint import save_params_npz

            save_params_npz(cfg.save_path, state)


def _stage_sizes(cfg: ExperimentConfig) -> tuple:
    """Block counts per family so resnet101/152 imports map the right
    tree (models/resnet.py)."""
    return {
        "resnet101": (3, 4, 23, 3),
        "resnet152": (3, 8, 36, 3),
    }.get(cfg.model, (3, 4, 6, 3))


def _load_pretrained(trainer, cfg: ExperimentConfig, train_data,
                     h5_path: str) -> None:
    """Overwrite the backbone's weights from the Keras .h5, in place.
    (``train_data`` keeps the JAX signature: the JAX trainer initializes
    its state from a first batch, the port's model holds its weights from
    construction.)"""
    import torch

    from pddl_tpu_torch.ckpt import load_keras_resnet50_h5

    load_keras_resnet50_h5(h5_path, trainer.model,
                           stage_sizes=_stage_sizes(cfg))
    # EMA shadows must restart from the loaded weights, not the random
    # init they were seeded with (eval/export run on the shadows) — the
    # BatchNorm statistics' shadows likewise, or EMA eval pairs imported
    # weights with mean=0/var=1 init statistics.
    if trainer.ema is not None:
        with torch.no_grad():
            for name, t in trainer._floating_state().items():
                trainer.ema[name].copy_(t)


def main(argv=None, device=None) -> int:
    """The CLI. ``device`` is ``--device``'s default (``None``: the
    card)."""
    p = argparse.ArgumentParser(
        prog="pddl_tpu_torch",
        description="ResNet/ImageNet distributed training on NVIDIA cards "
                    "(presets mirror the 8 reference scripts)",
    )
    p.add_argument("--preset", choices=sorted(PRESETS), default="single")
    p.add_argument("--data-dir", default=None, help="ImageNet root (TFDS/"
                   "TFRecords/folders), or a token corpus (train.txt/"
                   "train.bin) for a language model; omit for --synthetic")
    p.add_argument("--synthetic", action="store_true",
                   help="force synthetic data even if --data-dir is set")
    p.add_argument("--device", choices=["cuda", "cpu"],
                   default=device or "cuda",
                   help="train on the card (each process its own, "
                        "cuda:{local_rank}) or on the host's CPU")
    p.add_argument("--epochs", type=int, default=None)
    p.add_argument("--steps-per-epoch", type=int, default=None)
    p.add_argument("--batch", type=int, default=None, help="per-replica batch")
    p.add_argument("--lr", type=float, default=None)
    p.add_argument("--lr-schedule", default=None,
                   choices=["cosine", "warmup_cosine", "exponential",
                            "linear", "piecewise", "constant"],
                   help="compiled step->LR schedule (disables plateau/"
                        "warmup callbacks); decay horizon = "
                        "--lr-decay-steps, or epochs*steps_per_epoch when "
                        "--steps-per-epoch is set")
    p.add_argument("--lr-decay-steps", type=int, default=None,
                   help="schedule horizon in OPTIMIZER updates (with "
                        "--grad-accum k that is one per k micro-batches); "
                        "includes --lr-warmup-steps")
    p.add_argument("--lr-warmup-steps", type=int, default=None,
                   help="linear warmup, in optimizer updates; counted "
                        "inside --lr-decay-steps")
    p.add_argument("--lr-boundaries", default=None,
                   help="piecewise schedule: comma-separated step:scale "
                        "pairs, e.g. 30000:0.1,60000:0.1")
    p.add_argument("--grad-accum", type=int, default=None,
                   help="average gradients over k micro-batches per "
                        "optimizer update (large effective batch)")
    p.add_argument("--ema-decay", type=float, default=None,
                   help="exponential moving average of params; eval/"
                        "export use the shadow weights")
    p.add_argument("--image-size", type=int, default=None)
    p.add_argument("--synthetic-signal", type=float, default=None,
                   help="synthetic image task: class-mean separation in "
                        "noise-std units (default 1.0; raise so val "
                        "metrics track learning, not memorization)")
    p.add_argument("--bn-momentum", type=float, default=None,
                   help="resnet family: BatchNorm moving-average "
                        "momentum (default Keras-parity 0.99; lower for "
                        "short runs so eval stats converge)")
    p.add_argument("--crop", type=int, default=None)
    p.add_argument("--num-classes", type=int, default=None)
    p.add_argument("--seq-len", type=int, default=None,
                   help="LM sequence length (token-window size)")
    p.add_argument("--vocab-multiple", type=int, default=None,
                   help="pad the LM vocab dim to a multiple (enables "
                        "vocab-parallel TP on real vocab sizes)")
    p.add_argument("--param-update", default=None,
                   choices=["plain", "stochastic_round", "f32_master"],
                   help="update rule for bf16 param storage "
                        "(train/mixed_precision.py); ignored for f32")
    p.add_argument("--remat", default=None, choices=["none", "dots", "full"],
                   help="activation rematerialization for transformer "
                        "models (trade recompute for memory)")
    p.add_argument("--model", default=None)
    p.add_argument("--stem", default=None,
                   choices=["keras", "space_to_depth"],
                   help="resnet stem variant: exact keras.applications "
                        "shape, or the MLPerf-style space-to-depth "
                        "throughput form (same function)")
    p.add_argument("--strategy", default=None,
                   choices=["single", "mirrored", "multiworker", "ps",
                            "tensor_parallel", "expert_parallel"])
    # (pipeline parallelism needs a stage-stacked model — GPipeViT — which
    # carries its mesh; it is a library-API construction, see README.)
    p.add_argument("--model-parallel", type=int, default=None,
                   help="TP degree (tensor_parallel/expert_parallel only)")
    p.add_argument("--expert-parallel", type=int, default=None,
                   help="EP degree (expert_parallel only)")
    p.add_argument("--pretrained-h5", default=None,
                   help="local keras-style weight .h5; overrides the "
                        "preset's weights='imagenet' cache lookup")
    p.add_argument("--download-weights", action="store_true",
                   help="allow fetching the official keras-applications "
                        "weight file into the cache when absent "
                        "(ckpt/fetch.py; off by default — training hosts "
                        "may have no egress)")
    p.add_argument("--checkpoint-dir", default=None)
    p.add_argument("--checkpoint-every-steps", type=int, default=None,
                   help="step-granular verified checkpoint cadence "
                        "(CheckpointEveryN); a --resume restart then "
                        "continues MID-epoch from the newest verified "
                        "save instead of replaying the epoch")
    p.add_argument("--resume", action="store_true")
    p.add_argument("--save", dest="save_path", default=None)
    p.add_argument("--profile-dir", default=None,
                   help="write torch.profiler traces here (Chrome trace "
                        "JSON of CPU and CUDA activity; TensorBoard's "
                        "PyTorch profiler plugin reads it)")
    p.add_argument("--seed", type=int, default=None)
    p.add_argument("--verbose", type=int, default=None)
    args = p.parse_args(argv)

    overrides = {}
    mapping = {
        "data_dir": args.data_dir, "epochs": args.epochs,
        "steps_per_epoch": args.steps_per_epoch,
        "per_replica_batch": args.batch, "learning_rate": args.lr,
        "image_size": args.image_size, "crop": args.crop,
        "synthetic_signal": args.synthetic_signal,
        "bn_momentum": args.bn_momentum,
        "num_classes": args.num_classes, "seq_len": args.seq_len,
        "vocab_multiple": args.vocab_multiple,
        "remat": args.remat, "stem": args.stem,
        "param_update": args.param_update,
        "model": args.model, "strategy": args.strategy,
        "pretrained_h5": args.pretrained_h5,
        "checkpoint_dir": args.checkpoint_dir,
        "checkpoint_every_steps": args.checkpoint_every_steps,
        "save_path": args.save_path, "seed": args.seed,
        "verbose": args.verbose, "profile_dir": args.profile_dir,
        "lr_schedule": args.lr_schedule, "ema_decay": args.ema_decay,
        "gradient_accumulation_steps": args.grad_accum,
    }
    for field, value in mapping.items():
        if value is not None:
            overrides[field] = value
    schedule_opts = {}
    if args.lr_decay_steps is not None:
        schedule_opts["decay_steps"] = args.lr_decay_steps
    if args.lr_warmup_steps is not None:
        schedule_opts["warmup_steps"] = args.lr_warmup_steps
    if args.lr_boundaries:
        try:
            schedule_opts["boundaries_and_scales"] = {
                int(pair.split(":")[0]): float(pair.split(":")[1])
                for pair in args.lr_boundaries.split(",")
            }
        except (ValueError, IndexError):
            p.error("--lr-boundaries must be step:scale[,step:scale...]")
    if schedule_opts:
        overrides["lr_schedule_options"] = schedule_opts
    if args.resume:
        overrides["resume"] = True
    if args.download_weights:
        overrides["download_weights"] = True
    if args.synthetic:
        overrides["data_dir"] = None

    # Degree flags only apply to the strategies whose constructors take
    # them; reject mismatches here instead of a TypeError deep inside.
    if args.model_parallel is not None and args.strategy not in (
            "tensor_parallel", "expert_parallel"):
        p.error("--model-parallel requires --strategy tensor_parallel "
                "or expert_parallel")
    if args.expert_parallel is not None and args.strategy != "expert_parallel":
        p.error("--expert-parallel requires --strategy expert_parallel")
    if args.strategy == "expert_parallel" and args.expert_parallel is None:
        p.error("--strategy expert_parallel needs --expert-parallel N")
    strategy_options = {}
    if args.model_parallel is not None:
        strategy_options["model_parallel"] = args.model_parallel
    if args.expert_parallel is not None:
        strategy_options["expert_parallel"] = args.expert_parallel
    if strategy_options:
        overrides["strategy_options"] = strategy_options

    cfg = get_preset(args.preset, **overrides)
    run_experiment(cfg, device=args.device)
    return 0


if __name__ == "__main__":  # pragma: no cover
    sys.exit(main())
