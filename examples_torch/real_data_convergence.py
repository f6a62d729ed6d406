"""Real-data convergence of the PyTorch port, on the H100.

The port of ``examples/real_data_convergence.py``: the same two real
datasets, the same ingest paths and the same configurations, trained
through ``pddl_tpu_torch.run.run_experiment``:

- ``pycorpus`` — the running interpreter's CPython standard library
  source (~20 MB of real Python text), byte-tokenized through
  ``pddl_tpu_torch/data/text.py`` and modeled with GPT-Small next-byte
  prediction (bf16 compute, ``attention="flash"``: the flash kernels'
  forward and backward run every step on the card);
- ``pycorpus-llama`` — the same corpus and budget on ``llama_small``;
- ``bf16-recipe`` / ``bf16-recipe-safe`` — ``llama_300m`` with f32 against
  bf16 parameter storage, and bf16 storage under ``stochastic_round`` and
  ``f32_master`` (``train/mixed_precision.py``);
- ``digits`` — the scikit-learn handwritten-digits scans materialized as a
  ``<split>/<class>/*.png`` folder tree and read through
  ``data/imagenet.py``'s image-folder path; ResNet-18. It needs
  scikit-learn and TensorFlow, and raises naming whichever is missing.

Each track writes ``artifacts/convergence_torch/<track>.jsonl``: a header
line with the configuration, the corpus sizes and the device, then one
JSON line per epoch (the History).

    python examples_torch/real_data_convergence.py --track pycorpus
    python examples_torch/real_data_convergence.py --track pycorpus \\
        --device cpu          # the plain PyTorch paths, on the host

It runs on the card unless ``--device cpu`` is given; without a card it
raises. ``PDDL_EXAMPLE_SMOKE=1`` runs tiny models for a handful of steps
and writes the histories into the work dir.
"""

from __future__ import annotations

import argparse
import hashlib
import json
import math
import os
import shutil
import subprocess
import sys
import sysconfig
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

ARTIFACTS = os.path.join(REPO, "artifacts", "convergence_torch")
WORK_DIR = os.path.join(REPO, "build", "real_data")

# Smoke mode (PDDL_EXAMPLE_SMOKE=1): tiny models and a handful of steps,
# with artifacts redirected into the work dir so the committed card-run
# curves are never overwritten by a smoke pass.
SMOKE = bool(os.environ.get("PDDL_EXAMPLE_SMOKE"))


# --------------------------------------------------------------- datasets
def _digits_deps():
    """``(load_digits, tf)``, or an ImportError naming the missing one."""
    try:
        from sklearn.datasets import load_digits
    except ImportError as e:
        raise ImportError(
            "the digits track needs scikit-learn (sklearn.datasets."
            "load_digits holds the scans); it is not installed here") from e
    try:
        import tensorflow as tf  # CPU build; PNG encoding only
    except ImportError as e:
        raise ImportError(
            "the digits track needs TensorFlow (tf.io.encode_png writes "
            "the folder tree, and data/imagenet.py's folder source decodes "
            "it); it is not installed here") from e
    return load_digits, tf


def build_digits_folder(root: str, image_size: int = 32,
                        val_fraction: float = 1 / 6, seed: int = 0) -> dict:
    """Materialize sklearn digits as ``<split>/<class>/*.png`` (real scans).

    Images are nearest-neighbor upscaled 8->``image_size`` at write time so
    the on-disk tree looks like any small-image classification folder. The
    split is stratified per class with a seeded shuffle.
    """
    import numpy as np

    load_digits, tf = _digits_deps()

    digits = load_digits()
    images, labels = digits.images, digits.target  # [N, 8, 8] float 0..16
    rng = np.random.default_rng(seed)
    factor = image_size // 8
    counts = {"train": 0, "validation": 0}
    for cls in range(10):
        idx = np.flatnonzero(labels == cls)
        rng.shuffle(idx)
        n_val = max(1, int(len(idx) * val_fraction))
        for split, members in (("validation", idx[:n_val]),
                               ("train", idx[n_val:])):
            d = os.path.join(root, split, f"{cls:02d}")
            os.makedirs(d, exist_ok=True)
            for i in members:
                img = (images[i] * (255.0 / 16.0)).astype(np.uint8)
                img = np.kron(img, np.ones((factor, factor), np.uint8))
                rgb = np.repeat(img[..., None], 3, axis=-1)
                png = tf.io.encode_png(rgb).numpy()
                with open(os.path.join(d, f"{i:04d}.png"), "wb") as f:
                    f.write(png)
                counts[split] += 1
    return counts


def build_python_corpus(root: str, max_bytes: int = 20 << 20,
                        val_fraction: float = 0.05,
                        source_dir: str | None = None) -> dict:
    """Concatenate CPython stdlib sources into train.txt/val.txt.

    A real, public text corpus that ships with every machine. Files are
    walked in sorted order (deterministic), capped at ``max_bytes``; the
    tail ``val_fraction`` becomes the held-out split. ``source_dir``
    defaults to the RUNNING interpreter's stdlib (a hardcoded version
    path silently yields an empty corpus on any other interpreter).
    """
    if source_dir is None:
        source_dir = sysconfig.get_paths()["stdlib"]
    chunks, total = [], 0
    for dirpath, dirnames, filenames in sorted(os.walk(source_dir)):
        dirnames.sort()
        if "site-packages" in dirpath or "__pycache__" in dirpath:
            continue
        for fname in sorted(filenames):
            if not fname.endswith(".py"):
                continue
            try:
                with open(os.path.join(dirpath, fname), "rb") as f:
                    data = f.read()
            except OSError:
                continue
            chunks.append(data)
            total += len(data)
            if total >= max_bytes:
                break
        if total >= max_bytes:
            break
    blob = b"\n".join(chunks)[:max_bytes]
    split = int(len(blob) * (1 - val_fraction))
    os.makedirs(root, exist_ok=True)
    with open(os.path.join(root, "train.txt"), "wb") as f:
        f.write(blob[:split])
    with open(os.path.join(root, "val.txt"), "wb") as f:
        f.write(blob[split:])
    return {"train_bytes": split, "val_bytes": len(blob) - split}


def _build_atomically(final_dir: str, builder) -> None:
    """Run ``builder(tmp_dir)`` then rename into place.

    A killed run must not leave a partial tree that later runs silently
    reuse as the dataset (the existence check gates on ``final_dir`` only,
    which appears atomically). Concurrent builders each use their own tmp
    dir; the rename loser just discards its copy.
    """
    if os.path.isdir(final_dir):
        return
    tmp = f"{final_dir}.building.{os.getpid()}"
    shutil.rmtree(tmp, ignore_errors=True)
    builder(tmp)
    try:
        os.rename(tmp, final_dir)
    except OSError:
        if not os.path.isdir(final_dir):  # not just a lost race
            raise
        shutil.rmtree(tmp, ignore_errors=True)


def unigram_entropy_nats(path: str) -> float:
    """The byte-unigram entropy of a file in nats: the least loss a model
    that ignores context can reach on it."""
    import numpy as np

    counts = np.bincount(np.fromfile(path, np.uint8), minlength=256)
    p = counts[counts > 0] / counts.sum()
    return float(-(p * np.log(p)).sum())


def device_label(device) -> str:
    """The card's name and power limit as ``nvidia-smi`` reads them, or
    the device's type for the CPU."""
    import torch

    dev = torch.device(device)
    if dev.type != "cuda":
        return dev.type
    try:
        smi = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30).stdout.strip().splitlines()
    except (OSError, subprocess.SubprocessError):
        smi = []
    return smi[dev.index or 0] if smi else torch.cuda.get_device_name(dev)


# ----------------------------------------------------------------- tracks
def _write_history(path: str, header: dict, history) -> None:
    os.makedirs(os.path.dirname(path), exist_ok=True)
    with open(path, "w") as f:
        f.write(json.dumps({"config": header}) + "\n")
        keys = sorted(history.history)
        for i, epoch in enumerate(history.epoch):
            row = {"epoch": int(epoch)}
            for k in keys:
                if i < len(history.history[k]):
                    row[k] = float(history.history[k][i])
            f.write(json.dumps(row) + "\n")


def run_digits(work_dir: str, out_path: str, device: str = "cuda") -> dict:
    from pddl_tpu_torch.config import get_preset
    from pddl_tpu_torch.run import run_experiment

    data_dir = os.path.join(work_dir, "digits_png")
    _build_atomically(data_dir, build_digits_folder)
    counts = {
        split: sum(
            len(files)
            for _, _, files in os.walk(os.path.join(data_dir, split))
        )
        for split in ("train", "validation")
    }
    cfg = get_preset(
        "single",
        model="resnet18", num_classes=10, image_size=32,
        data_dir=data_dir, per_replica_batch=128,
        # Digits are orientation-sensitive: no horizontal flip.
        flip=False, epochs=30, seed=0, verbose=0,
    )
    if SMOKE:
        cfg = cfg.replace(model="tiny_resnet", epochs=2,
                          per_replica_batch=64)
    start = time.time()
    history = run_experiment(cfg, validation_steps=2, device=device)
    elapsed = time.time() - start
    header = {
        "track": "digits", "dataset": "sklearn load_digits (real scans)",
        "counts": counts, "model": cfg.model, "seed": cfg.seed,
        "batch": cfg.per_replica_batch, "epochs": cfg.epochs,
        "optimizer": cfg.optimizer, "learning_rate": cfg.learning_rate,
        "callbacks": "ReduceLROnPlateau + EarlyStopping (reference defaults)",
        "wall_seconds": round(elapsed, 1), "device": device_label(device),
    }
    _write_history(out_path, header, history)
    return {
        "final_val_accuracy": float(history.history["val_accuracy"][-1]),
        "best_val_accuracy": float(max(history.history["val_accuracy"])),
        "final_val_loss": float(history.history["val_loss"][-1]),
        "epochs_ran": len(history.epoch),
        "wall_seconds": round(elapsed, 1),
    }


def run_pycorpus(work_dir: str, out_path: str, *,
                 model_name: str = "gpt_small",
                 track_name: str = "pycorpus",
                 param_dtype: str = "float32",
                 param_update: str = "plain",
                 device: str = "cuda",
                 epochs: int = 10, steps_per_epoch: int = 300,
                 validation_steps: int = 20) -> dict:
    """One next-byte track. The defaults are the JAX example's budget: 10
    epochs of 300 steps at B 32 x S 256, cosine over all of them after
    100 warmup steps (a thirtieth of the run), 20 validation batches an
    epoch. A shorter ``epochs x steps_per_epoch`` keeps the same schedule
    shape over its own steps."""
    from pddl_tpu_torch.config import get_preset
    from pddl_tpu_torch.run import run_experiment

    data_dir = os.path.join(work_dir, "pycorpus")
    _build_atomically(data_dir, build_python_corpus)
    sizes = {
        "train_bytes": os.path.getsize(os.path.join(data_dir, "train.txt")),
        "val_bytes": os.path.getsize(os.path.join(data_dir, "val.txt")),
    }
    # Another 3.12 patch release ships other stdlib bytes: the digest names
    # the corpus a run trained on (a work dir's corpus is reused as built).
    digest = hashlib.sha256()
    for name in ("train.txt", "val.txt"):
        with open(os.path.join(data_dir, name), "rb") as f:
            digest.update(f.read())
    steps = epochs * steps_per_epoch
    cfg = get_preset(
        "single",
        model=model_name, num_classes=256, seq_len=256,
        data_dir=data_dir, per_replica_batch=32,
        learning_rate=3e-4, lr_schedule="cosine",
        lr_schedule_options={"decay_steps": steps,
                             "warmup_steps": max(2, steps // 30)},
        epochs=epochs, steps_per_epoch=steps_per_epoch, seed=0, verbose=0,
        param_dtype=param_dtype, param_update=param_update,
    )
    if SMOKE:
        tiny = "tiny_llama" if "llama" in model_name else "tiny_gpt"
        cfg = cfg.replace(
            model=tiny, seq_len=128, per_replica_batch=8, epochs=2,
            steps_per_epoch=10,
            lr_schedule_options={"decay_steps": 20, "warmup_steps": 2},
        )
        validation_steps = 2
    start = time.time()
    history = run_experiment(cfg, validation_steps=validation_steps,
                             device=device)
    elapsed = time.time() - start
    header = {
        "track": track_name,
        "dataset": (f"CPython {sys.version_info.major}."
                    f"{sys.version_info.minor} stdlib source, byte-level "
                    "(real text)"),
        "sizes": sizes, "corpus_sha256": digest.hexdigest(),
        "model": cfg.model, "seed": cfg.seed,
        "seq_len": cfg.seq_len, "batch": cfg.per_replica_batch,
        "steps": cfg.epochs * cfg.steps_per_epoch,
        "validation_steps": validation_steps,
        "optimizer": cfg.optimizer, "learning_rate": cfg.learning_rate,
        "lr_schedule": cfg.lr_schedule, **cfg.lr_schedule_options,
        "param_dtype": cfg.param_dtype, "param_update": cfg.param_update,
        "wall_seconds": round(elapsed, 1), "device": device_label(device),
    }
    _write_history(out_path, header, history)
    return {
        "final_val_loss_nats": float(history.history["val_loss"][-1]),
        "final_val_bits_per_byte": float(
            history.history["val_loss"][-1] / math.log(2)),
        "final_val_perplexity": float(
            history.history.get("val_perplexity", [float("nan")])[-1]),
        "epochs_ran": len(history.epoch),
        "wall_seconds": round(elapsed, 1),
        "sizes": sizes,
    }


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--track",
                   choices=("digits", "pycorpus", "pycorpus-llama",
                            "bf16-recipe", "bf16-recipe-safe", "all"),
                   default="all")
    p.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                   help="the card (default; raises without one) or the "
                        "host's plain PyTorch paths")
    p.add_argument("--work-dir", default=WORK_DIR,
                   help="where datasets are materialized (not committed)")
    p.add_argument("--artifacts-dir", default=None,
                   help="where the history JSONLs are written (the repo's "
                        "committed artifacts/convergence_torch by default; "
                        "the work dir in smoke mode)")
    args = p.parse_args(argv)
    from pddl_tpu_torch.device import resolve_device

    device = str(resolve_device(args.device))
    if args.artifacts_dir is None:
        args.artifacts_dir = (
            os.path.join(args.work_dir, "artifacts") if SMOKE else ARTIFACTS
        )

    def out(name):
        return os.path.join(args.artifacts_dir, name)

    results = {}
    if args.track in ("digits", "all"):
        results["digits"] = run_digits(args.work_dir, out("digits.jsonl"),
                                       device=device)
    if args.track in ("pycorpus", "all"):
        results["pycorpus"] = run_pycorpus(
            args.work_dir, out("pycorpus.jsonl"), device=device)
    if args.track in ("pycorpus-llama", "all"):
        # Same corpus, same token budget/schedule, modern-decoder family:
        # an apples-to-apples architecture comparison against pycorpus.
        results["pycorpus-llama"] = run_pycorpus(
            args.work_dir, out("pycorpus_llama.jsonl"),
            model_name="llama_small", track_name="pycorpus-llama",
            device=device)
    model = "llama_300m" if not SMOKE else "tiny_llama"
    if args.track == "bf16-recipe":
        # Identical mid-size Llama runs, f32 against bf16 parameter (and
        # optimizer-moment) storage, same data, seed and schedule.
        for dtype in ("float32", "bfloat16"):
            tag = "f32" if dtype == "float32" else "bf16"
            results[f"bf16_recipe_{tag}"] = run_pycorpus(
                args.work_dir, out(f"pycorpus_300m_{tag}.jsonl"),
                model_name=model, track_name=f"bf16-recipe-{tag}",
                param_dtype=dtype, device=device)
        delta = (results["bf16_recipe_bf16"]["final_val_loss_nats"]
                 - results["bf16_recipe_f32"]["final_val_loss_nats"])
        results["bf16_minus_f32_final_val_nats"] = round(delta, 5)
    if args.track == "bf16-recipe-safe":
        # bf16 storage under the two safe update rules, against the
        # bf16-recipe track's f32 and bf16-plain curves.
        for mode in ("stochastic_round", "f32_master"):
            tag = "sr" if mode == "stochastic_round" else "master"
            results[f"bf16_safe_{tag}"] = run_pycorpus(
                args.work_dir, out(f"pycorpus_300m_bf16_{tag}.jsonl"),
                model_name=model, track_name=f"bf16-recipe-{tag}",
                param_dtype="bfloat16", param_update=mode, device=device)
    print(json.dumps(results, indent=2))
    return 0


if __name__ == "__main__":
    sys.exit(main())
