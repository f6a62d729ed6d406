"""Checkpoints of the trainer's state (the port of :mod:`pddl_tpu.ckpt`'s
checkpointing; the Keras/HF import and export come later, ROADMAP.md
queue 1 item 6)."""

from pddl_tpu_torch.ckpt.checkpoint import (
    BackupAndRestore,
    CheckpointCorruptError,
    CheckpointEveryN,
    Checkpointer,
    ModelCheckpoint,
    latest_epoch,
    save_params_npz,
    tree_checksums,
)

__all__ = [
    "Checkpointer",
    "CheckpointCorruptError",
    "CheckpointEveryN",
    "ModelCheckpoint",
    "BackupAndRestore",
    "latest_epoch",
    "save_params_npz",
    "tree_checksums",
]
