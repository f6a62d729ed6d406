"""Keras-``History``-equivalent training record (the port's copy of
:mod:`pddl_tpu.train.history`)."""

from __future__ import annotations

import json
from typing import Dict, List


class History:
    """Per-epoch metric history, dict-of-lists like ``keras.callbacks.History``."""

    def __init__(self) -> None:
        self.history: Dict[str, List[float]] = {}
        self.epoch: List[int] = []

    def append(self, epoch: int, logs: Dict[str, float]) -> None:
        self.epoch.append(epoch)
        for k, v in logs.items():
            self.history.setdefault(k, []).append(float(v))

    def to_jsonl(self) -> str:
        lines = []
        for i, e in enumerate(self.epoch):
            row = {"epoch": e}
            for k, vals in self.history.items():
                if i < len(vals):
                    row[k] = vals[i]
            lines.append(json.dumps(row))
        return "\n".join(lines)

    def save(self, path: str) -> None:
        with open(path, "w") as f:
            f.write(self.to_jsonl() + "\n")

    def __repr__(self) -> str:
        return f"History(epochs={len(self.epoch)}, keys={sorted(self.history)})"
