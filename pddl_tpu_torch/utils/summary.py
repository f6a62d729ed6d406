"""Parameter summary: the ``model.summary()`` moment (the port of
:mod:`pddl_tpu.utils.summary`), and the two-column table the serving
metrics print with."""

from __future__ import annotations

from typing import Any, Dict

import torch


def format_table(title: str, rows: Dict[str, Any]) -> str:
    """Aligned two-column text table in :func:`param_summary`'s style:
    thousands separators for numbers, 3 decimals for floats."""
    def _fmt(v: Any) -> str:
        if isinstance(v, bool):
            return str(v)
        if isinstance(v, int):
            return f"{v:,}"
        if isinstance(v, float):
            return f"{v:,.3f}"
        return str(v)

    lines = [title]
    width = max((len(k) for k in rows), default=10)
    for key, value in rows.items():
        lines.append(f"  {key:<{width}}  {_fmt(value):>14}")
    return "\n".join(lines)


def param_summary(model: torch.nn.Module) -> str:
    """Per-top-level-module parameter counts, the total with its bytes,
    and the count of the floating-point buffers (BatchNorm's running
    averages: the JAX summary's ``batch_stats``), if any."""
    by_module: Dict[str, int] = {}
    total = total_bytes = 0
    for name, p in model.named_parameters():
        top = name.split(".", 1)[0] if "." in name else "<root>"
        by_module[top] = by_module.get(top, 0) + p.numel()
        total += p.numel()
        total_bytes += p.numel() * p.element_size()
    lines = ["Model parameters:"]
    width = max((len(k) for k in by_module), default=10)
    for name in sorted(by_module):
        lines.append(f"  {name:<{width}}  {by_module[name]:>14,}")
    lines.append(f"  {'TOTAL':<{width}}  {total:>14,}  "
                 f"({total_bytes / 1e6:.1f} MB)")
    n_stats = sum(b.numel() for b in model.buffers() if b.is_floating_point())
    if n_stats:
        lines.append(f"  {'(batch stats)':<{width}}  {n_stats:>14,}")
    return "\n".join(lines)
