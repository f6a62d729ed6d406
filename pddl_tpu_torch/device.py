"""Device resolution shared by the port's entry points.

Entry points run on the card unless the caller asks for the CPU: ``None``
means ``cuda``, and asking for ``cuda`` on a host without a card raises
instead of quietly running somewhere slower.
"""

from __future__ import annotations

from typing import Optional, Union

import torch


def resolve_device(device: Optional[Union[str, torch.device]] = None
                   ) -> torch.device:
    """``None`` → ``cuda``; a CUDA device needs ``torch.cuda.is_available()``.

    Raises ``RuntimeError`` when CUDA is asked for (explicitly or by
    default) and no card is present — pass ``device="cpu"`` to run the
    plain PyTorch paths on the host.
    """
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run the "
            "plain PyTorch paths on the host")
    return dev
