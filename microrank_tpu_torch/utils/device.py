"""Device resolution for the port's entry points.

Entry points run on the card unless the caller asks for the CPU. A
missing card is an error, never a silent fallback: a run that was meant
for the GPU and quietly ran on the CPU would report CPU numbers under a
GPU label.
"""

from __future__ import annotations

from typing import Optional, Union

import torch


def resolve_device(device: Optional[Union[str, torch.device]] = None) -> torch.device:
    """``None`` means ``"cuda"``. Raises when CUDA is asked for and absent."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev!s}; use 'cuda' or 'cpu'")
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available in this process; pass device='cpu' to "
            "run on the CPU"
        )
    return dev
