"""Where the port computes.

Entry points take ``device=None``, which means the CUDA card. There is no
silent fallback: without a card they raise, and a caller that wants the CPU
(the tests, a laptop) says so with ``device="cpu"``.
"""
from __future__ import annotations

from typing import Union

import torch

DeviceLike = Union[str, torch.device, None]


def resolve_device(device: DeviceLike = None) -> torch.device:
    """``None`` → ``cuda``; ``"cpu"`` only on request; raises when a CUDA
    device is asked for and none is present."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev} (cuda or cpu)")
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run the "
            "port's plain PyTorch path on the CPU")
    return dev


def on_device(tensor: torch.Tensor, device: torch.device) -> bool:
    """True when ``tensor`` lives on ``device``, where a CUDA device given
    without an index means the current one (``cuda`` holds ``cuda:0``'s
    tensors while card 0 is current)."""
    t = tensor.device
    if t.type != device.type:
        return False
    if device.index is None and t.type == "cuda":
        return t.index == torch.cuda.current_device()
    return t.index == device.index
