"""Explicit device handling.

The port never guesses a device and never drops to the CPU on its own: a
caller names the device, and asking for CUDA where there is none raises.
"""

from __future__ import annotations

from typing import Union

import numpy as np
import torch

DeviceLike = Union[str, torch.device]


def require_cuda() -> None:
    """Raise unless a CUDA device is visible to torch."""
    if not torch.cuda.is_available():
        raise RuntimeError(
            "a CUDA device is required but torch.cuda.is_available() is "
            f"False (torch {torch.__version__}, built for CUDA "
            f"{torch.version.cuda})")


def resolve_device(device: DeviceLike) -> torch.device:
    """'cpu', 'cuda' or 'cuda:N' (or a torch.device) -> torch.device.

    'cuda' without an index resolves to the current CUDA device. Any other
    device type, or None, is refused."""
    if device is None:
        raise ValueError("pass a device explicitly: 'cpu', 'cuda' or 'cuda:N'")
    dev = torch.device(device)
    if dev.type == "cuda":
        require_cuda()
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
    elif dev.type != "cpu":
        raise ValueError(f"unsupported device {dev}: expected cpu or cuda")
    return dev


def detection_device(device: DeviceLike) -> torch.device:
    """The detection entry points' device: 'auto' and 'default' -> the
    current CUDA device; 'cpu', 'cuda' and 'cuda:N' as named; None
    refused."""
    if device in ("auto", "default"):
        device = "cuda"
    return resolve_device(device)


def host_features(features) -> np.ndarray:
    """Features as host float32, from numpy or a tensor on any device."""
    if isinstance(features, torch.Tensor):
        features = features.detach().cpu().numpy()
    return np.asarray(features, np.float32)
