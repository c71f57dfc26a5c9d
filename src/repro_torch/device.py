"""Device choice for the port's entry points.

Every entry point takes ``device``; ``None`` means the CUDA card.  With no
card present it raises instead of moving to the CPU: a caller that wants
the CPU (the tests) says so with ``device="cpu"``.
"""
from __future__ import annotations

from typing import Optional, Union

import torch

DeviceLike = Optional[Union[str, torch.device]]


def resolve_device(device: DeviceLike = None) -> torch.device:
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device is available; pass device='cpu' to run on "
                "the CPU")
        return torch.device("cuda")
    return torch.device(device)
