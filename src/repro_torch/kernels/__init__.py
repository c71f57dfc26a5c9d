"""The port's hand-written Hopper kernels, one package each, and what their wrappers share."""
from __future__ import annotations

import torch


def vector_rows(*tensors: torch.Tensor) -> bool:
    """16-byte copies can read every row of each 2-byte (B, S, H, D)-shaped
    tensor: aligned pointers, and batch, sequence and head strides that
    keep them aligned (multiples of 8 elements)."""
    return all(t.data_ptr() % 16 == 0 and all(s % 8 == 0 for s in t.stride()[:3])
               for t in tensors)
