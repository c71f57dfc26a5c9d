"""Carrying parameter trees between numpy (the JAX package's host form) and
the port's tensors.

``params_from_numpy(jax.device_get(params), device)`` gives the port the
reference's exact weights; ``params_to_numpy`` goes back.  ``flatten``
keys a tree by the ``/``-joined paths of ``repro.ckpt.checkpoint._flatten``
(``main/layers/[0]/w``), and widens bf16 to f32 as it does: numpy has no
bf16, and the widening is exact.
"""
from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from repro_torch.device import DeviceLike, resolve_device
from repro_torch.tree import Tree, tree_flatten_with_path, tree_map


def _to_tensor(arr, device: torch.device) -> torch.Tensor:
    arr = np.asarray(arr)
    if arr.dtype.name == "bfloat16":  # ml_dtypes' bf16: widen, then narrow exactly
        return torch.from_numpy(arr.astype(np.float32)).to(device, torch.bfloat16)
    return torch.from_numpy(np.array(arr)).to(device)  # a copy: never a view of the caller's buffer


def to_numpy(t: torch.Tensor) -> np.ndarray:
    """A tensor on the host as numpy (bf16 widened to f32, exactly)."""
    t = t.detach().cpu()
    if t.dtype == torch.bfloat16:
        t = t.float()
    return t.numpy()


def params_from_numpy(tree: Tree, device: DeviceLike = None) -> Tree:
    """Tree of numpy arrays -> the same tree of tensors on ``device``."""
    dev = resolve_device(device)
    return tree_map(lambda a: _to_tensor(a, dev), tree)


def params_to_numpy(tree: Tree) -> Tree:
    """Tree of tensors -> the same tree of numpy arrays (bf16 widened)."""
    return tree_map(to_numpy, tree)


def flatten(tree: Tree) -> Dict[str, np.ndarray]:
    """``{path: numpy leaf}`` with the checkpoint's path keys."""
    return {path: (to_numpy(leaf) if isinstance(leaf, torch.Tensor)
                   else np.asarray(leaf))
            for path, leaf in tree_flatten_with_path(tree)}

