"""Uplink model-delta compression (communication-efficiency substrate).

The port of ``repro.fed.compression``:

* ``int8``: per-tensor symmetric quantization with stochastic rounding
  (unbiased: E[dequant] = value) — QSGD-style [arXiv:1610.02132];
* ``topk``: magnitude top-k sparsification with index+value packing;
* ``none``: identity.

Two equivalent representations, one quantization math: the legacy
flattened dict (:func:`compress` / :func:`decompress`) and the wire-native
tree (:func:`compress_tree` / :func:`decompress_tree`) whose leaves are
:class:`~repro_torch.fed.transport.QuantizedTensor` /
:class:`~repro_torch.fed.transport.TopKTensor` (the codec's own wire types,
as in the reference).  Wire leaves are numpy, so the v2 codec sends them.

The reference draws int8's rounding noise from ``jax.random``, which torch
cannot reproduce.  So the noise is a seam: ``noise(seed, leaf index, shape)``
returns uniform numbers in ``[0, 1)``.  By default it draws from a
``torch.Generator`` on the delta's device seeded from ``(seed, leaf
index)``; with the reference's noise injected, ``q`` and ``scale`` are the
reference's bit for bit.  ``topk`` sorts a host copy of the leaf with the
reference's ``np.argpartition``.  numpy has no bf16: a bf16 leaf leaves as
f32 in every form.
"""
from __future__ import annotations

from typing import Any, Callable, Dict, Optional, Tuple

import numpy as np
import torch

from repro_torch.bridge import to_numpy
from repro_torch.fed.transport import QuantizedTensor, TopKTensor
from repro_torch.tree import tree_leaves, tree_map, tree_unflatten

PyTree = Any
#: (seed, leaf index, shape) -> uniform [0, 1) of that shape (array or tensor)
Noise = Callable[[int, int, Tuple[int, ...]], Any]

_WIRE_LEAF_TYPES = (QuantizedTensor, TopKTensor)


def _default_noise(seed: int, index: int, shape, device: torch.device) -> torch.Tensor:
    mixed = int(np.random.SeedSequence((seed, index)).generate_state(1, np.uint64)[0])
    gen = torch.Generator(device=device).manual_seed(mixed >> 1)
    return torch.rand(tuple(shape), generator=gen, device=device)


def _int8_leaf(leaf, seed: int, index: int, noise: Optional[Noise]) -> Tuple[np.ndarray, float]:
    """One leaf -> (int8 q, fp32 scale); the single source of the
    quantization math for both representations."""
    l32 = torch.as_tensor(leaf).float()
    shape = tuple(l32.shape)
    u = (_default_noise(seed, index, shape, l32.device) if noise is None
         else noise(seed, index, shape))
    if not isinstance(u, torch.Tensor):
        u = torch.from_numpy(np.array(u, np.float32))
    u = u.to(device=l32.device, dtype=torch.float32)
    # a tensor divisor: CUDA divides by a host scalar as a multiply by its
    # reciprocal, a bit off the reference's division
    scale = torch.clamp(torch.max(torch.abs(l32)), min=1e-12) / l32.new_full((), 127.0)
    x = l32 / scale
    floor = torch.floor(x)
    q = floor + (u < x - floor).float()
    q = torch.clamp(q, -127, 127).to(torch.int8)
    return q.cpu().numpy(), float(scale)


def _topk_leaf(leaf, k_frac: float) -> Tuple[np.ndarray, np.ndarray, Tuple[int, ...]]:
    arr = to_numpy(torch.as_tensor(leaf))
    flat = arr.astype(np.float32).ravel()
    k = max(1, int(len(flat) * k_frac))
    idx = np.argpartition(np.abs(flat), -k)[-k:]
    return idx.astype(np.int32), flat[idx], arr.shape


def compress(delta: PyTree, method: str = "int8", k_frac: float = 0.01,
             seed: int = 0, noise: Optional[Noise] = None) -> Dict[str, Any]:
    leaves = tree_leaves(delta)
    like = tree_map(lambda _: None, delta)
    if method == "none":
        return {"method": "none", "leaves": [to_numpy(torch.as_tensor(l)) for l in leaves],
                "treedef": like}
    if method == "int8":
        return {"method": "int8", "treedef": like,
                "leaves": [_int8_leaf(l, seed, i, noise) for i, l in enumerate(leaves)]}
    if method == "topk":
        return {"method": "topk", "treedef": like,
                "leaves": [_topk_leaf(l, k_frac) for l in leaves]}
    raise ValueError(method)


def _dense_topk(idx, vals, shape) -> np.ndarray:
    flat = np.zeros(int(np.prod(shape)), np.float32)
    flat[np.asarray(idx)] = np.asarray(vals)
    return flat.reshape(shape)


def decompress(comp: Dict[str, Any]) -> PyTree:
    method = comp["method"]
    if method == "none":
        leaves = comp["leaves"]
    elif method == "int8":
        leaves = [q.astype(np.float32) * s for q, s in comp["leaves"]]
    elif method == "topk":
        leaves = [_dense_topk(*leaf) for leaf in comp["leaves"]]
    else:
        raise ValueError(method)
    return tree_unflatten(comp["treedef"], leaves)


def compressed_bytes(comp: Dict[str, Any]) -> int:
    method = comp["method"]
    if method == "none":
        return sum(l.nbytes for l in comp["leaves"])
    if method == "int8":
        return sum(q.nbytes + 4 for q, _ in comp["leaves"])
    if method == "topk":
        return sum(idx.nbytes + vals.nbytes for idx, vals, _ in comp["leaves"])
    raise ValueError(method)


# --------------------------------------------------------------------------
# Wire-native form: same structure, compressed leaves the codec transmits
# --------------------------------------------------------------------------


def compress_tree(delta: PyTree, method: str = "int8", k_frac: float = 0.01,
                  seed: int = 0, noise: Optional[Noise] = None) -> PyTree:
    """Compress a delta into the wire-native tree: the structure of
    ``delta`` with :class:`QuantizedTensor` / :class:`TopKTensor` leaves
    (``none`` keeps plain numpy leaves).  Leaf order and noise match
    :func:`compress` exactly, so both forms dequantize to the same bits for
    the same seed and noise."""
    comp = compress(delta, method, k_frac, seed, noise)
    if method == "int8":
        wire = [QuantizedTensor(q, s) for q, s in comp["leaves"]]
    elif method == "topk":
        wire = [TopKTensor(idx, vals, tuple(int(d) for d in shape))
                for idx, vals, shape in comp["leaves"]]
    else:
        wire = comp["leaves"]
    return tree_unflatten(delta, wire)


def _expand_leaf(x: Any):
    if isinstance(x, QuantizedTensor):
        return np.asarray(x.q).astype(np.float32) * x.scale
    if isinstance(x, TopKTensor):
        return _dense_topk(x.idx, x.vals, x.shape)
    return x


def decompress_tree(tree: PyTree) -> PyTree:
    """Dequantize a wire-native compressed tree back to fp32 numpy leaves.
    Identity on trees without compressed leaves."""
    return tree_map(_expand_leaf, tree)


def is_compressed_tree(tree: PyTree) -> bool:
    """Does this payload tree carry wire-native compressed leaves?"""
    return any(isinstance(l, _WIRE_LEAF_TYPES) for l in tree_leaves(tree))


def tree_wire_bytes(tree: PyTree) -> int:
    """Bytes-on-wire of a wire-native tree's tensor payloads; matches
    :func:`compressed_bytes` for the equivalent legacy form (int8: q bytes
    + 4 per scale; topk: index + value bytes; dense: raw bytes)."""
    total = 0
    for l in tree_leaves(tree):
        if isinstance(l, QuantizedTensor):
            total += np.asarray(l.q).nbytes + 4
        elif isinstance(l, TopKTensor):
            total += np.asarray(l.idx).nbytes + np.asarray(l.vals).nbytes
        else:
            total += np.asarray(l).nbytes
    return total
