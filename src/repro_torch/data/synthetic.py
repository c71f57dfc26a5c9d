"""Synthetic federated datasets with the paper's shapes/cardinalities.

A numpy copy of ``repro.data.synthetic.make_dataset`` and
``make_lm_tokens``: FEMNIST/CIFAR-10/SST-2 are synthesized with matching
shapes, class counts and learnable class structure (class-conditional
Gaussians over a random low-rank basis for images; class-biased token
unigrams for text); LM pretraining streams are Zipf-distributed tokens.
The same seed gives the same arrays as the reference.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Tuple

import numpy as np


@dataclass(frozen=True)
class DatasetSpec:
    name: str
    n_classes: int
    # images
    image_size: int = 0
    channels: int = 0
    # text
    vocab_size: int = 0
    seq_len: int = 0


SPECS: Dict[str, DatasetSpec] = {
    "femnist": DatasetSpec("femnist", 62, image_size=28, channels=1),
    "cifar10": DatasetSpec("cifar10", 10, image_size=32, channels=3),
    "sst2": DatasetSpec("sst2", 2, vocab_size=2048, seq_len=64),
}


def make_dataset(
    name: str, n_samples: int, seed: int = 0, class_sep: float = 8.0
) -> Tuple[np.ndarray, np.ndarray]:
    """Returns (x, y).  Images: (N,H,W,C) float32; text: (N,S) int32."""
    spec = SPECS[name]
    rng = np.random.default_rng(seed)
    y = rng.integers(0, spec.n_classes, size=n_samples).astype(np.int32)
    if spec.image_size:
        h, c = spec.image_size, spec.channels
        dim = h * h * c
        rank = min(32, dim)
        basis = rng.normal(size=(spec.n_classes, rank)).astype(np.float32)
        proj = rng.normal(size=(rank, dim)).astype(np.float32) / np.sqrt(rank)
        means = (basis @ proj) * class_sep / np.sqrt(dim)
        x = means[y] + rng.normal(size=(n_samples, dim)).astype(np.float32)
        return x.reshape(n_samples, h, h, c), y
    # text: class-biased unigram draws
    probs = rng.dirichlet(np.ones(spec.vocab_size) * 0.1, size=spec.n_classes)
    x = np.stack(
        [rng.choice(spec.vocab_size, size=spec.seq_len, p=probs[cls]) for cls in y]
    ).astype(np.int32)
    return x, y


def make_lm_tokens(n_tokens: int, vocab_size: int, seed: int = 0) -> np.ndarray:
    """Zipf-distributed token stream for LM pretraining examples."""
    rng = np.random.default_rng(seed)
    ranks = np.arange(1, vocab_size + 1)
    p = 1.0 / ranks
    p /= p.sum()
    return rng.choice(vocab_size, size=n_tokens, p=p).astype(np.int32)
