"""Non-IID federated partitioning: Dirichlet label skew.

A numpy copy of ``repro.data.partition.dirichlet_partition``; the same seed
gives the same split as the reference.
"""
from __future__ import annotations

from typing import List

import numpy as np


def dirichlet_partition(
    labels: np.ndarray, n_clients: int, alpha: float = 0.5, seed: int = 0,
    min_size: int = 2,
) -> List[np.ndarray]:
    """Label-skewed Non-IID split: per class, proportions ~ Dir(alpha)."""
    rng = np.random.default_rng(seed)
    n_classes = int(labels.max()) + 1
    for _ in range(100):
        idx_by_client: List[List[int]] = [[] for _ in range(n_clients)]
        for c in range(n_classes):
            idx_c = np.flatnonzero(labels == c)
            rng.shuffle(idx_c)
            props = rng.dirichlet(np.full(n_clients, alpha))
            cuts = (np.cumsum(props) * len(idx_c)).astype(int)[:-1]
            for client, chunk in enumerate(np.split(idx_c, cuts)):
                idx_by_client[client].extend(chunk.tolist())
        sizes = [len(ix) for ix in idx_by_client]
        if min(sizes) >= min_size:
            break
    return [np.asarray(sorted(ix), dtype=np.int64) for ix in idx_by_client]
