"""Plain PyTorch versions of the grouped matmul and its weight gradient.

y[m] = x[m] @ w[g(m)]  where rows are pre-sorted by group and
``group_sizes[g]`` rows belong to group g; rows past the last group are 0.
tgmm: dw[g] = x_gᵀ @ dy_g, exact zeros for an empty group.

Both loop over the groups with one matmul each, in f32, and cast to the
input dtype — the kernels' arithmetic.  They read the group sizes on the
host, so they are the CPU path of ``ops`` and the oracle the kernels are
held against on the card; never the path of a CUDA tensor.
"""
from __future__ import annotations

from typing import List, Tuple

import torch


def _row_ranges(group_sizes: torch.Tensor, m: int) -> List[Tuple[int, int]]:
    ends = torch.cumsum(group_sizes.to(torch.int64), 0).clamp(0, m).tolist()
    ranges, start = [], 0
    for end in ends:
        end = max(end, start)
        ranges.append((start, end))
        start = end
    return ranges


def grouped_matmul_ref(x: torch.Tensor, w: torch.Tensor,
                       group_sizes: torch.Tensor) -> torch.Tensor:
    """(M, K) x (G, K, N) -> (M, N) in x.dtype."""
    m, n = x.shape[0], w.shape[2]
    ranges = _row_ranges(group_sizes, m)
    pieces = [x[s:e].float() @ w[g].float() for g, (s, e) in enumerate(ranges)]
    tail = ranges[-1][1] if ranges else 0
    pieces.append(x.new_zeros((m - tail, n), dtype=torch.float32))
    return torch.cat(pieces).to(x.dtype)


def tgmm_ref(x: torch.Tensor, dy: torch.Tensor, group_sizes: torch.Tensor,
             num_groups: int) -> torch.Tensor:
    """(M, K) x (M, N) -> (G, K, N) in x.dtype."""
    ranges = _row_ranges(group_sizes, x.shape[0])
    if len(ranges) != num_groups:
        raise ValueError(f"{len(ranges)} group sizes for {num_groups} groups")
    if not ranges:
        return x.new_zeros((0, x.shape[1], dy.shape[1]))
    return torch.stack([x[s:e].float().T @ dy[s:e].float()
                        for s, e in ranges]).to(x.dtype)
