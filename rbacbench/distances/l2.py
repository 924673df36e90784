"""Metric `l2`: squared Euclidean distance, smaller is nearer.

In float32 with TF32 off (the reference's context). On integer features in
[0, 255] at d 128 every partial sum is an integer below 2^24, so every
distance is exact whatever the summation order.
"""

import torch


def pairwise(queries: torch.Tensor, rows: torch.Tensor,
             row_norms: torch.Tensor) -> torch.Tensor:
    """(Q, N) distances from float32 queries (Q, d) to float32 rows (N, d),
    row_norms (N,) being norms(rows)."""
    return (row_norms[None, :] - 2.0 * (queries @ rows.T)
            + (queries * queries).sum(dim=1)[:, None])


def norms(rows: torch.Tensor) -> torch.Tensor:
    """(N,) what pairwise takes of each row: its squared norm."""
    return (rows * rows).sum(dim=1)


def exact(rows: torch.Tensor, queries: torch.Tensor,
          ids: torch.Tensor) -> torch.Tensor:
    """(Q, k) float32 distances from each query (Q, d) to the rows (N, d)
    named by ids (Q, k), clamped into range (the caller masks invalid
    ids)."""
    safe = ids.clamp(0, rows.shape[0] - 1)
    x = rows.index_select(0, safe.reshape(-1)).to(torch.float32)
    diff = x.view(*ids.shape, -1) - queries.to(torch.float32)[:, None, :]
    return (diff * diff).sum(dim=2)
