"""Batched k-means on the device (Lloyd's), for the IVF lists and the
IVF-assisted kNN graph.

Counterpart of vectorsearch_rbac_tpu/ops/kmeans.py on one device: the
assignment is a distance matmul and an argmin, the update step sums rows
per cluster over row blocks (a one-hot product a block, as the
reference's), so that no (N, C) matrix is ever built. Float32 throughout
with TF32 off (`exact_f32_matmul`). `kmeans_init` is the reference's numpy
draw, so both packages start from the same centroids on one seed. The
mesh-sharded step (`sharded_kmeans_step`) and the row weights it takes
are ROADMAP queue 1 item 18.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from .scan import exact_f32_matmul

_UPDATE_BLOCK = 32768   # rows a one-hot product of the update step


def assign_clusters(x: torch.Tensor, centroids: torch.Tensor) -> torch.Tensor:
    """(N, d), (C, d) float32 -> (N,) int64 argmin_c ||x - c||^2 (ties to
    the lower centroid, as jnp.argmin)."""
    xn = (x * x).sum(dim=1, keepdim=True)
    cn = (centroids * centroids).sum(dim=1)
    with exact_f32_matmul():
        d = xn + cn[None, :] - 2.0 * (x @ centroids.T)
    return torch.argmin(d, dim=1)


def assign_clusters_blocked(x: np.ndarray, centroids: torch.Tensor,
                            block: int = 65536) -> np.ndarray:
    """Host rows (N, d) -> (N,) int32 nearest centroid, uploaded and
    assigned a block of rows at a time on the centroids' device."""
    dev = centroids.device
    out = np.empty(x.shape[0], dtype=np.int32)
    for s in range(0, x.shape[0], block):
        xb = torch.from_numpy(np.ascontiguousarray(
            x[s:s + block], dtype=np.float32)).to(dev)
        out[s:s + len(xb)] = assign_clusters(xb, centroids).cpu().numpy()
    return out


def _update_step(x: torch.Tensor, centroids: torch.Tensor
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """One Lloyd iteration -> (new centroids, assignment). Per row block
    the one-hot (block, C) matrix times the rows adds into the cluster
    sums; an empty cluster keeps its centroid."""
    c = centroids.shape[0]
    sums = torch.zeros_like(centroids)
    counts = torch.zeros(c, dtype=torch.float32, device=x.device)
    assign = torch.empty(x.shape[0], dtype=torch.int64, device=x.device)
    for s in range(0, x.shape[0], _UPDATE_BLOCK):
        xi = x[s:s + _UPDATE_BLOCK]
        a = assign_clusters(xi, centroids)
        assign[s:s + len(xi)] = a
        onehot = torch.nn.functional.one_hot(a, c).to(torch.float32)
        with exact_f32_matmul():
            sums += onehot.T @ xi
        counts += onehot.sum(dim=0)
    safe = torch.clamp_min(counts, 1.0)[:, None]
    new_c = torch.where(counts[:, None] > 0, sums / safe, centroids)
    return new_c, assign


def kmeans_fit(x: torch.Tensor, init_centroids: torch.Tensor,
               iters: int = 10) -> Tuple[torch.Tensor, torch.Tensor]:
    """Fit centroids on x's device. Returns (centroids (C, d) float32,
    assign (N,) int64: the assignment made in the last iteration, to the
    centroids it started from, as the reference returns it)."""
    x = x.to(torch.float32)
    cents = init_centroids.to(device=x.device, dtype=torch.float32)
    assign = torch.zeros(x.shape[0], dtype=torch.int64, device=x.device)
    for _ in range(iters):
        cents, assign = _update_step(x, cents)
    return cents, assign


def kmeans_init(x: np.ndarray, c: int, seed: int = 0) -> np.ndarray:
    """Sample c distinct rows as initial centroids (the reference's draw);
    fewer rows than clusters pad with jittered copies."""
    rng = np.random.default_rng(seed)
    idx = rng.choice(x.shape[0], size=min(c, x.shape[0]), replace=False)
    cents = np.asarray(x[idx], dtype=np.float32)
    if len(idx) < c:
        extra = cents[rng.integers(0, len(idx), c - len(idx))]
        cents = np.concatenate(
            [cents, extra + rng.standard_normal(extra.shape)
             .astype(np.float32) * 1e-3])
    return cents
