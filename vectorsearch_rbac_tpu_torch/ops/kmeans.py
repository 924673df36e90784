"""Batched k-means on the device (Lloyd's), one device or mesh-sharded,
for the IVF lists and the IVF-assisted kNN graph.

Counterpart of vectorsearch_rbac_tpu/ops/kmeans.py: the assignment is a
distance matmul and an argmin, the update step sums (optionally weighted)
rows per cluster over row blocks (a one-hot product a block, as the
reference's), so that no (N, C) matrix is ever built. Float32 throughout
with TF32 off (`exact_f32_matmul`). `kmeans_init` is the reference's numpy
draw, so both packages start from the same centroids on one seed.

`sharded_kmeans_step` is the distributed Lloyd iteration over a device
mesh (parallel/mesh.py): each shard sums its rows' statistics on its
device, the sums are added on the first device in shard order (where the
reference's psum adds them over its interconnect, so the rounding may
differ in the last bits), and the new centroids go back to every device.
"""

from __future__ import annotations

from typing import Optional, Tuple

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


def _cluster_stats(x: torch.Tensor, centroids: torch.Tensor,
                   weights: Optional[torch.Tensor] = None):
    """(per-cluster sums of the weighted rows (C, d), per-cluster summed
    weights (C,), assignment (N,) int64): per row block the (weighted)
    one-hot (block, C) matrix times the rows adds into the sums."""
    c = centroids.shape[0]
    sums = torch.zeros_like(centroids)
    counts = torch.zeros(c, dtype=torch.float32, device=x.device)
    assign = torch.empty(x.shape[0], dtype=torch.int64, device=x.device)
    for s in range(0, x.shape[0], _UPDATE_BLOCK):
        xi = x[s:s + _UPDATE_BLOCK]
        a = assign_clusters(xi, centroids)
        assign[s:s + len(xi)] = a
        onehot = torch.nn.functional.one_hot(a, c).to(torch.float32)
        if weights is not None:
            onehot = onehot * weights[s:s + len(xi), None]
        with exact_f32_matmul():
            sums += onehot.T @ xi
        counts += onehot.sum(dim=0)
    return sums, counts, assign


def _new_centroids(sums, counts, centroids) -> torch.Tensor:
    """Mean of each cluster; an empty (zero-weight) one keeps its place."""
    safe = torch.clamp_min(counts, 1.0)[:, None]
    return torch.where(counts[:, None] > 0, sums / safe, centroids)


def _update_step(x: torch.Tensor, centroids: torch.Tensor,
                 weights: Optional[torch.Tensor] = None
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """One Lloyd iteration -> (new centroids, assignment), rows weighted
    by `weights` (N,) where given."""
    sums, counts, assign = _cluster_stats(x, centroids, weights)
    return _new_centroids(sums, counts, centroids), assign


def kmeans_fit(x: torch.Tensor, init_centroids: torch.Tensor,
               iters: int = 10, weights: Optional[torch.Tensor] = None
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Fit centroids on x's device. Returns (centroids (C, d) float32,
    assign (N,) int64: the assignment made in the last iteration, to the
    centroids it started from, as the reference returns it)."""
    x = x.to(torch.float32)
    cents = init_centroids.to(device=x.device, dtype=torch.float32)
    w = None if weights is None else weights.to(x.device, torch.float32)
    assign = torch.zeros(x.shape[0], dtype=torch.int64, device=x.device)
    for _ in range(iters):
        cents, assign = _update_step(x, cents, w)
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


def sharded_kmeans_step(mesh, x_shards, centroids: torch.Tensor,
                        weights=None):
    """One distributed Lloyd iteration over the mesh's shard axis (its
    first replica row): x_shards the rows as a row-sharded
    parallel.sharded.ShardedArray (shard_rows), weights None or one of
    the same rows. Each shard's statistics on its device, their sum on the
    first device in shard order, the new centroids back to every device.
    Returns (centroids: a replicated ShardedArray, assignment: a
    row-sharded ShardedArray)."""
    from ..parallel.sharded import ShardedArray, replicate

    devs = mesh.devices[0]
    stats = []
    for s, dev in enumerate(devs):
        w = None if weights is None else weights.parts[0][s]
        stats.append(_cluster_stats(
            x_shards.parts[0][s].to(torch.float32),
            centroids.to(device=dev, dtype=torch.float32), w))
    first = devs[0]
    sums = stats[0][0]
    counts = stats[0][1]
    for st in stats[1:]:
        sums = sums + st[0].to(first)
        counts = counts + st[1].to(first)
    new_c = _new_centroids(sums, counts, centroids.to(
        device=first, dtype=torch.float32))
    assign = ShardedArray(
        tuple(tuple(stats[s][2] for s in range(len(devs)))
              for _ in mesh.devices), (x_shards.shape[0],))
    return replicate(mesh, new_c), assign
