"""IVF-Flat index: k-means clustering and padded inverted lists.

Counterpart of vectorsearch_rbac_tpu/index/ivf.py `IVFIndex` (pgvector's
IVFFlat): centroids fitted by the device k-means (ops/kmeans.py) on a
sample of at most 200,000 rows, every row assigned to its nearest
centroid, and the rows bucketed into (nlist, L_pad) padded lists, L_pad
the 0.995 quantile of the list sizes. A row past a full list spills to its
next-nearest centroid with space; where every list is full, L_pad grows
(x1.25 + 8) and the row joins its nearest list. Pad slots carry zero role
bits and row id -1, so the scan's permission test rejects them.

The lists are gathered on the device from the arena's tensors along the
(nlist, L_pad) row map (the reference stages them in host numpy): the
vectors in the arena's serving dtype (bfloat16 on an int8 arena, as the
reference's), the norms and the role bitsets. The k-means and the spill
read the arena's float32 host rows, as the reference's do.

Search is ops/ivf_scan.ivf_search_fn, with pgvector's iterative scan
(ivfflat.iterative_scan): queries that come back short re-probe with a
doubled probe count up to max_probes. `ivf_from_reference` carries a
reference index's centroids and lists over, so that both packages search
the same lists.

Online maintenance, the reference's (pgvector's ivfinsert.c and
ivfvacuum.c; centroids are never trained again): `insert_rows` places
each new row on the host, in its nearest list with a free slot (the
lowest free slot; pads and deleted slots are free), growing L_pad
(x1.25 + 8, or by what the rows need, a multiple of 8) where every list
is full, then writes the new slots into the device lists; `delete_rows`
frees the rows' slots (row -1, zero bits) for later inserts. Only the
changed slots travel, and a growth pads the lists on the device.
"""

from __future__ import annotations

import math
import time
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from ..config import get_logger
from ..core import DeviceArena
from ..ops.ivf_scan import ivf_search_fn
from ..ops.kmeans import assign_clusters_blocked, kmeans_fit, kmeans_init

logger = get_logger("index.ivf")

TRAIN_SAMPLE = 200_000   # k-means fits on at most this many rows
PAD_QUANTILE = 0.995     # l_pad: this quantile of the list sizes


def _spill_distances(sv: np.ndarray, cent: np.ndarray) -> np.ndarray:
    """The reference's host distances of spilled rows to every centroid
    (its preference order comes from an argsort of these)."""
    return (np.einsum("nd,nd->n", sv, sv)[:, None] - 2.0 * sv @ cent.T
            + np.einsum("cd,cd->c", cent, cent)[None, :])


def bucket_rows(assign: np.ndarray, vec: np.ndarray, cent: np.ndarray,
                l_pad: int) -> Tuple[List[np.ndarray], int]:
    """Rows into lists of at most l_pad, in row order; a row past a full
    list spills to its nearest centroid with space, and where every list
    is full l_pad grows (x1.25 + 8, a multiple of 8) and the row joins its
    nearest list. Returns (each list's local row ids, the final l_pad); no
    row is dropped."""
    nlist = cent.shape[0]
    order = np.argsort(assign, kind="stable")
    sa = assign[order]
    starts = np.searchsorted(sa, np.arange(nlist))
    rank = np.arange(len(sa)) - starts[sa]
    keep = rank < l_pad
    lists = [list(x) for x in np.split(order[keep], np.searchsorted(
        sa[keep], np.arange(1, nlist)))]
    spill = np.sort(order[~keep])
    if len(spill):
        pref = np.argsort(_spill_distances(vec[spill], cent), axis=1)
        sizes = np.array([len(x) for x in lists])
        for j, i in enumerate(spill.tolist()):
            free = np.flatnonzero(sizes[pref[j]] < l_pad)
            c = int(pref[j, free[0]]) if len(free) else int(pref[j, 0])
            if not len(free):
                l_pad = int(l_pad * 1.25 + 8) // 8 * 8
            lists[c].append(i)
            sizes[c] += 1
    return [np.asarray(x, dtype=np.int64) for x in lists], l_pad


def padded_row_map(lists: List[np.ndarray], rows: np.ndarray,
                   l_pad: int) -> np.ndarray:
    """(nlist, l_pad) int32 arena row ids of the lists, -1 on pad slots."""
    rmap = np.full((len(lists), l_pad), -1, dtype=np.int32)
    for c, members in enumerate(lists):
        rmap[c, :len(members)] = rows[members]
    return rmap


def gather_lists(vectors: torch.Tensor, norms: torch.Tensor,
                 bits: torch.Tensor, row_map: torch.Tensor):
    """(vectors, norms, bits) of a (P, L) row map, gathered on the device
    from (N, d), (N,) and (N, W) row tensors; pad slots (-1) are zero."""
    flat = row_map.reshape(-1).to(torch.int64)
    pad = (flat < 0)
    safe = flat.clamp_min(0)
    p, l_pad = row_map.shape
    v = vectors.index_select(0, safe)
    n = norms.index_select(0, safe)
    b = bits.index_select(0, safe)
    v[pad] = 0
    n[pad] = 0
    b[pad] = 0
    return v.view(p, l_pad, -1), n.view(p, l_pad), b.view(p, l_pad, -1)


class IVFIndex:
    def __init__(self, arena: DeviceArena, rows: Optional[np.ndarray] = None,
                 nlist: int = 1024, nprobe: int = 16, kmeans_iters: int = 10,
                 query_batch: int = 256, seed: int = 0):
        if arena.metric == "l1":
            # pgvector's ivfflat has l2, ip and cosine opclasses only
            raise ValueError("IVF has no l1 form (use flat or hnsw)")
        self.query_batch = query_batch
        self.metric = arena.metric
        dev = arena.device
        host_vec = (arena.host_vectors if arena.host_vectors is not None
                    else arena.vectors.float().cpu().numpy())
        rows = (np.arange(arena.n, dtype=np.int64) if rows is None
                else np.asarray(rows, dtype=np.int64))
        self.n_rows = len(rows)
        vec = host_vec[rows]
        nlist = max(1, min(nlist, self.n_rows))
        self.nlist = nlist
        self.nprobe = min(nprobe, nlist)

        t0 = time.perf_counter()
        rng = np.random.default_rng(seed)
        sample = vec if len(vec) <= TRAIN_SAMPLE else vec[
            rng.choice(len(vec), TRAIN_SAMPLE, replace=False)]
        init = kmeans_init(sample, nlist, seed=seed)
        cents, _ = kmeans_fit(
            torch.from_numpy(np.ascontiguousarray(sample, np.float32))
            .to(dev), torch.from_numpy(init).to(dev), iters=kmeans_iters)
        self._centroids = cents
        assign = assign_clusters_blocked(vec, cents)
        self.build_time_s = time.perf_counter() - t0

        counts = np.bincount(assign, minlength=nlist)
        l_pad = (int(np.quantile(counts, PAD_QUANTILE)) if nlist > 1
                 else int(counts[0]))
        l_pad = max(8, int(math.ceil(l_pad / 8) * 8))
        lists, self.l_pad = bucket_rows(assign, vec, cents.cpu().numpy(),
                                        l_pad)
        self._set_lists(torch.from_numpy(
            padded_row_map(lists, rows, self.l_pad)).to(dev), arena)
        logger.info("IVF built: %d rows, nlist=%d, L_pad=%d (fill %.1f%%), "
                    "%.2fs", self.n_rows, nlist, self.l_pad,
                    100.0 * self.n_rows / (nlist * self.l_pad),
                    self.build_time_s)

    def _set_lists(self, row_map: torch.Tensor, arena: DeviceArena) -> None:
        self._inv_rows = row_map.to(torch.int32)
        self._inv_vectors, self._inv_norms, self._inv_bits = gather_lists(
            arena.vectors, arena.norms, arena.role_bits, self._inv_rows)

    @property
    def fill(self) -> float:
        """Share of the list slots that hold a row."""
        return self.n_rows / (self.nlist * self.l_pad)

    # ------------------------------------------------------------- search

    def search_deferred(self, queries: np.ndarray, query_masks: np.ndarray,
                        k: int, nprobe: Optional[int] = None):
        """One pass at a fixed nprobe -> finalize() -> (dists (Q, k)
        float32, arena row ids (Q, k) int64). Not deferred on the card:
        each batch's routing is read back to the host to group its probes
        by list (ops/ivf_scan.probed_topk), so every batch waits for the
        card before the next is queued; only the results' copy waits for
        finalize."""
        nprobe = min(nprobe or self.nprobe, self.nlist)
        dev = self._centroids.device
        q = torch.from_numpy(np.ascontiguousarray(queries, np.float32)).to(
            dev)
        m = torch.from_numpy(np.ascontiguousarray(
            query_masks, np.uint32).view(np.int32)).to(dev)
        bs = self.query_batch
        pending = [ivf_search_fn(
            q[s:s + bs], self._centroids, self._inv_vectors,
            self._inv_norms, self._inv_bits, self._inv_rows, m[s:s + bs], k,
            nprobe, metric=self.metric) for s in range(0, q.shape[0], bs)]

        def finalize():
            if not pending:
                return (np.empty((0, k), np.float32),
                        np.empty((0, k), np.int64))
            d = torch.cat([p[0] for p in pending]).cpu().numpy()
            i = torch.cat([p[1] for p in pending]).cpu().numpy()
            return d, i.astype(np.int64)

        return finalize

    def search(self, queries: np.ndarray, query_masks: np.ndarray, k: int,
               nprobe: Optional[int] = None, iterative: bool = False,
               max_probes: Optional[int] = None
               ) -> Tuple[np.ndarray, np.ndarray]:
        """(dists, arena row ids); with iterative=True (pgvector's
        ivfflat.iterative_scan) the queries that came back with a -1 slot
        re-probe with the probe count doubled, up to max_probes (default
        nlist; ivfflat.max_probes)."""
        nprobe = min(nprobe or self.nprobe, self.nlist)
        q = np.asarray(queries, dtype=np.float32)
        m = np.asarray(query_masks, dtype=np.uint32)
        out_d, out_i = self.search_deferred(q, m, k, nprobe)()
        if iterative:
            cap = min(max_probes or self.nlist, self.nlist)
            np2 = nprobe
            while np2 < cap:
                np2 = min(np2 * 2, cap)
                short = np.flatnonzero((out_i < 0).any(axis=1))
                if not len(short):
                    break
                out_d[short], out_i[short] = self.search_deferred(
                    q[short], m[short], k, np2)()
        return out_d, out_i

    # -------------------------------------------------------- maintenance

    def insert_rows(self, arena: DeviceArena, new_rows: np.ndarray) -> None:
        """Online insert (the reference's :209): each new row, in order,
        takes the lowest free slot of the first list in its preference
        order (centroids by the reference's float32 host distances) that
        has one; where none has, L_pad grows once for the call to
        max(int(L_pad * 1.25) + 8, L_pad + the most such rows a list
        takes), a multiple of 8, and those rows fill their nearest lists'
        new slots in order. The new slots take the rows' vectors, norms and
        bitsets from `arena`."""
        new_rows = np.asarray(new_rows, dtype=np.int64)
        if new_rows.size == 0:
            return
        host_vec = (arena.host_vectors if arena.host_vectors is not None
                    else arena.vectors.float().cpu().numpy())
        vec = host_vec[new_rows].astype(np.float32)
        inv_rows = self._inv_rows.cpu().numpy()
        order = np.argsort(_spill_distances(
            vec, self._centroids.cpu().numpy().astype(np.float32)), axis=1)
        free = [np.flatnonzero(inv_rows[c] < 0).tolist()
                for c in range(self.nlist)]
        placements = []     # (list, slot or -1, new row index)
        for j in range(len(new_rows)):
            c = next((int(c) for c in order[j] if free[int(c)]), None)
            placements.append((int(order[j, 0]), -1, j) if c is None
                              else (c, free[c].pop(0), j))
        unplaced = [c for c, slot, _ in placements if slot < 0]
        if unplaced:
            old_pad = self.l_pad
            need = int(np.bincount(unplaced, minlength=self.nlist).max())
            new_pad = max(int(old_pad * 1.25) + 8, old_pad + need)
            new_pad = int(math.ceil(new_pad / 8) * 8)
            nxt = [old_pad] * self.nlist
            fixed = []
            for c, slot, j in placements:
                if slot < 0:
                    slot, nxt[c] = nxt[c], nxt[c] + 1
                fixed.append((c, slot, j))
            placements = fixed
            self._grow_lists(new_pad)
            logger.info("IVF insert grew L_pad %d -> %d", old_pad, new_pad)
        lists, slots, js = (np.array(x, dtype=np.int64)
                            for x in zip(*placements))
        dev = self._inv_rows.device
        flat = torch.from_numpy(lists * self.l_pad + slots).to(dev)
        src = torch.from_numpy(new_rows[js]).to(arena.device)
        for dst, val in (
                (self._inv_vectors, arena.vectors.index_select(0, src)),
                (self._inv_norms, arena.norms.index_select(0, src)),
                (self._inv_bits, arena.role_bits.index_select(0, src)),
                (self._inv_rows, src.to(torch.int32))):
            dst.view(self.nlist * self.l_pad, -1).index_copy_(
                0, flat, val.to(dev, dst.dtype).view(len(js), -1))
        self.n_rows += len(new_rows)

    def _grow_lists(self, l_pad: int) -> None:
        """Pad every list to l_pad slots on the device (pad slots: zero
        vectors, norms and bits, row -1)."""
        grow = l_pad - self.l_pad

        def pad(t, fill=0):
            extra = torch.full((self.nlist, grow, *t.shape[2:]), fill,
                               dtype=t.dtype, device=t.device)
            return torch.cat([t, extra], dim=1).contiguous()

        self._inv_vectors = pad(self._inv_vectors)
        self._inv_norms = pad(self._inv_norms)
        self._inv_bits = pad(self._inv_bits)
        self._inv_rows = pad(self._inv_rows, -1)
        self.l_pad = l_pad

    def delete_rows(self, arena: DeviceArena, rows: np.ndarray) -> int:
        """Row delete (the reference's :300): every slot holding one of
        `rows` gets row -1 and zero bits, and later inserts reuse it; pair
        it with core.tombstone_rows so the arena-backed paths agree.
        Returns the number of slots freed."""
        rows_t = torch.from_numpy(np.asarray(rows, dtype=np.int32)).to(
            self._inv_rows.device)
        hit = torch.isin(self._inv_rows, rows_t) & (self._inv_rows >= 0)
        ndel = int(hit.sum())
        if ndel:
            self._inv_rows[hit] = -1
            self._inv_bits[hit] = 0
            self.n_rows -= ndel
        return ndel

    # ------------------------------------------------------------ storage

    def storage_bytes(self) -> Dict[str, int]:
        """The reference's accounting: list vectors; norms, bitsets and row
        ids a slot, and the float32 centroids."""
        d = self._inv_vectors.shape[2]
        w = self._inv_bits.shape[2]
        slots = self.nlist * self.l_pad
        return {"vectors": int(slots * d * self._inv_vectors.element_size()),
                "index": int(slots * (4 + 4 * w + 4) + self.nlist * d * 4)}


def ivf_from_reference(ref, device) -> IVFIndex:
    """The port's IVFIndex over a reference IVFIndex's lists: its
    centroids and padded lists (vectors, norms, bitsets, row ids) taken as
    numpy, so that both packages search the same lists."""
    ix = IVFIndex.__new__(IVFIndex)
    ix.query_batch = ref.query_batch
    ix.metric = ref.metric
    ix.n_rows = ref.n_rows
    ix.nlist = ref.nlist
    ix.nprobe = ref.nprobe
    ix.l_pad = ref.l_pad
    ix.build_time_s = 0.0
    ix._centroids = torch.from_numpy(
        np.array(ref._centroids, dtype=np.float32)).to(device)
    vec = np.asarray(ref._inv_vectors)
    vt = torch.from_numpy(vec.astype(np.float32)).to(device)
    if vec.dtype != np.float32:       # bfloat16 lists stay bfloat16
        vt = vt.to(torch.bfloat16)
    ix._inv_vectors = vt
    ix._inv_norms = torch.from_numpy(
        np.array(ref._inv_norms, dtype=np.float32)).to(device)
    ix._inv_bits = torch.from_numpy(
        np.array(ref._inv_bits, dtype=np.uint32).view(np.int32)).to(device)
    ix._inv_rows = torch.from_numpy(
        np.array(ref._inv_rows, dtype=np.int32)).to(device)
    return ix
