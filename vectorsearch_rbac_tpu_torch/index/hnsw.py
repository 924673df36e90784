"""HNSW index: native graph construction and batched graph search on the card.

Counterpart of vectorsearch_rbac_tpu/index/hnsw.py `HNSWIndex`. The graph
addresses the partition's rows by local id; the row map takes a local id
to its arena row. Two storage modes, the reference's (:253-259):

- physical (logical=False, the reference's default and
  cfg.index.hnsw_logical's): the index keeps its own device copy of its
  rows, gathered once at build (rows=None too), and serves from it with no
  row map; the row map translates the results' ids at the end. On an l2,
  ip or cosine arena whose int8 mirror is lossless the copy is the
  partition's own packed-row table (core.build_packed_graph_rows over its
  rows: [int8 code | W bitset words | f32 norm], 148 bytes a row at SIFT
  shape), which the fused search and KS7 take with a null row map and the
  fixed-budget traversals read dequantized (ops/graph_search.py
  PackedCopy); the reference's copy is the unpacked bfloat16 rows, the
  same values. On every other arena the copy is the rows, norms and
  bitsets in the arena's dtype, the reference's layout. Maintenance keeps
  the copy in step (new rows written, deleted rows' bits zeroed) and its
  host mirror of float32 rows feeds the native edge update through an
  identity map;
- logical (logical=True; AnonySys's graph executors and the
  GraphProbeBatcher take only these): vectors live once, in the shared
  arena, read through the row map; the graph and the row map are the
  index's only storage.

Three builders; "auto" picks between the first two by row count as the
reference does:

- "classic" (up to 50,000 rows): the native Malkov-Yashunin construction
  (native/hnsw_builder.cpp vsr_hnsw_build);
- "tpu" (above 50,000 rows; the reference's name for its
  device-assisted builder): a kNN graph on the device, random long-range
  edges, the native alpha-RNG prune (vsr_rng_prune), then one
  search-based refinement pass (`_vamana_refine`) over the device beam
  search. Up to 200,000 rows the kNN is exact, from blockwise float32
  matmuls (TF32 off), each row's k + 1 nearest taken in (distance, index)
  order as lax.top_k takes them; above, it is the reference's
  IVF-assisted kNN (`_device_knn_graph_ivf`: the device k-means and the
  probed scan of ops/kmeans.py and ops/ivf_scan.py);
- "acorn": the native construction with ACORN-gamma dense layer-0 lists
  of m_beta columns (native/hnsw_builder.cpp vsr_hnsw_build_acorn), for
  the filtered traversal at low selectivity.

Every builder works in L2, on the metric's build vectors (the
reference's :286-325): cosine rows are unit vectors, so L2 order is
cosine order; ip rows take the MIPS lift, sqrt(max ||x||^2 - ||x||^2)
appended as one more column, for the build only; l1 builds the L2 graph
as a proxy. Serving scores in the arena's metric on the original rows.

A failed native build raises (native/__init__.py): the reference's
pure-Python stand-in for a missing compiler is not carried over.

Search: the iterative rescan (pgvector's hnsw.iterative_scan analog) with
per-query entries, the fixed-budget beam, or the ACORN filtered traversal
over it, through ops/graph_search.py; packed-row scoring where an l2, ip
or cosine arena carries a lossless int8 mirror.

Online maintenance (the reference's :433-887, pgvector's hnswinsert.c and
hnswvacuum.c), on the host mirrors `_hgraph` / `_hrmap` with delta
scatters into the device graph and row map:

- `insert_rows`: arena rows join the graph in sub-batches of 4,096; each
  sub-batch's candidates come from the fixed beam over the current device
  graph (L2, every row admissible, width min(efc, 32), queries in batches
  of 1,024), and the native edge update (vsr_insert_update) prunes them
  and adds reverse edges; then only the new region and the changed old
  rows are scattered (and a physical index's copy of the new rows).
  Crossing a power-of-two bucket re-uploads the graph, the row map and a
  physical copy once, before the first sub-batch.
- `refine_rows`: the same update in refine mode for rows already in the
  graph, against the final graph (a bulk insert links mostly forward in
  its batch).
- `delete_rows`: graph repair (each live node that pointed at a deleted
  one re-selects its list from its live neighbours and the deleted
  neighbour's, alpha-RNG pruned to M0), the deleted nodes' lists emptied
  and their row-map entries set to -1, the entry moved off a deleted node.
  A logical index then serves from the arena it is given (the caller's
  tombstoned one, core.tombstone_rows) and drops its packed rows, which
  carry the old bitsets; a physical one zeroes the deleted rows' bitsets
  in its copy (the reference's :878-881).

Each step's phases are spans for torch.profiler (hnsw.insert.search,
.link, .scatter; hnsw.refine.*; hnsw.delete.repair, .scatter) and add
their host seconds to `maintenance_s` (a search's include the wait for
its results).

Candidate search and prune work in L2 on the partition's rows whatever
the metric, as the reference's do (an ip arena's raw rows, not the MIPS
lift): a logical index reads them from the arena, a physical one from its
copy. A GraphProbeBatcher's slab is a copy of the graphs taken at build:
an index changed behind it serves through the slab as it was until the
searcher is built again, as the reference's physical copies serve old
bits until rebuilt.
"""

from __future__ import annotations

import time
from contextlib import contextmanager
from typing import Dict, Optional, Tuple

import numpy as np
import torch
from torch.profiler import record_function

from .. import native
from ..config import get_logger
from ..core import DeviceArena, build_packed_graph_rows, packed_query_operands
from ..ops.graph_search import (PackedCopy, graph_beam_search,
                                graph_beam_search_filtered,
                                graph_beam_search_iterative)
from ..ops.graph_step import PACKED_METRICS
from ..ops.ivf_scan import ivf_search_fn
from ..ops.kmeans import assign_clusters_blocked, kmeans_fit, kmeans_init
from ..ops.scan import exact_f32_matmul
from ..ops.topk import merge_topk_host
from .ivf import TRAIN_SAMPLE, bucket_rows, padded_row_map

logger = get_logger("index.hnsw")

CLASSIC_MAX_ROWS = 50_000   # "auto" builds larger graphs with the kNN builder
KNN_MAX_ROWS = 200_000      # above, the IVF-assisted kNN (the reference's
                            # :366)
KNN_IVF_CHUNK = 4096        # rows a probed scan of the IVF-assisted kNN
INSERT_SUB_BATCH = 4096     # rows an insert links before the next ones
                            # search (later rows see earlier inserts)
CAND_BATCH = 1024           # queries a candidate search of insert/refine
ALPHA = 1.2                 # the maintenance prunes' alpha (the
                            # reference's)


def _device_knn_graph(vec: np.ndarray, k: int, device,
                      block: int = 4096) -> np.ndarray:
    """(n, k + 1) int32: each row's k + 1 nearest rows (itself first) by
    squared L2 from blockwise float32 matmuls, ties to the lower index (the
    reference's lax.top_k order). The (k + 1)-th smallest score bounds the
    candidates; those are then put in (score, index) order exactly."""
    n = vec.shape[0]
    v = torch.from_numpy(np.ascontiguousarray(vec)).to(device)
    norms = (v * v).sum(dim=1)
    ar = torch.arange(n, device=device)
    out = np.empty((n, k + 1), dtype=np.int32)
    with exact_f32_matmul():
        for s in range(0, n, block):
            sc = norms[None, :] - 2.0 * (v[s:s + block] @ v.T)
            thr = torch.topk(sc, k + 1, dim=1, largest=False).values.amax(
                dim=1, keepdim=True)
            keep = sc <= thr
            width = int(keep.sum(dim=1).max())
            pos = torch.topk(torch.where(keep, ar, n), width, dim=1,
                             largest=False).values          # ascending index
            val = torch.where(pos < n, sc.gather(1, pos.clamp_max(n - 1)),
                              float("inf"))
            order = torch.sort(val, dim=1, stable=True).indices[:, :k + 1]
            out[s:s + block] = pos.gather(1, order).cpu().numpy()
    return out


def _device_knn_graph_ivf(vec: np.ndarray, k: int, device, seed: int = 0,
                          centroids: Optional[np.ndarray] = None
                          ) -> np.ndarray:
    """(n, k + 1) int32 approximate kNN lists from IVF probing (the
    reference's :62): nlist max(16, sqrt n) centroids fitted by 8 Lloyd
    iterations on a sample of at most 200,000 rows (or `centroids` as
    given), every row in its nearest list or, past a full one (l_pad the
    0.99 quantile of the list sizes), its nearest list with space: no row
    is dropped. Each row then searches its 6 nearest lists for its k + 1
    nearest by squared L2, in chunks of 4096 queries through the probed
    scan: bfloat16 lists, one all-admitting role word, pad norms 3e37."""
    n, d = vec.shape
    nlist = max(16, int(np.sqrt(n)))
    nprobe = 6
    if centroids is None:
        rng = np.random.default_rng(seed)
        sample = vec if n <= TRAIN_SAMPLE else vec[
            rng.choice(n, TRAIN_SAMPLE, replace=False)]
        cents, _ = kmeans_fit(
            torch.from_numpy(np.ascontiguousarray(sample)).to(device),
            torch.from_numpy(kmeans_init(sample, nlist, seed)).to(device),
            iters=8)
    else:
        cents = torch.from_numpy(np.array(centroids, np.float32)).to(
            device)
    assign = assign_clusters_blocked(vec, cents)
    counts = np.bincount(assign, minlength=nlist)
    l_pad = max(8, int(np.quantile(counts, 0.99)) // 8 * 8 + 8)
    lists, l_pad = bucket_rows(assign, vec, cents.cpu().numpy(), l_pad)
    if sum(len(x) for x in lists) != n:
        raise RuntimeError("the IVF graph lists lost rows")
    rmap = torch.from_numpy(padded_row_map(
        lists, np.arange(n, dtype=np.int64), l_pad)).to(device)
    flat = rmap.reshape(-1).to(torch.int64)
    pad = flat < 0
    v = torch.from_numpy(np.ascontiguousarray(vec)).to(device)
    norms = torch.from_numpy(
        np.einsum("nd,nd->n", vec, vec).astype(np.float32)).to(device)
    inv_vec = v.index_select(0, flat.clamp_min(0)).to(torch.bfloat16)
    inv_vec[pad] = 0
    inv_norm = norms.index_select(0, flat.clamp_min(0))
    inv_norm[pad] = 3e37
    inv_bits = (~pad).to(torch.int32)
    shape = (nlist, l_pad)
    inv_vec, inv_norm = inv_vec.view(*shape, d), inv_norm.view(shape)
    inv_bits = inv_bits.view(*shape, 1)
    masks = torch.ones((KNN_IVF_CHUNK, 1), dtype=torch.int32, device=device)
    out = np.empty((n, k + 1), dtype=np.int32)
    for s in range(0, n, KNN_IVF_CHUNK):
        e = min(s + KNN_IVF_CHUNK, n)
        _, ids = ivf_search_fn(v[s:e], cents, inv_vec, inv_norm, inv_bits,
                               rmap, masks[:e - s], k + 1, nprobe)
        out[s:e] = ids.cpu().numpy()
    return out


def _vamana_refine(vec: np.ndarray, nbr: np.ndarray, entry: int, m: int,
                   alpha: float, device, knn: Optional[np.ndarray] = None,
                   ef: int = 48, batch: int = 16384,
                   passes: int = 1) -> np.ndarray:
    """The search-based refinement pass (DiskANN's second phase, the
    reference's :146): every node's beam search on the current graph from
    the entry gives candidates along the search path, and the native prune
    re-selects its edges from them, its current edges and its kNN list.
    A node's search does not depend on its batch; batches of 16,384 (the
    reference's are 4,096) take fewer host-bound steps."""
    n, d = vec.shape
    norms = np.einsum("nd,nd->n", vec, vec).astype(np.float32)
    k_cand = min(ef, 32)
    for _ in range(passes):
        dv = torch.from_numpy(np.ascontiguousarray(vec)).to(device)
        dn = torch.from_numpy(norms).to(device)
        db = torch.ones((n, 1), dtype=torch.int32, device=device)
        dg = torch.from_numpy(np.ascontiguousarray(nbr)).to(device)
        found = np.full((n, k_cand), -1, dtype=np.int32)
        for s in range(0, n, batch):
            e = min(s + batch, n)
            masks = torch.ones((e - s, 1), dtype=torch.int32, device=device)
            _, ids = graph_beam_search(dv[s:e], dv, dn, db, dg, masks,
                                       int(entry), k_cand, ef)
            found[s:e] = ids.cpu().numpy()
        parts = [found, nbr] + ([knn] if knn is not None else [])
        cands = np.concatenate(parts, axis=1).astype(np.int32)
        nbr = native.rng_prune(vec, cands, m=m, alpha=alpha)
    return nbr


def build_vectors(vec: np.ndarray, metric: str) -> np.ndarray:
    """The rows the L2 builders see: the MIPS lift for ip (Bachrach et
    al.: sqrt(max ||x||^2 - ||x||^2) appended, so L2 proximity in the
    lifted space tracks inner-product order), the rows themselves
    otherwise (cosine rows are unit; l1 takes the L2 graph as a proxy)."""
    if metric != "ip" or not len(vec):
        return vec
    nrm2 = np.einsum("nd,nd->n", vec, vec)
    lift = np.sqrt(np.maximum(float(nrm2.max()) - nrm2, 0.0))
    return np.concatenate([vec, lift[:, None].astype(np.float32)], axis=1)


def _pow2_rows(n: int) -> int:
    """The padded node count of an n-node graph: the reference's
    power-of-two bucket, at least 1024 (the graph batcher stacks graphs of
    one padded size into a slab)."""
    return max(1024, 1 << (max(n, 1) - 1).bit_length())


def _host_rows(arena: DeviceArena) -> np.ndarray:
    """The arena's (Npad, d) float32 host rows."""
    return (arena.host_vectors if arena.host_vectors is not None
            else arena.vectors.float().cpu().numpy())


def _scatter_rows(dst: torch.Tensor, idx: np.ndarray, src) -> None:
    """dst[idx] = src (a host array or a tensor), in place on dst's device
    (the reference's donated jit scatter); only the given rows travel."""
    if len(idx):
        dev = dst.device
        if not torch.is_tensor(src):
            src = torch.from_numpy(np.ascontiguousarray(src))
        dst.index_copy_(0, torch.from_numpy(idx.astype(np.int64)).to(dev),
                        src.to(dev))


def _bits_i32(bits: np.ndarray, device) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(bits, dtype=np.uint32)
                            .view(np.int32)).to(device)


class HNSWIndex:
    def __init__(self, arena: DeviceArena, rows: Optional[np.ndarray] = None,
                 m: int = 16, ef_construction: int = 64, ef_search: int = 40,
                 query_batch: int = 256, builder: str = "auto",
                 knn_k: int = 32, alpha: float = 1.2, m_beta: int = 64,
                 seed: int = 0, graph_state: Optional[dict] = None,
                 logical: bool = False):
        """graph_state: a graph_state() dict (this index's or the JAX
        index's: neighbours and entry) to serve instead of building. m_beta:
        the "acorn" builder's layer-0 width. logical: serve from the shared
        arena through the row map (True) or from the index's own copy of
        its rows (False, the reference's default). The iterative search
        scores packed rows where an l2, ip or cosine arena's int8 mirror is
        lossless."""
        self.m = m
        self.ef_search = ef_search
        self.query_batch = query_batch
        self.metric = arena.metric
        self.logical = bool(logical)
        dev = arena.device
        self.use_packed = bool(arena.quant is not None
                               and arena.metric in PACKED_METRICS
                               and arena.quant.lossless)
        self._arena = arena
        self._packed = None
        self._entry_sample = None
        self.maintenance_s: Dict[str, float] = {}
        self.repaired_nodes = 0     # the nodes the last delete_rows rewired

        host_vec = _host_rows(arena)
        rows = (np.arange(arena.n, dtype=np.int64) if rows is None
                else np.asarray(rows, dtype=np.int64))
        self.n_rows = n = len(rows)
        base = np.ascontiguousarray(host_vec[rows], dtype=np.float32)
        vec = build_vectors(base, self.metric)

        if builder == "auto":
            builder = "tpu" if n > CLASSIC_MAX_ROWS else "classic"
        self.builder = "state" if graph_state is not None else builder
        t0 = time.perf_counter()
        if graph_state is not None:
            nbr = np.asarray(graph_state["neighbors"], dtype=np.int32)
            entry = int(np.asarray(graph_state["entry"]).reshape(-1)[0])
            if nbr.shape[0] != n:
                raise ValueError(f"graph state of {nbr.shape[0]} rows does "
                                 f"not match the {n}-row set")
        elif builder == "classic":
            nbr, _, entry, _ = native.hnsw_build(
                vec, m=m, ef_construction=ef_construction, seed=seed)
        elif builder == "tpu":
            knn = (_device_knn_graph_ivf(vec, knn_k, dev, seed=seed)
                   if n > KNN_MAX_ROWS else
                   _device_knn_graph(vec, knn_k, dev))
            rng = np.random.default_rng(seed)
            rand_edges = rng.integers(0, n, size=(n, 16), dtype=np.int64)
            cand0 = np.concatenate([knn[:, 1:], rand_edges.astype(np.int32)],
                                   axis=1)
            nbr = native.rng_prune(vec, cand0, m=m, alpha=alpha)
            mean = vec.mean(axis=0, keepdims=True)
            entry = int(np.argmin(((vec - mean) ** 2).sum(axis=1)))
            nbr = _vamana_refine(vec, nbr, entry, m=m, alpha=alpha,
                                 device=dev, knn=knn[:, 1:])
        elif builder == "acorn":
            nbr, _, entry, _ = native.hnsw_build_acorn(
                vec, m=m, m_beta=m_beta, ef_construction=ef_construction,
                seed=seed)
        else:
            raise ValueError(f"unknown builder {builder}")
        self.build_time_s = time.perf_counter() - t0
        self.entry = int(entry)
        m0 = nbr.shape[1]

        npad = _pow2_rows(n)
        pad = npad - n
        self._hgraph = np.concatenate([nbr, np.full((pad, m0), -1, np.int32)])
        self._hrmap = np.concatenate([rows, np.full(pad, -1)]).astype(np.int32)
        # deleted local nodes (the reference creates it at the first delete)
        self._deleted_local = np.zeros(npad, dtype=bool)
        self._graph = torch.from_numpy(self._hgraph).to(dev)
        self._row_map = torch.from_numpy(self._hrmap).to(dev)
        # the physical copy: the packed table, or the unpacked rows, norms
        # and bits; the host mirror of its float32 rows
        self._table = self._vectors = self._norms = self._bits = None
        self._hvec = self._center = None
        if not self.logical:
            self._hvec = np.zeros((npad, base.shape[1]), np.float32)
            self._hvec[:n] = base
            self._table, self._vectors, self._norms, self._bits = \
                self._gather_copy(arena, rows, npad)
            if self._table is not None:
                self._center = torch.from_numpy(arena.quant.center).to(dev)
        logger.info("HNSW built (%s, %s): %d rows, M0=%d (avg deg %.1f), "
                    "%.2fs", self.builder,
                    "logical" if self.logical else "physical", n, m0,
                    float((nbr >= 0).sum(1).mean()) if n else 0.0,
                    self.build_time_s)

    # ------------------------------------------------------ the copy

    def _gather_copy(self, arena: DeviceArena, rows: np.ndarray,
                     n_pad: int):
        """The physical copy of arena `rows` with zero rows after them up
        to n_pad: (packed table, None, None, None) on a lossless packed
        arena, else (None, rows in the arena's dtype, float32 norms, int32
        bitsets)."""
        if self.use_packed:
            return build_packed_graph_rows(arena, rows, n_pad), None, None, \
                None
        idx = torch.from_numpy(np.asarray(rows, np.int64)).to(arena.device)

        def take(t):
            out = t.new_zeros((n_pad,) + tuple(t.shape[1:]))
            out[:len(idx)] = t[idx]
            return out
        return (None, take(arena.vectors), take(arena.norms),
                take(arena.role_bits))

    def _copy_view(self) -> PackedCopy:
        """The packed table as ops/graph_search.py's PackedCopy."""
        return PackedCopy(self._table, len(self._center),
                          self._arena.quant.scale, self._center,
                          self._arena.vectors.dtype)

    def _tables(self):
        """(vectors, norms, bits, row map) the unpacked scorers read: the
        arena through the row map (logical), the unpacked copy, or the
        packed copy as a PackedCopy (its own norms and bits), without a
        row map."""
        if self.logical:
            a = self._arena
            return a.vectors, a.norms, a.role_bits, self._row_map
        if self._table is not None:
            return self._copy_view(), None, None, None
        return self._vectors, self._norms, self._bits, None

    def _write_copy(self, arena: DeviceArena, local: np.ndarray,
                    rows: np.ndarray) -> None:
        """Physical mode: the copy's local rows `local` become arena rows
        `rows` (an insert) on the device."""
        table, vectors, norms, bits = self._gather_copy(arena, rows,
                                                        len(rows))
        if table is not None:
            _scatter_rows(self._table, local, table)
        else:
            for dst, src in ((self._vectors, vectors), (self._norms, norms),
                             (self._bits, bits)):
                _scatter_rows(dst, local, src)

    def _zero_copy_bits(self, local: np.ndarray) -> None:
        """Physical mode: the copy's local rows `local` admit no query."""
        idx = torch.from_numpy(np.asarray(local, np.int64)).to(
            self._graph.device)
        if self._table is not None:
            d_pad = self._arena.quant.d_pad
            self._table[idx, d_pad:-4] = 0
        else:
            self._bits[idx] = 0

    # ------------------------------------------------------- maintenance

    @contextmanager
    def _phase(self, name: str):
        """A maintenance phase: the span hnsw.<name>, its host seconds
        added to maintenance_s[name]."""
        t0 = time.perf_counter()
        with record_function(f"hnsw.{name}"):
            yield
        self.maintenance_s[name] = (self.maintenance_s.get(name, 0.0)
                                    + time.perf_counter() - t0)

    def _locals_of(self, rows: np.ndarray) -> np.ndarray:
        """The local node ids of those arena `rows` that are live nodes of
        the graph, in `rows`' order."""
        rmap = self._hrmap[:self.n_rows]
        live = rmap >= 0
        inv = np.full(max(int(rmap.max(initial=-1)),
                          int(rows.max(initial=-1))) + 1, -1, np.int64)
        inv[rmap[live]] = np.flatnonzero(live)
        loc = inv[rows[rows >= 0]]
        return loc[loc >= 0]

    def _candidates(self, q: np.ndarray, width: int, ef: int) -> np.ndarray:
        """(len(q), width) int32 local ids: the fixed beam over the current
        device graph from the entry, in L2 with every row admissible (an
        all-ones one-word bit table and mask), queries in batches of
        CAND_BATCH, the deleted nodes dropped (-1)."""
        vectors, norms, _, row_map = self._tables()
        dev = self._graph.device
        n_tab = (self._arena.n_padded if self.logical
                 else self._hgraph.shape[0])
        ones = torch.ones((n_tab, 1), dtype=torch.int32, device=dev)
        masks = torch.ones((CAND_BATCH, 1), dtype=torch.int32, device=dev)
        q_t = torch.from_numpy(np.ascontiguousarray(q, np.float32)).to(dev)
        found = []
        for s in range(0, len(q), CAND_BATCH):
            qb = q_t[s:s + CAND_BATCH]
            found.append(graph_beam_search(
                qb, vectors, norms, ones, self._graph, masks[:len(qb)],
                self.entry, width, ef, row_map=row_map)[1])
        cand = torch.cat(found).cpu().numpy().astype(np.int32)
        cand[(cand >= 0) & self._deleted_local[np.maximum(cand, 0)]] = -1
        return cand

    def _grow_to(self, n_total: int) -> None:
        """Grow the host mirrors to the power-of-two bucket of n_total
        nodes and upload the graph, the row map and a physical copy once
        (nothing if they fit). No tensor of the old size stays in the
        index: the sampled entries are drawn again."""
        npad = _pow2_rows(n_total)
        old = self._hgraph.shape[0]
        if npad <= old:
            return

        def grow(a, fill):
            out = np.full((npad,) + a.shape[1:], fill, dtype=a.dtype)
            out[:old] = a
            return out

        self._hgraph = grow(self._hgraph, -1)
        self._hrmap = grow(self._hrmap, -1)
        self._deleted_local = grow(self._deleted_local, False)
        dev = self._graph.device
        self._graph = torch.from_numpy(self._hgraph).to(dev)
        self._row_map = torch.from_numpy(self._hrmap).to(dev)
        if not self.logical:
            self._hvec = grow(self._hvec, 0)

            def grow_t(t):
                if t is None:
                    return None
                out = t.new_zeros((npad,) + tuple(t.shape[1:]))
                out[:old] = t
                return out
            self._table, self._vectors, self._norms, self._bits = map(
                grow_t, (self._table, self._vectors, self._norms,
                         self._bits))
        self._entry_sample = None

    def _vec_map(self, hv: np.ndarray):
        """(float32 row table, local id -> table row) for the native edge
        update: the arena's rows through the row map (logical), or the
        copy's host mirror through an identity map (the reference's
        :564-568)."""
        if self.logical:
            return hv, self._hrmap
        return self._hvec, np.arange(self._hgraph.shape[0], dtype=np.int32)

    def insert_rows(self, arena: DeviceArena, rows: np.ndarray) -> None:
        """Online insert of arena rows (the reference's :433; pgvector's
        hnswinsert.c: search for neighbours, RNG prune, bidirectional
        edges, re-prune of overflowing lists), in sub-batches of
        INSERT_SUB_BATCH rows, so that a sub-batch's searches see the rows
        inserted before it. `arena` is the one the index serves (its host
        rows feed the prune, and a physical copy takes its new rows from
        it); the bucket grows once, to the final size."""
        rows = np.asarray(rows, dtype=np.int64)
        if len(rows) == 0:
            return
        efc = max(self.m * 2, 48)     # the search's ef (the reference's)
        hv = _host_rows(arena)
        self._grow_to(self.n_rows + len(rows))
        for s in range(0, len(rows), INSERT_SUB_BATCH):
            self._insert_sub_batch(arena, rows[s:s + INSERT_SUB_BATCH], efc,
                                   hv)
        self._entry_sample = None
        logger.info("inserted %d rows (now %d, npad %d)", len(rows),
                    self.n_rows, self._hgraph.shape[0])

    def _insert_sub_batch(self, arena: DeviceArena, rows: np.ndarray,
                          efc: int, hv: np.ndarray) -> None:
        """Candidates for the sub-batch from the current device graph, the
        native edge update on the host mirrors, then the device delta: the
        new region and the changed old rows of the graph, the new region
        of the row map and of a physical copy."""
        n_old, n_new = self.n_rows, len(rows)
        n_total = n_old + n_new
        new_ids = np.arange(n_old, n_total, dtype=np.int64)
        with self._phase("insert.search"):
            cand = self._candidates(hv[rows], min(efc, 32), efc)
        with self._phase("insert.link"):
            self._hrmap[n_old:n_total] = rows.astype(np.int32)
            if not self.logical:
                self._hvec[new_ids] = hv[rows]
            changed_old = native.insert_update(*self._vec_map(hv),
                                               self._hgraph, cand, n_old,
                                               self.m, ALPHA)
        with self._phase("insert.scatter"):
            gidx = np.concatenate([new_ids, np.unique(changed_old)])
            _scatter_rows(self._graph, gidx, self._hgraph[gidx])
            _scatter_rows(self._row_map, new_ids, self._hrmap[new_ids])
            if not self.logical:
                self._write_copy(arena, new_ids, rows)
        self.n_rows = n_total

    def refine_rows(self, arena: DeviceArena, rows: np.ndarray) -> None:
        """Re-prune the given arena rows' lists against the current graph
        (the reference's :649, the insert path's analog of the builder's
        refinement pass): candidates from the fixed beam over the final
        graph, where every inserted row is visible, then the native update
        in refine mode and a scatter of the rows it touched. Deleted nodes
        are never linked again."""
        rows = np.asarray(rows, dtype=np.int64)
        if len(rows) == 0:
            return
        hv = _host_rows(arena)
        nodes = self._locals_of(rows)
        nodes = nodes[~self._deleted_local[nodes]]
        if len(nodes) == 0:
            return
        efr = max(self.m * 2, 48)
        with self._phase("refine.search"):
            cand = self._candidates(hv[self._hrmap[nodes]], min(efr, 32),
                                    efr)
        with self._phase("refine.link"):
            touched = native.insert_update(*self._vec_map(hv), self._hgraph,
                                           cand, self.n_rows, self.m, ALPHA,
                                           nodes=nodes)
        with self._phase("refine.scatter"):
            cidx = np.unique(touched).astype(np.int64)
            _scatter_rows(self._graph, cidx, self._hgraph[cidx])
        self._entry_sample = None
        logger.info("refined %d rows (%d graph rows updated)", len(nodes),
                    len(cidx))

    def delete_rows(self, arena: DeviceArena, rows: np.ndarray) -> int:
        """Row delete with graph repair (the reference's :782; pgvector's
        hnswvacuum.c HnswRepairGraph). Each live node holding an edge to a
        deleted one re-selects its list from its live neighbours and the
        deleted neighbours' live neighbours, alpha-RNG pruned to M0 (the
        reference's numpy loop; the pairwise distances of a candidate
        against the kept ones taken in one product, the same float32
        values); the deleted nodes' lists empty and their row-map entries
        become -1, so they are unreachable and unreturnable; the entry
        moves to the nearest live node of a 4,096-node sample
        (default_rng(0)). A logical index then serves from `arena` (the
        caller's tombstoned one) and builds its packed rows again, since
        they carry the bitsets; a physical index zeroes the deleted rows'
        bitsets in its copy. Storage stays until a rebuild over
        core.compact_corpus. Returns the number of rows deleted (0 for
        rows already deleted or not in the graph) and leaves the number of
        nodes repaired in `repaired_nodes`."""
        self._arena = arena
        self._packed = None
        self.repaired_nodes = 0
        rows = np.asarray(rows, dtype=np.int64)
        dels = np.sort(self._locals_of(rows))
        if len(dels) == 0:
            return 0
        self._deleted_local[dels] = True
        with self._phase("delete.repair"):
            affected = self._repair(dels, _host_rows(arena))
        self.repaired_nodes = len(affected)
        with self._phase("delete.scatter"):
            self._hrmap[dels] = -1
            _scatter_rows(self._row_map, dels, self._hrmap[dels])
            changed = np.unique(np.concatenate([affected, dels]))
            _scatter_rows(self._graph, changed, self._hgraph[changed])
            if not self.logical:
                self._zero_copy_bits(dels)
        self._entry_sample = None
        logger.info("deleted %d rows (graph repaired at %d nodes)",
                    len(dels), len(affected))
        return len(dels)

    def _repair(self, dels: np.ndarray, hv: np.ndarray) -> np.ndarray:
        """delete_rows' work on the host mirror: each live node that holds
        an edge to one of the deleted nodes `dels` re-selects its list (the
        reference's loop), the deleted nodes' lists empty, the entry moves
        to a live node. Returns the repaired nodes."""
        graph, rmap = self._hgraph, self._hrmap
        is_del = np.zeros(graph.shape[0], dtype=bool)
        is_del[dels] = True

        def vec_of(local_ids):
            return hv[rmap[np.asarray(local_ids, dtype=np.int64)]].astype(
                np.float32)

        # live nodes holding an edge to a deleted node
        hit = np.isin(graph, dels) & (graph >= 0)
        affected = np.nonzero(hit.any(axis=1) & ~is_del)[0]
        m0 = graph.shape[1]
        for node in affected.tolist():
            nbrs = graph[node]
            cand = {int(c) for c in nbrs if c >= 0 and not is_del[c]}
            for c in nbrs:
                if c >= 0 and is_del[c]:
                    cand.update(int(x) for x in graph[c]
                                if x >= 0 and not is_del[x] and x != node)
            cand.discard(node)
            cids = sorted(cand)
            if not cids:
                graph[node, :] = -1
                continue
            cvecs = vec_of(cids)
            dists = ((cvecs - vec_of([node])[0]) ** 2).sum(axis=1)
            kept: list = []
            for oi in np.argsort(dists, kind="stable"):
                if len(kept) >= m0:
                    break
                if kept and (((cvecs[kept] - cvecs[oi]) ** 2).sum(axis=1)
                             * ALPHA < dists[oi]).any():
                    continue
                kept.append(oi)
            graph[node, :len(kept)] = [cids[oi] for oi in kept]
            graph[node, len(kept):] = -1
        graph[dels, :] = -1

        if is_del[self.entry]:
            live = np.nonzero(~self._deleted_local[:self.n_rows])[0]
            if len(live):
                ev = vec_of([self.entry])[0]
                sub = live[np.random.default_rng(0).permutation(
                    len(live))[:4096]]
                self.entry = int(sub[np.argmin(
                    ((vec_of(sub) - ev) ** 2).sum(axis=1))])
            else:
                self.entry = 0
        return affected

    def graph_state(self) -> dict:
        """The graph to persist or hand over: neighbours and entry."""
        return {"neighbors": self._hgraph[:self.n_rows],
                "entry": np.asarray([self.entry], dtype=np.int32)}

    def _sampled_entries(self, q: np.ndarray, sample: int = 1024,
                         seed: int = 0) -> np.ndarray:
        """Per-query entry: the nearest node of a fixed random sample of
        the live nodes by the metric's score, from one matmul a chunk of
        256 queries (l1: the sum of |x - q|), the reference's stand-in for
        the upper layers. A logical index reads the sample's rows from the
        arena, a physical one from its copy (the table rows are the ids,
        the reference's :908-909)."""
        chunk = 256
        dev = self._graph.device
        if self._entry_sample is None:
            rng = np.random.default_rng(seed)
            pool = np.arange(self.n_rows, dtype=np.int32)
            pool = pool[~self._deleted_local[:self.n_rows]]
            ids = np.sort(pool if len(pool) <= sample else
                          rng.choice(pool, sample, replace=False)
                          .astype(np.int32))
            trows = self._hrmap[ids] if self.logical else ids
            self._entry_sample = (ids, torch.from_numpy(
                np.ascontiguousarray(trows)).to(dev).long())
        ids, trows = self._entry_sample
        vectors, norms, _, _ = self._tables()
        if isinstance(vectors, PackedCopy):
            x, nrm, _ = vectors.gather(trows)
        else:
            x = vectors[trows].float()                            # (S, d)
            nrm = norms[trows]
        qt = torch.from_numpy(np.ascontiguousarray(q)).to(dev)
        if self.metric == "cosine":
            qt = qt / torch.clamp_min(
                torch.linalg.vector_norm(qt, dim=1, keepdim=True), 1e-30)
        best = []
        with exact_f32_matmul():
            for s in range(0, len(qt), chunk):
                qc = qt[s:s + chunk]
                if self.metric == "l1":
                    sc = (x[None, :, :] - qc[:, None, :]).abs().sum(-1)
                elif self.metric == "l2":
                    sc = nrm[None, :] - 2.0 * (qc @ x.T)
                else:
                    sc = -(qc @ x.T)
                best.append(sc.argmin(dim=1))
        return ids[torch.cat(best).cpu().numpy()]

    def search(self, queries: np.ndarray, query_masks: np.ndarray, k: int,
               **kwargs) -> Tuple[np.ndarray, np.ndarray]:
        """(dists (Q, k), arena row ids (Q, k)): search_deferred's pass,
        finalized."""
        return self.search_deferred(queries, query_masks, k, **kwargs)()

    def search_deferred(self, queries: np.ndarray, query_masks: np.ndarray,
                        k: int, ef_search: Optional[int] = None,
                        filtered_traversal: bool = False,
                        iterative: bool = False,
                        entries: Optional[np.ndarray] = None,
                        entry_local: Optional[int] = None,
                        max_steps: Optional[int] = None,
                        harvest_2hop: bool = False,
                        sampled_entry: bool = False):
        """The reference's search, its batches enqueued without a read-back
        (the iterative rescan reads its done test every few steps); returns
        finalize() -> (dists (Q, k) float32, arena row ids (Q, k) int64).
        The fixed-budget beam, or the iterative rescan (iterative=True, or
        sampled_entry) from per-query entries, entry_local or the graph's
        entry, or (filtered_traversal, without the iterative rescan) the
        ACORN two-hop harvest over the fixed beam; a small k + 8 margin is
        fetched and deduplicated on the host. The queries and masks go to
        the device once; a batch is a slice of them (a query's results do
        not depend on its batch). A physical index searches its copy with
        no row map; the row map translates the local ids at the end."""
        dev = self._graph.device
        ef = max(ef_search or self.ef_search, k + 1)
        q = np.asarray(queries, dtype=np.float32)
        nq = q.shape[0]
        if sampled_entry:
            iterative = True
            if entries is None:
                entries = self._sampled_entries(q)
        kk = min(k + 8, ef)
        a = self._arena
        vectors, norms, bits, row_map = self._tables()
        q_t = torch.from_numpy(np.ascontiguousarray(q)).to(dev)
        m_t = _bits_i32(query_masks, dev)
        if iterative:
            ent = np.full(nq, self.entry if entry_local is None
                          else int(entry_local), np.int32)
            if entries is not None:
                ent[:] = np.asarray(entries, dtype=np.int32)
            ent_t = torch.from_numpy(ent).to(dev)
            packed_rows = None
            if self.use_packed:
                if self.logical:
                    if self._packed is None:
                        self._packed = build_packed_graph_rows(a)
                    packed_rows = self._packed
                else:
                    packed_rows = self._table
                    vectors = norms = bits = None
                dqs, qcd = packed_query_operands(a, q)
                qcd_t = torch.from_numpy(qcd).to(dev)
        bs = min(self.query_batch,
                 max(64, 1 << (max(nq, 1) - 1).bit_length()))
        pending = []
        for s in range(0, nq, bs):
            e = min(s + bs, nq)
            if iterative:
                packed_kw = {} if packed_rows is None else dict(
                    packed_rows=packed_rows, dq_scale=float(dqs),
                    q_center_dot=qcd_t[s:e])
                d, i = graph_beam_search_iterative(
                    q_t[s:e], vectors, norms, bits, self._graph,
                    m_t[s:e], ent_t[s:e], kk, ef, max_steps or 4 * ef,
                    harvest_2hop, row_map=row_map, metric=self.metric,
                    **packed_kw)
            else:
                fn = (graph_beam_search_filtered if filtered_traversal
                      else graph_beam_search)
                d, i = fn(q_t[s:e], vectors, norms, bits, self._graph,
                          m_t[s:e], self.entry, kk, ef, row_map=row_map,
                          metric=self.metric)
            pending.append((s, e, d, i))

        def finalize():
            out_d = np.empty((nq, k), dtype=np.float32)
            out_i = np.empty((nq, k), dtype=np.int64)
            for s, e, d, i in pending:
                d = d.cpu().numpy().astype(np.float64)
                i = i.cpu().numpy().astype(np.int64)
                i = np.where(i >= 0, self._hrmap[np.maximum(i, 0)], -1)
                out_d[s:e], out_i[s:e] = merge_topk_host([d], [i], k)
            return out_d, out_i
        return finalize

    def storage_bytes(self) -> Dict[str, int]:
        """The index's own device bytes: a logical index's graph and row
        map ("index"); a physical index's copy ("vectors": the packed
        table whole, or the unpacked rows) beside its graph and row map,
        and the unpacked copy's norms and bitsets ("index"), the
        reference's accounting (:1053-1066)."""
        npad, m0 = self._graph.shape
        index = npad * (m0 * 4 + 4)
        if self.logical:
            return {"vectors": 0, "index": int(index)}
        if self._table is not None:
            return {"vectors": int(self._table.numel()), "index": int(index)}
        nb = lambda t: t.numel() * t.element_size()
        return {"vectors": int(nb(self._vectors)),
                "index": int(index + nb(self._norms) + nb(self._bits))}
