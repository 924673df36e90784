#!/usr/bin/env python3
"""Smoke run of the GPU port (vectorsearch_rbac_tpu_torch) on one CUDA card.

    python3 chip_smoke.py

Run from the root of a checkout, on a machine with an NVIDIA H100 and the
CUDA toolkit. It needs no arguments and no network, and it exits non-zero
without a CUDA device or without the port's package beside it. Phases:

1. the card's name and power limit, and the torch / CUDA versions;
2. the kernel build (one nvcc per csrc/*.cu, all at once, then a link into
   build/kernels/), timed, with ptxas's register report;
3. the narrow scan and the merge kernels against their plain PyTorch
   versions at the SIFT path's geometry (a 2048-query batch against the
   1M-row arena, group 128, k 100): the scan must be bit-identical; the
   extraction must give identical values and identical positions on the
   non-empty slots, the bitonic sort identical values and metas in every
   row (fed the same survivors), beside its bound and torch.topk's time
   over the minima. Times come from CUDA events around launches queued
   behind a spin on the card (a wrapper's host dispatch is not timed).
   Beside the scan, its yardsticks: the wide scan (K2) launched on the
   same d_pad-128 operands
   (bit-identical to the same plain minima), a dots-only torch._int_mm
   over the same operands in 8 row chunks (not the scan's function, so not
   its library_ms), the first port's dp4a scan (the lab control of 3e),
   and the epilogue's integer-operation floor: its operations a pair,
   counted by hand from the kernel's source, times the pairs, over the
   card's INT32 issue rate;
3c. the narrow scan's admit-dedup slot form against its plain version at
   the same geometry with group 32: a 2048-query batch whose 100 distinct
   masks fill 128 slots of 16, in the contiguous layout the index uses and
   the interleaved one of the TPU kernel, bit-identical; beside them the
   per-query form's time on the same masks, and the slot form's epilogue
   floor over the admitted pairs;
3e. the kernel lab's path (bench/lab.py's entry points) on phase 3's
   operands: the first port's dp4a scan, and three forms of the narrow
   scan's tensor-core kernel: trim (the narrow scan's own per-query form),
   its control the chain (the reference's literal epilogue) and the floor
   probe, timed in turns beside the narrow scan on the same operands (the
   fold's saving, chain - trim, and the share of the scan's time that its
   epilogue takes), extract_merge and extract_merge_v2 on phase 3's 2048 x
   8192-group minima, the y-form extraction (sub 128, t 8 and 16) and
   both y-form sorts (keep 128), with
   the counts set to 0 just before and read just after; then each of these
   kernels against its plain version, bit-identical, beside its bound and
   torch.topk's time on each merge kernel's own input (and over the whole
   minima, the y-form merge's yardstick), the y-form sorts also beside the
   bitonic sort (K4) on the same survivors with their gids as metas; its
   wide half (K2's slot form,
   100 masks in slots of 16, both layouts, on phase 3b's operands) runs
   after phase 3b;
3d. the graph step's two kernels against their plain versions at the
   hybrid path's geometry: 4096 queries (the graph batcher's chunk) with
   M0 32 candidates each, mapped through a 40 x 65,536 row-map slab onto
   the 1M arena's packed rows (scores bit-identical on the SIFT-like
   queries, in the l2 and the inner-product form, timed side by side),
   and the step's merges at ef 64, kk 18 (bit-identical); beside
   the score kernel, index_select's time for the same row gather, printed
   as a gather-only yardstick (the kernel also scores the rows, so it is
   not the kernel's library_ms), and the score kernel on the same
   candidates at W 40 (36 sparse random words appended to the rows and
   masks) and at d_pad 1152 (1,024 random code columns appended), each
   bit-identical to its plain version; its search half runs after 4d, on 4d's
   slab: a 4096-query chunk of the cell (the recorded graph chunks' real
   queries with their slots, entries and step budgets) through the fused
   graph search and its plain loop, bit-equal, beside the step loop on the
   same inputs (KS7 + KS6 + the PyTorch dedup: a yardstick, since no one
   PyTorch call computes a graph search) and the bound from the kernel's
   expansion count, then the same chunk at W 40 through the fused search
   and its plain loop, bit-equal; then the harvest leg, the same chunk with the 2-hop
   harvest (the step loop: KS7 and KS6 launch, the fused search not),
   bit-equal to its plain loop, with its own launch counts;
4. the SIFT path at full size: a 1M x 128 SIFT-like corpus (seed 0) with
   bench.py's tree RBAC world (100 roles, 10k users), 8192 queries drawn
   from the corpus's held-out pool as bench.py draws them, top-100, L2,
   through build_searcher("rls") and run_benchmark against the exact
   float32 oracle; then admit-dedup on and off in turns on that path
   (pass walls, identical results); then one pass each on the mask-row
   wire, and on the uid wire (the path's own) with the ids, f32, bf16 and
   u8 result wires: the same ids, the distances within each wire's
   precision of the f32 wire's;
4e. a wider world on the same corpus: the tree generator's world with 300
   roles (10k users, 10 bitset words). The narrow scan and its slot form
   at W 10 (and at W 32: the same bitsets with zero words appended)
   against their plain versions on a 2048-query batch, bit-identical, and
   timed in turns beside both at W 4 (phase 3's operands), with both on
   random bitsets at W 32, 64 and 128 (past 32 words: the huge forms),
   bit-identical to their plain versions; then 8192
   queries, top-100, through build_searcher("rls") with admit-dedup on and
   run_benchmark against the exact float32 oracle: recall, readable rows,
   and the slot form launched;
4c. the partitioned strategies on the same corpus and arena: ROLE, USER,
   AnonySys (dynamic, storage alpha 2.0, the port's own planner) and
   QDTree (built from the 4096 queries as the reference's strategy compare
   builds it: min_leaf 64, max_depth 16, radius scale 0.3; its leaves and
   their tiers printed, and where a leaf takes the big tier the slot form,
   the extraction and the bitonic sort must launch), each
   over the first 4096 queries, top-10, batch 1024, against the exact
   top-10 oracle, with recall, QPS, batch-1 latency, partitions, storage,
   build time and the device time of the chunk engine against the big
   tier from one traced pass; over the phase the narrow scan, its slot
   form and the merge kernels must have launched, and admit-dedup must
   have grouped a big-tier pass; then admit-dedup on and off in turns on
   the AnonySys path;
4d. the hybrid AnonySys executor on the same corpus and arena, on 4c's
   plan (alpha 2.0): HNSW graphs on the partitions whose combs keep
   selectivity >= 0.5, the int8 scan on the remainder, over the first 4096
   queries, top-10, batch 1024, against the exact top-10 oracle, with
   recall, QPS, batch-1 latency, graph and flat partitions, the graph
   build seconds by builder, storage (the graph batcher's slabs and packed
   rows included), and the device time of the graph search against the
   flat remainder from one traced pass; the fused graph search, the narrow
   scan and the merge kernels must all have launched, and the graph step's
   kernels (the step loop's) not; the same pass on the
   graph search's plain loop must give the same ids and distances;
4g. the IVF path on the same corpus and arena: build_searcher("rls") with
   index kind ivf (nlist 1024, nprobe 16: k-means on a 200,000-row
   sample, the padded lists gathered on the card) over the 8192 queries,
   top-100, against the exact oracle: recall at nprobe 16 (with QPS and
   batch-1 latency) and at 64, l_pad, fill and build seconds; full probe
   on the first 256 queries must reach recall 0.99, and after the
   iterative scan no query may be short whose user can read 100 rows.
   These two hold the path to its reference. Recall at nprobe 16 is
   printed and not held to 0.95: only to a regression floor of 0.5,
   which was set under its first measured value (0.573 on an H100) after
   that run;
4i. HNSW everywhere (after 4g; (c) after 4b, (d) in 4h): (a) rls over
   one HNSW graph of the whole SIFT arena (index kind hnsw: the "tpu"
   builder, M 16, through the IVF-assisted kNN: its build seconds, its
   kNN recall against the exact kNN on 1,024 sampled rows; every row has
   32 distinct neighbours other than itself; a row misses its own list
   exactly when the reference's placement put it in a list outside its
   6 probed ones, every other row lists itself first, and a row that no
   kNN list holds has an edge into it in the graph), 8192 queries,
   top-100, served
   three ways: the fixed-budget beam (through run_benchmark, as bench
   --index hnsw), the ACORN filtered traversal and the sampled entries
   (the fused search, l2; one 4096-query chunk equal to the plain loop);
   (b) an int8 ip arena of the same corpus (lossless: packed rows), a
   graph on the MIPS lift over its first 262,144 rows, the sampled
   entries through the fused search's ip form (launched; a chunk equal to
   the plain loop, timed beside it), then the same chunk with the 2-hop
   harvest (KS6 and KS7's ip form launched, equal to its plain loop);
   (c) cosine on the first 131,072 rows of the 768-d arena and (d) l1 on
   the first 131,072 rows of 4h(b)'s synthetic arena (the exact device
   kNN), each the fixed beam and the sampled entries (the unpacked step
   loop: KS6 launched); (e) on a 131,072-row SIFT-like corpus under the
   100-role world, ROLE, USER and QDTree over HNSW through run_benchmark
   (top-10, 1,024 queries), and the ACORN builder (m 16, m_beta 64)
   beside the classic one over 65,536 rows (built in threads beside
   (a)-(b), so their build times, and (a)'s, are concurrent): layer-0
   lists 64 wide and over 1.5x the classic build's
   edges, the filtered traversal's recall and the unfiltered top-1 found
   printed beside the reference contract's floors. Each leg's recall
   (against the exact oracle of its rows and metric), build seconds and
   QPS print beside the prediction written before the phase first ran
   (HNSW_PREDICTED); every returned row must be readable, and the first
   16 queries' distances equal a float64 numpy recomputation within
   1e-3 relative;
4j. online maintenance (after 4i(e), while the SIFT corpus is alive): (d)
   first, on 4c's corpus, world and plan: one role inserted by the reference
   CLI's sampling rule (1/num_roles of each role's documents, granted to
   1% of the users, seed 0; insert_role with every comb holding it), the
   int8 arena rebuilt for the new world, the old plan materialized on it
   and apply_plan_update'd (the TiledSearcher rebuilt whole), a
   4,096-query top-10 pass whose every fourth user holds the new role
   (every returned row readable under the new world, recall@10 against
   the exact oracle >= 0.95, the narrow scan and the merge kernels
   launched where a partition takes the big tier), then delete_role of
   the role with the most orphaned documents, its orphaned rows
   tombstoned, and an rls Int8FlatIndex pass over the tombstoned arena
   with that role's users' old masks on queries at the orphaned rows: no
   orphaned row comes back (the same pass before the tombstone returns
   some), and the narrow scan and the merge kernels launch; then
   bench.online's cell at its size (scripts/online_insert_scale.py:
   sift_like_corpus 300,000 x 128, 30 roles, 512 queries with
   full-access masks, top-10): (a) on a float32 arena, a "tpu" HNSW graph
   (m 16, ef 64) over rows [0, 200,000), one insert_rows of the other
   100,000 and refine_rows of them, the sampled-entry search (the
   unpacked step loop: KS6 launched) before, after and after refine, and
   IVF (nlist 512, nprobe 48) on the same split; seconds, rows/s and
   recalls printed beside the reference's TPU record
   (results/online_insert_scale.json) and the predictions written before
   the phase first ran (ONLINE_PREDICTED), not held; (b) the refined
   graph carried to a lossless int8 arena of the same corpus, its
   sampled-entry search through the fused kernel (launched), one
   4,096-query chunk of it bit-equal to its plain loop; (c) 1,000 random
   inserted rows tombstoned and deleted from both graphs (the repair
   timed, its nodes counted) and from IVF, then each searched: no deleted
   row returned, every returned row live in the tombstoned arena, recall
   against the exact oracle over the remaining rows printed, and the
   fused chunk check again on the repaired graph (-1 row-map entries);
4k. snapshots and the CLI (after 4j, while 4c's corpus, world, arena and
   plan are alive): (a) 4c's arena saved (utils.persist) and restored in
   the process, every tensor and host mirror equal; 4c's ROLE and AnonySys
   TiledSearchers (AnonySys on 4c's plan, whose big tier runs the kernels)
   saved in the light and the packed form and restored over the restored
   arena, each restored engine's ids and distances on 4c's 4,096 queries
   bit-equal to the live engine's and every row readable; an rls searcher
   over the restored arena with the live arena's ids digest on the 8,192
   queries; K1, S2, K3 and K4 launched on the restored state; (b) the CLI
   end to end (cli.main, --device cuda) in a temporary directory at
   200,000 SIFT-like rows: prepare, generate-queries, plan-dynamic (alpha
   2.0), compute-ground-truth, test RLS and AnonySys on the int8 arena
   (recall@10 >= 0.95 against the exact oracle, every returned row
   readable), serve for 3 s at 16 clients, insert-role, delete-role of a
   role that orphans documents, rollback, fit-params --index ivf over
   three nprobes; then 256 requests through the BatchingServer, ids and
   distances equal to search_batch's on the same requests; K1, K3 and K4
   launched by the CLI's passes;
4l. multi-device serving (after 4k, while 4c's corpus, world, arena and
   plan and 4d's hybrid searcher are alive) on a mesh of 4 shards that
   all sit on cuda:0 (no collective crosses a card; no scale-out is
   measured): (a) ShardedGlobalSearcher's int8 flagship over the SIFT
   corpus, 4 x 262,144 rows at group 32, the 8,192 queries, top-100:
   recall >= 0.95 against the exact oracle beside the same searcher on
   one device (1,015,808 padded rows at group 64), every row readable, K1, K3 and K4 launched, and
   on every shard K1 and the merge kernels bit-identical to their plain
   versions on the shard's own operands (all 8,192 queries); (b)
   the sharded float scan over the arena's bfloat16 mirror (exact on the
   integer rows) against the one-device scan, distances within rtol
   1e-5; (c) one sharded k-means step over the 1M rows, C 1,024, against
   the one-device step, centroids within 1e-4; (d) ShardedTiledSearcher
   on 4c's AnonySys plan against the one-device TiledSearcher, both with
   the exact epilogue and no big tier, distances within 1e-5 on 4c's
   4,096 queries; (e) ShardedGraphSearcher in place of 4d's
   GraphProbeBatcher in 4d's searcher: ids equal job for job and the
   searcher's ids and distances equal, the fused graph search launched;
   (f) two processes on the card over gloo, each ingesting half of the
   first 262,144 rows through multihost_quant_arena and serving 2,048
   queries with the candidates all-gathered: both ranks' ids and
   distances equal the in-process 2-shard mesh's (the parent built the
   kernels before it spawned). Each QPS prints beside one device's and
   beside the prediction written before the phase first ran
   (MULTI_PREDICTED);
4h. the flat family, binary and sparse (no CUDA kernel: PyTorch, as the
   reference leaves these scans to XLA): (a) on the SIFT corpus, rls
   through FlatIndex in approx mode (the augmented layout) and exact, on
   a bfloat16 and a float32 arena, 8192 queries, top-100, recall >= 0.95
   against the exact float32 oracle, readable rows, pass walls and QPS,
   and the augmented and plain score forms timed in turns on the same
   arena and queries; (c) the binary index (median sign bits, hamming,
   rerank multiplier 4) on the float32 arena, its recall printed (not
   held), its scan without rerank (hamming and jaccard) equal to a numpy
   recomputation on 16 queries from the arena's rows and their medians
   (distances equal, ids up to ties); (b) the
   synthetic corpus (1M x 128 float32) on an l1 arena: rls flat exact
   over 1,024 queries, top-100, equal to a float64 recomputation on the
   card on 16 queries (rtol 1e-5, ids up to ties), and ROLE through the
   PackedSearcher equal to ROLE's packed=False layout (a FlatIndex a
   partition) on every query; (d) the sparse corpus (250,000 documents x
   4 blocks, dim 4096, nnz 16-48) under a tree world over its documents,
   1,024 sparse queries, top-100, l2 and ip, equal to a dense float32
   recomputation on 16 queries whose rows are densified from the corpus's
   own CSR (not the index's padded arrays or norms). The sparse corpus is drawn in a spawned
   worker process while (a)-(c) run;
4m. the evidence runners' cells at a cut size (after 4h, each on its own
   data: bench.graph_crossover, bench.ivf_coverage, bench.binary_1m and
   bench.model_validation, the port's runners for the scripts whose
   records the planner rests on), at 65,536 rows: (a) the crossover at d
   128, selectivity 0.036 and 1.0, 1,024 queries, the flat leg (K1, K3,
   K4) and the graph ladder at ef 40 and 80 (the fused search) with the
   harvest legs at 0.036 (KS6, KS7); (b) IVF coverage over selectivities
   0.05 and 0.25 x nprobe 4, 8, 16, 32; (c) the binary index's 768-d
   cosine leg at rerank multiplier 2, 2,048 queries (512 graded); (d)
   model validation over sizes 8,192 and 16,384 x selectivities 0.1 and
   1.0 x ef 16, 32, 64, both cost families fitted. Every returned row must be readable by its user
   (the runners raise otherwise; nothing catches it), every record must
   carry its script's keys, and K1, K3, K4, the fused search, KS6 and KS7
   must have launched in the phase;
3b. the wide scan against its plain version at the 768-d path's geometry
   (a 2048-query batch against the 1,048,576-row cosine arena, ip kernel
   metric, score shift 3, group 128), bit-identical, beside a dots-only
   yardstick (torch._int_mm over the same operands in 8 row chunks: the
   int32 dots alone, written out), the wide scan's W 10, 32, 64 and 128 forms on
   the same bitsets with zero words appended (the same minima), timed in
   turns beside it, then the merge kernels on its minima at kk = 100 + 32
   (keep 136);
4b. the 768-d path at full size: the cohere-like 1M x 768 corpus (seed 0),
   the same world, 8192 queries, top-100, cosine, residual4 rerank,
   through build_searcher("rls") and run_benchmark against the exact
   cosine oracle, and the wire passes of phase 4;
4f. ROLE, USER, AnonySys (4c's plan at alpha 2.0: the same world) and
   QDTree (built from the first 1,024 queries, on unit vectors) on the
   same cosine arena through the PackedSearcher, each over the first 4096
   queries, top-100, batch 1024, against the exact cosine oracle: recall
   (>= 0.95), QPS, batch-1 p50/p95/p99, partitions, the buckets (P,
   L_pad), storage, build seconds and one traced pass's packed.route,
   packed.scan and packed.merge host and device times; every returned row
   readable. No CUDA kernel of the port is on this path (the slot scan is
   PyTorch), so it adds no launches.
On each path but 4g's nprobe-16 pass and 4i's graphs (a post-filtered
graph's recall is the paper's point: printed, not held) recall must
reach 0.95; on each
path every returned row must be readable by its user, and each kernel of
the path must have launched while it ran
(the counts are set to 0 just before it; "scan_int8" counts every launch
of the narrow scan, "scan_int8_slots" those of its slot form). Each path
prints short content hashes of its workload (query vectors and user ids)
and of its ground truth, so that a change of recall can be traced to the
input that moved.

Neither jax nor the JAX package (vectorsearch_rbac_tpu) is imported; the
run fails if either was loaded.

Its last lines are one JSON object of per-kernel results, the card's
nvidia-smi line, and {"ok": true, "device": {...}}. Each kernel's entry
has its launches on the paths (each path's counts, read just after it),
its time and its plain version's, the least time the card could take for
the same work (`bound_ms`: the larger of the bytes it must move over the
HBM rate and its operations over the peak rate for their type, from the
H100 SXM data sheet, computed from this run's inputs), which of the two
bounds it, and the time of one PyTorch call computing the same function
where there is one (`library_ms`, else null; the port never calls it).
"""

import concurrent.futures
import copy
import gc
import hashlib
import json
import os
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
N_ROWS = 1_000_000
N_QUERIES = 8192
TOPK = 100
BATCH = 2048          # the main path's query batch
BLOCK_ROWS = 131072   # bench.py's default arena padding
RECALL_FLOOR = 0.95
GROUP = 128           # the group width both paths' indexes pick at 1M
RERANK_MARGIN = 32    # kk = TOPK + 32 on the 768-d path
SLOT_SB = 16          # admit-dedup slot width (index/flat_int8.py MASK_SB)
SLOT_GROUP = 32       # the big tier's group width (phase 3c's geometry)
PART_QUERIES = 4096   # the strategy compare's workload (4c)
PART_TOPK = 10
PART_ALPHA = 2.0      # AnonySys storage budget (scripts/strategy_compare_1m)
GRAPH_Q = 4096        # the graph batcher's query chunk (phase 3d)
GRAPH_M0 = 32         # 2 * hnsw_m: candidates of one graph step
GRAPH_EF = 64         # the hybrid probes' ef (pow2 of max(40, 2 * 10))
GRAPH_KK = 18         # top-10 + the 8-row dedupe margin
GRAPH_SLAB = (40, 65536)   # graph partitions x padded rows at 1M, alpha 2
WIDE_ROLES = 300      # phase 4e's tree world: 10 bitset words
HUGE_WORDS = (32, 64, 128)  # phase 4e's random bitsets: 1,024-4,096 roles
GRAPH_WIDE_W = 40     # phase 3d's graph rows past 1,024 roles
GRAPH_WIDE_D = 1152   # and past the register form's d_pad 1024
# QDTree in 4c: the reference's strategy compare's build
# (scripts/strategy_compare_1m.py:69, build_qdtree_searcher's defaults)
QD_MIN_LEAF, QD_MAX_DEPTH, QD_RADIUS_SCALE = 64, 16, 0.3
PACKED_TREE_QUERIES = 1024   # 4f's QDTree is built from the first 1,024
IVF_NLIST, IVF_NPROBE = 1024, 16   # 4g: the config's IVF defaults
IVF_WIDE_PROBE = 64          # 4g's second recall
IVF_FULL_QUERIES = 256       # 4g's full-probe check
KNN_K = 32                   # the "tpu" builder's knn_k
KNN_NPROBE = 6               # the IVF-assisted kNN's probed lists a row
KNN_SAMPLE = 1024            # rows whose kNN lists are held to the exact
HNSW_CHUNK = 4096            # 4i: HNSWIndex's query batch (a search chunk)
HNSW_IP_ROWS = 262_144       # 4i(b): the ip graph's rows (a cut)
HNSW_CUT_ROWS = 131_072      # 4i(c), (d) and (e)'s rows (cuts)
HNSW_ACORN_ROWS = 65_536     # 4i(e)'s ACORN graph
HNSW_PART_QUERIES = 1024     # 4i(e)'s workload
HNSW_ACORN_EF = 48           # 4i(e)'s ACORN legs search at the ef of the
                             # reference's contract (tests/test_hnsw.py:222)
HNSW_DIST_RTOL = 1e-3        # 4i's distances against float64 numpy
# phase 4i's predictions, written before its first run on the card
HNSW_PREDICTED = {
    "4i(a) build s": 150.0, "4i(a) fixed": 0.30, "4i(a) fixed QPS": 40000.0,
    "4i(a) filtered": 0.60, "4i(a) sampled": 0.55,
    "4i(b) build s": 35.0, "4i(b) sampled": 0.60,
    "4i(c) cosine build s": 40.0, "4i(c) cosine fixed": 0.40,
    "4i(c) cosine sampled": 0.60,
    "4i(d) l1 build s": 25.0, "4i(d) l1 fixed": 0.20,
    "4i(d) l1 sampled": 0.30,
    "4i(e) role build s": 15.0, "4i(e) role": 0.90,
    "4i(e) user build s": 15.0, "4i(e) user": 0.95,
    "4i(e) qdtree build s": 15.0, "4i(e) qdtree": 0.70,
    "4i(e) acorn filtered": 0.80, "4i(a)-(b) s": 260.0,
}
ONLINE_DELETE = 1000         # 4j(c): inserted rows deleted
ONLINE_CHUNK_SEED = 2        # 4j(b): the fused check's 4,096-query chunk
# phase 4j's predictions, written before its first run on the card
ONLINE_PREDICTED = {
    "hnsw build_s": 7.0, "hnsw insert_s": 38.0, "hnsw refine_s": 32.0,
    "hnsw recall_before": 0.8984, "hnsw recall_after": 0.8307,
    "hnsw recall_inserted_region": 0.75,
    "hnsw recall_after_refine": 0.9549,
    "hnsw recall_inserted_region_after_refine": 0.9498,
    "ivf build_s": 3.0, "ivf insert_s": 6.0, "ivf recall_before": 1.0,
    "ivf recall_after": 1.0, "ivf recall_inserted_region": 1.0,
    "4j(b) recall": 0.9549, "4j(b) fused chunk ms": 3.0,
    "4j(c) delete_s": 12.0, "4j(c) repaired_nodes": 20000,
    "4j(c) recall": 0.95, "4j(d) arena_s": 8.0, "4j(d) old_plan_s": 9.0,
    "4j(d) apply_plan_update_s": 9.0, "4j(d) recall": 0.99,
    "4j(d) s": 45.0, "4j s": 200.0,
}
MESH_SHARDS = 4              # 4l: the mesh's shards, every one on cuda:0
MESH_GROUP = 32              # 4l(a): the group a 262,144-row shard takes
MULTI_BLOCK = 16384          # 4l(b): the float scan's row block
KMEANS_C = 1024              # 4l(c): clusters of the k-means step
MULTI_ROWS = 262_144         # 4l(f): the process axis's rows (a cut)
MULTI_QUERIES = 2048         # 4l(f)'s queries
MULTI_GROUP = 16             # 4l(f): the group a 131,072-row shard takes
MULTI_DEADLINE_S = 120.0     # 4l(f): the two processes' whole run
# phase 4l's predictions, written before its first run on the card
MULTI_PREDICTED = {
    "a recall": 0.998, "a one recall": 0.9938, "a QPS": 230000.0,
    "a one QPS": 330000.0, "b QPS": 18000.0, "b one QPS": 20000.0,
    "c ms": 40.0, "c one ms": 30.0, "d QPS": 12000.0, "d one QPS": 14000.0,
    "e QPS": 150000.0, "e one QPS": 160000.0, "f s": 25.0, "4l s": 80.0,
}
EVIDENCE_ROWS = 65_536       # 4m: the cut the four runners' cells run at
EVIDENCE_QUERIES = 1024      # 4m: the crossover's queries (its harvest legs
                             # take the step loop) and the binary leg's graded
EVIDENCE_MV_SIZES = (8_192, 16_384)    # 4m: model validation's index sizes
EVIDENCE_MV_EFS = (16, 32, 64)         # and its efs (the fixed beam's loop)
# phase 4m's prediction, written before its first run on the card
EVIDENCE_PREDICTED = {"4m s": 35.0}
# the second run's, written after the first (49.9 s at 4,096 crossover
# queries, 8,192 binary queries, sizes 16,384 and 32,768, ef up to 256)
EVIDENCE_PREDICTED_CUT = {"4m s": 22.0}
L1_QUERIES = 1024            # 4h(b)'s l1 workload
CHECK_QUERIES = 16           # 4h's numpy and dense recomputations
SPARSE_DOCS, SPARSE_BLOCKS = 250_000, 4   # 4h(d): 1M sparse rows
SPARSE_QUERIES = 1024
# H100 SXM peaks (NVIDIA's data sheet, at 700 W): HBM bytes/s, dense int8
# tensor-core ops/s, float32 ops/s outside the tensor cores
HBM_BYTES_S = 3.35e12
INT8_OPS_S = 1.979e15
F32_OPS_S = 67e12
# 32-bit integer operations a second on the CUDA cores: 64 an SM a clock
# (the CUDA C++ programming guide's throughput table, compute capability
# 9.0) x 132 SMs x the 1,980 MHz boost clock (the data sheet)
INT32_OPS_S = 64 * 132 * 1.98e9
# K1's epilogue, integer operations a (query, row) pair, by hand from
# csrc/scan_int8.cu at score shift 0: per-query masks W AND/ORs (the admit
# test), one multiply-add (score and pack) and one predicated minimum; the
# warp-slot path one multiply-add and one minimum on an admitted pair
K1_EPI_OPS = lambda w: w + 2
S2_EPI_OPS = 2
# the chain (trim's control): K1's with the shift and the shift-or of the
# pack after the multiply-add, two more a pair
CHAIN_EPI_OPS = lambda w: w + 4


def fail(msg: str) -> None:
    print(f"FAIL: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def say(msg: str) -> None:
    print(msg, flush=True)


def cuda_ms(fn, reps: int) -> float:
    """Mean device time of fn() over reps launches, after one warm-up. The
    launches queue up behind a spin of about 50 us a launch on the card,
    so the events time them back to back: a wrapper's host dispatch (~15-25
    us of Python and ctypes) would otherwise be the time of a kernel that
    runs for less."""
    import torch

    fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    torch.cuda._sleep(reps * 100_000)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def dots_only(q8, x8, chunks: int = 8) -> None:
    """The scans' dots alone: torch._int_mm of the int8 queries and rows in
    row chunks, int32 dots out (a yardstick: no epilogue)."""
    import torch

    step = x8.shape[0] // chunks
    for r0 in range(0, x8.shape[0], step):
        torch._int_mm(q8, x8[r0:r0 + step].t())


def max_abs_err(a, b) -> int:
    return int((a.long() - b.long()).abs().max().item())


def bound_ms(nbytes: float, ops: float, peak_ops: float):
    """(least ms, "bytes" or "operations"): the larger of the bytes over
    the HBM rate and the operations over their peak rate."""
    t_bytes = nbytes / HBM_BYTES_S * 1e3
    t_ops = ops / peak_ops * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def nbytes(*tensors) -> int:
    """Bytes of the distinct tensors: one passed twice is read once."""
    distinct = {id(t): t for t in tensors}.values()
    return sum(t.numel() * t.element_size() for t in distinct)


def scan_bound(q8, x8, norms, bits, qbits, out, admitted_pairs=None):
    """K1/K2's bound: every input read once, the minima written once, and
    2 * d_pad int8 operations for each (query, row) pair whose dots the
    function needs (all pairs, or the admitted ones for the slot form)."""
    pairs = (q8.shape[0] * x8.shape[0] if admitted_pairs is None
             else admitted_pairs)
    return bound_ms(nbytes(q8, x8, norms, bits, qbits, out),
                    2.0 * x8.shape[1] * pairs, INT8_OPS_S)


def digest(*arrays) -> str:
    """Short content hash of numpy arrays (dtype, shape and bytes)."""
    import numpy as np

    h = hashlib.blake2b(digest_size=8)
    for a in arrays:
        a = np.ascontiguousarray(a)
        h.update(f"{a.dtype}{a.shape}".encode())
        h.update(a.tobytes())
    return h.hexdigest()


def report(title, rows) -> None:
    """Print kernel-vs-plain rows and fail on any disagreement."""
    say(title)
    for name, (ok, err, ms, plain_ms) in rows.items():
        say(f"  {name:14s} identical={ok} max_abs_err={err} kernel "
            f"{ms:.3f} ms, plain {plain_ms:.3f} ms")
    bad = [name for name, row in rows.items() if not row[0]]
    if bad:
        fail(f"kernels disagree with their plain versions: {bad}")


def check_merge(packed, k, nsub=32, t=16):
    """The merge kernels against their plain versions on packed minima:
    (ok, max_abs_err, kernel ms, plain ms) per stage, the keep width, and
    per stage (bound ms, bound_by, library ms): torch.topk over the minima,
    the one call that computes the pair's function."""
    import torch

    from vectorsearch_rbac_tpu_torch.ops import merge, scan_int8

    keep = 8 * ((k + 7) // 8)
    y, meta = merge.extract_pairs(packed, nsub, t)
    y_plain, meta_plain = merge.extract_pairs_plain(packed, nsub, t)
    ys, gs = merge.bitonic_pairs(y, meta, keep)
    ys_plain, gs_plain = merge.bitonic_pairs_plain(y, meta, keep)
    torch.cuda.synchronize()
    empty = scan_int8.EMPTY_I32
    out = {
        "merge_extract": (
            torch.equal(y, y_plain)
            and torch.equal(meta[y < empty], meta_plain[y < empty]),
            max_abs_err(y, y_plain),
            cuda_ms(lambda: merge.extract_pairs(packed, nsub, t), 10),
            cuda_ms(lambda: merge.extract_pairs_plain(packed, nsub, t), 3)),
        # fed the same survivors, the sort's every row must agree: the
        # metas of equal values (drained INT32_MAX, inadmissible
        # 0x7F000000) follow the TPU network's tie order
        "merge_bitonic": (
            torch.equal(ys, ys_plain) and torch.equal(gs, gs_plain),
            max(max_abs_err(ys, ys_plain), max_abs_err(gs, gs_plain)),
            cuda_ms(lambda: merge.bitonic_pairs(y, meta, keep), 10),
            cuda_ms(lambda: merge.bitonic_pairs_plain(y, meta, keep), 3)),
    }
    topk_ms = cuda_ms(lambda: torch.topk(packed, k, dim=0, largest=False),
                      10)
    extra = {"merge_extract": (*bound_ms(nbytes(packed, y, meta), 0, 1),
                               topk_ms),
             "merge_bitonic": (*bound_ms(nbytes(y, meta, ys, gs), 0, 1),
                               topk_ms)}
    say(f"  bitonic sort (npc {y.shape[0]}, keep {keep}, Q {y.shape[1]}): "
        f"{out['merge_bitonic'][2]:.6f} ms, bound "
        f"{extra['merge_bitonic'][0]:.6f} ms (bytes), torch.topk over the "
        f"minima (the extraction and sort together) {topk_ms:.6f} ms")
    return out, keep, extra


def drive_path(name, searcher, corpus, world, workload, truth, arena,
               kernels, smi):
    """Run one path through run_benchmark with every launch count set to 0
    just before, and check it: recall, group, readable rows, launches.
    Returns the launch counts of the run."""
    import numpy as np

    from vectorsearch_rbac_tpu_torch.bench import run_benchmark
    from vectorsearch_rbac_tpu_torch.ops import _build

    index = searcher.partitions[0].index
    _build.reset_launches()
    t0 = time.perf_counter()
    res = run_benchmark(searcher, corpus, world, workload, None, k=TOPK,
                        warmup_runs=2, timed_batches=64, timed_passes=8,
                        recall_sample=None, truth=truth)
    launches = dict(_build.LAUNCHES)
    say(f"{name} path ({time.perf_counter() - t0:.1f} s, {smi}): "
        f"recall@{TOPK} {res.avg_recall}, {res.qps} QPS over "
        f"{workload.num_queries} queries (pass walls ms "
        f"{[round(w, 3) for w in res.extra['pass_walls_ms']]}), batch-1 p50 "
        f"{res.p50_ms} ms p95 {res.p95_ms} ms, group {index.group}, rerank "
        f"{index.rerank_mode if index.rerank else None}, launches {launches}")
    if res.avg_recall < RECALL_FLOOR:
        fail(f"{name}: recall {res.avg_recall:.4f} < {RECALL_FLOOR}")
    if index.group != GROUP:
        fail(f"{name}: the index chose group {index.group}, not {GROUP}")
    idle = [k for k in kernels if launches[k] == 0]
    if idle:
        fail(f"{name}: the path never launched {idle}")

    _, ids = searcher.search_batch(workload.vectors[:BATCH],
                                   workload.user_ids[:BATCH],
                                   world.user_masks, TOPK)
    check_readable(name, ids, workload.user_ids[:BATCH], TOPK, corpus, world,
                   arena)
    return launches


def check_readable(name, ids, users, k, corpus, world, arena) -> None:
    """Every returned row exists and is readable by the querying user."""
    import numpy as np

    if ids.shape != (len(users), k) or ids.min() < -1 \
            or ids.max() >= corpus.n:
        fail(f"{name}: result ids out of range: shape {ids.shape}, "
             f"[{ids.min()}, {ids.max()}]")
    masks = world.user_masks[users]
    rows = arena.host_bits[np.maximum(ids, 0)]
    readable = (rows & masks[:, None, :]).any(axis=2) | (ids < 0)
    if not readable.all():
        fail(f"{name}: {int((~readable).sum())} returned rows are not "
             "readable by their users")
    say(f"{name} permissions: all {int((ids >= 0).sum())} returned rows "
        "readable")


def ab_dedup(name, indexes, one_pass, smi) -> None:
    """Admit-dedup on and off in turns (on, off, off, on, three times) over
    full passes of one path, after one warm pass each: host-clock walls
    (each pass ends in the host copy of its results) and results that must
    not change."""
    import numpy as np
    import torch

    walls, out, fired = {True: [], False: []}, {}, False
    for flag in (True, False, *(True, False, False, True) * 3):
        for ix in indexes:
            ix.mask_dedup = flag
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = one_pass()
        ms = (time.perf_counter() - t0) * 1000.0
        if flag in out:           # the first pass of each is the warm one
            walls[flag].append(ms)
        out.setdefault(flag, res)
        fired |= flag and any(ix._last_dedup for ix in indexes)
    for ix in indexes:
        ix.mask_dedup = True
    same = all(np.array_equal(a, b) for a, b in zip(out[True], out[False]))
    say(f"admit-dedup A/B on the {name} path ({smi}): on "
        f"{[round(w, 3) for w in walls[True]]} ms (median "
        f"{float(np.median(walls[True])):.3f}), off "
        f"{[round(w, 3) for w in walls[False]]} ms (median "
        f"{float(np.median(walls[False])):.3f}); grouped {fired}; results "
        f"identical {same}")
    if not same:
        fail(f"{name}: admit-dedup changed the results")
    if not fired:
        fail(f"{name}: admit-dedup never grouped a pass")


def check_slot_form(arena, workload, world, device, smi):
    """Phase 3c: the slot form against its plain version in both layouts,
    at 2048 queries x the arena, group 32; 128 slots of 16 queries carry
    the world's 100 distinct masks (slot s the (s % 100)-th). Returns
    (ok, max_abs_err, kernel ms, plain ms) for the contiguous layout the
    index uses."""
    import numpy as np
    import torch

    from vectorsearch_rbac_tpu_torch.ops import scan_int8

    quant = arena.quant
    q8, _ = quant.quantize_queries(workload.vectors[:BATCH], with_norms=False)
    distinct = np.unique(world.user_masks, axis=0)
    slots = distinct[np.arange(BATCH // SLOT_SB) % len(distinct)]
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(device)
    args = (t(q8), quant.vectors_q, quant.norms_q, arena.role_bits)
    slot_bits = t(slots.view(np.int32))
    kw = dict(group=SLOT_GROUP, metric="l2", score_shift=quant.score_shift,
              mask_sub_block=SLOT_SB)
    rows, errs, ms = {}, [], {}
    for layout, tile in (("contiguous", 0), ("interleaved", BATCH)):
        got = scan_int8.int8_group_minima(*args, slot_bits, slot_tile=tile,
                                          **kw)
        want = scan_int8.int8_group_minima_plain(*args, slot_bits,
                                                 slot_tile=tile, **kw)
        torch.cuda.synchronize()
        rows[layout] = torch.equal(got, want)
        errs.append(max_abs_err(got, want))
        ms[layout] = cuda_ms(lambda: scan_int8.int8_group_minima(
            *args, slot_bits, slot_tile=tile, **kw), 10)
        del got, want
    per_query = t(slots[np.arange(BATCH) // SLOT_SB].view(np.int32))
    kw_q = dict(group=SLOT_GROUP, metric="l2", score_shift=quant.score_shift)
    ms["per-query"] = cuda_ms(lambda: scan_int8.int8_group_minima(
        *args, per_query, **kw_q), 10)
    plain_ms = cuda_ms(lambda: scan_int8.int8_group_minima_plain(
        *args, slot_bits, slot_tile=0, **kw), 3)
    # the dots this run needs: each slot's SLOT_SB queries on the rows its
    # mask admits
    admitted = {}
    for m in np.unique(slots.view(np.int32), axis=0):
        hit = (arena.role_bits & t(m)[None, :]).ne(0).any(dim=1)
        admitted[m.tobytes()] = int(hit.sum())
    pairs = SLOT_SB * sum(admitted[m.tobytes()]
                          for m in slots.view(np.int32))
    out_rows = arena.n_padded // SLOT_GROUP
    bound = scan_bound(args[0], *args[1:], slot_bits, torch.empty(
        (out_rows, BATCH), dtype=torch.int32, device="meta"), pairs)
    floor = S2_EPI_OPS * pairs / INT32_OPS_S * 1e3
    say(f"slot form vs plain at Q={BATCH} x {arena.n_padded} rows, "
        f"{len(distinct)} distinct masks in {BATCH // SLOT_SB} slots of "
        f"{SLOT_SB}, group {SLOT_GROUP} ({smi}); tolerance 0: contiguous "
        f"identical={rows['contiguous']} {ms['contiguous']:.3f} ms, "
        f"interleaved identical={rows['interleaved']} "
        f"{ms['interleaved']:.3f} ms, plain {plain_ms:.3f} ms; the "
        f"per-query form on the same masks {ms['per-query']:.3f} ms "
        f"(interleaved / per-query {ms['interleaved'] / ms['per-query']:.3f})"
        f"; bound {bound[0]:.6f} ms ({bound[1]}); epilogue floor "
        f"{floor:.6f} ms ({S2_EPI_OPS} integer operations on each of the "
        f"{pairs} admitted pairs at {INT32_OPS_S:.4g} a second)")
    if not all(rows.values()):
        fail(f"the slot form disagrees with its plain version: {rows}")
    return (True, max(errs), ms["contiguous"], plain_ms), (*bound, None)


def check_lab_path(scan_args, packed, packed_plain, smi):
    """Phase 3e: the kernel lab's path on phase 3's operands and minima,
    the counts set to 0 just before and read just after; then its kernels
    against their plain versions. Returns (launches, {kernel: (ok,
    max_abs_err, ms, plain ms)}, {kernel: (bound ms, bound_by, library
    ms)})."""
    import torch

    from vectorsearch_rbac_tpu_torch.ops import (_build, lab_merge, lab_scan,
                                                 merge, scan_int8)

    q8, x8, norms, bits, qbits, group, metric, shift = scan_args
    rows = (q8, x8, norms, bits, qbits)
    qn = (q8.to(torch.int32) ** 2).sum(dim=1, dtype=torch.int32)
    full = (q8, qn, x8, norms, bits, qbits, 1.0, TOPK)
    lab_kw = dict(group=group, metric=metric, score_shift=shift)
    _build.reset_launches()
    lab_scan.int8_masked_topk_lab(*full, merge="none", variant="dp4a",
                                  **lab_kw)
    lab_scan.int8_masked_topk_lab(*full, variant="trim", **lab_kw)
    lab_scan.int8_masked_topk_lab(*full, merge="none", variant="chain",
                                  **lab_kw)
    lab_scan.int8_masked_topk_lab(*full, merge="none", variant="floor",
                                  **lab_kw)
    for t in (16, 8):
        lab_merge.extract_merge(packed, TOPK, 128, t)
    lab_merge.extract_merge_v2(packed, TOPK, 128, 8, 128)
    lab_merge.bitonic_sort_keep(lab_merge.subgroup_extract(packed, 128, 16),
                                128)
    torch.cuda.synchronize()
    launches = dict(_build.LAUNCHES)
    lab_kernels = ("scan_int8_dp4a", "scan_int8_trim", "scan_int8_chain",
                   "scan_int8_floor", "merge_y_extract", "merge_y_sort",
                   "merge_y_pairs")
    idle = [k for k in lab_kernels if launches[k] == 0]
    if idle:
        fail(f"the kernel lab's path never launched {idle}")

    out, extra = {}, {}
    out_meta = torch.empty(packed.shape, dtype=torch.int32, device="meta")
    k1_plain = lambda: scan_int8.int8_group_minima_plain(*rows, **lab_kw)
    plains = {"dp4a": k1_plain, "trim": k1_plain, "chain": k1_plain,
              "floor": lambda: lab_scan.floor_minima_plain(*rows, group)}
    for variant, plain_fn in plains.items():
        fn = lambda v=variant: lab_scan.lab_group_minima(*rows, variant=v,
                                                         **lab_kw)
        got = fn()
        # all but floor's plain version is K1's: phase 3 computed it
        plain = packed_plain if variant != "floor" else plain_fn()
        torch.cuda.synchronize()
        out[f"scan_int8_{variant}"] = (
            torch.equal(got, plain), max_abs_err(got, plain), cuda_ms(fn, 10),
            cuda_ms(plain_fn, 3))
        extra[f"scan_int8_{variant}"] = (*scan_bound(*rows, out_meta), None)
        del got, plain
    # trim, the chain and the floor run on K1's schedule: the four in turns
    # on the same operands. The chain less trim is what the fold saves; K1
    # less the floor is what K1's epilogue costs there
    fns = {"k1": lambda: scan_int8.int8_group_minima(*rows, **lab_kw)}
    for v in ("trim", "chain", "floor"):
        fns[v] = lambda v=v: lab_scan.lab_group_minima(*rows, variant=v,
                                                       **lab_kw)
    turns = {name: [] for name in fns}
    for name in (*fns, *reversed(fns)):
        turns[name].append(cuda_ms(fns[name], 10))
    mean = {name: sum(ts) / len(ts) for name, ts in turns.items()}
    w, n_pairs = bits.shape[1], q8.shape[0] * x8.shape[0]
    epi = {n: f(w) * n_pairs / INT32_OPS_S * 1e3
           for n, f in (("k1", K1_EPI_OPS), ("chain", CHAIN_EPI_OPS))}
    say(f"trim, chain and floor on K1's tensor-core schedule at Q="
        f"{q8.shape[0]} x {x8.shape[0]} rows, W {w}, group {group} ({smi}),"
        f" in turns: " + ", ".join(f"{n} {ts} ms" for n, ts in turns.items())
        + f"; the fold's saving (chain - trim) "
        f"{mean['chain'] - mean['trim']:.4f} ms, chain / trim "
        f"{mean['chain'] / mean['trim']:.4f}; epilogue share (K1 - floor) "
        f"/ K1 {(mean['k1'] - mean['floor']) / mean['k1']:.4f}; epilogue "
        f"floors: K1/trim {epi['k1']:.6f} ms ({K1_EPI_OPS(w)} integer "
        f"operations a pair), chain {epi['chain']:.6f} ms "
        f"({CHAIN_EPI_OPS(w)}); bound {extra['scan_int8_trim'][0]:.6f} ms "
        f"({extra['scan_int8_trim'][1]})")
    topk_ms = cuda_ms(lambda: torch.topk(packed, TOPK, dim=0, largest=False),
                      10)
    names = ("merge_y_extract", "merge_y_sort", "merge_y_pairs")
    same, errs = dict.fromkeys(names, True), dict.fromkeys(names, 0)
    for t in (16, 8):
        y = lab_merge.subgroup_extract(packed, 128, t)
        ys = lab_merge.bitonic_sort_keep(y, 128)
        yp, gp = lab_merge.bitonic_pairs_keep(y, 128, t, 128)
        pairs = {"merge_y_extract": [(y, lab_merge.subgroup_extract_plain(
                     packed, 128, t))],
                 "merge_y_sort": [(ys, lab_merge.bitonic_sort_keep_plain(
                     y, 128))],
                 "merge_y_pairs": list(zip((yp, gp), lab_merge.
                                           bitonic_pairs_keep_plain(
                                               y, 128, t, 128)))}
        torch.cuda.synchronize()
        for name, checks in pairs.items():
            same[name] &= all(torch.equal(a, b) for a, b in checks)
            errs[name] = max(errs[name], *(max_abs_err(a, b)
                                           for a, b in checks))
    # timed at extract_merge_v2's shape: t 8, 512 survivors, keep 128
    timed = {
        "merge_y_extract": (
            lambda: lab_merge.subgroup_extract(packed, 128, 8),
            lambda: lab_merge.subgroup_extract_plain(packed, 128, 8)),
        "merge_y_sort": (lambda: lab_merge.bitonic_sort_keep(y, 128),
                         lambda: lab_merge.bitonic_sort_keep_plain(y, 128)),
        "merge_y_pairs": (
            lambda: lab_merge.bitonic_pairs_keep(y, 128, 8, 128),
            lambda: lab_merge.bitonic_pairs_keep_plain(y, 128, 8, 128)),
    }
    for name, (fn, plain_fn) in timed.items():
        out[name] = (same[name], errs[name], cuda_ms(fn, 10),
                     cuda_ms(plain_fn, 3))
    # library calls on each kernel's own input: S4's is the 8 smallest of
    # each subgroup of 128 (values and positions); S5's the 128 smallest of
    # the survivors, sorted (the pairs form's gids follow from the indices)
    sub_ms = cuda_ms(lambda: torch.topk(
        packed.view(-1, 128, packed.shape[1]), 8, dim=1, largest=False), 10)
    keep_ms = cuda_ms(lambda: torch.topk(y, 128, dim=0, largest=False), 10)
    extra["merge_y_extract"] = (*bound_ms(nbytes(packed, y), 0, 1), sub_ms)
    extra["merge_y_sort"] = (*bound_ms(nbytes(y, ys), 0, 1), keep_ms)
    extra["merge_y_pairs"] = (*bound_ms(nbytes(y, yp, gp), 0, 1), keep_ms)
    # S5 beside K4 on the same survivors, K4 reading the pairs form's gids
    # as its metas (the network both run), and beside torch.topk
    gid = lab_merge.group_ids(y, 8, 128).contiguous()
    k4_ms = cuda_ms(lambda: merge.bitonic_pairs(y, gid, 128), 10)
    say(f"  S5 at npc {y.shape[0]}, keep 128, Q {y.shape[1]} ({smi}): sort "
        f"{out['merge_y_sort'][2]:.6f} ms (bound "
        f"{extra['merge_y_sort'][0]:.6f}), pairs "
        f"{out['merge_y_pairs'][2]:.6f} ms (bound "
        f"{extra['merge_y_pairs'][0]:.6f}); K4 on the same survivors and "
        f"gids {k4_ms:.6f} ms; torch.topk over the survivors {keep_ms:.6f} "
        "ms")
    report(f"kernel lab vs plain at Q={q8.shape[0]} x {x8.shape[0]} rows "
           f"(dp4a, trim, chain, floor: group {group}) and on the "
           f"{packed.shape[0]} x "
           f"{packed.shape[1]} minima (y-form: sub 128, t 8 and 16, keep "
           f"128; timed at t 8) ({smi}); tolerance 0:", out)
    say(f"  bounds ms { {k: round(v[0], 6) for k, v in extra.items()} }; "
        f"torch.topk per subgroup {sub_ms:.3f} ms, over the survivors "
        f"{keep_ms:.3f} ms, over the whole minima (the y-form merge's "
        f"yardstick) {topk_ms:.3f} ms; lab path launches "
        f"{ {k: launches[k] for k in lab_kernels} }")
    return launches, out, extra


def check_wide_slots(wide_args, arena, world, device, k, smi):
    """Phase 3e, wide half: K2's slot form on phase 3b's operands, 2048
    queries whose 100 distinct masks fill 128 slots of 16. The lab path
    first (bench/lab.py wide-admit: the scan and the merge kernels at k,
    interleaved in tiles of 512 as the reference's wide index tiles, the
    counts set to 0 just before and read just after), then the kernel
    against its plain version in both layouts, bit-identical. Returns
    (launches, (ok, max_abs_err, ms, plain ms), (bound ms, bound_by,
    library ms))."""
    import numpy as np
    import torch

    from vectorsearch_rbac_tpu_torch.ops import _build, scan_int8

    q8, x8, norms, bits, _, group, metric, shift = wide_args
    distinct = np.unique(world.user_masks, axis=0)
    slots = distinct[np.arange(BATCH // SLOT_SB) % len(distinct)]
    slot_bits = torch.from_numpy(np.ascontiguousarray(slots).view(
        np.int32)).to(device)
    rows = (q8, x8, norms, bits, slot_bits)
    kw = dict(group=group, metric=metric, score_shift=shift,
              mask_sub_block=SLOT_SB)
    tile = 512
    _build.reset_launches()
    scan_int8.int8_masked_topk(
        q8, None, x8, norms, bits, slot_bits,
        torch.ones(BATCH, device=device), k, group=group, merge="kernel",
        metric=metric, score_shift=shift, mask_sub_block=SLOT_SB,
        slot_tile=tile)
    torch.cuda.synchronize()
    launches = dict(_build.LAUNCHES)
    if launches["scan_int8_wide_slots"] == 0:
        fail("the wide-admit path never launched the wide slot form")
    same, err, ms = {}, 0, {}
    for layout, t in (("contiguous", 0), ("interleaved", tile)):
        got = scan_int8.int8_group_minima_wide(*rows, slot_tile=t, **kw)
        want = scan_int8.int8_group_minima_wide_plain(*rows, slot_tile=t,
                                                      **kw)
        torch.cuda.synchronize()
        same[layout] = torch.equal(got, want)
        err = max(err, max_abs_err(got, want))
        ms[layout] = cuda_ms(lambda t=t: scan_int8.int8_group_minima_wide(
            *rows, slot_tile=t, **kw), 10)
        del got, want
    plain_ms = cuda_ms(lambda: scan_int8.int8_group_minima_wide_plain(
        *rows, slot_tile=tile, **kw), 3)
    out_meta = torch.empty((x8.shape[0] // group, BATCH), dtype=torch.int32,
                           device="meta")
    bound = scan_bound(*rows, out_meta)
    say(f"wide slot form vs plain at Q={BATCH} x {x8.shape[0]} rows x d_pad "
        f"{x8.shape[1]}, {len(distinct)} distinct masks in "
        f"{BATCH // SLOT_SB} slots of {SLOT_SB}, group {group} ({smi}); "
        f"tolerance 0: contiguous identical={same['contiguous']} "
        f"{ms['contiguous']:.3f} ms, interleaved (tiles of {tile}) "
        f"identical={same['interleaved']} {ms['interleaved']:.3f} ms, plain "
        f"{plain_ms:.3f} ms, bound {bound[0]:.6f} ms ({bound[1]}); lab path "
        f"launches {launches['scan_int8_wide_slots']}")
    if not all(same.values()):
        fail(f"the wide slot form disagrees with its plain version: {same}")
    return launches, (True, err, ms["interleaved"], plain_ms), (*bound, None)


def pad_words(bits, w: int):
    """(n, W) int32 bitsets with zero words appended up to w: the same
    admissibility, read by the scan form for w words."""
    import torch

    return torch.nn.functional.pad(bits, (0, w - bits.shape[1])).contiguous()


def sparse_words(n: int, w: int, device, gen, ands: int = 5):
    """(n, w) int32 random bitset words, each bit set with p 2^-ands (the
    AND of `ands` uniform words)."""
    import torch

    out = None
    for _ in range(ands):
        r = torch.randint(-2**31, 2**31, (n, w), dtype=torch.int32,
                          device=device, generator=gen)
        out = r if out is None else out & r
    return out


def widen_packed(packed, w: int, more_words: int = 0, more_cols: int = 0,
                 gen=None):
    """Packed graph rows [int8 code | w words | f32 norm] with more_cols
    random int8 code columns and more_words sparse random words appended to
    their sections (the kernels and their plain versions read the same
    rows, so the norm need not follow the code)."""
    import torch

    d_pad = packed.shape[1] - 4 * w - 4
    n = packed.shape[0]
    parts = [packed[:, :d_pad]]
    if more_cols:
        parts.append(torch.randint(-127, 128, (n, more_cols),
                                   dtype=torch.int8, device=packed.device,
                                   generator=gen))
    parts.append(packed[:, d_pad:d_pad + 4 * w])
    if more_words:
        parts.append(sparse_words(n, more_words, packed.device, gen).view(
            torch.int8))
    parts.append(packed[:, d_pad + 4 * w:])
    return torch.cat(parts, 1).contiguous()


def check_wide_world(scan_args, arena, world, workload, device, smi):
    """Phase 4e, kernel half: K1 and its slot form at W 10 (the 300-role
    world's arena) and W 32 (the same bitsets with zero words appended),
    and on random bitsets at W 32, 64 and 128 (the huge forms past 32
    words), against their plain versions on a 2048-query batch, and their
    times in turns beside K1 and its slot form at W 4 (phase 3's operands:
    the same query codes and rows, the 100-role world's bitsets). Returns
    {kernel: (ok, max_abs_err)} for the scan rows."""
    import numpy as np
    import torch

    from vectorsearch_rbac_tpu_torch.ops import scan_int8

    q8, x8, norms, bits4, qbits4, group, metric, shift = scan_args
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(device)
    users = workload.user_ids[:BATCH]
    bits10 = arena.role_bits
    qbits10 = t(world.user_masks[users].view(np.int32))
    kw = dict(group=group, metric=metric, score_shift=shift)
    distinct = np.unique(world.user_masks, axis=0)
    slots10 = t(distinct[np.arange(BATCH // SLOT_SB) % len(distinct)].view(
        np.int32))
    slot_kw = dict(group=SLOT_GROUP, metric=metric, score_shift=shift,
                   mask_sub_block=SLOT_SB)
    distinct4 = np.unique(np.ascontiguousarray(qbits4.cpu().numpy()), axis=0)
    slots4 = t(distinct4[np.arange(BATCH // SLOT_SB) % len(distinct4)])
    # past 1,024 roles: random bitsets at W 32, 64 and 128 (each bit of a
    # row set with p 1 / (4 W), of a query with 1 / (2 W): about 1 - e^(-4
    # / W) of the pairs admitted), the huge forms beside the W 32 form
    gen = torch.Generator(device=device).manual_seed(4)
    huge = {}
    for w in HUGE_WORDS:
        lg = w.bit_length() - 1
        rb = sparse_words(x8.shape[0], w, device, gen, lg + 2)
        huge[f"K1 W{w} rand"] = ((q8, x8, norms, rb, sparse_words(
            BATCH, w, device, gen, lg + 1)), kw)
        huge[f"S2 W{w} rand"] = ((q8, x8, norms, rb, sparse_words(
            BATCH // SLOT_SB, w, device, gen, lg + 1)), slot_kw)
    forms = {   # name: (operands, kwargs)
        "K1 W4": ((q8, x8, norms, bits4, qbits4), kw),
        "K1 W10": ((q8, x8, norms, bits10, qbits10), kw),
        "K1 W32": ((q8, x8, norms, pad_words(bits10, 32),
                    pad_words(qbits10, 32)), kw),
        "S2 W4": ((q8, x8, norms, bits4, slots4), slot_kw),
        "S2 W10": ((q8, x8, norms, bits10, slots10), slot_kw),
        "S2 W32": ((q8, x8, norms, pad_words(bits10, 32),
                    pad_words(slots10, 32)), slot_kw),
        **huge,
    }
    same, errs = {}, {}
    for name in ("K1 W10", "K1 W32", "S2 W10", "S2 W32", *huge):
        ops, fkw = forms[name]
        got = scan_int8.int8_group_minima(*ops, **fkw)
        want = scan_int8.int8_group_minima_plain(*ops, **fkw)
        torch.cuda.synchronize()
        same[name] = torch.equal(got, want)
        errs[name] = max_abs_err(got, want)
        del got, want
    turns = {name: [] for name in forms}
    for name in (*forms, *reversed(forms)):
        ops, fkw = forms[name]
        turns[name].append(cuda_ms(
            lambda ops=ops, fkw=fkw: scan_int8.int8_group_minima(*ops, **fkw),
            10))
    out_rows = {n: x8.shape[0] // (SLOT_GROUP if n.startswith("S2")
                                   else group) for n in forms}
    bounds = {n: scan_bound(*ops, torch.empty((out_rows[n], BATCH),
                                              device="meta"))[0]
              for n, (ops, _) in forms.items()}
    say(f"wide-world scans at Q={BATCH} x {x8.shape[0]} rows x d_pad "
        f"{x8.shape[1]} (K1 group {group}; S2 {SLOT_SB}-query slots, group "
        f"{SLOT_GROUP}, the contiguous layout) ({smi}); tolerance 0: "
        f"identical {same}; in turns (ms): "
        + ", ".join(f"{n} {ts}" for n, ts in turns.items())
        + "; bounds (ms, all-pairs dots) "
        + ", ".join(f"{n} {b:.6f}" for n, b in bounds.items()))
    if not all(same.values()):
        fail(f"a wide-world scan disagrees with its plain version: {same}")
    return {"scan_int8": (True, max(v for n, v in errs.items()
                                    if n.startswith("K1"))),
            "scan_int8_slots": (True, max(v for n, v in errs.items()
                                          if n.startswith("S2")))}


def check_wires(name, searcher, workload, world, smi) -> None:
    """One pass on the mask-row wire and one on the uid wire (the path's
    own: a resident user table, 2-byte user ids) with each result wire:
    the ids must be the ids wire's on every pass, the distances within
    each wire's precision of the f32 wire's (bf16: 2^-8 of the value;
    u8: half a code step of the row's span)."""
    import numpy as np

    index = searcher.partitions[0].index
    q, users = workload.vectors, workload.user_ids
    wire0 = index.wire
    out = {}
    try:
        for wire in ("ids", "f32", "bf16", "u8"):
            index.wire = wire
            out[wire] = searcher.search_batch(q, users, world.user_masks,
                                              TOPK)
            if not index._last_uid_wire:
                fail(f"{name}: the {wire} pass did not take the uid wire")
        index.wire = "ids"
        out["mask rows"] = index.search(q, world.user_masks[users], TOPK)
        if index._last_uid_wire:
            fail(f"{name}: the mask-row pass took the uid wire")
    finally:
        index.wire = wire0
    ids = out["ids"][1]
    same = {w: bool(np.array_equal(o[1], ids)) for w, o in out.items()}
    d32 = out["f32"][0]
    fin = np.isfinite(d32)
    span = (np.where(fin, d32, -np.inf).max(1)
            - np.where(fin, d32, np.inf).min(1))
    step = np.where(np.isfinite(span), span, 0.0)[:, None] / 254.0
    err = {"bf16": float(np.max(np.abs(out["bf16"][0] - d32)[fin]
                                / np.maximum(np.abs(d32[fin]), 1e-30))),
           "u8": float(np.max((np.abs(out["u8"][0] - d32)
                               / np.maximum(step, 1e-30))[fin]))}
    say(f"{name} wires ({smi}): ids equal to the ids wire's {same}; bf16 "
        f"max relative error {err['bf16']:.3e} (bound 2^-8), u8 max error "
        f"{err['u8']:.4f} code steps (bound 0.5)")
    if not all(same.values()):
        fail(f"{name}: a wire changed the ids: {same}")
    if err["bf16"] > 2.0**-8 or err["u8"] > 0.5 * 1.0001 + 1e-3:
        fail(f"{name}: a wire's distances are off: {err}")


def check_graph_step(arena, workload, world, device, smi):
    """Phase 3d: the graph step's kernels against their plain versions at
    the hybrid path's geometry. Returns {kernel: (ok, max_abs_err, ms,
    plain ms)} and {kernel: (bound ms, bound_by, library ms)}."""
    import numpy as np
    import torch

    from vectorsearch_rbac_tpu_torch.core import (build_packed_graph_rows,
                                                  packed_query_operands)
    from vectorsearch_rbac_tpu_torch.ops import graph_step

    rng = np.random.default_rng(3)
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(device)
    nq, m0, (n_part, n_class) = GRAPH_Q, GRAPH_M0, GRAPH_SLAB
    packed = build_packed_graph_rows(arena)
    qv = workload.vectors[:nq]
    qf = np.zeros((nq, arena.quant.d_pad), np.float32)
    qf[:, :qv.shape[1]] = qv
    dqs, qcd = packed_query_operands(arena, qv)
    qmask = np.ascontiguousarray(
        world.user_masks[workload.user_ids[:nq]]).view(np.int32)
    row_map = rng.integers(0, arena.n, (n_part, n_class)).astype(np.int32)
    pids = rng.integers(0, n_part, nq).astype(np.int32)
    ids = rng.integers(0, n_class, (nq, m0)).astype(np.int32)
    ids[rng.random((nq, m0)) < 0.25] = -1     # neighbours dropped as seen
    sargs = (t(ids), packed, t(qf), t(qmask), t(qcd), dqs, t(row_map),
             t(pids))
    sc, ok = graph_step.graph_score_packed(*sargs)
    sc_p, ok_p = graph_step.graph_score_packed_plain(*sargs)
    torch.cuda.synchronize()
    fin = torch.isfinite(sc_p)
    score_err = float((sc - sc_p)[fin].abs().max()) if fin.any() else 0.0
    rows = graph_step.candidate_rows(*sargs[:1], sargs[6], sargs[7])
    gather_rows = rows[rows >= 0]     # the valid candidates' arena rows
    valid = int(gather_rows.numel())
    # ids, the row map entries and packed rows of the valid candidates,
    # the query operands; scores and flags out; 2 d_pad float32 ops each
    s_bytes = (nbytes(sargs[0], sargs[2], sargs[3], sargs[4], sargs[7], sc,
                      ok) + valid * (4 + packed.shape[1]))
    out = {"graph_score": (
        torch.equal(sc, sc_p) and torch.equal(ok, ok_p), score_err,
        cuda_ms(lambda: graph_step.graph_score_packed(*sargs), 20),
        cuda_ms(lambda: graph_step.graph_score_packed_plain(*sargs), 5))}
    # the inner-product form (ip and cosine arenas) on the same rows and
    # candidates: the same bytes, the same operations
    sc_ip, ok_ip = graph_step.graph_score_packed(*sargs, metric="ip")
    sc_ip_p, ok_ip_p = graph_step.graph_score_packed_plain(*sargs,
                                                           metric="ip")
    torch.cuda.synchronize()
    out["graph_score_ip"] = (
        torch.equal(sc_ip, sc_ip_p) and torch.equal(ok_ip, ok_ip_p)
        and torch.equal(ok_ip, ok),
        float((sc_ip - sc_ip_p)[fin].abs().max()) if fin.any() else 0.0,
        cuda_ms(lambda: graph_step.graph_score_packed(*sargs, metric="ip"),
                20),
        cuda_ms(lambda: graph_step.graph_score_packed_plain(*sargs,
                                                            metric="ip"), 5))
    del sc_ip, ok_ip, sc_ip_p, ok_ip_p
    # index_select gathers the same rows but does not score them: a
    # yardstick for a part of the kernel's function, not its library call
    gather_ms = cuda_ms(lambda: torch.index_select(packed, 0, gather_rows),
                        20)
    extra = {"graph_score": (
        *bound_ms(s_bytes, 2.0 * arena.quant.d_pad * valid, F32_OPS_S),
        None)}
    extra["graph_score_ip"] = extra["graph_score"]
    # past 1,024 roles and past d_pad 1024: the same candidates on rows
    # with 36 sparse random words appended (W 40: the role test loops past
    # 32 words) and on rows with 1,024 random code columns appended (d_pad
    # 1152: the query's floats read from L1), each against its plain
    # version; integer queries keep every dot exact
    gen = torch.Generator(device=device).manual_seed(5)
    w0 = qmask.shape[1]
    legs = {}
    for leg, more_w, more_c in ((f"W {GRAPH_WIDE_W}", GRAPH_WIDE_W - w0, 0),
                                (f"d_pad {GRAPH_WIDE_D}", 0,
                                 GRAPH_WIDE_D - arena.quant.d_pad)):
        wide = widen_packed(packed, w0, more_w, more_c, gen)
        wargs = list(sargs)
        wargs[1] = wide
        if more_w:
            wargs[3] = torch.cat([sargs[3], sparse_words(
                nq, more_w, device, gen, 4)], 1).contiguous()
        if more_c:
            wargs[2] = torch.cat([sargs[2], torch.randint(
                -20, 21, (nq, more_c), device=device, generator=gen).float()],
                1).contiguous()
        ws, wok = graph_step.graph_score_packed(*wargs)
        ws_p, wok_p = graph_step.graph_score_packed_plain(*wargs)
        torch.cuda.synchronize()
        wd = wide.shape[1] - 4 * wargs[3].shape[1] - 4
        legs[leg] = (
            torch.equal(ws, ws_p) and torch.equal(wok, wok_p),
            cuda_ms(lambda wargs=wargs: graph_step.graph_score_packed(
                *wargs), 20),
            bound_ms(nbytes(wargs[0], wargs[2], wargs[3], wargs[4],
                            wargs[7], ws, wok) + valid * (4 + wide.shape[1]),
                     2.0 * wd * valid, F32_OPS_S)[0],
            float(wok.float().mean()))
        del wide, ws, wok, ws_p, wok_p
    say("  graph_score past the first forms (" + smi + "; tolerance 0): "
        + "; ".join(f"{leg}: identical={ok} {ms:.4f} ms, bound {b:.6f} ms, "
                    f"admitted share {adm:.4f}"
                    for leg, (ok, ms, b, adm) in legs.items()))
    if not all(v[0] for v in legs.values()):
        fail(f"graph_score disagrees with its plain version past W 32 or "
             f"d_pad 1024: { {k: v[0] for k, v in legs.items()} }")

    def sorted_vals(w, empty):
        v = np.sort(rng.integers(0, 400_000, (nq, w)).astype(np.float32), 1)
        v[:, w - int(w * empty):] = np.inf
        return v

    beam_d = sorted_vals(GRAPH_EF, 0.3)
    beam_d[:, 0] = np.inf                     # the popped slot
    margs = (t(beam_d), t(rng.integers(0, n_class, (nq, GRAPH_EF)).astype(
        np.int32)), sc, sargs[0], t(sorted_vals(GRAPH_EF, 0.0)),
        t(sorted_vals(GRAPH_KK, 0.2)), t(rng.integers(0, n_class, (
            nq, GRAPH_KK)).astype(np.int32)),
        torch.where(ok, sc, float("inf")), sargs[0])
    got = graph_step.graph_merge_step(*margs)
    want = graph_step.graph_merge_step_plain(*margs)
    torch.cuda.synchronize()
    same = all(torch.equal(g, w) for g, w in zip(got, want))
    out["graph_merge"] = (
        same, max(max_abs_err(g, w) if g.dtype == torch.int32 else float(
            (g - w)[torch.isfinite(w)].abs().max()) for g, w in zip(got,
                                                                    want)),
        cuda_ms(lambda: graph_step.graph_merge_step(*margs), 20),
        cuda_ms(lambda: graph_step.graph_merge_step_plain(*margs), 5))
    extra["graph_merge"] = (*bound_ms(nbytes(*margs, *got), 0, 1), None)
    report(f"graph step kernels vs plain at Q={nq}, M0 {m0}, ef {GRAPH_EF},"
           f" kk {GRAPH_KK}, {n_part} x {n_class} row-map slab over "
           f"{arena.n_padded} packed rows of {packed.shape[1]} B ({smi}); "
           "tolerance 0 (SIFT-like integer data):", out)
    say(f"  graph_score: {valid} valid candidates; gather only "
        f"(index_select of the same rows, unscored, so not the kernel's "
        f"library_ms) {gather_ms:.3f} ms; bounds ms "
        f"{ {k: round(v[0], 6) for k, v in extra.items()} }")
    del packed
    return out, extra


def drive_hybrid(plan, corpus, world, arena, workload, truth, smi):
    """Phase 4d: the hybrid AnonySys executor through build_searcher and
    run_benchmark on 4c's plan, launch counts set to 0 just before and
    read just after; the same pass on the graph search's plain loop, equal
    ids and distances; then one traced pass for the device split. Returns
    the launch counts and the plain pass's recorded graph chunks (args,
    kwargs of each graph_beam_search_iterative call), and the searcher
    (phase 4l serves its graphs again)."""
    import collections

    import numpy as np
    import torch

    from vectorsearch_rbac_tpu_torch.bench import (run_benchmark,
                                                   serving_config)
    from vectorsearch_rbac_tpu_torch.bench.profile import profile_pass
    from vectorsearch_rbac_tpu_torch.index.hnsw import HNSWIndex
    from vectorsearch_rbac_tpu_torch.ops import _build, graph_search
    from vectorsearch_rbac_tpu_torch.partition import (build_searcher,
                                                       graph_batch)

    cfg = serving_config(seed=0, block_rows=BLOCK_ROWS, topk=PART_TOPK,
                         strategy="dynamic")
    cfg.optimizer.storage_alpha = PART_ALPHA
    cfg.optimizer.topk = PART_TOPK
    cfg.index.kind = "hybrid"
    t0 = time.perf_counter()
    searcher = build_searcher("dynamic", corpus, world, arena, cfg,
                              plan=plan, packed=False)
    build_s = time.perf_counter() - t0
    graphs = [p.index for p in searcher.partitions.values()
              if isinstance(p.index, HNSWIndex)]
    by_builder = collections.defaultdict(lambda: [0, 0.0, 0])
    for ix in graphs:
        row = by_builder[ix.builder]
        row[0] += 1
        row[1] += ix.build_time_s
        row[2] = max(row[2], ix.n_rows)
    _build.reset_launches()
    res = run_benchmark(searcher, corpus, world, workload, None, k=PART_TOPK,
                        warmup_runs=1, timed_batches=32, timed_passes=5,
                        recall_sample=None, truth=truth)
    dists, ids = searcher.search_batch(workload.vectors, workload.user_ids,
                                       world.user_masks, PART_TOPK)
    launches = dict(_build.LAUNCHES)
    name = "hybrid AnonySys (1M x 128, l2, batch 1024)"
    # the same pass with the graph search's plain loop in place of the
    # fused kernel; its graph chunks are recorded for phase 3d's search half
    calls = []

    def plain_search(*args, **kw):
        calls.append((args, kw))
        return graph_search.graph_beam_search_iterative_plain(*args, **kw)

    graph_batch.graph_beam_search_iterative = plain_search
    try:
        dists_p, ids_p = searcher.search_batch(
            workload.vectors, workload.user_ids, world.user_masks, PART_TOPK)
    finally:
        graph_batch.graph_beam_search_iterative = \
            graph_search.graph_beam_search_iterative
    same = np.array_equal(ids, ids_p) and np.array_equal(dists, dists_p)
    say(f"{name}: ids and distances equal to the plain loop's {same} "
        f"({len(calls)} graph chunks)")
    if not same:
        fail(f"{name}: the fused graph search disagrees with its plain loop")
    check_readable(name, ids, workload.user_ids, PART_TOPK, corpus, world,
                   arena)

    def one_pass():
        searcher.search_batch(workload.vectors, workload.user_ids,
                              world.user_masks, PART_TOPK)
        torch.cuda.synchronize()

    wall, spans, kernels, busy = profile_pass(one_pass)
    graph = spans.get("partitioned.graph", (0.0, 0.0))[1]
    flat = sum(spans.get(k, (0.0, 0.0))[1]
               for k in ("partitioned.enqueue", "flat_int8.fetch_unpack"))
    step = {k: round(spans.get(f"graph.{k}", (0.0, 0.0))[1], 3)
            for k in ("search", "step", "dedup", "score", "merge", "drain")}
    rep = res.storage
    say(f"{name} ({smi}): recall@{PART_TOPK} {res.avg_recall}, {res.qps} "
        f"QPS over {workload.num_queries} queries (pass walls ms "
        f"{[round(w, 3) for w in res.extra['pass_walls_ms']]}), batch-1 p50 "
        f"{res.p50_ms} ms p95 {res.p95_ms} ms; {len(graphs)} graph and "
        f"{len(searcher.partitions) - len(graphs)} flat partitions, "
        f"{rep['total_mb']:.1f} MB (graph slabs {rep['graph_slab_mb']:.1f},"
        f" packed rows {rep['packed_rows_mb']:.1f}); build {build_s:.2f} s "
        f"(graphs "
        f"{searcher.graph_build_s:.2f} s wall; by builder [count, summed s, "
        f"largest rows] {dict(by_builder)}); traced pass {wall:.3f} ms, "
        f"device busy {busy:.3f} ms: graph {graph:.3f} ms "
        f"{step}, flat remainder {flat:.3f} ms; launches {launches}")
    for ms, count, key in kernels[:12]:
        say(f"  device {ms:10.3f} ms {count:6d}x  {key[:80]}")
    if res.avg_recall < RECALL_FLOOR:
        fail(f"{name}: recall {res.avg_recall:.4f} < {RECALL_FLOOR}")
    idle = [k for k in ("graph_search", "merge_extract", "merge_bitonic")
            if launches[k] == 0]
    if launches["scan_int8"] == 0:
        idle.append("scan_int8")
    if idle:
        fail(f"{name}: the path never launched {idle}")
    stepped = {k: launches[k] for k in ("graph_score", "graph_merge")
               if launches[k]}
    if stepped:
        fail(f"{name}: the cell's graph search took the step loop {stepped}")
    return launches, calls, searcher


def check_graph_search(calls, smi):
    """Phase 3d, search half (after 4d: it takes 4d's slab and chunks): a
    4096-query chunk of the hybrid cell (the real, unpadded queries of the
    recorded no-harvest chunks of the largest slab, with their slots,
    entries, step budgets and the packed rows) through the fused search
    and its plain loop, bit-equal; beside them the step loop on the same
    inputs (KS7, KS6 and the PyTorch dedup: the path before the fused
    kernel, a yardstick, not a library call); its bound from the kernel's
    expansion count. Then the harvest leg: the same chunk with the 2-hop
    harvest (the step loop's path, KS7 and KS6) held bit-equal to its plain
    loop, launch counts set to 0 just before and read just after. Returns
    ({kernel: (ok, max_abs_err, ms, plain ms)}, {kernel: (bound ms,
    bound_by, library ms)}, the harvest leg's launches)."""
    import torch

    from vectorsearch_rbac_tpu_torch.ops import (_build, graph_search,
                                                 graph_step)

    by_slab = {}
    for args, kw in calls:
        if not args[10]:                         # harvest_2hop
            by_slab.setdefault(id(args[4]), []).append((args, kw))
    chunks = max(by_slab.values(),
                 key=lambda c: sum(int((kw["step_budget"] > 0).sum())
                                   for _, kw in c))
    args0, kw0 = chunks[0]
    graph, kk, ef = args0[4], args0[7], args0[8]
    cols = {k: [] for k in ("q", "mask", "entry", "pid", "budget", "qcd")}
    for args, kw in chunks:
        real = kw["step_budget"] > 0             # the batcher pads with 0
        for key, t in (("q", args[0]), ("mask", args[5]), ("entry", args[6]),
                       ("pid", kw["pids"]), ("budget", kw["step_budget"]),
                       ("qcd", kw["q_center_dot"])):
            cols[key].append(t[real])
    cols = {k: torch.cat(v) for k, v in cols.items()}
    n_real = cols["q"].shape[0]
    reps = -(-GRAPH_Q // n_real)
    cols = {k: v.repeat(reps, *[1] * (v.dim() - 1))[:GRAPH_Q].contiguous()
            for k, v in cols.items()}
    max_steps = 1 << (int(cols["budget"].max()) - 1).bit_length()
    packed = kw0["packed_rows"]
    fused_args = (cols["q"], graph, cols["mask"], cols["entry"], kk, ef,
                  max_steps, packed, kw0["dq_scale"], cols["qcd"],
                  kw0["row_map"], cols["pid"], cols["budget"])
    loop_args = (cols["q"], None, None, None, graph, cols["mask"],
                 cols["entry"], kk, ef, max_steps)
    loop_kw = dict(row_map=kw0["row_map"], pids=cols["pid"],
                   step_budget=cols["budget"], packed_rows=packed,
                   dq_scale=kw0["dq_scale"], q_center_dot=cols["qcd"])
    stats = torch.zeros(2, dtype=torch.int64, device=graph.device)
    stats_p = torch.zeros_like(stats)
    got = graph_search.graph_search_fused(*fused_args, stats=stats)
    want = graph_search.graph_beam_search_iterative_plain(
        *loop_args, **loop_kw, stats=stats_p)
    steps = graph_search._step_loop(
        *loop_args, False, kw0["row_map"], cols["pid"], cols["budget"],
        packed, kw0["dq_scale"], cols["qcd"], graph_search.SYNC_EVERY,
        graph_step.graph_score_packed, graph_step.graph_merge_step)
    torch.cuda.synchronize()
    same = all(torch.equal(a, b) for a, b in zip(got, want))
    steps_same = all(torch.equal(a, b) for a, b in zip(steps, want))
    fin = torch.isfinite(want[0])
    err = float((got[0] - want[0])[fin].abs().max()) if fin.any() else 0.0
    expansions, scored = (int(v) for v in stats.tolist())
    m0 = graph.shape[-1]
    w = cols["mask"].shape[1]
    d_pad = packed.shape[1] - 4 * w - 4
    # per query its operands, its entry's row map entry and packed row, its
    # results; per expansion the graph row; per scored candidate its row
    # map entry and packed row; 2 d_pad float32 operations a scored row
    s_bytes = (nbytes(*cols.values(), *got)
               + GRAPH_Q * (4 + packed.shape[1]) + expansions * 4 * m0
               + scored * (4 + packed.shape[1]))
    bound = bound_ms(s_bytes, 2.0 * d_pad * (scored + GRAPH_Q), F32_OPS_S)
    fused_ms = cuda_ms(lambda: graph_search.graph_search_fused(*fused_args),
                       10)
    plain_ms = cuda_ms(lambda: graph_search.graph_beam_search_iterative_plain(
        *loop_args, **loop_kw), 2)
    steps_ms = cuda_ms(lambda: graph_search._step_loop(
        *loop_args, False, kw0["row_map"], cols["pid"], cols["budget"],
        packed, kw0["dq_scale"], cols["qcd"], graph_search.SYNC_EVERY,
        graph_step.graph_score_packed, graph_step.graph_merge_step), 2)
    out = {"graph_search": (same, err, fused_ms, plain_ms)}
    report(f"fused graph search vs its plain loop on a {GRAPH_Q}-query chunk "
           f"of the hybrid cell ({n_real} real queries of "
           f"{len(chunks)} chunks, repeated to {GRAPH_Q}), slab "
           f"{tuple(graph.shape)}, ef {ef}, kk {kk}, max_steps {max_steps} "
           f"(step budgets {int(cols['budget'].min())}-"
           f"{int(cols['budget'].max())}), {packed.shape[1]}-B packed rows "
           f"({smi}); tolerance 0:", out)
    say(f"  graph_search: {expansions} expansions "
        f"({expansions / GRAPH_Q:.2f} a query), {scored} scored candidates;"
        f" bound {bound[0]:.6f} ms ({bound[1]}, {s_bytes} bytes); the step "
        f"loop on the same inputs (KS7 + KS6 + PyTorch dedup, every launch;"
        f" a yardstick, not library_ms) {steps_ms:.3f} ms, equal to the "
        f"plain loop {steps_same}")
    if not steps_same:
        fail("the step loop disagrees with the plain loop on the cell chunk")

    # past 1,024 roles: the same chunk on packed rows with 36 sparse random
    # words appended (W 40) and query masks with as many, through the fused
    # search (its role test loops past 32 words) and its plain loop
    gen = torch.Generator(device=graph.device).manual_seed(6)
    more = GRAPH_WIDE_W - w
    packed_w = widen_packed(packed, w, more, 0, gen)
    mask_w = torch.cat([cols["mask"], sparse_words(
        GRAPH_Q, more, graph.device, gen, 4)], 1).contiguous()
    fused_w = (fused_args[0], graph, mask_w, *fused_args[3:7], packed_w,
               *fused_args[8:])
    stats_w = torch.zeros_like(stats)
    got_w = graph_search.graph_search_fused(*fused_w, stats=stats_w)
    want_w = graph_search.graph_beam_search_iterative_plain(
        cols["q"], None, None, None, graph, mask_w, cols["entry"], kk, ef,
        max_steps, **{**loop_kw, "packed_rows": packed_w})
    torch.cuda.synchronize()
    same_w = all(torch.equal(a, b) for a, b in zip(got_w, want_w))
    ms_w = cuda_ms(lambda: graph_search.graph_search_fused(*fused_w), 10)
    exp_w, scored_w = (int(v) for v in stats_w.tolist())
    row_w = packed_w.shape[1]
    bound_w = bound_ms(
        nbytes(*cols.values(), mask_w, *got_w) + GRAPH_Q * (4 + row_w)
        + exp_w * 4 * m0 + scored_w * (4 + row_w),
        2.0 * d_pad * (scored_w + GRAPH_Q), F32_OPS_S)
    say(f"  graph_search at W {GRAPH_WIDE_W} (the same chunk, {row_w}-B "
        f"packed rows) ({smi}): equal to its plain loop {same_w}, "
        f"{ms_w:.3f} ms against {fused_ms:.3f} ms at W {w}; bound "
        f"{bound_w[0]:.6f} ms ({bound_w[1]}); {exp_w} expansions, "
        f"{scored_w} scored; {int((want_w[1] >= 0).sum())} results against "
        f"{int((want[1] >= 0).sum())}")
    if not same_w:
        fail(f"the fused graph search at W {GRAPH_WIDE_W} disagrees with its "
             "plain loop")
    del packed_w, got_w, want_w

    _build.reset_launches()
    got_h = graph_search.graph_beam_search_iterative(*loop_args, True,
                                                     **loop_kw)
    launches = dict(_build.LAUNCHES)
    want_h = graph_search.graph_beam_search_iterative_plain(*loop_args, True,
                                                            **loop_kw)
    torch.cuda.synchronize()
    same_h = all(torch.equal(a, b) for a, b in zip(got_h, want_h))
    say(f"harvest leg ({GRAPH_Q} queries of the same chunk, 2-hop harvest, "
        f"the step loop) ({smi}): equal to its plain loop {same_h}; launches "
        f"{ {k: v for k, v in launches.items() if v} }")
    if not same_h:
        fail("the harvest leg disagrees with its plain loop")
    idle = [k for k in ("graph_score", "graph_merge") if launches[k] == 0]
    if idle or launches["graph_search"]:
        fail(f"the harvest leg launched {launches}: it must run the step "
             "kernels, not the fused search")
    return out, {"graph_search": (*bound, None)}, launches


def drive_partitioned(name, searcher, build_s, corpus, world, workload,
                      truth, arena, smi):
    """One strategy of phase 4c through run_benchmark, its launch counts
    set to 0 just before and read just after (with the final full pass
    that checks permissions); then one traced pass for the device time of
    the chunk engine and of the big tier. Returns (launches, whether a
    big-tier pass grouped by mask)."""
    import torch

    from vectorsearch_rbac_tpu_torch.bench import run_benchmark
    from vectorsearch_rbac_tpu_torch.bench.profile import profile_pass
    from vectorsearch_rbac_tpu_torch.ops import _build

    _build.reset_launches()
    res = run_benchmark(searcher, corpus, world, workload, None, k=PART_TOPK,
                        warmup_runs=1, timed_batches=32, timed_passes=5,
                        recall_sample=None, truth=truth)
    _, ids = searcher.search_batch(workload.vectors, workload.user_ids,
                                   world.user_masks, PART_TOPK)
    launches = dict(_build.LAUNCHES)
    grouped = {pid: ix._last_dedup for pid, ix in searcher._big.items()}
    check_readable(name, ids, workload.user_ids, PART_TOPK, corpus, world,
                   arena)

    def one_pass():
        searcher.search_batch(workload.vectors, workload.user_ids,
                              world.user_masks, PART_TOPK)
        torch.cuda.synchronize()

    wall, spans, _, busy = profile_pass(one_pass)
    chunk = spans.get("tiled.chunk_scan", (0.0, 0.0))[1]
    big = sum(spans.get(k, (0.0, 0.0))[1]
              for k in ("tiled.big_enqueue", "tiled.big_fetch"))
    share = (f"{chunk / (chunk + big):.3f}" if chunk + big
             else "not measured")
    rep = res.storage
    fired = {k: launches[k] > 0 for k in
             ("scan_int8", "scan_int8_slots", "merge_extract",
              "merge_bitonic")}
    say(f"{name} ({smi}): recall@{PART_TOPK} {res.avg_recall}, {res.qps} "
        f"QPS over {workload.num_queries} queries (pass walls ms "
        f"{[round(w, 3) for w in res.extra['pass_walls_ms']]}), batch-1 p50 "
        f"{res.p50_ms} ms p95 {res.p95_ms} ms p99 {res.p99_ms} ms, "
        f"{rep['num_partitions']} "
        f"partitions ({len(searcher._big)} big tier), {rep['total_mb']:.1f} "
        f"MB, build {build_s:.2f} s; traced pass {wall:.3f} ms, device busy "
        f"{busy:.3f} ms: chunk engine {chunk:.3f} ms, big tier {big:.3f} "
        f"ms, chunk-engine share {share}; fired {fired}, big tier grouped "
        f"by mask {grouped}; launches {launches}")
    if res.avg_recall < RECALL_FLOOR:
        fail(f"{name}: recall {res.avg_recall:.4f} < {RECALL_FLOOR}")
    return launches, any(grouped.values())


def check_qdtree_tiers(searcher, launches, smi) -> None:
    """4c's QDTree leg: its leaves and the tier each took (the chunk engine
    or the big tier, above 48 chunks of 2,048 rows); where a leaf took the
    big tier, the narrow scan's slot form (admit-dedup), the extraction
    and the bitonic sort must have launched in the leg."""
    tree = searcher.tree
    big = {pid: len(tree.leaf_rows[pid]) for pid in sorted(searcher._big)}
    chunked = {pid: len(tree.leaf_rows[pid])
               for pid in sorted(searcher.part_chunks)}
    say(f"qdtree leaves ({smi}): {len(tree.leaf_rows)} leaves, route radius "
        f"{tree.route_radius}; big tier (rows) {big}; chunk engine (rows) "
        f"{chunked}")
    if big:
        idle = [k for k in ("scan_int8_slots", "merge_extract",
                            "merge_bitonic") if launches[k] == 0]
        if idle:
            fail(f"qdtree: a leaf took the big tier but {idle} never "
                 "launched")


def drive_packed(name, searcher, build_s, corpus, world, workload, truth,
                 arena, smi) -> None:
    """One strategy of phase 4f through run_benchmark (top-100), a full
    pass whose rows must all be readable, and one traced pass split by
    the packed.* spans."""
    import torch

    from vectorsearch_rbac_tpu_torch.bench import run_benchmark
    from vectorsearch_rbac_tpu_torch.bench.profile import profile_pass
    from vectorsearch_rbac_tpu_torch.partition.packed import PackedSearcher

    if not isinstance(searcher, PackedSearcher):
        fail(f"{name}: built a {type(searcher).__name__}, not the "
             "PackedSearcher")
    res = run_benchmark(searcher, corpus, world, workload, None, k=TOPK,
                        warmup_runs=1, timed_batches=32, timed_passes=3,
                        recall_sample=None, truth=truth)
    _, ids = searcher.search_batch(workload.vectors, workload.user_ids,
                                   world.user_masks, TOPK)
    check_readable(name, ids, workload.user_ids, TOPK, corpus, world, arena)

    def one_pass():
        searcher.search_batch(workload.vectors, workload.user_ids,
                              world.user_masks, TOPK)
        torch.cuda.synchronize()

    wall, spans, rows, busy = profile_pass(one_pass)
    split = ", ".join(
        f"{k} host {spans.get(k, (0.0, 0.0))[0]:.3f} ms device "
        f"{spans.get(k, (0.0, 0.0))[1]:.3f} ms"
        for k in ("packed.route", "packed.scan", "packed.merge"))
    rep = res.storage
    say(f"{name} ({smi}): recall@{TOPK} {res.avg_recall}, {res.qps} QPS "
        f"over {workload.num_queries} queries (pass walls ms "
        f"{[round(w, 3) for w in res.extra['pass_walls_ms']]}), batch-1 p50 "
        f"{res.p50_ms} ms p95 {res.p95_ms} ms p99 {res.p99_ms} ms, "
        f"{rep['num_partitions']} partitions in buckets (P, L_pad) "
        f"{searcher.bucket_shapes}, {rep['total_mb']:.1f} MB, build "
        f"{build_s:.2f} s; traced pass {wall:.3f} ms, device busy "
        f"{busy:.3f} ms: {split}; top device ops "
        + "; ".join(f"{ms:.3f} ms {n}x {key[:40]}" for ms, n, key in rows[:4]))
    if res.avg_recall < RECALL_FLOOR:
        fail(f"{name}: recall {res.avg_recall:.4f} < {RECALL_FLOOR}")


def drive_ivf(corpus, world, arena, workload, truth, smi) -> None:
    """Phase 4g: build_searcher("rls") with index kind ivf (nlist 1024,
    nprobe 16) over the SIFT workload, top-100: recall at nprobe 16
    (through run_benchmark) and 64, l_pad, fill and build seconds; full
    probe on the first 256 queries must reach recall 0.99; after the
    iterative scan no query may be short whose user can read k rows."""
    import numpy as np

    from vectorsearch_rbac_tpu_torch.bench import (run_benchmark,
                                                   serving_config)
    from vectorsearch_rbac_tpu_torch.bench.ground_truth import \
        per_query_recall
    from vectorsearch_rbac_tpu_torch.index.ivf import IVFIndex
    from vectorsearch_rbac_tpu_torch.partition import build_searcher

    cfg = serving_config(seed=0, block_rows=BLOCK_ROWS, batch=BATCH,
                         topk=TOPK, index="ivf")
    cfg.index.ivf_nlist, cfg.search.nprobe = IVF_NLIST, IVF_NPROBE
    t0 = time.perf_counter()
    searcher = build_searcher("rls", corpus, world, arena, cfg)
    build_s = time.perf_counter() - t0
    ix = searcher.partitions[0].index
    if not isinstance(ix, IVFIndex):
        fail(f"IVF: rls built a {type(ix).__name__}")
    res = run_benchmark(searcher, corpus, world, workload, None, k=TOPK,
                        warmup_runs=1, timed_batches=32, timed_passes=3,
                        recall_sample=None, truth=truth)
    q, users = workload.vectors, workload.user_ids
    masks = world.user_masks[users]
    t0 = time.perf_counter()
    _, ids64 = ix.search(q, masks, TOPK, nprobe=IVF_WIDE_PROBE)
    wide_s = time.perf_counter() - t0
    r64 = float(np.mean(per_query_recall(ids64, truth)))
    nf = IVF_FULL_QUERIES
    t0 = time.perf_counter()
    _, ids_full = ix.search(q[:nf], masks[:nf], TOPK, nprobe=ix.nlist)
    full_s = time.perf_counter() - t0
    r_full = float(np.mean(per_query_recall(ids_full, truth[:nf])))
    t0 = time.perf_counter()
    _, ids_it = ix.search(q, masks, TOPK, iterative=True)
    it_s = time.perf_counter() - t0
    check_readable("IVF (iterative)", ids_it, users, TOPK, corpus, world,
                   arena)
    short = np.flatnonzero((ids_it < 0).any(axis=1))
    bits = arena.host_bits[:corpus.n]
    readable = {int(u): int((bits & world.user_masks[u]).any(axis=1).sum())
                for u in np.unique(users[short])}
    wrong = [int(qi) for qi in short if readable[int(users[qi])] >= TOPK]
    say(f"IVF rls (1M x 128, l2, nlist {ix.nlist}, nprobe {ix.nprobe}, "
        f"{smi}): recall@{TOPK} {res.avg_recall} at nprobe {ix.nprobe}, "
        f"{res.qps} QPS over {workload.num_queries} queries (pass walls ms "
        f"{[round(w, 3) for w in res.extra['pass_walls_ms']]}), batch-1 p50 "
        f"{res.p50_ms} ms p95 {res.p95_ms} ms; recall {r64} at nprobe "
        f"{IVF_WIDE_PROBE} ({wide_s:.2f} s a pass); l_pad {ix.l_pad}, fill "
        f"{ix.fill:.4f}, storage {res.storage['total_mb']:.1f} MB, build "
        f"{build_s:.2f} s (k-means and assignment {ix.build_time_s:.2f} s);"
        f" full probe on {nf} queries recall {r_full} ({full_s:.2f} s); "
        f"iterative scan ({it_s:.2f} s): recall "
        f"{float(np.mean(per_query_recall(ids_it, truth)))}, {len(short)} "
        f"queries short, their users' readable rows "
        f"{sorted(readable.values())}")
    if res.avg_recall < 0.5:
        fail(f"IVF: recall {res.avg_recall} at nprobe {ix.nprobe}")
    if r_full < 0.99:
        fail(f"IVF: full probe recall {r_full} < 0.99")
    if wrong:
        fail(f"IVF: the iterative scan left {len(wrong)} queries short "
             f"whose users can read {TOPK} rows ({wrong[:5]})")


def same_topk(got, want, rtol: float = 1e-5) -> int:
    """The number of queries whose top-k differs beyond ties: empty slots
    must match, finite distances agree within rtol of the query's
    largest, and the ids strictly inside the k-th distance (less that
    tolerance) must be equal as sets."""
    import numpy as np

    gd, gi = got
    wd, wi = want
    bad = 0
    for q in range(len(wd)):
        ok = np.isfinite(wd[q])
        if not np.array_equal(ok, np.isfinite(gd[q])) \
                or not np.array_equal(wi[q] < 0, gi[q] < 0):
            bad += 1
            continue
        if not ok.any():
            continue
        tol = rtol * max(1.0, float(np.abs(wd[q][ok]).max()))
        last = wd[q][ok].max()
        if np.abs(gd[q][ok] - wd[q][ok]).max() > tol or (
                set(gi[q][ok & (gd[q] < last - tol)])
                != set(wi[q][ok & (wd[q] < last - tol)])):
            bad += 1
    return bad


def start_sparse_corpus():
    """Phase 4h(d)'s sparse corpus (the reference's generator draws it row
    by row: about a minute at 1M rows) in a worker process of its own,
    started before the phase's other legs; returns (executor, future)."""
    import concurrent.futures
    import multiprocessing

    ex = concurrent.futures.ProcessPoolExecutor(
        max_workers=1, mp_context=multiprocessing.get_context("spawn"))
    return ex, ex.submit(make_sparse_corpus)


def make_sparse_corpus():
    from vectorsearch_rbac_tpu_torch.data import synthetic_sparse_corpus

    t0 = time.perf_counter()
    corpus = synthetic_sparse_corpus(num_docs=SPARSE_DOCS,
                                     blocks_per_doc=SPARSE_BLOCKS, seed=0)
    return corpus, time.perf_counter() - t0


def drive_flat_family(corpus, world, workload, truth, device, smi) -> None:
    """Phase 4h (a) and (c) on the SIFT corpus: rls through FlatIndex in
    approx mode (the augmented layout) and exact on bfloat16 and float32
    arenas, recall >= 0.95 against the exact float32 oracle and readable
    rows, the augmented and plain score forms timed in turns on the same
    arena and queries; then the binary index (rerank multiplier 4) on the
    float32 arena, its recall printed, and its scan without rerank
    (hamming and jaccard) against a numpy recomputation on 16 queries."""
    import numpy as np
    import torch

    from vectorsearch_rbac_tpu_torch.bench import (run_benchmark,
                                                   serving_config)
    from vectorsearch_rbac_tpu_torch.core import build_device_arena
    from vectorsearch_rbac_tpu_torch.index.binary import BinaryQuantIndex
    from vectorsearch_rbac_tpu_torch.index.flat import FlatIndex
    from vectorsearch_rbac_tpu_torch.partition import build_searcher

    q, users = workload.vectors, workload.user_ids
    masks = world.user_masks[users]
    for dtype in ("bfloat16", "float32"):
        t0 = time.perf_counter()
        arena = build_device_arena(corpus, world, device=device,
                                   block_rows=BLOCK_ROWS, dtype=dtype)
        build_s = time.perf_counter() - t0
        indexes = {}
        for kind in ("flat_approx", "flat"):
            cfg = serving_config(seed=0, block_rows=BLOCK_ROWS, batch=BATCH,
                                 topk=TOPK, index=kind, dtype=dtype)
            searcher = build_searcher("rls", corpus, world, arena, cfg)
            ix = searcher.partitions[0].index
            if not isinstance(ix, FlatIndex) \
                    or (ix._vectors_aug is not None) != (kind != "flat"):
                fail(f"4h {dtype} {kind}: built {type(ix).__name__}, "
                     "not the FlatIndex with its score form")
            indexes[kind] = ix
            res = run_benchmark(searcher, corpus, world, workload, None,
                                k=TOPK, warmup_runs=1, timed_batches=8,
                                timed_passes=2, recall_sample=None,
                                truth=truth)
            _, ids = searcher.search_batch(q[:BATCH], users[:BATCH],
                                           world.user_masks, TOPK)
            name = f"4h rls FlatIndex {kind} ({dtype}, 1M x 128, l2)"
            check_readable(name, ids, users[:BATCH], TOPK, corpus, world,
                           arena)
            say(f"{name} ({smi}): recall@{TOPK} {res.avg_recall}, "
                f"{res.qps} QPS over {workload.num_queries} queries (pass "
                f"walls ms {[round(w, 3) for w in res.extra['pass_walls_ms']]}"
                f"), batch-1 p50 {res.p50_ms} ms p95 {res.p95_ms} ms, arena "
                f"{build_s:.2f} s, {res.storage['total_mb']:.1f} MB")
            if res.avg_recall < RECALL_FLOOR:
                fail(f"{name}: recall {res.avg_recall} < {RECALL_FLOOR}")
        walls = {"augmented": [], "plain": []}
        for form in ("augmented", "plain", "plain", "augmented",
                     "augmented", "plain"):
            ix = indexes["flat_approx" if form == "augmented" else "flat"]
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            ix.search(q, masks, TOPK)
            walls[form].append(round((time.perf_counter() - t0) * 1e3, 3))
        say(f"4h score forms in turns on the {dtype} arena, "
            f"{workload.num_queries} queries, top-{TOPK}, batch {BATCH} "
            f"({smi}): pass walls ms augmented {walls['augmented']}, plain "
            f"{walls['plain']}")
        if dtype == "bfloat16":
            del indexes, searcher, arena
            gc.collect()
            torch.cuda.empty_cache()

    # (c) the binary index on the float32 arena
    cfg = serving_config(seed=0, block_rows=BLOCK_ROWS, batch=BATCH,
                         topk=TOPK, index="binary", dtype="float32")
    t0 = time.perf_counter()
    searcher = build_searcher("rls", corpus, world, arena, cfg)
    build_s = time.perf_counter() - t0
    ix = searcher.partitions[0].index
    if not isinstance(ix, BinaryQuantIndex) or ix.rerank_mult != 4:
        fail(f"4h binary: built {type(ix).__name__}")
    res = run_benchmark(searcher, corpus, world, workload, None, k=TOPK,
                        warmup_runs=1, timed_batches=8, timed_passes=2,
                        recall_sample=None, truth=truth)
    _, ids = searcher.search_batch(q[:BATCH], users[:BATCH],
                                   world.user_masks, TOPK)
    check_readable("4h binary", ids, users[:BATCH], TOPK, corpus, world,
                   arena)
    say(f"4h rls BinaryQuantIndex (float32 arena, hamming, rerank x4, "
        f"{smi}): recall@{TOPK} {res.avg_recall} (printed, not held), "
        f"{res.qps} QPS over {workload.num_queries} queries (pass walls ms "
        f"{[round(w, 3) for w in res.extra['pass_walls_ms']]}), batch-1 p50 "
        f"{res.p50_ms} ms, build {build_s:.2f} s, "
        f"{res.storage['total_mb']:.1f} MB")
    nq = CHECK_QUERIES
    # the per-dimension median pivot, taken here from the arena's rows
    thr = np.median(arena.host_vectors[:corpus.n], axis=0).astype(np.float32)
    xb = arena.host_vectors[:corpus.n] > thr
    qb = q[:nq] > thr
    readable = (arena.host_bits[:corpus.n, None, :]
                & masks[None, :nq]).any(axis=2)
    for metric in ("hamming", "jaccard"):
        # the same index's bits, read without rerank
        raw = copy.copy(ix)
        raw.rerank, raw.bit_metric = False, metric
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        d, i = raw.search(q[:BATCH], masks[:BATCH], TOPK)
        pass_ms = (time.perf_counter() - t0) * 1e3
        bad = 0
        for qi in range(nq):
            if metric == "hamming":
                dist = (xb != qb[qi]).sum(axis=1).astype(np.float32)
            else:
                inter = (xb & qb[qi]).sum(axis=1).astype(np.float32)
                union = np.maximum((xb | qb[qi]).sum(axis=1), 1).astype(
                    np.float32)
                dist = np.where(inter > 0, np.float32(1.0) - inter / union,
                                np.float32(1.0))
            dist[~readable[:, qi]] = np.inf
            want = np.sort(dist)[:TOPK]
            ok = i[qi] >= 0
            if not (np.array_equal(d[qi], want)
                    and np.array_equal(dist[i[qi][ok]], d[qi][ok])):
                bad += 1
        say(f"4h binary scan without rerank, {metric} ({smi}): "
            f"{BATCH} queries in {pass_ms:.1f} ms; against "
            f"numpy on {nq} queries (distances equal, ids equal up to ties):"
            f" {nq - bad} of {nq} equal")
        if bad:
            fail(f"4h binary {metric}: {bad} of {nq} queries differ from "
                 "the numpy recomputation")
    del searcher, ix, raw, arena
    gc.collect()
    torch.cuda.empty_cache()


def drive_l1(device, smi):
    """Phase 4h (b): the synthetic corpus (1M x 128 float32) on an l1
    arena: rls flat exact over 1,024 queries, top-100, against a float64
    numpy recomputation on 16 queries; ROLE through the PackedSearcher
    against ROLE's packed=False layout (a FlatIndex a partition); then
    phase 4i (d), HNSW on the same arena. Returns 4i (d)'s launches."""
    import numpy as np
    import torch

    from vectorsearch_rbac_tpu_torch.bench import (
        GroundTruthOracle, compute_truth_sample, make_scenario,
        run_benchmark, serving_config)
    from vectorsearch_rbac_tpu_torch.core import build_device_arena
    from vectorsearch_rbac_tpu_torch.partition import build_searcher
    from vectorsearch_rbac_tpu_torch.partition.packed import PackedSearcher
    from vectorsearch_rbac_tpu_torch.partition.strategies import \
        build_role_searcher

    t0 = time.perf_counter()
    corpus, world, workload = make_scenario(
        n=N_ROWS, num_queries=L1_QUERIES, topk=TOPK, seed=0,
        dataset="synthetic")
    arena = build_device_arena(corpus, world, device=device,
                               block_rows=BLOCK_ROWS, dtype="float32",
                               metric="l1")
    say(f"4h synthetic data: {corpus.n} x {corpus.dim}, l1 float32 arena, "
        f"{workload.num_queries} queries: {time.perf_counter() - t0:.1f} s;"
        f" workload hash {digest(workload.vectors, workload.user_ids)}")
    q, users = workload.vectors, workload.user_ids
    masks = world.user_masks[users]
    cfg = serving_config(seed=0, block_rows=BLOCK_ROWS, batch=BATCH,
                         topk=TOPK, index="flat", dtype="float32")
    searcher = build_searcher("rls", corpus, world, arena, cfg)
    t0 = time.perf_counter()
    truth = compute_truth_sample(GroundTruthOracle(arena,
                                                   block_rows=BLOCK_ROWS,
                                                   query_batch=1024),
                                 corpus, world, workload, TOPK,
                                 recall_sample=None)
    oracle_s = time.perf_counter() - t0
    res = run_benchmark(searcher, corpus, world, workload, None, k=TOPK,
                        warmup_runs=1, timed_batches=8, timed_passes=2,
                        recall_sample=None, truth=truth)
    d, i = searcher.search_batch(q, users, world.user_masks, TOPK)
    check_readable("4h l1 rls", i, users, TOPK, corpus, world, arena)
    nq = CHECK_QUERIES
    readable = (arena.host_bits[:corpus.n, None, :]
                & masks[None, :nq]).any(axis=2)
    # the float64 recomputation from the corpus's rows, on the card (a
    # numpy pass over the 1M rows took ~17 s of host time)
    dist = torch.empty((nq, corpus.n), dtype=torch.float64, device=device)
    q64 = torch.from_numpy(q[:nq]).to(device).double()
    for r0 in range(0, corpus.n, 8192):
        x64 = torch.from_numpy(corpus.vectors[r0:r0 + 8192]).to(
            device).double()
        dist[:, r0:r0 + 8192] = (x64[None] - q64[:, None]).abs().sum(-1)
    dist[torch.from_numpy(~readable.T).to(device)] = torch.inf
    want_d, want_i = (t.cpu().numpy() for t in torch.sort(
        dist, dim=1, stable=True))
    want_d, want_i = want_d[:, :TOPK], want_i[:, :TOPK]
    del dist, x64
    bad = same_topk((d[:nq], i[:nq]), (want_d, want_i))
    say(f"4h l1 rls FlatIndex exact (1M x 128, {smi}): "
        f"{res.qps} QPS over {workload.num_queries} queries (pass walls ms "
        f"{[round(w, 3) for w in res.extra['pass_walls_ms']]}), batch-1 "
        f"p50 {res.p50_ms} ms; oracle {oracle_s:.1f} s; against a float64 "
        f"recomputation on {nq} queries (rtol 1e-5, ids up to ties): "
        f"{nq - bad} of {nq} equal")
    if bad:
        fail(f"4h l1: {bad} of {nq} queries differ from the float64 "
             "recomputation")
    del searcher
    gc.collect()
    torch.cuda.empty_cache()

    t0 = time.perf_counter()
    packed = build_searcher("role", corpus, world, arena, cfg)
    packed_s = time.perf_counter() - t0
    if not isinstance(packed, PackedSearcher):
        fail(f"4h l1 role: built {type(packed).__name__}")
    t0 = time.perf_counter()
    got = packed.search_batch(q, users, world.user_masks, TOPK)
    packed_ms = (time.perf_counter() - t0) * 1e3
    check_readable("4h l1 role packed", got[1], users, TOPK, corpus, world,
                   arena)
    del packed
    gc.collect()
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    unpacked = build_role_searcher(corpus, world, arena, cfg, packed=False)
    unpacked_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    want = unpacked.search_batch(q, users, world.user_masks, TOPK)
    unpacked_ms = (time.perf_counter() - t0) * 1e3
    bad = same_topk(got, want)
    say(f"4h l1 role ({smi}): PackedSearcher build {packed_s:.2f} s, a "
        f"{workload.num_queries}-query pass {packed_ms:.1f} ms (first); "
        f"packed=False ({len(unpacked.partitions)} FlatIndex partitions) "
        f"build {unpacked_s:.2f} s, pass {unpacked_ms:.1f} ms (first); "
        f"{workload.num_queries - bad} of {workload.num_queries} queries "
        "equal (rtol 1e-5, ids up to ties)")
    if bad:
        fail(f"4h l1 role: {bad} queries differ between the packed and "
             "unpacked layouts")
    del unpacked
    gc.collect()
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    launches = drive_hnsw_cut("4i(d) l1", arena, HNSW_CUT_ROWS, "l1",
                              workload, world, corpus, device, smi)
    say(f"phase 4i (d): {time.perf_counter() - t0:.1f} s ({smi})")
    del arena
    gc.collect()
    torch.cuda.empty_cache()
    return launches


def drive_sparse(sparse_job, device, smi) -> None:
    """Phase 4h (d): the sparse corpus (250,000 documents x 4 blocks, dim
    4096, nnz 16-48) under a tree world over its documents: 1,024 sparse
    queries (perturbed corpus rows), top-100, l2 and ip through
    SparseFlatIndex, against a dense float32 recomputation on 16
    queries."""
    import numpy as np
    import torch

    from vectorsearch_rbac_tpu_torch.index.sparse import SparseFlatIndex
    from vectorsearch_rbac_tpu_torch.rbac import TreeRBACGenerator

    ex, fut = sparse_job
    t0 = time.perf_counter()
    corpus, gen_s = fut.result()
    ex.shutdown(wait=True)
    wait_s = time.perf_counter() - t0
    world = TreeRBACGenerator(num_users=10_000, num_roles=100,
                              num_docs=corpus.num_docs, h=4, b0=3, b1=4,
                              seed=0).generate()
    rng = np.random.default_rng(1)
    nq = SPARSE_QUERIES
    q_cols = np.full((nq, 32), corpus.dim, np.int32)
    q_vals = np.zeros((nq, 32), np.float32)
    for j, r in enumerate(rng.integers(0, corpus.n, nq)):
        s, e = corpus.indptr[r], corpus.indptr[r + 1]
        take = min(e - s, 32)
        q_cols[j, :take] = corpus.indices[s:s + take]
        q_vals[j, :take] = corpus.data[s:s + take] * (
            1.0 + 0.1 * rng.standard_normal(take)).astype(np.float32)
    users = rng.integers(0, world.num_users, nq)
    masks = world.user_masks[users]
    bits = corpus.vector_role_bits(world)
    say(f"4h sparse data: {corpus.n} rows ({corpus.num_docs} documents), "
        f"dim {corpus.dim}, {len(corpus.data)} non-zeros, generated in "
        f"{gen_s:.1f} s beside the other legs (waited {wait_s:.1f} s); "
        f"{nq} queries, hash {digest(q_cols, q_vals, users)}")
    nc = CHECK_QUERIES
    readable = (bits[:, None, :] & masks[None, :nc]).any(axis=2)
    qd = np.zeros((nc, corpus.dim + 1), np.float32)
    qd[np.arange(nc)[:, None], q_cols[:nc]] = q_vals[:nc]
    qd_t = torch.from_numpy(qd[:, :corpus.dim]).to(device)
    indptr = torch.from_numpy(corpus.indptr.astype(np.int64)).to(device)
    indices = torch.from_numpy(corpus.indices.astype(np.int64)).to(device)
    data = torch.from_numpy(corpus.data.astype(np.float32)).to(device)
    for metric in ("l2", "ip"):
        t0 = time.perf_counter()
        ix = SparseFlatIndex(corpus, world, device=device, metric=metric,
                             block_rows=16384, query_batch=1024)
        build_s = time.perf_counter() - t0
        ix.search_sparse(q_cols[:64], q_vals[:64], masks[:64], TOPK)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        d, i = ix.search_sparse(q_cols, q_vals, masks, TOPK)
        pass_ms = (time.perf_counter() - t0) * 1e3
        name = f"4h sparse {metric}"
        if i.shape != (nq, TOPK) or i.max() >= corpus.n:
            fail(f"{name}: ids out of range")
        ok = i >= 0
        if not (bits[np.maximum(i, 0)] & masks[:, None, :]).any(
                axis=2)[ok].all():
            fail(f"{name}: returned rows a user cannot read")
        # the dense float32 recomputation, rows densified in chunks from
        # the corpus's own CSR (not the index's padded arrays or norms)
        dist = torch.empty((nc, corpus.n), device=device)
        with torch.no_grad():
            prev = torch.get_float32_matmul_precision()
            torch.set_float32_matmul_precision("highest")
            for r0 in range(0, corpus.n, 65536):
                r1 = min(r0 + 65536, corpus.n)
                s0, s1 = int(indptr[r0]), int(indptr[r1])
                rows = torch.repeat_interleave(
                    torch.arange(r1 - r0, device=device),
                    indptr[r0 + 1:r1 + 1] - indptr[r0:r1])
                x = torch.zeros((r1 - r0, corpus.dim), device=device)
                x.index_put_((rows, indices[s0:s1]), data[s0:s1],
                             accumulate=True)
                dots = qd_t @ x.T
                dist[:, r0:r1] = ((x * x).sum(dim=1)[None] - 2.0 * dots
                                  + (qd_t * qd_t).sum(dim=1, keepdim=True)
                                  if metric == "l2" else -dots)
            torch.set_float32_matmul_precision(prev)
        dist = dist.cpu().numpy().astype(np.float64)
        dist[~readable.T] = np.inf
        order = np.argsort(dist, axis=1, kind="stable")[:, :TOPK]
        want = (np.take_along_axis(dist, order, axis=1), order)
        if metric == "l2":
            want = (np.maximum(want[0], 0.0), order)
        bad = same_topk((d[:nc], i[:nc]), want)
        say(f"{name} ({smi}): build {build_s:.2f} s (nnz_pad "
            f"{ix.nnz_pad}, {ix.storage_bytes()['vectors'] / 2**20:.1f} MB "
            f"padded CSR), {nq} queries top-{TOPK} in {pass_ms:.1f} ms "
            f"({nq / pass_ms * 1e3:.1f} QPS); against the dense float32 "
            f"recomputation on {nc} queries (rtol 1e-5, ids up to ties): "
            f"{nc - bad} of {nc} equal")
        if bad:
            fail(f"{name}: {bad} of {nc} queries differ from the dense "
                 "recomputation")
        del ix
        torch.cuda.empty_cache()


# ---- phase 4i: HNSW everywhere

def hnsw_predicted(key: str) -> str:
    return f"(predicted {HNSW_PREDICTED[key]})"


def subset_truth(arena, rows, q, masks, metric, k, device):
    """Exact top-k arena rows of each query over `rows` of the arena's
    float32 host rows (unit rows on a cosine arena), readable rows only,
    -1 past the readable ones: float32 matmuls (TF32 off) on the card, l1
    by torch.cdist."""
    import numpy as np
    import torch

    from vectorsearch_rbac_tpu_torch.ops.scan import exact_f32_matmul

    x = torch.from_numpy(np.ascontiguousarray(
        arena.host_vectors[rows], np.float32)).to(device)
    bits = torch.from_numpy(np.ascontiguousarray(
        arena.host_bits[rows]).view(np.int32)).to(device)
    nrm = (x * x).sum(1)
    chunk = max(1, (1 << 26) // len(rows))
    out = np.full((len(q), k), -1, np.int64)
    rows_t = torch.from_numpy(np.asarray(rows, np.int64)).to(device)
    with exact_f32_matmul():
        for s in range(0, len(q), chunk):
            qc = torch.from_numpy(np.ascontiguousarray(
                q[s:s + chunk], np.float32)).to(device)
            if metric == "cosine":
                qc = qc / torch.linalg.vector_norm(qc, dim=1, keepdim=True)
            if metric == "l1":
                sc = torch.cdist(qc, x, p=1)
            elif metric == "l2":
                sc = nrm[None, :] - 2.0 * (qc @ x.T)
            else:
                sc = -(qc @ x.T)
            mk = torch.from_numpy(np.ascontiguousarray(
                masks[s:s + chunk]).view(np.int32)).to(device)
            ok = torch.zeros(sc.shape, dtype=torch.bool, device=device)
            for w in range(bits.shape[1]):
                ok |= (bits[None, :, w] & mk[:, w, None]) != 0
            sc = torch.where(ok, sc, torch.inf)
            v, i = torch.topk(sc, k, dim=1, largest=False)
            out[s:s + chunk] = torch.where(torch.isfinite(v), rows_t[i],
                                           -1).cpu().numpy()
    return out


def hnsw_distances_ok(name, arena, metric, q, ids, dists) -> None:
    """The first CHECK_QUERIES queries' returned distances against a
    float64 numpy recomputation from the rows the search reads (the arena's
    stored rows: the bfloat16 mirror of an int8 arena, exact on SIFT's
    integers; float32 rows) and the query as the search rounds it, within
    HNSW_DIST_RTOL relative."""
    import numpy as np
    import torch

    n = CHECK_QUERIES
    ids, dists = ids[:n], dists[:n]
    x = arena.vectors[torch.from_numpy(np.maximum(ids, 0)).to(
        arena.vectors.device)].double().cpu().numpy()
    qt = torch.from_numpy(np.ascontiguousarray(q[:n], np.float32))
    if metric == "cosine":
        qt = qt / torch.linalg.vector_norm(qt, dim=1, keepdim=True)
    if metric != "l1":
        qt = qt.to(arena.vectors.dtype)
    qr = qt.double().numpy()[:, None, :]
    if metric == "l2":
        want = ((x - qr) ** 2).sum(-1)
    elif metric == "ip":
        want = -(x * qr).sum(-1)
    elif metric == "cosine":
        want = np.clip(1.0 - (x * qr).sum(-1), 0.0, 2.0)
    else:
        want = np.abs(x - qr).sum(-1)
    got = ids >= 0
    bad = int((got & ~np.isclose(dists, want, rtol=HNSW_DIST_RTOL,
                                 atol=1e-6)).sum())
    if bad or not got.any():
        fail(f"{name}: {bad} of {int(got.sum())} distances on {n} queries "
             f"differ from float64 numpy beyond {HNSW_DIST_RTOL} relative")


def hnsw_recorder(hnsw_mod):
    """Record the iterative searches an HNSWIndex runs (their args and
    kwargs), calling through; returns (calls, restore)."""
    real = hnsw_mod.graph_beam_search_iterative
    calls = []

    def record(*args, **kw):
        calls.append((args, kw))
        return real(*args, **kw)

    hnsw_mod.graph_beam_search_iterative = record

    def restore():
        hnsw_mod.graph_beam_search_iterative = real
    return calls, restore


def hnsw_ways(name, ix, arena, metric, q, users, world, corpus, k, truth,
              ways, smi):
    """Serve q through HNSWIndex `ix` each of `ways` (fixed, filtered,
    sampled), the launch counts set to 0 just before each and read just
    after; every returned row readable, distances against numpy, recall
    against `truth` printed beside its prediction. Returns {way: (recall,
    QPS, launches, recorded iterative calls)}."""
    import numpy as np
    import torch

    from vectorsearch_rbac_tpu_torch.bench.ground_truth import \
        per_query_recall
    from vectorsearch_rbac_tpu_torch.index import hnsw as hnsw_mod
    from vectorsearch_rbac_tpu_torch.ops import _build

    masks = world.user_masks[users]
    kw_of = {"fixed": {}, "filtered": dict(filtered_traversal=True),
             "sampled": dict(sampled_entry=True)}
    out = {}
    for way in ways:
        calls, restore = hnsw_recorder(hnsw_mod)
        _build.reset_launches()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        try:
            d, i = ix.search(q, masks, k, **kw_of[way])
        finally:
            restore()
        wall = time.perf_counter() - t0
        launches = {key: v for key, v in _build.LAUNCHES.items() if v}
        rec = float(np.mean(per_query_recall(i, truth)))
        check_readable(f"{name} {way}", i, users, k, corpus, world, arena)
        hnsw_distances_ok(f"{name} {way}", arena, metric, q, i, d)
        say(f"{name} {way} ({smi}): recall@{k} {rec} "
            f"{hnsw_predicted(name + ' ' + way)}, {len(q) / wall:.1f} QPS "
            f"({len(q)} queries, one pass {wall * 1e3:.1f} ms, query batch "
            f"{ix.query_batch}), {int((i >= 0).sum())} rows returned; "
            f"launches {launches}")
        out[way] = (rec, len(q) / wall, launches, calls)
    return out


def fused_chunk(name, calls, smi):
    """The first recorded iterative search of an HNSWIndex pass (one chunk)
    through the fused search and its plain loop: equal ids and distances,
    the same expansions and scored candidates; both timed, the bound from
    the kernel's counts. Returns ((ok, err, ms, plain ms), (bound ms,
    bound_by, None), the call)."""
    import torch

    from vectorsearch_rbac_tpu_torch.ops import graph_search

    args, kw = calls[0]
    q, graph, masks, entries, kk, ef, max_steps = (
        args[0], args[4], args[5], args[6], args[7], args[8], args[9])
    fused_kw = dict(dq_scale=kw["dq_scale"], q_center_dot=kw["q_center_dot"],
                    row_map=kw["row_map"], metric=kw["metric"])
    stats = torch.zeros(2, dtype=torch.int64, device=q.device)
    stats_p = torch.zeros_like(stats)
    packed = kw["packed_rows"]
    got = graph_search.graph_search_fused(
        q, graph, masks, entries, kk, ef, max_steps, packed, stats=stats,
        **fused_kw)
    want = graph_search.graph_beam_search_iterative_plain(
        *args[:10], **kw, stats=stats_p)
    torch.cuda.synchronize()
    same = all(torch.equal(a, b) for a, b in zip(got, want)) \
        and torch.equal(stats, stats_p)
    fin = torch.isfinite(want[0])
    err = float((got[0] - want[0])[fin].abs().max()) if fin.any() else 0.0
    ms = cuda_ms(lambda: graph_search.graph_search_fused(
        q, graph, masks, entries, kk, ef, max_steps, packed, **fused_kw), 5)
    plain_ms = cuda_ms(lambda: graph_search.graph_beam_search_iterative_plain(
        *args[:10], **kw), 1)
    expansions, scored = (int(v) for v in stats.tolist())
    nq, m0 = q.shape[0], graph.shape[-1]
    d_pad = packed.shape[1] - 4 * masks.shape[1] - 4
    s_bytes = (nbytes(q, masks, entries, kw["q_center_dot"], *got)
               + nq * (4 + packed.shape[1]) + expansions * 4 * m0
               + scored * (4 + packed.shape[1]))
    bound = bound_ms(s_bytes, 2.0 * d_pad * (scored + nq), F32_OPS_S)
    say(f"{name}: fused search ({kw['metric']} form) vs its plain loop on "
        f"one {nq}-query chunk, ef {ef}, kk {kk}, max_steps {max_steps} "
        f"({smi}); tolerance 0: identical={same} kernel {ms:.3f} ms, plain "
        f"{plain_ms:.3f} ms; {expansions} expansions, {scored} scored; bound"
        f" {bound[0]:.6f} ms ({bound[1]})")
    if not same:
        fail(f"{name}: the fused search disagrees with its plain loop")
    return (same, err, ms, plain_ms), (*bound, None), (args, kw)


def knn_checks(caught, nbr, arena, device, smi):
    """The "tpu" builder's IVF-assisted kNN lists (caught by spies on the
    kNN and on its list placement): KNN_K distinct neighbours other than
    itself in each, their recall against the exact kNN on KNN_SAMPLE rows
    printed. Every row lists itself first unless the reference's placement
    keeps it from itself: a row that spills past a full list into one
    outside its own KNN_NPROBE probed lists never scans its own list.
    Held: the rows that miss their own list are exactly those; every other
    row lists itself first (SIFT's integer rows score exactly in the
    probed scan, and the corpus has no twins); a row in no list is one of
    them and has an edge into it in the final graph `nbr`."""
    import numpy as np
    import torch

    from vectorsearch_rbac_tpu_torch.ops.scan import exact_f32_matmul

    if "knn" not in caught:
        fail("the tpu builder above 200,000 rows did not take the "
             "IVF-assisted kNN")
    knn, lists, cents = caught["knn"], caught["lists"], caught["cents"]
    n = nbr.shape[0]
    rows = np.arange(n)
    if knn.shape != (n, KNN_K + 1) or knn.min() < 0 or knn.max() >= n:
        fail(f"IVF kNN: shape {knn.shape}, ids [{knn.min()}, {knn.max()}]")
    srt = np.sort(knn, axis=1)
    repeats = int((srt[:, 1:] == srt[:, :-1]).any(axis=1).sum())
    has_self = (knn == rows[:, None]).any(axis=1)
    others = KNN_K + 1 - has_self
    missing = np.setdiff1d(rows, knn)
    home = np.empty(n, np.int64)            # the list each row was put in
    for c, members in enumerate(lists):
        home[members] = c
    vec = torch.from_numpy(arena.host_vectors[:n]).to(device)
    ct = torch.from_numpy(np.asarray(cents, np.float32)).to(device)
    probes = []
    with exact_f32_matmul():                # the probed scan's routing
        for s in range(0, n, 65536):
            q = vec[s:s + 65536]
            cd = ((q * q).sum(1, keepdim=True) + (ct * ct).sum(1)[None]
                  - 2.0 * (q @ ct.T))
            probes.append(torch.topk(cd, KNN_NPROBE, dim=1,
                                     largest=False).indices.cpu())
    probes = torch.cat(probes).numpy()
    nearest = probes[:, 0]
    unprobed = ~(probes == home[:, None]).any(axis=1)
    sample = np.random.default_rng(0).choice(n, KNN_SAMPLE, replace=False)
    with exact_f32_matmul():
        sc = (vec * vec).sum(1)[None, :] - 2.0 * (vec[sample] @ vec.T)
    sc[torch.arange(KNN_SAMPLE), torch.from_numpy(sample).to(device)] = \
        torch.inf
    exact = torch.topk(sc, KNN_K, dim=1, largest=False).indices.cpu().numpy()
    indeg = np.bincount(nbr[nbr >= 0], minlength=n)
    del vec, sc
    rec = np.mean([len(set(exact[j]) & (set(knn[s]) - {s})) / KNN_K
                   for j, s in enumerate(sample)])
    not_first = has_self & (knn[:, 0] != rows)
    show = [(int(r), int(home[r]), int(nearest[r]), probes[r].tolist())
            for r in missing[:4]]
    say(f"  IVF-assisted kNN ({n} rows, knn_k {KNN_K}, {len(lists)} lists, "
        f"{KNN_NPROBE} probed, {smi}): {caught['s']:.2f} s; "
        f"recall@{KNN_K} against the exact kNN on {KNN_SAMPLE} sampled rows "
        f"{rec}; rows put past their nearest list {int((home != nearest).sum())}"
        f", of them outside their own probed lists {int(unprobed.sum())}; "
        f"rows missing from their own list {int((~has_self).sum())} (all "
        f"of them outside their probed lists: "
        f"{np.array_equal(~has_self, unprobed)}); rows listing another row "
        f"first {int(not_first.sum())}; {n - len(missing)} of {n} rows in "
        f"the kNN lists, the others' (row, its list, its nearest list, its "
        f"probed lists) {show}... and in-edges in the final graph "
        f"{sorted(set(indeg[missing].tolist()))}; rows with a repeated id "
        f"{repeats}, rows with fewer than {KNN_K} other neighbours "
        f"{int((others < KNN_K).sum())}; rows without an in-edge in the "
        f"final graph {int((indeg == 0).sum())}")
    if not np.array_equal(~has_self, unprobed) or not_first.any():
        fail(f"IVF kNN: {int((~has_self).sum())} rows miss their own list "
             f"against {int(unprobed.sum())} placed outside their probed "
             f"lists; {int(not_first.sum())} list another row first")
    if (indeg[missing] == 0).any():
        fail(f"IVF kNN: {int((indeg[missing] == 0).sum())} rows are in no "
             "kNN list and have no edge into them in the graph")
    if repeats or (others < KNN_K).any():
        fail(f"IVF kNN: {repeats} rows repeat an id, "
             f"{int((others < KNN_K).sum())} have fewer than {KNN_K} "
             "other neighbours")


def drive_hnsw_sift(corpus, world, arena, workload, truth, device, smi):
    """Phase 4i (a) and (b) on the SIFT corpus. (a) rls over one HNSW graph
    of the whole 1M-row l2 arena (build_searcher("rls") with index kind
    hnsw: the "tpu" builder through the IVF-assisted kNN), its kNN lists
    checked, then 8192 queries, top-100, the fixed-budget beam (through
    run_benchmark: bench --index hnsw), the ACORN filtered traversal and
    the sampled entries (the fused search, l2), a chunk of the last equal
    to the plain loop. (b) an int8 ip arena of the same corpus (lossless:
    packed rows), a graph on the MIPS lift over its first 262,144 rows,
    the sampled entries (the fused search's ip form) against an exact ip
    oracle over those rows, a chunk equal to the plain loop, then the same
    chunk with the 2-hop harvest (KS6 and KS7's ip form) equal to its plain
    loop. Returns (the launches of the legs, {kernel: row}, {kernel:
    bound})."""
    import numpy as np
    import torch

    from vectorsearch_rbac_tpu_torch.bench import (run_benchmark,
                                                   serving_config)
    from vectorsearch_rbac_tpu_torch.core import build_device_arena
    from vectorsearch_rbac_tpu_torch.index import hnsw as hnsw_mod
    from vectorsearch_rbac_tpu_torch.ops import _build, graph_search
    from vectorsearch_rbac_tpu_torch.partition import build_searcher

    t4i = time.perf_counter()
    launches = {k: 0 for k in _build.LAUNCHES}

    def add(counts):
        for key, v in counts.items():
            launches[key] += v

    cfg = serving_config(seed=0, block_rows=BLOCK_ROWS, batch=HNSW_CHUNK,
                         topk=TOPK, index="hnsw")
    caught = {}
    ivf_knn, bucket_rows = hnsw_mod._device_knn_graph_ivf, hnsw_mod.bucket_rows

    def spy(vec, k, dev, **kw):
        t0 = time.perf_counter()
        caught["knn"] = ivf_knn(vec, k, dev, **kw)
        caught["s"] = time.perf_counter() - t0
        return caught["knn"]

    def spy_lists(assign, vec, cent, l_pad):
        out = bucket_rows(assign, vec, cent, l_pad)
        caught["lists"], caught["cents"] = out[0], cent
        return out

    hnsw_mod._device_knn_graph_ivf = spy
    hnsw_mod.bucket_rows = spy_lists
    try:
        t0 = time.perf_counter()
        searcher = build_searcher("rls", corpus, world, arena, cfg)
        build_s = time.perf_counter() - t0
    finally:
        hnsw_mod._device_knn_graph_ivf = ivf_knn
        hnsw_mod.bucket_rows = bucket_rows
    ix = searcher.partitions[0].index
    nbr = ix.graph_state()["neighbors"]
    say(f"4i(a) rls HNSW over {ix.n_rows} rows x 128 (l2, M 16, builder "
        f"{ix.builder}, {smi}): build {build_s:.2f} s, concurrent (4i(e)'s "
        f"ACORN and classic builds run beside it in two threads) "
        f"{hnsw_predicted('4i(a) build s')}; graph M0 {nbr.shape[1]}, mean "
        f"degree {float((nbr >= 0).sum(1).mean()):.2f}, entry {ix.entry}")
    if ix.builder != "tpu" or ix.n_rows != corpus.n:
        fail(f"4i(a): built {ix.builder} over {ix.n_rows} rows")
    knn_checks(caught, nbr, arena, device, smi)
    del caught
    gc.collect()

    _build.reset_launches()
    res = run_benchmark(searcher, corpus, world, workload, None, k=TOPK,
                        warmup_runs=1, timed_batches=16, timed_passes=3,
                        recall_sample=None, truth=truth)
    fixed_launches = dict(_build.LAUNCHES)
    say(f"4i(a) rls HNSW fixed beam through run_benchmark ({smi}): "
        f"recall@{TOPK} {res.avg_recall} {hnsw_predicted('4i(a) fixed')}, "
        f"{res.qps} QPS {hnsw_predicted('4i(a) fixed QPS')} over "
        f"{workload.num_queries} queries (pass walls ms "
        f"{[round(w, 3) for w in res.extra['pass_walls_ms']]}), batch-1 p50 "
        f"{res.p50_ms} ms p95 {res.p95_ms} ms, storage "
        f"{res.storage['total_mb']:.1f} MB; launches "
        f"{ {k: v for k, v in fixed_launches.items() if v} }")
    q, users = workload.vectors, workload.user_ids
    ways = hnsw_ways("4i(a)", ix, arena, "l2", q, users, world, corpus, TOPK,
                     truth, ("fixed", "filtered", "sampled"), smi)
    for way, (_, _, counts, _) in ways.items():
        add(counts)
    if not ways["sampled"][2].get("graph_search"):
        fail("4i(a): the sampled entries did not launch the fused search")
    fused_chunk("4i(a) sampled", ways["sampled"][3], smi)
    del searcher, ix, ways
    gc.collect()
    torch.cuda.empty_cache()

    # (b) the inner-product form on an int8 ip arena of the same corpus
    t0 = time.perf_counter()
    ip_arena = build_device_arena(corpus, world, device=device,
                                  block_rows=BLOCK_ROWS, dtype="int8",
                                  metric="ip")
    if not ip_arena.quant.lossless:
        fail("4i(b): the SIFT ip arena's int8 mirror is not lossless")
    rows = np.arange(HNSW_IP_ROWS, dtype=np.int64)
    arena_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    ix = hnsw_mod.HNSWIndex(ip_arena, rows, m=16, query_batch=HNSW_CHUNK)
    build_s = time.perf_counter() - t0
    say(f"4i(b) ip HNSW on the MIPS lift over the first {len(rows)} rows "
        f"(builder {ix.builder}, packed rows {ix.use_packed}, {smi}): arena "
        f"{arena_s:.1f} s, build {build_s:.2f} s (concurrent with 4i(e)'s "
        f"builds where they still run) "
        f"{hnsw_predicted('4i(b) build s')}")
    if not ix.use_packed:
        fail("4i(b): the lossless ip arena does not take packed rows")
    ip_truth = subset_truth(ip_arena, rows, q, world.user_masks[users], "ip",
                            TOPK, device)
    ways = hnsw_ways("4i(b)", ix, ip_arena, "ip", q, users, world, corpus,
                     TOPK, ip_truth, ("sampled",), smi)
    counts = ways["sampled"][2]
    add(counts)
    if not counts.get("graph_search") or not counts.get("graph_search_ip"):
        fail(f"4i(b): the fused search's ip form did not launch: {counts}")
    row, bound, (args, kw) = fused_chunk("4i(b) sampled",
                                         ways["sampled"][3], smi)
    _build.reset_launches()
    got_h = graph_search.graph_beam_search_iterative(*args[:10], True, **kw)
    counts = dict(_build.LAUNCHES)
    want_h = graph_search.graph_beam_search_iterative_plain(*args[:10], True,
                                                            **kw)
    torch.cuda.synchronize()
    add(counts)
    same_h = all(torch.equal(a, b) for a, b in zip(got_h, want_h))
    say(f"4i(b) harvest leg (one {args[0].shape[0]}-query chunk, 2-hop "
        f"harvest, the step loop, ip) ({smi}): equal to its plain loop "
        f"{same_h}; launches { {k: v for k, v in counts.items() if v} }")
    idle = [k for k in ("graph_score", "graph_score_ip", "graph_merge")
            if not counts[k]]
    if not same_h or idle or counts["graph_search"]:
        fail(f"4i(b) harvest: equal {same_h}, launches {counts}")
    del ix, ip_arena, ways, args, kw, got_h, want_h
    gc.collect()
    torch.cuda.empty_cache()
    say(f"phase 4i (a)-(b): {time.perf_counter() - t4i:.1f} s "
        f"{hnsw_predicted('4i(a)-(b) s')} ({smi})")
    return launches, {"graph_search_ip": row}, {"graph_search_ip": bound}


def drive_hnsw_cut(name, arena, n_rows, metric, workload, world, corpus,
                   device, smi):
    """Phase 4i (c) and (d): an HNSW graph over the first n_rows of an
    arena (the "tpu" builder with the exact device kNN), the fixed beam and
    the sampled entries (the unpacked step loop: KS6 on the card) over the
    workload, top-100, against an exact oracle over those rows. Returns the
    launches."""
    import numpy as np
    import torch

    from vectorsearch_rbac_tpu_torch.index.hnsw import HNSWIndex
    from vectorsearch_rbac_tpu_torch.ops import _build

    t0 = time.perf_counter()
    rows = np.arange(n_rows, dtype=np.int64)
    ix = HNSWIndex(arena, rows, m=16, query_batch=HNSW_CHUNK)
    build_s = time.perf_counter() - t0
    say(f"{name} HNSW over the first {n_rows} rows x {arena.dim} ({metric}, "
        f"builder {ix.builder}, packed rows {ix.use_packed}, {smi}): build "
        f"{build_s:.2f} s {hnsw_predicted(name + ' build s')}")
    q, users = workload.vectors, workload.user_ids
    truth = subset_truth(arena, rows, q, world.user_masks[users], metric,
                         TOPK, device)
    ways = hnsw_ways(name, ix, arena, metric, q, users, world, corpus, TOPK,
                     truth, ("fixed", "sampled"), smi)
    if ix.use_packed or not ways["sampled"][2].get("graph_merge"):
        fail(f"{name}: the sampled entries did not take the unpacked step "
             f"loop: {ways['sampled'][2]}")
    launches = {k: 0 for k in _build.LAUNCHES}
    for _, _, counts, _ in ways.values():
        for key, v in counts.items():
            launches[key] += v
    del ix, ways
    gc.collect()
    torch.cuda.empty_cache()
    return launches


def start_hnsw_partitioned(device):
    """Phase 4i (e)'s data (a 131,072-row SIFT-like corpus under the
    100-role tree world, 1,024 queries, its int8 arena and exact top-10)
    and its two single-graph builds over the first 65,536 rows, the ACORN
    builder (m 16, m_beta 64) and the classic one, started in two threads
    (the native builders release the GIL) so that they run beside phase
    4i (a)-(b). Returns the job for drive_hnsw_partitioned."""
    import numpy as np

    from vectorsearch_rbac_tpu_torch.bench import (
        GroundTruthOracle, compute_truth_sample, make_scenario)
    from vectorsearch_rbac_tpu_torch.core import build_device_arena
    from vectorsearch_rbac_tpu_torch.index.hnsw import HNSWIndex

    t0 = time.perf_counter()
    corpus, world, workload = make_scenario(
        n=HNSW_CUT_ROWS, num_queries=HNSW_PART_QUERIES, topk=PART_TOPK,
        seed=0)
    arena = build_device_arena(corpus, world, device=device,
                               block_rows=BLOCK_ROWS, dtype="int8")
    gt = build_device_arena(corpus, world, device=device, block_rows=65536,
                            dtype="float32")
    truth = compute_truth_sample(GroundTruthOracle(gt, block_rows=65536,
                                                   query_batch=1024),
                                 corpus, world, workload, PART_TOPK,
                                 recall_sample=None)
    del gt
    data_s = time.perf_counter() - t0
    rows = np.arange(HNSW_ACORN_ROWS, dtype=np.int64)
    pool = concurrent.futures.ThreadPoolExecutor(2)
    kw = dict(m=16, ef_search=HNSW_ACORN_EF, query_batch=HNSW_PART_QUERIES)
    return dict(corpus=corpus, world=world, workload=workload, arena=arena,
                truth=truth, data_s=data_s, rows=rows, pool=pool,
                t_builds=time.perf_counter(),
                acorn=pool.submit(HNSWIndex, arena, rows, builder="acorn",
                                  m_beta=64, **kw),
                classic=pool.submit(HNSWIndex, arena, rows,
                                    builder="classic", **kw))


def drive_hnsw_partitioned(job, device, smi):
    """Phase 4i (e) on start_hnsw_partitioned's data: ROLE, USER and
    QDTree with index kind hnsw (a graph a partition, the native builders
    in a thread pool) through run_benchmark, top-10, 1,024 queries; then
    the reference's ACORN contract on the two graphs built beside 4i
    (a)-(b): layer-0 lists m_beta wide and more than 1.5x the classic
    build's edges (held); the filtered traversal's recall on both graphs
    and the unfiltered top-1 found, each printed beside the reference
    test's floors, which it shows at 8,192 rows of 32 dimensions (both
    recalls above 0.75 and within 0.15 of each other, top-1 found on
    0.85 of the queries). Returns the launches."""
    import numpy as np
    import torch

    from vectorsearch_rbac_tpu_torch.bench import (run_benchmark,
                                                   serving_config)
    from vectorsearch_rbac_tpu_torch.bench.ground_truth import \
        per_query_recall
    from vectorsearch_rbac_tpu_torch.index.hnsw import HNSWIndex
    from vectorsearch_rbac_tpu_torch.ops import _build
    from vectorsearch_rbac_tpu_torch.partition import build_searcher

    corpus, world, workload = job["corpus"], job["world"], job["workload"]
    arena, truth = job["arena"], job["truth"]
    say(f"4i(e) data: {corpus.n} x {corpus.dim}, {world.num_roles} roles, "
        f"{workload.num_queries} queries: {job['data_s']:.1f} s; workload "
        f"hash {digest(workload.vectors, workload.user_ids)}, truth hash "
        f"{digest(truth)}")
    launches = {k: 0 for k in _build.LAUNCHES}
    for name in ("role", "user", "qdtree"):
        cfg = serving_config(seed=0, block_rows=BLOCK_ROWS, topk=PART_TOPK,
                             strategy=name, index="hnsw")
        kw = (dict(workload=workload, min_leaf=QD_MIN_LEAF,
                   max_depth=QD_MAX_DEPTH, radius_scale=QD_RADIUS_SCALE)
              if name == "qdtree" else {})
        t0 = time.perf_counter()
        searcher = build_searcher(name, corpus, world, arena, cfg, **kw)
        build_s = time.perf_counter() - t0
        if not all(isinstance(p.index, HNSWIndex)
                   for p in searcher.partitions.values()):
            fail(f"4i(e) {name}: not every partition serves a graph")
        # the timed pass's ids, kept for the readable check
        full, search_batch = {}, searcher.search_batch

        def keep_full(qv, uids, umasks, k, search_batch=search_batch,
                      full=full):
            out = search_batch(qv, uids, umasks, k)
            if len(qv) == workload.num_queries:
                full["ids"] = out[1]
            return out

        searcher.search_batch = keep_full
        _build.reset_launches()
        # one timed pass: ROLE's and USER's run 100 graphs' fixed beams
        # one after another, seconds a pass
        res = run_benchmark(searcher, corpus, world, workload, None,
                            k=PART_TOPK, warmup_runs=0, timed_batches=8,
                            timed_passes=1, recall_sample=None, truth=truth)
        for key, v in _build.LAUNCHES.items():
            launches[key] += v
        ids = full["ids"]
        check_readable(f"4i(e) {name}", ids, workload.user_ids, PART_TOPK,
                       corpus, world, arena)
        sizes = [len(p.rows) for p in searcher.partitions.values()]
        say(f"4i(e) {name} over HNSW ({corpus.n} x 128, l2, top-{PART_TOPK},"
            f" {smi}): build {build_s:.2f} s "
            f"{hnsw_predicted('4i(e) ' + name + ' build s')}, "
            f"{len(sizes)} graphs of {min(sizes)}-{max(sizes)} rows "
            f"({sum(sizes)} in all); recall@{PART_TOPK} {res.avg_recall} "
            f"{hnsw_predicted('4i(e) ' + name)}, {res.qps} QPS over "
            f"{workload.num_queries} queries (pass walls ms "
            f"{[round(w, 3) for w in res.extra['pass_walls_ms']]}), batch-1 "
            f"p50 {res.p50_ms} ms")
        del searcher
        gc.collect()
        torch.cuda.empty_cache()

    # the ACORN builder against the classic one over the first 65,536 rows
    t0 = time.perf_counter()
    acorn, classic = job["acorn"].result(), job["classic"].result()
    job["pool"].shutdown()
    waited = time.perf_counter() - t0
    rows = job["rows"]
    na = acorn.graph_state()["neighbors"]
    nc = classic.graph_state()["neighbors"]
    q, users = workload.vectors, workload.user_ids
    masks = world.user_masks[users]
    sub = subset_truth(arena, rows, q, masks, "l2", PART_TOPK, device)
    ones = np.full_like(masks, 0xFFFFFFFF)
    top1 = subset_truth(arena, rows, q, ones, "l2", 1, device)[:, 0]
    rec, hit = {}, {}
    for label, ix in (("acorn", acorn), ("classic", classic)):
        _build.reset_launches()
        d, i = ix.search(q, masks, PART_TOPK, filtered_traversal=True)
        for key, v in _build.LAUNCHES.items():
            launches[key] += v
        check_readable(f"4i(e) {label} filtered", i, users, PART_TOPK,
                       corpus, world, arena)
        hnsw_distances_ok(f"4i(e) {label} filtered", arena, "l2", q, i, d)
        rec[label] = float(np.mean(per_query_recall(i, sub)))
        _, i_all = ix.search(q, ones, PART_TOPK)
        hit[label] = float(np.mean([t in set(r)
                                    for t, r in zip(top1, i_all)]))
    band = (min(rec.values()) > 0.75
            and abs(rec["acorn"] - rec["classic"]) < 0.15)
    say(f"4i(e) ACORN builder (m 16, m_beta 64) over {len(rows)} rows "
        f"({smi}): builds, concurrent, {acorn.build_time_s:.2f} s (classic "
        f"{classic.build_time_s:.2f} s; both in threads beside 4i (a)-(b) "
        f"and each other, so neither time is the builder's alone; "
        f"waited {waited:.2f} s after ROLE/USER/QDTree); layer-0 width "
        f"{na.shape[1]}, edges {int((na >= 0).sum())} against the classic "
        f"build's {int((nc >= 0).sum())} ({nc.shape[1]} wide); at ef "
        f"{HNSW_ACORN_EF} the filtered traversal's recall@{PART_TOPK} "
        f"{rec['acorn']} {hnsw_predicted('4i(e) acorn filtered')} (classic "
        f"graph {rec['classic']}; within the reference's floors, above "
        f"0.75 and 0.15 apart: {band}); unfiltered top-1 found {hit['acorn']} on the dense graph "
        f"(classic {hit['classic']}; the reference's floor 0.85: "
        f"{hit['acorn'] >= 0.85})")
    if na.shape[1] != 64 or (na >= 0).sum() <= 1.5 * (nc >= 0).sum():
        fail(f"4i(e) ACORN: layer-0 width {na.shape[1]}, "
             f"{int((na >= 0).sum())} edges against {int((nc >= 0).sum())}")
    del acorn, classic, arena
    gc.collect()
    torch.cuda.empty_cache()
    return launches


# ---- phase 4j: online maintenance

def online_predicted(key: str) -> str:
    return (f"(predicted {ONLINE_PREDICTED[key]})" if key in ONLINE_PREDICTED
            else "")


def check_live(name, ids, arena, deleted) -> None:
    """Every returned row in range, none of `deleted`, and each still
    holding a role bit in `arena` (a tombstoned row holds none)."""
    import numpy as np

    got = ids[ids >= 0]
    if ids.min() < -1 or (len(got) and got.max() >= arena.n):
        fail(f"{name}: result ids out of range [{ids.min()}, {ids.max()}]")
    back = np.intersect1d(got, deleted)
    if len(back):
        fail(f"{name}: {len(back)} deleted rows returned, e.g. "
             f"{back[:5].tolist()}")
    dead = ~(arena.host_bits[got] != 0).any(axis=1)
    if dead.any():
        fail(f"{name}: {int(dead.sum())} returned rows hold no role bit")
    say(f"{name}: none of the {len(deleted)} deleted rows among the "
        f"{len(got)} returned, every one live")


def check_repaired(name, ix) -> None:
    """After delete_rows: the device graph and row map equal the host
    mirrors, the deleted nodes have empty lists and row map -1, and no live
    list holds one."""
    import numpy as np

    g, rm = ix._graph.cpu().numpy(), ix._row_map.cpu().numpy()
    dead = np.flatnonzero(ix._deleted_local)
    live = ~ix._deleted_local
    bad = [msg for ok, msg in (
        (np.array_equal(g, ix._hgraph), "device graph != host mirror"),
        (np.array_equal(rm, ix._hrmap), "device row map != host mirror"),
        ((g[dead] < 0).all(), "a deleted node keeps edges"),
        ((rm[dead] == -1).all(), "a deleted node keeps its row"),
        (not np.isin(g[live], dead).any(), "a live list holds a deleted "
                                           "node")) if not ok]
    if bad:
        fail(f"{name}: {bad}")
    say(f"{name}: {len(dead)} deleted nodes unreachable; device graph and "
        "row map equal the host mirrors")


def online_chunk(name, ix, queries, masks, smi):
    """A sampled-entry search of `ix` over `queries`, recorded, and its
    first chunk through the fused search and its plain loop
    (fused_chunk)."""
    from vectorsearch_rbac_tpu_torch.index import hnsw as hnsw_mod

    calls, restore = hnsw_recorder(hnsw_mod)
    try:
        ix.search(queries, masks, PART_TOPK, sampled_entry=True)
    finally:
        restore()
    return fused_chunk(name, calls, smi)


def drive_roles(corpus, world, plan, part_workload, device, smi):
    """Phase 4j (d): bench.online's role cycle on 4c's corpus, world and
    plan. Returns the launches of its two passes."""
    from vectorsearch_rbac_tpu_torch.bench import online, serving_config
    from vectorsearch_rbac_tpu_torch.ops import _build

    t0 = time.perf_counter()
    cfg = serving_config(seed=0, block_rows=BLOCK_ROWS, topk=PART_TOPK,
                         strategy="dynamic")
    cfg.optimizer.storage_alpha = PART_ALPHA
    cfg.optimizer.topk = PART_TOPK
    try:
        rep, served = online.role_cycle(corpus, world, plan, cfg, device,
                                        part_workload.vectors,
                                        part_workload.user_ids, PART_TOPK,
                                        block_rows=BLOCK_ROWS)
    except RuntimeError as e:
        fail(f"4j(d): {e}")
    check_readable("4j(d) after the role insert", served["ids"],
                   served["users"], PART_TOPK, corpus, served["world"],
                   served["arena"])
    wall = time.perf_counter() - t0
    say(f"4j(d) role cycle on 4c's plan ({smi}): " + ", ".join(
        f"{key} {v} {online_predicted('4j(d) ' + key)}".rstrip()
        for key, v in rep.items()) + f"; {wall:.1f} s "
        f"{online_predicted('4j(d) s')}")
    if rep["recall"] < RECALL_FLOOR:
        fail(f"4j(d): recall@{PART_TOPK} {rep['recall']:.4f} < "
             f"{RECALL_FLOOR} after the role insert")
    merged = ("scan_int8", "merge_extract", "merge_bitonic")
    idle = [k for k in merged if not rep["launches_tombstoned_pass"].get(k)]
    if rep["big_tier_partitions"]:
        idle += [f"{k} (the update's pass)" for k in merged
                 if not rep["launches_update_pass"].get(k)]
    if idle:
        fail(f"4j(d): never launched {idle}")
    return {k: rep["launches_update_pass"].get(k, 0)
            + rep["launches_tombstoned_pass"].get(k, 0) for k in
            _build.LAUNCHES}


def drive_online(device, smi):
    """Phase 4j (a)-(c) on bench.online's cell. Returns their searches'
    launches."""
    import numpy as np

    from vectorsearch_rbac_tpu_torch.bench import online
    from vectorsearch_rbac_tpu_torch.core import build_device_arena
    from vectorsearch_rbac_tpu_torch.index.hnsw import HNSWIndex
    from vectorsearch_rbac_tpu_torch.ops import _build

    launches = {k: 0 for k in _build.LAUNCHES}

    def counted(fn):
        _build.reset_launches()
        out = fn()
        for key, v in _build.LAUNCHES.items():
            launches[key] += v
        return out, {key: v for key, v in _build.LAUNCHES.items() if v}

    with open(os.path.join(HERE, "results", "online_insert_scale.json")) as f:
        record = json.load(f)
    t0 = time.perf_counter()
    cell = online.make_cell(device)
    n, k = cell.corpus.n, PART_TOPK
    truth_old = online.exact_topk(cell.arena, cell.queries, cell.n_old, k)
    truth_all = online.exact_topk(cell.arena, cell.queries, n, k)
    say(f"4j data: {n} x {cell.corpus.dim}, {cell.world.num_roles} roles, "
        f"float32 arena {cell.arena.n_padded} rows, {len(cell.queries)} "
        f"queries, full-access masks: {time.perf_counter() - t0:.1f} s; "
        f"workload hash {digest(cell.queries)}, truth hash "
        f"{digest(truth_old, truth_all)}")

    # (a) the float32 cell: HNSW build, insert, refine; IVF
    (rep_h, ix), got = counted(lambda: online.drive_hnsw(cell, truth_old,
                                                         truth_all))
    if not got.get("graph_merge"):
        fail(f"4j(a): the float32 arena's sampled-entry search never "
             f"launched KS6 (graph_merge): {got}")
    (rep_i, ivf), _ = counted(lambda: online.drive_ivf(cell, truth_old,
                                                       truth_all))
    for family, rep in (("hnsw", rep_h), ("ivf", rep_i)):
        say(f"4j(a) {family}, {cell.n_old} rows + {n - cell.n_old} inserted "
            f"({smi}): " + "; ".join(
                f"{key} {v} {online_predicted(family + ' ' + key)}".rstrip()
                + (f" [TPU v5e record {record[family][key]}]"
                   if key in record[family] else "")
                for key, v in rep.items())
            + (f"; launches {got}" if family == "hnsw" else ""))

    # (b) the refined graph over a lossless int8 arena: the fused search
    t0 = time.perf_counter()
    arena8 = build_device_arena(cell.corpus, cell.world, device=device,
                                block_rows=65536, dtype="int8")
    ix8 = HNSWIndex(arena8, rows=ix._hrmap[:ix.n_rows], m=ix.m,
                    ef_search=ix.ef_search, query_batch=HNSW_CHUNK,
                    graph_state=ix.graph_state())
    if not ix8.use_packed:
        fail("4j(b): the int8 arena's graph does not take the packed rows")
    (_, ids8), got = counted(lambda: ix8.search(
        cell.queries, cell.masks, k, sampled_entry=True))
    if not got.get("graph_search"):
        fail(f"4j(b): the fused search never launched: {got}")
    rec8 = online.recall_against(ids8, truth_all)
    rng = np.random.default_rng(ONLINE_CHUNK_SEED)
    q4 = cell.pool[rng.choice(len(cell.pool), HNSW_CHUNK)].astype(np.float32)
    m4 = np.full((HNSW_CHUNK, cell.world.words), 0xFFFFFFFF, np.uint32)
    row, bnd, _ = online_chunk("4j(b) the grown, refined graph", ix8, q4, m4,
                               smi)
    say(f"4j(b) int8 arena ({smi}): recall@{k} {rec8} "
        f"{online_predicted('4j(b) recall')} (the float32 arena's after "
        f"refine {rep_h['recall_after_refine']}); fused chunk {row[2]:.3f} "
        f"ms {online_predicted('4j(b) fused chunk ms')}, plain "
        f"{row[3]:.3f} ms, bound {bnd[0]:.6f} ms; launches {got}; "
        f"{time.perf_counter() - t0:.1f} s")

    # (c) delete inserted rows: tombstone, graph repair, IVF slots
    dels = np.sort(np.random.default_rng(0).choice(
        np.arange(cell.n_old, n), ONLINE_DELETE, replace=False))
    arena_f, rep_f = online.delete_leg(cell.arena, dels, [ix], [ivf])
    arena_8, rep_8 = online.delete_leg(arena8, dels, [ix8])
    truth_rem = online.exact_topk(cell.arena, cell.queries, n, k,
                                  excluded=dels)
    for name, r in (("float32", rep_f), ("int8", rep_8)):
        say(f"4j(c) delete {ONLINE_DELETE} inserted rows, {name} arena "
            f"({smi}): tombstone {r['tombstone_s']:.4f} s; HNSW "
            + ", ".join(f"{key} {v} {online_predicted('4j(c) ' + key)}"
                        .rstrip() for key, v in r["hnsw"][0].items())
            + "".join(f"; IVF {key} {v}" for key, v in
                      (r["ivf"][0].items() if r["ivf"] else ())))
        if r["hnsw"][0]["deleted"] != ONLINE_DELETE:
            fail(f"4j(c): HNSW deleted {r['hnsw'][0]['deleted']} rows")
    if rep_f["ivf"][0]["deleted"] != ONLINE_DELETE:
        fail(f"4j(c): IVF freed {rep_f['ivf'][0]['deleted']} slots")
    check_repaired("4j(c) float32 graph", ix)
    check_repaired("4j(c) int8 graph", ix8)
    for name, index, arena_, kw in (
            ("hnsw float32", ix, arena_f, dict(sampled_entry=True)),
            ("hnsw int8 (fused)", ix8, arena_8, dict(sampled_entry=True)),
            ("ivf", ivf, arena_f, {})):
        (_, got_ids), got = counted(lambda: index.search(
            cell.queries, cell.masks, k, **kw))
        check_live(f"4j(c) {name}", got_ids, arena_, dels)
        say(f"4j(c) {name} after the delete ({smi}): recall@{k} against "
            f"the remaining rows {online.recall_against(got_ids, truth_rem)} "
            f"{online_predicted('4j(c) recall') if 'hnsw' in name else ''}"
            f"; launches {got}")
    online_chunk("4j(c) the repaired graph", ix8, q4, m4, smi)
    return launches


# ---- phase 4k: snapshots and the CLI

def arenas_equal(a, b) -> list:
    """The names of the DeviceArena fields where b differs from a."""
    import numpy as np
    import torch

    pairs = {
        "vectors_q": (a.quant.vectors_q, b.quant.vectors_q),
        "norms_q": (a.quant.norms_q, b.quant.norms_q),
        "role_bits": (a.role_bits, b.role_bits),
        "vectors": (a.vectors, b.vectors), "norms": (a.norms, b.norms)}
    bad = [k for k, (x, y) in pairs.items()
           if x.dtype != y.dtype or not torch.equal(x, y)]
    for k in ("host_bits", "host_vectors", "host_norms", "doc_ids",
              "block_ids"):
        if not np.array_equal(getattr(a, k), getattr(b, k)):
            bad.append(k)
    for k in ("n", "metric"):
        if getattr(a, k) != getattr(b, k):
            bad.append(k)
    qa, qb = a.quant, b.quant
    if (qa.scale, qa.lossless, qa.qclip) != (qb.scale, qb.lossless, qb.qclip) \
            or not np.array_equal(qa.center, qb.center):
        bad.append("quant params")
    return bad


def drive_snapshots(corpus, world, arena, plan, workload, part_workload,
                    cfg, device, smi):
    """Phase 4k (a): 4c's arena saved and restored (utils.persist) and held
    equal field by field; 4c's ROLE and AnonySys TiledSearchers (the
    latter on 4c's plan: its big tier runs the kernels) saved light and
    packed and restored over the restored arena, each restored engine's
    ids and distances on 4c's 4,096 queries bit-equal to the live one's;
    an rls searcher over the restored arena with the SIFT path's ids digest
    on its 8,192 queries. Returns the restored engines' launches."""
    import shutil
    import tempfile

    import numpy as np
    import torch

    from vectorsearch_rbac_tpu_torch.bench import serving_config
    from vectorsearch_rbac_tpu_torch.ops import _build
    from vectorsearch_rbac_tpu_torch.partition import (TiledSearcher,
                                                       build_searcher)
    from vectorsearch_rbac_tpu_torch.utils.persist import (
        load_arena_snapshot, save_arena_snapshot)

    t4k = time.perf_counter()
    tmp = tempfile.mkdtemp(prefix="smoke_4k_")
    total = {k: 0 for k in _build.LAUNCHES}

    def count():
        for k, v in _build.LAUNCHES.items():
            total[k] += v
        return {k: v for k, v in _build.LAUNCHES.items() if v}

    try:
        t0 = time.perf_counter()
        save_arena_snapshot(arena, f"{tmp}/arena.npz")
        save_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        arena2 = load_arena_snapshot(f"{tmp}/arena.npz", device)
        torch.cuda.synchronize()
        load_s = time.perf_counter() - t0
        bad = arenas_equal(arena, arena2)
        if bad:
            fail(f"4k(a): the restored arena differs in {bad}")
        say(f"4k(a) arena snapshot ({smi}): "
            f"{os.path.getsize(f'{tmp}/arena.npz') / 1e6:.1f} MB, save "
            f"{save_s:.2f} s, load {load_s:.2f} s; every field equal")
        q, u, k = (part_workload.vectors, part_workload.user_ids,
                   PART_TOPK)
        for name in ("role", "dynamic"):
            pcfg = serving_config(seed=0, block_rows=BLOCK_ROWS,
                                  topk=PART_TOPK, strategy=name)
            live = build_searcher(name, corpus, world, arena, pcfg,
                                  **({"plan": plan} if name == "dynamic"
                                     else {}))
            want_d, want_i = live.search_batch(q, u, world.user_masks, k)
            for pack in (False, True):
                path = f"{tmp}/tiled_{name}_{int(pack)}.npz"
                t0 = time.perf_counter()
                live.save_snapshot(path, pack_arrays=pack)
                save_s = time.perf_counter() - t0
                t0 = time.perf_counter()
                got = TiledSearcher.from_snapshot(arena2, live.router, path)
                torch.cuda.synchronize()
                restore_s = time.perf_counter() - t0
                _build.reset_launches()
                d, i = got.search_batch(q, u, world.user_masks, k)
                fired = count()
                form = "packed" if pack else "light"
                if not (np.array_equal(i, want_i)
                        and np.array_equal(d, want_d)):
                    fail(f"4k(a) {name} {form}: the restored engine's "
                         f"results differ on {int((i != want_i).sum())} ids")
                check_readable(f"4k(a) {name} {form}", i, u, k, corpus,
                               world, arena2)
                say(f"4k(a) {name} TiledSearcher {form} snapshot ({smi}): "
                    f"{os.path.getsize(path) / 1e6:.1f} MB, save "
                    f"{save_s:.2f} s, restore {restore_s:.3f} s, "
                    f"{len(got._big)} big-tier partitions; ids and "
                    f"distances bit-equal to the live engine's on "
                    f"{len(u)} queries; launches {fired}")
                if name == "dynamic":
                    idle = [x for x in ("scan_int8", "merge_extract",
                                        "merge_bitonic") if not fired.get(x)]
                    if idle:
                        fail(f"4k(a) {name} {form}: never launched {idle}")
            del live
        for label, a in (("live", arena), ("restored", arena2)):
            searcher = build_searcher("rls", corpus, world, a, cfg)
            _build.reset_launches()
            _, ids = searcher.search_batch(workload.vectors,
                                           workload.user_ids,
                                           world.user_masks, TOPK)
            fired = count() if label == "restored" else None
            if label == "live":
                want = digest(ids)
            elif digest(ids) != want:
                fail(f"4k(a) rls over the restored arena: ids digest "
                     f"{digest(ids)} != the live arena's {want}")
            del searcher
        say(f"4k(a) rls over the restored arena: ids digest {want} equal to "
            f"the live arena's on {workload.num_queries} queries, top-{TOPK}"
            f"; launches {fired}")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    idle = [x for x in ("scan_int8", "scan_int8_slots", "merge_extract",
                        "merge_bitonic") if not total[x]]
    if idle:
        fail(f"4k(a): the restored state never launched {idle}")
    say(f"phase 4k (a): {time.perf_counter() - t4k:.1f} s ({smi})")
    return total


CLI_N = 200_000        # 4k(b): prepare --n
CLI_QUERIES = 1000     # generate-queries' default
CLI_SERVE_S, CLI_CLIENTS = 3, 16


def drive_cli(device, smi):
    """Phase 4k (b): the CLI end to end (cli.main) in a temporary artifact
    directory: prepare (the SIFT-like twin, CLI_N rows), generate-queries,
    plan-dynamic (alpha 2.0), compute-ground-truth, test RLS and AnonySys
    on the int8 arena (recall >= 0.95 against the exact oracle, every
    returned row readable: run_benchmark's per-query records), serve
    (CLI_SERVE_S s at CLI_CLIENTS clients), insert-role, delete-role of a
    role that orphans documents, rollback, and fit-params --index ivf over
    three nprobes; then one served batch through the BatchingServer held
    equal to search_batch on the same requests. Returns its launches."""
    import pickle
    import shutil
    import tempfile
    import threading

    import numpy as np

    import vectorsearch_rbac_tpu_torch.bench as bench_pkg
    from vectorsearch_rbac_tpu_torch import cli
    from vectorsearch_rbac_tpu_torch.config import FrameworkConfig
    from vectorsearch_rbac_tpu_torch.core import build_device_arena
    from vectorsearch_rbac_tpu_torch.data import resolve_dataset
    from vectorsearch_rbac_tpu_torch.ops import _build
    from vectorsearch_rbac_tpu_torch.partition import build_searcher
    from vectorsearch_rbac_tpu_torch.partition.dynamic.maintenance import (
        orphaned_docs_after_role_delete)
    from vectorsearch_rbac_tpu_torch.serving import BatchingServer

    t4k = time.perf_counter()
    tmp = tempfile.mkdtemp(prefix="smoke_cli_")
    base = ["--artifacts", tmp, "--device", "cuda"]
    run_benchmark = bench_pkg.run_benchmark
    records = {}

    def recording(*args, **kw):   # the CLI's run_benchmark, per query
        kw["per_query_path"] = f"{tmp}/per_query.json"
        res = run_benchmark(*args, **kw)
        with open(kw["per_query_path"]) as f:
            records[args[0].name] = json.load(f)
        return res

    def state():
        with open(f"{tmp}/state.pkl", "rb") as f:
            return pickle.load(f)

    def readable(name, recs, world, corpus, arena):
        ids = np.full((len(recs), PART_TOPK), -1, np.int64)
        for j, r in enumerate(recs):
            ids[j, :len(r["result_rows"])] = r["result_rows"]
        users = np.asarray([r["user_id"] for r in recs])
        check_readable(name, ids, users, PART_TOPK, corpus, world, arena)

    steps = {}

    def step(name, argv):
        t0 = time.perf_counter()
        cli.main(base + argv)
        steps[name] = round(time.perf_counter() - t0, 2)

    _build.reset_launches()
    bench_pkg.run_benchmark = recording
    try:
        step("prepare", ["prepare", "--n", str(CLI_N)])
        step("generate-queries", ["generate-queries", "--num-queries",
                                  str(CLI_QUERIES), "--topk",
                                  str(PART_TOPK)])
        step("plan-dynamic", ["plan-dynamic", "--storage", str(PART_ALPHA)])
        step("compute-ground-truth", ["compute-ground-truth", "--topk",
                                      str(PART_TOPK)])
        st = state()
        corpus, _ = resolve_dataset(st["dataset"], num_vectors=st["n"],
                                    seed=st["seed"])
        world = st["world"]
        arena = build_device_arena(corpus, world, device=device,
                                   block_rows=65536, dtype="int8")
        test = ["--efs", "40", "--topk", str(PART_TOPK), "--dtype", "int8",
                "--storage", str(PART_ALPHA)]
        for algo in ("RLS", "AnonySys"):
            step(f"test {algo}", ["test", "--algorithm", algo, *test])
            with open(f"{tmp}/{algo.lower()}_results.json") as f:
                res = json.load(f)[-1]
            recs = records[cli.ALGORITHM_TO_STRATEGY[algo]]
            readable(f"4k(b) cli test {algo}", recs, world, corpus, arena)
            say(f"4k(b) cli test {algo} ({smi}): recall@{PART_TOPK} "
                f"{res['avg_recall']}, {res['qps']} QPS, "
                f"{res['storage']['num_partitions']} partitions")
            if res["avg_recall"] < RECALL_FLOOR:
                fail(f"4k(b) cli test {algo}: recall {res['avg_recall']} < "
                     f"{RECALL_FLOOR}")
        step("serve", ["serve", "--clients", str(CLI_CLIENTS), "--duration",
                       str(CLI_SERVE_S), "--topk", str(PART_TOPK)])
        with open(f"{tmp}/serve_results.json") as f:
            served = json.load(f)
        if not served["requests"]:
            fail("4k(b) cli serve answered no request")
        step("insert-role", ["insert-role", "--seed", "11"])
        if state()["world"].num_roles != world.num_roles + 1:
            fail("4k(b) insert-role added no role")
        w1 = state()["world"]
        victim = next(r for r in range(world.num_roles)
                      if orphaned_docs_after_role_delete(w1, r))
        step("delete-role", ["delete-role", "--role", str(victim)])
        if victim in state()["world"].role_to_docs \
                or not state().get("tombstoned_docs"):
            fail("4k(b) delete-role left its role or orphaned nothing")
        step("rollback", ["rollback"])
        if victim not in state()["world"].role_to_docs:
            fail("4k(b) rollback did not restore the deleted role")
        step("fit-params ivf", ["fit-params", "--index", "ivf", "--efs", "4",
                                "16", "64", "--topk", str(PART_TOPK)])
        with open(f"{tmp}/parameter_ivf.json") as f:
            fitted = json.load(f)
        with open(f"{tmp}/model_validation.json") as f:
            mae = json.load(f)["recall_mae"]
        if fitted["family"] != "ivf_coverage":
            fail(f"4k(b) fit-params wrote the {fitted['family']} family")
    finally:
        bench_pkg.run_benchmark = run_benchmark
    launches = dict(_build.LAUNCHES)
    say(f"4k(b) cli serve ({smi}): {served['requests']} requests, "
        f"{served['qps']:.1f} QPS, p50 {served['p50_ms']:.2f} ms, p99 "
        f"{served['p99_ms']:.2f} ms, avg batch {served['avg_batch']:.1f}; "
        f"fit-params ivf: k {fitted['k']:.4f}, lam {fitted['lam']:.4g}, "
        f"sigma {fitted['sigma']:.4f}, recall MAE {mae:.4f}; steps (s) "
        f"{steps}; launches {launches}")
    idle = [x for x in ("scan_int8", "merge_extract", "merge_bitonic")
            if not launches[x]]
    if idle:
        fail(f"4k(b): the CLI's passes never launched {idle}")

    # one served batch against search_batch on the same requests; its
    # launches are counted from 0 and added to the CLI's
    _build.reset_launches()
    cli_cfg = FrameworkConfig(seed=0)
    cli_cfg.index.kind = "flat_approx"
    cli_cfg.search.wire_dist = "f32"
    searcher = build_searcher("rls", corpus, world, arena, cli_cfg)
    rng = np.random.default_rng(0)
    nq = 256
    qv = corpus.vectors[rng.integers(0, corpus.n, nq)]
    uids = rng.integers(0, world.num_users, nq)
    want_d, want_i = searcher.search_batch(qv, uids, world.user_masks,
                                           PART_TOPK)
    results = [None] * nq
    with BatchingServer(searcher, world.user_masks, max_batch=64,
                        max_wait_ms=5.0) as srv:
        def client(lo, hi):
            tickets = [srv.submit(qv[j], uids[j], PART_TOPK)
                       for j in range(lo, hi)]
            for j, tk in zip(range(lo, hi), tickets):
                results[j] = tk.result(timeout=120)

        threads = [threading.Thread(target=client, args=(s, s + 32))
                   for s in range(0, nq, 32)]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        stats = srv.stats()
    got_i = np.stack([r.row_ids for r in results])
    got_d = np.stack([r.dists for r in results])
    if not (np.array_equal(got_i, want_i) and np.array_equal(got_d, want_d)):
        fail(f"4k(b) served ids differ from search_batch's on "
             f"{int((got_i != want_i).any(1).sum())} of {nq} requests")
    check_readable("4k(b) served batch", got_i, uids, PART_TOPK, corpus,
                   world, arena)
    fired = {k: v for k, v in _build.LAUNCHES.items() if v}
    say(f"4k(b) BatchingServer: {nq} requests in {stats['dispatches']} "
        f"dispatches (avg batch {stats['avg_batch']:.1f}), ids equal to "
        f"search_batch's; launches {fired}")
    for k, v in _build.LAUNCHES.items():
        launches[k] += v
    shutil.rmtree(tmp, ignore_errors=True)
    say(f"phase 4k (b): {time.perf_counter() - t4k:.1f} s ({smi})")
    return launches


# ---- phase 4l: multi-device serving

def multi_predicted(key: str) -> str:
    return f"(predicted {MULTI_PREDICTED[key]})"


def passes(fn, n: int = 2):
    """One warm call of fn, then n timed ones: (the last result, mean
    host-clock seconds a call, the card synchronized around each)."""
    import torch

    out = fn()
    walls = []
    for _ in range(n):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
    return out, sum(walls) / len(walls)


def shard_kernels_identical(s4, queries, users, world):
    """4l(a): on every shard of the sharded flagship, K1 and the K3/K4
    merge against their plain versions on the shard's own operands, at the
    shape the timed pass launches them (every query, the shard's rows and
    group): {name: (identical, max_abs_err)} over the shards. These launches are comparisons: the caller's counts
    exclude them."""
    import numpy as np
    import torch

    from vectorsearch_rbac_tpu_torch.ops import merge, scan_int8

    quant = s4._quant
    dev = s4.mesh.devices[0][0]
    q8, _ = quant.quantize_queries(queries)
    q8 = torch.from_numpy(q8).to(dev)
    m = torch.from_numpy(np.ascontiguousarray(
        world.user_masks[users]).view(np.int32)).to(dev)
    keep = 8 * ((TOPK + 7) // 8)
    out = {"scan_int8": [True, 0], "merge_extract": [True, 0],
           "merge_bitonic": [True, 0]}

    def add(name, ok, err):
        out[name][0] &= bool(ok)
        out[name][1] = max(out[name][1], err)

    for s in range(s4.n_shards):
        args = (q8, quant.vectors_q.parts[0][s], quant.norms_q.parts[0][s],
                s4._bits.parts[0][s], m, s4._int8_group(), "l2",
                quant.score_shift)
        packed = scan_int8.int8_group_minima(*args)
        plain = scan_int8.int8_group_minima_plain(*args)
        y, meta = merge.extract_pairs(packed, 32, 16)
        y_p, meta_p = merge.extract_pairs_plain(packed, 32, 16)
        ys, gs = merge.bitonic_pairs(y, meta, keep)
        ys_p, gs_p = merge.bitonic_pairs_plain(y, meta, keep)
        torch.cuda.synchronize()
        live = y < scan_int8.EMPTY_I32
        add("scan_int8", torch.equal(packed, plain),
            max_abs_err(packed, plain))
        add("merge_extract", torch.equal(y, y_p)
            and torch.equal(meta[live], meta_p[live]), max_abs_err(y, y_p))
        add("merge_bitonic", torch.equal(ys, ys_p) and torch.equal(gs, gs_p),
            max(max_abs_err(ys, ys_p), max_abs_err(gs, gs_p)))
    return {k: tuple(v) for k, v in out.items()}


def drive_multi_device(corpus, world, arena, plan, hybrid, workload, truth,
                       part_workload, part_truth, device, smi):
    """Phase 4l: multi-device serving on a mesh of MESH_SHARDS shards, all
    on `device` (parallel/): (a) the sharded int8 flagship through
    ShardedGlobalSearcher on the 1M SIFT arena's corpus, against the same
    searcher on one device (recall, readable rows, QPS; K1, K3, K4 on every
    shard bit-identical to their plain versions); (b) the sharded float
    scan against the one-device scan; (c) one sharded k-means step against
    the one-device step; (d) ShardedTiledSearcher on 4c's AnonySys plan
    against the one-device TiledSearcher, both exact and without a big
    tier; (e) ShardedGraphSearcher in place of 4d's GraphProbeBatcher on
    4d's hybrid searcher; (f) the process axis, two processes on the same
    card over gloo, against the in-process two-shard mesh. Launch counts
    are set to 0 before each driven pass and read after it. Returns the
    phase's launch counts."""
    import numpy as np
    import torch

    from vectorsearch_rbac_tpu_torch.bench.ground_truth import (
        per_query_recall)
    from vectorsearch_rbac_tpu_torch.core import ArenaQuant, quantize_corpus
    from vectorsearch_rbac_tpu_torch.index.hnsw import HNSWIndex
    from vectorsearch_rbac_tpu_torch.ops import _build
    from vectorsearch_rbac_tpu_torch.ops.kmeans import (
        _update_step, kmeans_init, sharded_kmeans_step)
    from vectorsearch_rbac_tpu_torch.ops.scan import masked_scan_topk
    from vectorsearch_rbac_tpu_torch.parallel import (
        ShardedGlobalSearcher, ShardedGraphSearcher, ShardedTiledSearcher,
        make_mesh, shard_arena_arrays, sharded_masked_topk)
    from vectorsearch_rbac_tpu_torch.parallel.multihost import spawn_flagship
    from vectorsearch_rbac_tpu_torch.parallel.sharded import (
        shard_quant_arrays, shard_rows, sharded_int8_topk)
    from vectorsearch_rbac_tpu_torch.partition import TiledSearcher
    from vectorsearch_rbac_tpu_torch.partition.dynamic.materialize import (
        _plan_router)

    t4l = time.perf_counter()
    label = f"{MESH_SHARDS} shards on one H100"
    mesh = make_mesh(MESH_SHARDS, devices=[device] * MESH_SHARDS)
    one = make_mesh(1, devices=[device])
    say(f"phase 4l: a mesh of {MESH_SHARDS} shards, every one on {device} "
        f"({smi}): no collective crosses a card and no scale-out is "
        f"measured; each QPS is \"{label}\" beside one device")
    launches = {k: 0 for k in _build.LAUNCHES}

    def counted(fn):
        """fn() with the counts set to 0 just before and read just after;
        the phase's totals gain them."""
        _build.reset_launches()
        out = fn()
        torch.cuda.synchronize()
        got = dict(_build.LAUNCHES)
        for k, v in got.items():
            launches[k] += v
        return out, got

    q, users = workload.vectors, workload.user_ids

    # (a) the sharded int8 flagship
    t0 = time.perf_counter()
    s4 = ShardedGlobalSearcher(corpus, world, mesh=mesh, dtype="int8")
    s1 = ShardedGlobalSearcher(corpus, world, mesh=one, dtype="int8")
    build_s = time.perf_counter() - t0
    if s4._int8_group() != MESH_GROUP:
        fail(f"4l(a): a shard of {s4.npad // MESH_SHARDS} rows takes group "
             f"{s4._int8_group()}, not {MESH_GROUP}")
    ((d4, i4), wall4), la = counted(lambda: passes(
        lambda: s4.search_batch(q, users, world.user_masks, TOPK)))
    ((d1, i1), wall1), l1 = counted(lambda: passes(
        lambda: s1.search_batch(q, users, world.user_masks, TOPK)))
    rec4 = float(np.mean(per_query_recall(i4, truth)))
    rec1 = float(np.mean(per_query_recall(i1, truth)))
    check_readable(f"4l(a) sharded flagship ({label})", i4, users, TOPK,
                   corpus, world, arena)
    check_readable("4l(a) one device", i1, users, TOPK, corpus, world, arena)
    same = shard_kernels_identical(s4, q, users, world)
    nq = len(q)
    say(f"4l(a) sharded int8 flagship, {nq} queries, top-{TOPK}, "
        f"{s4.n_shards} x {s4.npad // s4.n_shards} rows, group "
        f"{s4._int8_group()} a shard ({label}; {smi}): recall@{TOPK} {rec4} "
        f"{multi_predicted('a recall')}, one device (group "
        f"{s1._int8_group()}) {rec1} {multi_predicted('a one recall')}; "
        f"{nq / wall4:.1f} QPS ({wall4 * 1e3:.3f} ms a pass) "
        f"{multi_predicted('a QPS')} against one device's {nq / wall1:.1f} "
        f"({wall1 * 1e3:.3f} ms) {multi_predicted('a one QPS')}; searchers "
        f"built in {build_s:.1f} s; launches sharded "
        f"{ {k: v for k, v in la.items() if v} }, one device "
        f"{ {k: v for k, v in l1.items() if v} }; on every shard (all "
        f"{nq} queries), tolerance 0, kernel vs plain "
        f"[identical, max_abs_err]: {same}")
    if rec4 < RECALL_FLOOR:
        fail(f"4l(a): sharded recall {rec4:.4f} < {RECALL_FLOOR}")
    idle = [k for k in ("scan_int8", "merge_extract", "merge_bitonic")
            if la[k] == 0]
    if idle:
        fail(f"4l(a): the sharded flagship never launched {idle}")
    if not all(ok for ok, _ in same.values()):
        fail(f"4l(a): a shard's kernels disagree with their plain versions "
             f"{same}")
    del s1, d1, i1
    torch.cuda.empty_cache()

    # (b) the sharded float scan against the one-device scan
    vb, nb, bb = shard_arena_arrays(mesh, arena.vectors, arena.norms,
                                    arena.role_bits)
    qf = torch.from_numpy(q).to(device)
    mq = torch.from_numpy(np.ascontiguousarray(
        world.user_masks[users]).view(np.int32)).to(device)
    (db, ib), wall_b4 = passes(lambda: sharded_masked_topk(
        mesh, qf, vb, nb, bb, mq, TOPK, block_rows=MULTI_BLOCK))
    (do, io), wall_b1 = passes(lambda: masked_scan_topk(
        qf, arena.vectors, arena.norms, arena.role_bits, mq, TOPK,
        block_rows=MULTI_BLOCK))
    db, do = db.cpu().numpy(), do.cpu().numpy()
    fin = np.isfinite(do)
    ok_b = bool((np.isfinite(db) == fin).all() and np.allclose(
        db[fin], do[fin], rtol=1e-5, atol=0))
    rec_b = float(np.mean(per_query_recall(ib.cpu().numpy(), truth)))
    say(f"4l(b) sharded float scan ({arena.vectors.dtype} mirror, exact on "
        f"the integer SIFT rows), {nq} queries, top-{TOPK}, block "
        f"{MULTI_BLOCK} ({label}; {smi}): distances equal to one device's "
        f"within rtol 1e-5 {ok_b}, max abs diff "
        f"{float(np.abs(db[fin] - do[fin]).max()) if fin.any() else 0.0}; "
        f"recall@{TOPK} {rec_b}; {nq / wall_b4:.1f} QPS "
        f"{multi_predicted('b QPS')} against one device's "
        f"{nq / wall_b1:.1f} {multi_predicted('b one QPS')}")
    if not ok_b:
        fail("4l(b): the sharded float scan's distances differ from one "
             "device's")
    del vb, nb, bb, db, ib, do, io, qf, mq
    torch.cuda.empty_cache()

    # (c) one sharded k-means step over the corpus's 1M rows
    init = torch.from_numpy(kmeans_init(corpus.vectors, KMEANS_C, seed=0))
    xs = shard_rows(mesh, corpus.vectors)
    (c4, a4), t_c4 = passes(lambda: sharded_kmeans_step(mesh, xs, init), 1)
    xd = torch.from_numpy(corpus.vectors).to(device)
    (c1, a1), t_c1 = passes(lambda: _update_step(xd, init.to(device)), 1)
    c4, c1 = c4.gather().numpy(), c1.cpu().numpy()
    ok_c = bool(np.allclose(c4, c1, rtol=1e-4, atol=1e-4))
    same_a = bool(torch.equal(a4.gather(), a1.cpu()))
    say(f"4l(c) sharded k-means step, {corpus.n} x {corpus.dim} rows, C "
        f"{KMEANS_C} ({label}; {smi}): centroids equal to one device's "
        f"within rtol/atol 1e-4 {ok_c} (max abs diff "
        f"{float(np.abs(c4 - c1).max())}), assignments equal {same_a}; "
        f"{t_c4 * 1e3:.3f} ms a step {multi_predicted('c ms')} against one "
        f"device's {t_c1 * 1e3:.3f} {multi_predicted('c one ms')}")
    if not ok_c:
        fail("4l(c): the sharded k-means step's centroids differ from one "
             "device's")
    del xs, xd, a4, a1
    torch.cuda.empty_cache()

    # (d) ShardedTiledSearcher on 4c's AnonySys plan
    partition_rows = {}
    for pid, docs in sorted(plan.assignment.items()):
        rows = corpus.rows_for_docs(np.fromiter(docs, dtype=np.int64,
                                                count=len(docs)))
        if len(rows):
            partition_rows[pid] = rows
    router = _plan_router(plan, world, partition_rows)
    t0 = time.perf_counter()
    tiled4 = ShardedTiledSearcher(
        arena, partition_rows, router, mesh, name="dynamic_sharded",
        partition_weights={p: len(r) for p, r in partition_rows.items()},
        scan_group=0)
    tiled1 = TiledSearcher(arena, partition_rows, router, name="dynamic",
                           big_chunks=1 << 30, scan_group=0)
    tiled_s = time.perf_counter() - t0
    pq, pu = part_workload.vectors, part_workload.user_ids
    (dt4, it4), wall_d4 = passes(lambda: tiled4.search_batch(
        pq, pu, world.user_masks, PART_TOPK), 1)
    (dt1, it1), wall_d1 = passes(lambda: tiled1.search_batch(
        pq, pu, world.user_masks, PART_TOPK), 1)
    ok_d = bool(np.allclose(dt4, dt1, rtol=1e-5, atol=1e-5))
    loads = [sum(len(partition_rows[p]) for p, devs in tiled4.placement.items()
                 if devs[0] == d) for d in range(MESH_SHARDS)]
    check_readable("4l(d) sharded tiled", it4, pu, PART_TOPK, corpus, world,
                   arena)
    say(f"4l(d) ShardedTiledSearcher on 4c's AnonySys plan ({len(
        partition_rows)} partitions, rows a shard {loads}, exact epilogue), "
        f"{len(pq)} queries, top-{PART_TOPK} ({label}; {smi}): distances "
        f"equal to the one-device TiledSearcher's (no big tier) within "
        f"1e-5 {ok_d}; recall@{PART_TOPK} "
        f"{float(np.mean(per_query_recall(it4, part_truth)))}; "
        f"{len(pq) / wall_d4:.1f} QPS {multi_predicted('d QPS')} against "
        f"one device's {len(pq) / wall_d1:.1f} "
        f"{multi_predicted('d one QPS')}; both built in {tiled_s:.1f} s")
    if not ok_d:
        fail("4l(d): the sharded tiled searcher's distances differ from one "
             "device's")
    del tiled4, tiled1
    torch.cuda.empty_cache()

    # (e) ShardedGraphSearcher in place of 4d's GraphProbeBatcher
    batcher = hybrid.graph_batcher
    recorded = []

    def recording_run(queries, qmasks, jobs, k):
        recorded.append((queries, qmasks, jobs, k))
        return type(batcher).run(batcher, queries, qmasks, jobs, k)

    batcher.run = recording_run
    try:
        (de1, ie1), wall_e1 = passes(lambda: hybrid.search_batch(
            pq, pu, world.user_masks, PART_TOPK), 1)
    finally:
        del batcher.run
    gparts = {pid: p.index for pid, p in hybrid.partitions.items()
              if isinstance(p.index, HNSWIndex)}
    graph4 = ShardedGraphSearcher(
        arena, {pid: {"neighbors": ix._hgraph, "entry": ix.entry,
                      "row_map": ix._hrmap} for pid, ix in gparts.items()},
        mesh, partition_weights={pid: float(len(hybrid.partitions[pid].rows))
                                 for pid in gparts})
    hybrid.graph_batcher = graph4
    try:
        ((de4, ie4), wall_e4), le = counted(lambda: passes(
            lambda: hybrid.search_batch(pq, pu, world.user_masks,
                                        PART_TOPK), 1))
    finally:
        hybrid.graph_batcher = batcher
    queries_e, qmasks_e, jobs_e, k_e = recorded[-1]
    r1 = batcher.run(queries_e, qmasks_e, jobs_e, k_e)
    r4 = graph4.run(queries_e, qmasks_e, jobs_e, k_e)
    ok_jobs = all(np.array_equal(a[1], b[1]) for a, b in zip(r1, r4))
    ok_e = bool(np.array_equal(ie4, ie1) and np.array_equal(de4, de1))
    per_dev = [sum(1 for dv, _ in graph4.slot_of.values() if dv == d)
               for d in range(MESH_SHARDS)]
    check_readable("4l(e) sharded graphs", ie4, pu, PART_TOPK, corpus, world,
                   arena)
    say(f"4l(e) ShardedGraphSearcher in place of 4d's GraphProbeBatcher "
        f"({len(gparts)} graph partitions, a shard {per_dev}, "
        f"{'packed' if graph4.packed else 'arena'} rows; {label}; {smi}): "
        f"ids equal to the batcher's job for job, array for array, "
        f"{ok_jobs} ({len(jobs_e)} probe jobs); the searcher's ids and "
        f"distances equal {ok_e}; {len(pq) / wall_e4:.1f} QPS "
        f"{multi_predicted('e QPS')} against one device's "
        f"{len(pq) / wall_e1:.1f} {multi_predicted('e one QPS')}; launches "
        f"{ {k: v for k, v in le.items() if v} }")
    if not (ok_jobs and ok_e):
        fail("4l(e): the sharded graph searcher's ids differ from the "
             "batcher's")
    if le["graph_search"] == 0:
        fail("4l(e): the sharded graph searcher never launched the fused "
             "graph search")
    del graph4, recorded
    torch.cuda.empty_cache()

    # (f) the process axis: two processes on this card over gloo, each
    # ingesting half of MULTI_ROWS rows, against the in-process two-shard
    # mesh on the same rows
    quant = arena.quant
    vec_f = corpus.vectors[:MULTI_ROWS]
    bits_f = arena.host_bits[:MULTI_ROWS]
    q_f = q[:MULTI_QUERIES]
    qb_f = world.user_masks[users[:MULTI_QUERIES]]
    hint = (quant.scale, quant.center, quant.qclip)
    t0 = time.perf_counter()
    ranks = spawn_flagship(2, 1, str(device), "gloo", vec_f, bits_f, q_f,
                           qb_f, hint, TOPK, MULTI_GROUP, 4096,
                           timeout_s=60.0, deadline_s=MULTI_DEADLINE_S)
    spawn_s = time.perf_counter() - t0
    mesh2 = make_mesh(2, devices=[device] * 2)
    xq, nq_, scale, center, _, qclip = quantize_corpus(vec_f, MULTI_ROWS)
    if (scale, qclip) != (quant.scale, quant.qclip) or not np.array_equal(
            center, quant.center):
        fail("4l(f): the cut's quantization is not the arena's")
    vq, nqd, bd = shard_quant_arrays(mesh2, xq, nq_, bits_f)
    q8, qn = ArenaQuant(vectors_q=vq, norms_q=nqd, scale=scale,
                        center=center, lossless=True,
                        qclip=qclip).quantize_queries(q_f)
    (df, if_), lf = counted(lambda: sharded_int8_topk(
        mesh2, q8, qn, vq, nqd, bd, qb_f, 1.0 / scale**2, TOPK,
        group=MULTI_GROUP, score_shift=quant.score_shift))
    df, if_ = df.cpu().numpy(), if_.cpu().numpy()
    ok_f = all(np.array_equal(rd, df) and np.array_equal(ri, if_)
               for rd, ri in ranks)
    say(f"4l(f) the process axis: 2 processes on {device} over gloo "
        f"(candidates through host memory), each ingesting {MULTI_ROWS // 2}"
        f" of {MULTI_ROWS} SIFT rows through multihost_quant_arena, "
        f"{MULTI_QUERIES} queries, top-{TOPK}, group {MULTI_GROUP} ({smi}): "
        f"both ranks' ids and distances equal the in-process 2-shard "
        f"mesh's {ok_f}; the spawned run took {spawn_s:.1f} s "
        f"{multi_predicted('f s')} (the ranks' own launches count in their "
        f"processes, not here; the in-process mesh's "
        f"{ {k: v for k, v in lf.items() if v} }). NCCL with one rank a "
        f"card is not run: this machine has one card")
    if not ok_f:
        fail("4l(f): the two processes' results differ from the in-process "
             "mesh's")
    del vq, nqd, bd
    gc.collect()
    torch.cuda.empty_cache()
    say(f"phase 4l: {time.perf_counter() - t4l:.1f} s "
        f"{multi_predicted('4l s')} ({smi})")
    return launches


# ---- phase 4m: the evidence runners' cells at a cut size

def drive_evidence(device, smi):
    """Phase 4m: each evidence runner's cell function at EVIDENCE_ROWS
    rows: the crossover at d 128, selectivity 0.036 and 1.0, ladder ef 40
    and 80 (and the harvest legs at 0.036), EVIDENCE_QUERIES queries; IVF
    coverage over 2 selectivities x 4 nprobes; the binary 768-d cosine
    leg at multiplier 2; model validation over 2 sizes x 2 selectivities
    x 3 efs. Each
    runner raises where a returned row is not readable by its user, and
    nothing here catches it; each record must carry its script's keys.
    The counts are set to 0 before the phase and read after it; K1, K3,
    K4, the fused search and the harvest's KS6/KS7 must have launched.
    Returns the phase's launch counts."""
    import torch

    from vectorsearch_rbac_tpu_torch.bench import (binary_1m,
                                                   graph_crossover,
                                                   ivf_coverage,
                                                   model_validation)
    from vectorsearch_rbac_tpu_torch.data import resolve_dataset
    from vectorsearch_rbac_tpu_torch.ops import _build

    def keys(name, record, want):
        missing = set(want) - set(record)
        if missing:
            fail(f"4m {name}: the record lacks {sorted(missing)}")

    t4m = time.perf_counter()
    _build.reset_launches()
    t0 = time.perf_counter()
    corpus, pool = graph_crossover.corpus_for(EVIDENCE_ROWS, 128, seed=0)
    world = graph_crossover.make_world(corpus.num_docs, seed=1)
    out = {"config": graph_crossover.CONFIG, "cases": []}
    graph_crossover.measure_case(corpus, pool, world, {1: 0.036, 3: 1.0},
                                 out, device, efs=(40, 80),
                                 nq=EVIDENCE_QUERIES, tag="4m")
    if len(out["cases"]) != 2:
        fail(f"4m crossover: {len(out['cases'])} cells, not 2")
    for row in out["cases"]:
        keys("crossover", row, (
            "n", "d", "selectivity", "flat_qps", "flat_recall", "graph_qps",
            "graph_recall", "graph_ef", "graph_harvest", "graph_ladder",
            "graph_build_s", "winner", "graph_builder"))
        say(f"4m(a) crossover {row['n']} x {row['d']}, sel "
            f"{row['selectivity']}: flat {row['flat_qps']} QPS @ "
            f"{row['flat_recall']} ({row['flat_kernels']}) | graph "
            f"({row['graph_builder']}, built {row['graph_build_s']} s) "
            f"{row['graph_qps']} QPS @ {row['graph_recall']} -> "
            f"{row['winner']}; ladder " + json.dumps(row["graph_ladder"]))
    say(f"4m(a): {time.perf_counter() - t0:.1f} s")
    del corpus, pool, world
    gc.collect()
    torch.cuda.empty_cache()

    t0 = time.perf_counter()
    ivf = ivf_coverage.run(device, n=EVIDENCE_ROWS,
                           sizes=[EVIDENCE_ROWS], sels=[0.05, 0.25],
                           nprobes=[4, 8, 16, 32])
    keys("ivf", ivf, ("config", "cells", "heldout_recall_mae", "time_mape",
                      "hnsw_family_reference_mae"))
    for c in ivf["cells"]:
        keys("ivf cell", c, ("n", "sel", "nprobes", "measured_recall",
                             "predicted_recall", "measured_time_s",
                             "heldout_recall_mae", "time_mape", "fit"))
        say(f"4m(b) ivf coverage n={c['n']} nlist {c['nlist']} sel "
            f"{c['sel']}: recall {c['measured_recall']} at nprobe "
            f"{c['nprobes']}, held-out MAE {c['heldout_recall_mae']}, time "
            f"MAPE {c['time_mape']}")
    say(f"4m(b): {time.perf_counter() - t0:.1f} s")
    gc.collect()
    torch.cuda.empty_cache()

    t0 = time.perf_counter()
    corpus, pool = resolve_dataset("cohere", num_vectors=EVIDENCE_ROWS,
                                   seed=0)
    rows = binary_1m.run_leg(corpus, pool, "cosine", 2 * EVIDENCE_QUERIES,
                             binary_1m.K, EVIDENCE_QUERIES // 2, (2,),
                             device, "cohere768_cosine")
    keys("binary", rows.get("mult2", {}), (
        "rerank_mult", "recall_at_100", "qps", "pass_walls_s", "build_s",
        "bits_mb", "index_mb", "vector_copy_mb"))
    say(f"4m(c) binary 768-d cosine at {EVIDENCE_ROWS} rows: "
        f"{json.dumps(rows)}; {time.perf_counter() - t0:.1f} s")
    del corpus, pool
    gc.collect()
    torch.cuda.empty_cache()

    t0 = time.perf_counter()
    mv, tpu = model_validation.run(device, n=EVIDENCE_ROWS, sels=[0.1, 1.0],
                                   sizes=list(EVIDENCE_MV_SIZES),
                                   efs=list(EVIDENCE_MV_EFS))
    want = ("index", "params", "cells", "recall_mae", "time_mape",
            "fit_cell")
    keys("model validation", mv, want + ("corpus",))
    keys("model validation (TPU family)", tpu, want + ("family",))
    if len(mv["cells"]) != 4:
        fail(f"4m model validation: {len(mv['cells'])} cells, not 4")
    say(f"4m(d) model validation {list(EVIDENCE_MV_SIZES)} x [0.1, 1.0] x "
        f"ef {list(EVIDENCE_MV_EFS)}: recall "
        + str([[round(r, 4) for r in c["measured_recall"]]
               for c in mv["cells"]])
        + f"; reference family MAE {mv['recall_mae']:.4f}, MAPE "
        f"{mv['time_mape']:.3f}; TPU family MAE {tpu['recall_mae']:.4f}, "
        f"MAPE {tpu['time_mape']:.3f}; {time.perf_counter() - t0:.1f} s")
    torch.cuda.synchronize()
    launches = dict(_build.LAUNCHES)
    idle = [k for k in ("scan_int8", "merge_extract", "merge_bitonic",
                        "graph_search", "graph_score", "graph_merge")
            if not launches[k]]
    if idle:
        fail(f"4m: never launched {idle}")
    gc.collect()
    torch.cuda.empty_cache()
    say(f"phase 4m: {time.perf_counter() - t4m:.1f} s (predicted "
        f"{EVIDENCE_PREDICTED['4m s']}, after the cut "
        f"{EVIDENCE_PREDICTED_CUT['4m s']}); launches "
        f"{ {k: v for k, v in launches.items() if v} } ({smi})")
    return launches


def main() -> None:
    try:
        import torch
    except ImportError as e:
        fail(f"torch is not importable: {e}")
    if not torch.cuda.is_available():
        fail("no CUDA device: this smoke run measures the GPU port")
    try:
        import vectorsearch_rbac_tpu_torch as port
    except ImportError as e:
        fail(f"the port's package is not importable here: {e}")
    if not os.path.abspath(port.__file__).startswith(HERE + os.sep):
        fail(f"the port's package was found outside this checkout "
             f"({port.__file__})")

    # ---- 1. the card
    try:
        smi = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"],
            capture_output=True, text=True, check=True,
            timeout=60).stdout.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError) as e:
        fail(f"nvidia-smi did not report the card: {e}")
    device = torch.device("cuda", 0)
    say(f"card: {smi}")
    say(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"python {sys.version.split()[0]}, "
        f"{torch.cuda.get_device_name(device)} x {torch.cuda.device_count()}")

    # ---- 2. the kernel build
    from vectorsearch_rbac_tpu_torch.ops import _build

    t0 = time.perf_counter()
    so, log = _build.build()
    _build.lib()
    say(f"kernel build: {time.perf_counter() - t0:.2f} s -> "
        f"{os.path.relpath(so, HERE)}")
    for line in log.splitlines():
        if "registers" in line or "spill" in line or "Compiling" in line:
            say(f"  ptxas: {line.strip()}")

    import numpy as np

    from vectorsearch_rbac_tpu_torch.bench import (
        GroundTruthOracle, QueryWorkload, compute_truth_sample, make_scenario,
        serving_config)
    from vectorsearch_rbac_tpu_torch.core import build_device_arena
    from vectorsearch_rbac_tpu_torch.ops import scan_int8
    from vectorsearch_rbac_tpu_torch.ops.merge import merge_supported
    from vectorsearch_rbac_tpu_torch.partition import build_searcher

    cfg = serving_config(seed=0, block_rows=BLOCK_ROWS, batch=BATCH,
                         topk=TOPK)
    result = {}          # kernel -> (ok, max_abs_err, ms, plain_ms)
    extra = {}           # kernel -> (bound ms, bound_by, library ms)

    def oracle_truth(corpus, world, workload, metric, part_workload=None):
        """Exact top-TOPK of the workload (and top-PART_TOPK of
        part_workload) on a float32 arena, freed after."""
        t0 = time.perf_counter()
        gt_arena = build_device_arena(corpus, world, device=device,
                                      block_rows=65536, dtype="float32",
                                      metric=metric)
        oracle = GroundTruthOracle(gt_arena, block_rows=65536,
                                   query_batch=1024)
        truth = compute_truth_sample(oracle, corpus, world, workload, TOPK,
                                     recall_sample=None)
        part = (None if part_workload is None else compute_truth_sample(
            oracle, corpus, world, part_workload, PART_TOPK,
            recall_sample=None))
        say(f"exact {metric} oracle ({len(truth)} queries, float32 on the "
            f"card): {time.perf_counter() - t0:.1f} s")
        del oracle, gt_arena
        torch.cuda.empty_cache()
        return truth if part_workload is None else (truth, part)

    def batch_operands(arena, workload, world, metric):
        quant = arena.quant
        qv = workload.vectors[:BATCH]
        if metric == "l2":
            q8, _ = quant.quantize_queries(qv, with_norms=False)
        else:
            q8, _, _ = quant.quantize_queries_ip(
                qv, cosine=metric == "cosine")
        qbits = np.ascontiguousarray(
            world.user_masks[workload.user_ids[:BATCH]]).view(np.int32)
        return (torch.from_numpy(q8).to(device), quant.vectors_q,
                quant.norms_q, arena.role_bits,
                torch.from_numpy(qbits).to(device))

    # ---- the SIFT path: data, phase 3, phase 4
    t0 = time.perf_counter()
    corpus, world, workload = make_scenario(n=N_ROWS, num_queries=N_QUERIES,
                                            topk=TOPK, seed=0)
    arena = build_device_arena(corpus, world, device=device,
                               block_rows=BLOCK_ROWS, dtype="int8")
    say(f"SIFT data: {corpus.n} x {corpus.dim}, {world.num_roles} roles, "
        f"{world.num_users} users, {N_QUERIES} queries, arena "
        f"{arena.n_padded} rows: {time.perf_counter() - t0:.1f} s; workload "
        f"hash {digest(workload.vectors, workload.user_ids)}")

    scan_args = (*batch_operands(arena, workload, world, "l2"), GROUP, "l2",
                 arena.quant.score_shift)
    n_groups = arena.n_padded // GROUP
    if not merge_supported(n_groups, TOPK):
        fail(f"the merge gate refuses the SIFT path's shape ({n_groups} "
             f"groups, k {TOPK})")
    packed = scan_int8.int8_group_minima(*scan_args)
    packed_plain = scan_int8.int8_group_minima_plain(*scan_args)
    torch.cuda.synchronize()
    result["scan_int8"] = (
        torch.equal(packed, packed_plain), max_abs_err(packed, packed_plain),
        cuda_ms(lambda: scan_int8.int8_group_minima(*scan_args), 10),
        cuda_ms(lambda: scan_int8.int8_group_minima_plain(*scan_args), 3))
    extra["scan_int8"] = (*scan_bound(*scan_args[:5], packed), None)
    # K1's yardsticks on the same operands: K2 at d_pad 128, and the int32
    # dots alone
    k2 = scan_int8.int8_group_minima_wide(*scan_args)
    torch.cuda.synchronize()
    k2_same = torch.equal(k2, packed_plain)
    del k2
    k2_ms = cuda_ms(lambda: scan_int8.int8_group_minima_wide(*scan_args), 10)
    dots_ms = cuda_ms(lambda: dots_only(scan_args[0], scan_args[1]), 3)
    if not k2_same:
        fail("K2 at d_pad 128 disagrees with K1's plain minima")
    merges, keep, merge_extra = check_merge(packed, TOPK)
    result.update(merges)
    extra.update(merge_extra)
    report(f"kernel vs plain at Q={BATCH} x {arena.n_padded} rows x d_pad "
           f"128, group {GROUP}, nsub 32, t 16, keep {keep} ({smi}); "
           "tolerance 0: values bit-identical, extraction positions "
           "identical where the value is a candidate, sort metas identical "
           "in every row:",
           {k: result[k] for k in ("scan_int8", *merges)})
    result["scan_int8_slots"], extra["scan_int8_slots"] = check_slot_form(
        arena, workload, world, device, smi)
    torch.cuda.empty_cache()
    launches_lab, lab_rows, lab_extra = check_lab_path(scan_args, packed,
                                                       packed_plain, smi)
    result.update(lab_rows)
    extra.update(lab_extra)
    n_words = scan_args[3].shape[1]
    pairs = BATCH * arena.n_padded
    say(f"K1 yardsticks at Q={BATCH} x {arena.n_padded} rows x d_pad 128, "
        f"W {n_words}, group {GROUP} ({smi}): K1 "
        f"{result['scan_int8'][2]:.3f} ms; "
        f"K2 on the same operands {k2_ms:.3f} ms (identical to K1's plain "
        f"minima {k2_same}); dots only (torch._int_mm, 8 row chunks, int32 "
        f"dots out; not K1's function, so not its library_ms) {dots_ms:.3f}"
        f" ms; the first port's dp4a K1 {result['scan_int8_dp4a'][2]:.3f} "
        f"ms; bound {extra['scan_int8'][0]:.6f} ms ({extra['scan_int8'][1]})"
        f"; epilogue floor "
        f"{K1_EPI_OPS(n_words) * pairs / INT32_OPS_S * 1e3:.6f} ms "
        f"({K1_EPI_OPS(n_words)} integer operations a pair x {pairs} pairs at "
        f"{INT32_OPS_S:.4g} a second)")
    del packed, packed_plain
    torch.cuda.empty_cache()
    graph_rows, graph_extra = check_graph_step(arena, workload, world,
                                               device, smi)
    result.update(graph_rows)
    extra.update(graph_extra)
    torch.cuda.empty_cache()

    part_workload = QueryWorkload(
        vectors=workload.vectors[:PART_QUERIES],
        user_ids=workload.user_ids[:PART_QUERIES], topk=PART_TOPK,
        selectivities=workload.selectivities[:PART_QUERIES],
        repetitions=workload.repetitions[:PART_QUERIES])
    truth, part_truth = oracle_truth(corpus, world, workload, "l2",
                                     part_workload)
    say(f"SIFT ground-truth hash {digest(truth)}, top-{PART_TOPK} over the "
        f"first {PART_QUERIES} queries {digest(part_truth)}")
    searcher = build_searcher("rls", corpus, world, arena, cfg)
    launches_sift = drive_path(
        "SIFT (1M x 128, l2)", searcher, corpus, world, workload, truth,
        arena, ("scan_int8", "merge_extract", "merge_bitonic"), smi)
    ab_dedup("SIFT rls", [searcher.partitions[0].index],
             lambda: searcher.search_batch(workload.vectors,
                                           workload.user_ids,
                                           world.user_masks, TOPK), smi)
    check_wires("SIFT", searcher, workload, world, smi)
    del searcher
    gc.collect()
    torch.cuda.empty_cache()

    # ---- phase 4e: a 300-role tree world (10 bitset words) on the same
    # corpus: the scans' wide-world forms, then the rls path with
    # admit-dedup
    t0 = time.perf_counter()
    w_corpus, w_world, w_workload = make_scenario(
        n=N_ROWS, num_queries=N_QUERIES, topk=TOPK, seed=0,
        num_roles=WIDE_ROLES)
    w_arena = build_device_arena(w_corpus, w_world, device=device,
                                 block_rows=BLOCK_ROWS, dtype="int8")
    say(f"wide-world data: {w_world.num_roles} roles, {w_world.num_users} "
        f"users, {w_arena.role_bits.shape[1]} bitset words, "
        f"{len(np.unique(w_world.user_masks, axis=0))} distinct masks: "
        f"{time.perf_counter() - t0:.1f} s; workload hash "
        f"{digest(w_workload.vectors, w_workload.user_ids)}")
    if w_arena.role_bits.shape[1] != 10:
        fail(f"{WIDE_ROLES} roles in {w_arena.role_bits.shape[1]} words")
    for k, (ok, err) in check_wide_world(scan_args, w_arena, w_world,
                                         w_workload, device, smi).items():
        result[k] = (result[k][0] and ok, max(result[k][1], err),
                     *result[k][2:])
    w_truth = oracle_truth(w_corpus, w_world, w_workload, "l2")
    say(f"wide-world ground-truth hash {digest(w_truth)}")
    searcher = build_searcher("rls", w_corpus, w_world, w_arena, cfg)
    launches_wide_world = drive_path(
        f"wide world (1M x 128, {WIDE_ROLES} roles, l2)", searcher, w_corpus,
        w_world, w_workload, w_truth, w_arena,
        ("scan_int8", "scan_int8_slots", "merge_extract", "merge_bitonic"),
        smi)
    del searcher, w_corpus, w_world, w_workload, w_arena, w_truth
    gc.collect()
    torch.cuda.empty_cache()

    # ---- phase 4c: the partitioned strategies on the same corpus and arena
    launches_part = {k: 0 for k in launches_sift}
    grouped = False
    plan = None
    for name in ("role", "user", "dynamic", "qdtree"):
        pcfg = serving_config(seed=0, block_rows=BLOCK_ROWS, topk=PART_TOPK,
                              strategy=name)
        pcfg.optimizer.storage_alpha = PART_ALPHA
        pcfg.optimizer.topk = PART_TOPK
        kw = (dict(workload=part_workload, min_leaf=QD_MIN_LEAF,
                   max_depth=QD_MAX_DEPTH, radius_scale=QD_RADIUS_SCALE)
              if name == "qdtree" else {})
        t0 = time.perf_counter()
        searcher = build_searcher(name, corpus, world, arena, pcfg, **kw)
        build_s = time.perf_counter() - t0
        launches, g = drive_partitioned(
            f"{name} (1M x 128, l2, batch {pcfg.search.batch_size})",
            searcher, build_s, corpus, world, part_workload, part_truth,
            arena, smi)
        grouped |= g
        for k in launches_part:
            launches_part[k] += launches[k]
        if name == "qdtree":
            check_qdtree_tiers(searcher, launches, smi)
        if name == "dynamic":
            plan = searcher.plan
            ab_dedup("AnonySys", list(searcher._big.values()),
                     lambda: searcher.search_batch(
                         part_workload.vectors, part_workload.user_ids,
                         world.user_masks, PART_TOPK), smi)
        del searcher
        gc.collect()
        torch.cuda.empty_cache()
    idle = [k for k in ("scan_int8", "scan_int8_slots", "merge_extract",
                        "merge_bitonic") if launches_part[k] == 0]
    if idle:
        fail(f"the partitioned strategies never launched {idle}")
    if not grouped:
        fail("admit-dedup grouped no big-tier pass of the partitioned path")
    say(f"4d workload hash {digest(part_workload.vectors, part_workload.user_ids)}"
        f", truth hash {digest(part_truth)} (4c's)")
    launches_hybrid, graph_calls, hybrid = drive_hybrid(
        plan, corpus, world, arena, part_workload, part_truth, smi)
    search_rows, search_extra, launches_harvest = check_graph_search(
        graph_calls, smi)
    result.update(search_rows)
    extra.update(search_extra)
    del graph_calls
    gc.collect()
    torch.cuda.empty_cache()

    # ---- phase 4g: the IVF index (rls, nlist 1024, nprobe 16), on the
    # same corpus and arena
    drive_ivf(corpus, world, arena, workload, truth, smi)
    gc.collect()
    torch.cuda.empty_cache()

    # ---- phase 4i (a), (b), (e): HNSW under rls over the whole arena, the
    # ip form on an ip arena of the same corpus, and ROLE, USER, QDTree and
    # the ACORN builder on a 131,072-row corpus (its two graph builds run
    # in threads beside (a) and (b))
    hnsw_job = start_hnsw_partitioned(device)
    launches_4i, hnsw_rows, hnsw_extra = drive_hnsw_sift(
        corpus, world, arena, workload, truth, device, smi)
    result.update(hnsw_rows)
    extra.update(hnsw_extra)
    t0 = time.perf_counter()
    for key, v in drive_hnsw_partitioned(hnsw_job, device, smi).items():
        launches_4i[key] += v
    del hnsw_job
    say(f"phase 4i (e): {time.perf_counter() - t0:.1f} s ({smi})")

    # ---- phase 4j: online maintenance; (d) the role cycle on 4c's plan
    # while the SIFT corpus is alive, then (a)-(c) on bench.online's cell
    t4j = time.perf_counter()
    launches_4j = drive_roles(corpus, world, plan, part_workload, device,
                              smi)
    gc.collect()
    torch.cuda.empty_cache()
    for key, v in drive_online(device, smi).items():
        launches_4j[key] += v
    gc.collect()
    torch.cuda.empty_cache()
    say(f"phase 4j: {time.perf_counter() - t4j:.1f} s "
        f"{online_predicted('4j s')} ({smi})")

    # ---- phase 4k: (a) 4c's arena and TiledSearchers through their
    # snapshots, (b) the CLI end to end at CLI_N rows
    launches_4k = drive_snapshots(corpus, world, arena, plan, workload,
                                  part_workload, cfg, device, smi)
    gc.collect()
    torch.cuda.empty_cache()
    for key, v in drive_cli(device, smi).items():
        launches_4k[key] += v
    gc.collect()
    torch.cuda.empty_cache()

    # ---- phase 4l: multi-device serving on a mesh of 4 shards on this
    # card, over 4c's corpus, arena and plan and 4d's graphs
    launches_4l = drive_multi_device(corpus, world, arena, plan, hybrid,
                                     workload, truth, part_workload,
                                     part_truth, device, smi)
    del hybrid
    gc.collect()
    torch.cuda.empty_cache()

    # ---- phase 4h: the flat family's breadth (FlatIndex approx and exact
    # on bfloat16 and float32 arenas), the binary index, l1 on the
    # synthetic corpus, and the sparse index; the sparse corpus is drawn
    # in a worker process meanwhile
    t4h = time.perf_counter()
    sparse_job = start_sparse_corpus()
    drive_flat_family(corpus, world, workload, truth, device, smi)
    # free the SIFT arrays before the 768-d corpus (3 GB of float32)
    del corpus, world, workload, arena, truth, part_truth, scan_args
    gc.collect()
    torch.cuda.empty_cache()
    for key, v in drive_l1(device, smi).items():
        launches_4i[key] += v
    drive_sparse(sparse_job, device, smi)
    say(f"phase 4h: {time.perf_counter() - t4h:.1f} s ({smi})")
    gc.collect()

    # ---- phase 4m: the evidence runners' cells at a cut size
    launches_4m = drive_evidence(device, smi)

    # ---- the 768-d path: data, phase 3b, phase 4b
    t0 = time.perf_counter()
    corpus, world, workload = make_scenario(n=N_ROWS, num_queries=N_QUERIES,
                                            topk=TOPK, seed=0,
                                            dataset="cohere")
    t_data = time.perf_counter() - t0
    arena = build_device_arena(corpus, world, device=device,
                               block_rows=BLOCK_ROWS, dtype="int8",
                               metric="cosine")
    shift = arena.quant.score_shift
    say(f"cohere data: {corpus.n} x {corpus.dim}, {N_QUERIES} queries: "
        f"{t_data:.1f} s; cosine int8 arena {arena.n_padded} rows x d_pad "
        f"{arena.quant.d_pad}, score shift {shift}: "
        f"{time.perf_counter() - t0 - t_data:.1f} s; workload hash "
        f"{digest(workload.vectors, workload.user_ids)}")
    if shift != 3:
        fail(f"score shift {shift} at d_pad {arena.quant.d_pad}, not 3")

    wide_args = (*batch_operands(arena, workload, world, "cosine"), GROUP,
                 "ip", shift)
    kk = TOPK + RERANK_MARGIN
    if not merge_supported(arena.n_padded // GROUP, kk):
        fail(f"the merge gate refuses the 768-d path's shape (k {kk})")
    packed = scan_int8.int8_group_minima_wide(*wide_args)
    packed_plain = scan_int8.int8_group_minima_wide_plain(*wide_args)
    torch.cuda.synchronize()
    result["scan_int8_wide"] = (
        torch.equal(packed, packed_plain), max_abs_err(packed, packed_plain),
        cuda_ms(lambda: scan_int8.int8_group_minima_wide(*wide_args), 10),
        cuda_ms(lambda: scan_int8.int8_group_minima_wide_plain(*wide_args),
                3))
    extra["scan_int8_wide"] = (*scan_bound(*wide_args[:5], packed), None)
    # K2's wide-world forms (W 10, 32) and huge forms (W 64, 128): the
    # same bitsets with zero words appended (the same admissibility, so
    # the same minima), in turns with K2 at W 4
    k2_forms = {f"K2 W{w}": (*wide_args[:3], pad_words(wide_args[3], w),
                             pad_words(wide_args[4], w))
                for w in (10, 32, 64, 128)}
    k2_forms = {"K2 W4": wide_args[:5], **k2_forms}
    k2_kw = dict(group=GROUP, metric="ip", score_shift=shift)
    k2_same = {}
    for name in ("K2 W10", "K2 W32", "K2 W64", "K2 W128"):
        got = scan_int8.int8_group_minima_wide(*k2_forms[name], **k2_kw)
        torch.cuda.synchronize()
        k2_same[name] = torch.equal(got, packed_plain)
        del got
    k2_turns = {name: [] for name in k2_forms}
    for name in (*k2_forms, *reversed(k2_forms)):
        k2_turns[name].append(cuda_ms(
            lambda ops=k2_forms[name]: scan_int8.int8_group_minima_wide(
                *ops, **k2_kw), 10))
    say(f"K2's wide-world forms at Q={BATCH} x {arena.n_padded} rows x d_pad"
        f" {arena.quant.d_pad} ({smi}); tolerance 0: identical to the W 4 "
        f"plain minima {k2_same}; in turns (ms): "
        + ", ".join(f"{n} {ts}" for n, ts in k2_turns.items())
        + "; bounds (ms) " + ", ".join(
            f"{n} {scan_bound(*ops, packed)[0]:.6f}"
            for n, ops in k2_forms.items()))
    if not all(k2_same.values()):
        fail(f"K2's wide-world forms disagree: {k2_same}")
    del packed_plain

    say(f"dots only (torch._int_mm of the same int8 queries and rows, 8 "
        f"chunks of {wide_args[1].shape[0] // 8} rows, int32 dots out; no "
        f"epilogue, so not K2's function and not its library_ms) "
        f"{cuda_ms(lambda: dots_only(wide_args[0], wide_args[1]), 3):.3f} "
        f"ms against K2's "
        f"{result['scan_int8_wide'][2]:.3f} ms ({smi})")
    merges_kk, keep, _ = check_merge(packed, kk)
    report(f"kernel vs plain at Q={BATCH} x {arena.n_padded} rows x d_pad "
           f"{arena.quant.d_pad}, ip, shift {shift}, group {GROUP}; merge at "
           f"kk {kk}, keep {keep} ({smi}); tolerance 0 as above:",
           {"scan_int8_wide": result["scan_int8_wide"], **merges_kk})
    for k, (ok, err, _, _) in merges_kk.items():    # one row per kernel
        result[k] = (result[k][0] and ok, max(result[k][1], err),
                     *result[k][2:])
    del packed
    torch.cuda.empty_cache()
    launches_wide_lab, result["scan_int8_wide_slots"], \
        extra["scan_int8_wide_slots"] = check_wide_slots(
            wide_args, arena, world, device, TOPK, smi)
    del wide_args
    torch.cuda.empty_cache()

    truth = oracle_truth(corpus, world, workload, "cosine")
    say(f"cohere ground-truth hash {digest(truth)}")
    searcher = build_searcher("rls", corpus, world, arena, cfg)
    mode = searcher.partitions[0].index.rerank_mode
    if mode != "residual4":
        fail(f"the 768-d index reranks with {mode!r}, not 'residual4'")
    launches_wide = drive_path(
        "768-d (1M x 768, cosine)", searcher, corpus, world, workload, truth,
        arena, ("scan_int8_wide", "merge_extract", "merge_bitonic"), smi)
    check_wires("768-d", searcher, workload, world, smi)
    del searcher
    gc.collect()
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    for key, v in drive_hnsw_cut("4i(c) cosine", arena, HNSW_CUT_ROWS,
                                 "cosine", workload, world, corpus, device,
                                 smi).items():
        launches_4i[key] += v
    say(f"phase 4i (c): {time.perf_counter() - t0:.1f} s ({smi})")

    # ---- phase 4f: ROLE, USER, AnonySys (4c's plan: the same world at
    # alpha 2.0) and QDTree (built from the first 1,024 queries) through the
    # PackedSearcher on the cosine arena, 4096 queries, top-100
    p_workload = QueryWorkload(
        vectors=workload.vectors[:PART_QUERIES],
        user_ids=workload.user_ids[:PART_QUERIES], topk=TOPK,
        selectivities=workload.selectivities[:PART_QUERIES],
        repetitions=workload.repetitions[:PART_QUERIES])
    tree_workload = QueryWorkload(
        vectors=workload.vectors[:PACKED_TREE_QUERIES],
        user_ids=workload.user_ids[:PACKED_TREE_QUERIES], topk=TOPK,
        selectivities=workload.selectivities[:PACKED_TREE_QUERIES],
        repetitions=workload.repetitions[:PACKED_TREE_QUERIES])
    for name in ("role", "user", "dynamic", "qdtree"):
        pcfg = serving_config(seed=0, block_rows=BLOCK_ROWS, topk=TOPK,
                              strategy=name)
        pcfg.optimizer.storage_alpha = PART_ALPHA
        kw = (dict(workload=tree_workload, min_leaf=QD_MIN_LEAF,
                   max_depth=QD_MAX_DEPTH, radius_scale=QD_RADIUS_SCALE)
              if name == "qdtree" else
              dict(plan=plan) if name == "dynamic" else {})
        t0 = time.perf_counter()
        searcher = build_searcher(name, corpus, world, arena, pcfg, **kw)
        build_s = time.perf_counter() - t0
        drive_packed(f"packed {name} (1M x 768, cosine, batch "
                     f"{pcfg.search.batch_size})", searcher, build_s, corpus,
                     world, p_workload, truth[:PART_QUERIES], arena, smi)
        if name == "qdtree":
            say(f"packed qdtree tree: {len(searcher.tree.leaf_rows)} leaves,"
                f" route radius {searcher.tree.route_radius} (chord, unit "
                "vectors)")
        del searcher
        gc.collect()
        torch.cuda.empty_cache()
    del plan
    paths = (launches_sift, launches_wide_world, launches_part, launches_wide,
             launches_hybrid, launches_harvest, launches_lab,
             launches_wide_lab, launches_4i, launches_4j, launches_4k,
             launches_4l, launches_4m)
    launches = {k: sum(p[k] for p in paths) for k in launches_sift}

    loaded = [m for m in sys.modules
              if m.split(".")[0] in ("jax", "vectorsearch_rbac_tpu")]
    if loaded:
        fail(f"jax or the JAX package was imported: {sorted(loaded)[:5]}")

    sources = {
        "scan_int8": ("vectorsearch_rbac_tpu_torch/csrc/scan_int8.cu",
                      "vectorsearch_rbac_tpu/ops/pallas_scan_int8.py:40"),
        "scan_int8_slots": (
            "vectorsearch_rbac_tpu_torch/csrc/scan_int8.cu",
            "scripts/r4_admit_lab.py:98 (and vectorsearch_rbac_tpu/ops/"
            "pallas_scan_int8.py:40 with mask_sub_block)"),
        "scan_int8_wide": ("vectorsearch_rbac_tpu_torch/csrc/scan_int8_wide.cu",
                           "vectorsearch_rbac_tpu/ops/pallas_scan_int8.py:295"),
        "merge_extract": ("vectorsearch_rbac_tpu_torch/csrc/merge.cu",
                          "vectorsearch_rbac_tpu/ops/pallas_merge.py:55"),
        "merge_bitonic": ("vectorsearch_rbac_tpu_torch/csrc/merge.cu",
                          "vectorsearch_rbac_tpu/ops/pallas_merge.py:79"),
        "graph_search": ("vectorsearch_rbac_tpu_torch/csrc/graph_step.cu",
                         "vectorsearch_rbac_tpu/ops/graph_search.py:343 (its "
                         "lax.while_loop, :607) with scripts/"
                         "pallas_merge_probe.py:107 and scripts/"
                         "r5_graph_fused_probe.py:233"),
        "graph_merge": ("vectorsearch_rbac_tpu_torch/csrc/graph_step.cu",
                        "scripts/pallas_merge_probe.py:107"),
        "graph_score": ("vectorsearch_rbac_tpu_torch/csrc/graph_step.cu",
                        "scripts/r5_graph_fused_probe.py:233"),
        "graph_search_ip": (
            "vectorsearch_rbac_tpu_torch/csrc/graph_step.cu",
            "vectorsearch_rbac_tpu/ops/graph_search.py:343 in its ip and "
            "cosine score form (:476-493, s = -dots), with scripts/"
            "pallas_merge_probe.py:107 and scripts/r5_graph_fused_probe.py:"
            "233"),
        "graph_score_ip": (
            "vectorsearch_rbac_tpu_torch/csrc/graph_step.cu",
            "scripts/r5_graph_fused_probe.py:233 in the ip and cosine score "
            "form of vectorsearch_rbac_tpu/ops/graph_search.py:476-493"),
        "scan_int8_wide_slots": (
            "vectorsearch_rbac_tpu_torch/csrc/scan_int8_wide.cu",
            "vectorsearch_rbac_tpu/ops/pallas_scan_int8.py:343 (the mask_sb "
            "form of :295)"),
        "scan_int8_dp4a": ("vectorsearch_rbac_tpu_torch/csrc/scan_int8.cu",
                           "vectorsearch_rbac_tpu/ops/pallas_scan_int8.py:40 "
                           "(the first port's dp4a design, the lab's "
                           "control)"),
        "scan_int8_trim": ("vectorsearch_rbac_tpu_torch/csrc/scan_int8.cu",
                           "scripts/r4_kernel_variants.py:37"),
        "scan_int8_chain": ("vectorsearch_rbac_tpu_torch/csrc/scan_int8.cu",
                            "vectorsearch_rbac_tpu/ops/pallas_scan_int8.py:40"
                            " (its epilogue chain, :74-97, as the control of "
                            "scripts/r4_kernel_variants.py:37)"),
        "scan_int8_floor": ("vectorsearch_rbac_tpu_torch/csrc/scan_int8.cu",
                            "scripts/r4_kernel_variants.py:94"),
        "merge_y_extract": ("vectorsearch_rbac_tpu_torch/csrc/merge.cu",
                            "scripts/r4_extract_kernel.py:28"),
        "merge_y_sort": ("vectorsearch_rbac_tpu_torch/csrc/merge.cu",
                         "scripts/r4_bitonic_kernel.py:26"),
        "merge_y_pairs": ("vectorsearch_rbac_tpu_torch/csrc/merge.cu",
                          "scripts/r4_bitonic_kernel.py:55"),
    }
    say(json.dumps({"kernels": [
        {"name": name, "route": "cuda", "source": src, "replaces": rep,
         "launches": launches[name], "max_abs_err": result[name][1],
         "ms": result[name][2], "plain_ms": result[name][3],
         "bound_ms": extra[name][0], "bound_by": extra[name][1],
         "library_ms": extra[name][2]}
        for name, (src, rep) in sources.items()]}))
    say(smi)
    say(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
