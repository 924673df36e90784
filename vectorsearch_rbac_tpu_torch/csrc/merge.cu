// Group-minima merge: subgroup extraction, then a bitonic sort of survivors.
//
// The scan kernel (scan_int8.cu) emits one packed (score << 7 | lane) minimum
// per group of rows, as an (n_groups, Q) int32 matrix. These two kernels turn
// it into each query's k smallest packed values and their group positions.
//
// ---------------------------------------------------------------------------
// extract_pairs_kernel replaces the TPU kernel
// vectorsearch_rbac_tpu/ops/pallas_merge.py _make_extract_pairs_kernel
// (stage 1 of pallas_merge_topk).
//
// Contract: the minima are cut into nsub subgroups of sub = n_groups / nsub
// rows. For each subgroup j and query q, round r = 0..t-1 emits
//   y[j*t + r, q]    = the r-th smallest DISTINCT packed value of the column,
//   meta[j*t + r, q] = min over the rows p holding that value of
//                      ((j*sub + p) << 7) | (original value & 127).
// Equal values (the many 0x7F000000 of inadmissible groups among them)
// extract as one candidate with the smallest meta. Once the column is
// drained a round emits INT32_MAX, and its meta is the minimum meta over all
// rows: on the TPU every row is masked to INT32_MAX by then, so every row is
// a hit. Round r keeps only values strictly above round r-1's value, which is
// exactly the set the TPU kernel leaves unmasked.
//
// What bounds it on an H100: the bytes of one read of the minima (0.0225 ms
// for a 2048-query x 8192-group batch), if the read is spread over enough
// threads to hide its latency. The first port gave each column one thread
// that re-read its sub values in every one of the t rounds: 16 reads of
// 67 MB through L2, a dependent chain of t * sub loads, and only 512 blocks
// of 128 threads at 2048 queries (1.767 ms, 79x the bound).
// Design: a team of kTeam lanes of one warp owns a (subgroup, query)
// column; lane l reads rows l, l + kTeam, ... once, kBatch loads in flight,
// and keeps in registers a sorted list of its kCap smallest DISTINCT values,
// each with the smallest meta among its rows (a fixed compare-exchange
// insertion: no dynamically indexed array, which ptxas would spill). Each
// round is a team minimum of the list heads (warp shuffles); a second team
// minimum over the lanes whose head equals it gives the meta, and those
// lanes pop their head, so equal values held by different lanes extract
// as one candidate. A lane that evicted values (more than kCap distinct)
// and has popped its whole list re-reads its rows for the values above the
// last extracted one; with t <= kCap that never happens. The drained
// round's meta is the column's first row's: meta grows with the row.
// Neighbouring teams own neighbouring queries, so a warp's load of one row
// reads 32/kTeam consecutive int32 and the next warp the rest of the
// sector, from L1.
//
// ---------------------------------------------------------------------------
// bitonic_net_kernel<npc, kMetaIn> (K4) replaces the TPU kernel
// vectorsearch_rbac_tpu/ops/pallas_merge.py _make_bitonic_pairs_kernel
// (stage 2 of pallas_merge_topk); its other forms are S5's (below).
//
// Contract: a full bitonic network sorts each query column's npc = nsub * t
// survivors by value, meta riding along, and keeps the first `keep` rows.
// The compare-exchange is the TPU network's own, not the textbook one:
//   le = a <= b; lo = le ? a : b; hi = le ? b : a
//   descending block (i & size) != 0: i <- hi, i + stride <- lo
// so equal values SWAP in a descending block. Copying that rule keeps the
// meta order of equal values identical to the TPU kernel's.
//
// What bounds it on an H100: the bytes of one read of the survivors and one
// write of the kept rows (0.0030 ms at 2048 queries, npc 512, keep 104).
// The first port gave each column a block of npc / 2 threads in shared
// memory: 45 stages at npc 512, each ending in a __syncthreads, and a
// column load that stepped by nq, one 32-byte sector an int32 (0.060 ms,
// 20x the bound). Design: a warp owns a column in registers, npc / 32
// values and metas a lane (j = lane * kE + e), so the network has no block
// barrier: strides below kE are compare-exchanges between a lane's
// registers, the larger ones (at most five a merge) __shfl_xor_sync of
// value and meta. A cross-lane pair is no symmetric min/max: both lanes
// evaluate it as (lower index, upper index), so equal values keep the TPU
// network's order. Every index is a template constant (the kernel is
// instantiated per npc), so nothing spills. A block stages 8 adjacent
// queries' (npc, 8) tile through shared memory, so each row's read is one
// full sector, and stores the kept rows the same way. npc 2048 (64 + 64
// registers a lane would spill) gives a column two warps, whose one
// pairing stride (the last merge's npc / 2) goes through shared memory
// between two barriers; where keep <= npc / 2 the upper warp stops there,
// its half unable to reach the output. Below npc 2048 the same pruning
// would leave whole lanes idle in a warp that still issues every
// instruction, so the kernel drops the dead half only from the stores.
// What holds it now is the network's compare-and-select work on the
// integer pipes, about two thirds of its time (PERF.md).
//
// ---------------------------------------------------------------------------
// The y-form lab merge (scripts/r4_extract_kernel.py, r4_bitonic_kernel.py):
// the candidate's position in its subgroup rides in the low 7 bits of the
// packed value instead of a meta word, so the survivors are one int32 each.
//
// y_extract_kernel replaces the TPU kernel r4_extract_kernel.py
// _make_extract_kernel (subgroup_extract, S4). Contract: the minima are cut
// into subgroups of sub <= 128 rows; for subgroup j and query q
//   y[p]            = (mins[j*sub + p, q] & ~127) | p      (p < sub)
//   out[j*t + r, q] = the r-th smallest y of the subgroup, INT32_MAX once
//                     all sub are out.
// The y of one subgroup are distinct (p is), so each round takes exactly the
// smallest y above the last one. The lab kernel masks a hit with 2^30, which
// sorts below the inadmissible 0x7F000000 | p: in a subgroup with fewer than
// t admissible groups it emits 2^30 again and again, which decodes to
// position 0 and duplicates a real candidate downstream. This kernel masks
// with INT32_MAX, as the package's extraction kernel does
// (vectorsearch_rbac_tpu/ops/pallas_merge.py:62-67); on every input where no
// subgroup runs out of admissible groups within t rounds the two agree bit
// for bit. Bound: as extract_pairs_kernel's, the bytes of one read of the
// minima (0.0213 ms at 2048 queries x 8192 groups, sub 128, t 8). The first
// port gave each column one thread that re-read its sub values in every one
// of the t rounds: t passes over the minima (67 MB at that shape, more than
// L2 holds) and a dependent chain of t * sub loads (0.186 ms on an NVIDIA
// H100 80GB HBM3 at 700.00 W, 8.7x the bound). Design: one thread a column
// still, but one read: it loads its rows kYBatch at a time, all in flight
// (neighbouring threads own neighbouring queries, so a warp's load of a
// row is 128 contiguous bytes), and inserts each y into an ascending list
// of kT registers, one min and one max an entry (no branch, no dynamic
// index: nothing spills); then it writes the list's first t. The y of a
// column are distinct, so no meta and no dedup: the list holds exactly the
// kT smallest. The list is templated on kT = 8, 16, 32 (the smallest that
// holds t); t > 32 reads the column again for each further 32, keeping
// only the y above the last one written. Against a team of lanes a column
// (extract_pairs_kernel's layout, without its meta) it does fewer
// operations a value and writes each output row as 128 contiguous bytes
// (PERF.md: the A/B).
//
// S5: bitonic_net_kernel<npc, kGid> and <npc, kValues> replace the TPU
// kernels r4_bitonic_kernel.py _make_bitonic_pairs_kernel
// (bitonic_pairs_keep) and _make_bitonic_kernel (bitonic_sort_keep).
// Contract: K4's network sorts each column of (npc, Q) y-values and keeps
// the first `keep` rows; the pairs form (kGid) carries
//   gid[i] = (i / t) * sub + (y[i] & 127)
// (the candidate's global group) along as K4 carries its meta, computed
// from the row i as it is staged, and swaps equal y the TPU network's way
// (le = a <= b; a descending block puts hi first), so equal y of different
// subgroups keep the TPU's gid order. The sort form (kValues) carries
// nothing; its output is the sorted values, whatever the order of equal
// ones, so its network is values only: one shuffle a cross-lane stride and
// a plain min/max a pair. Bound: K4's, the bytes of one read of the y and
// one write of the kept rows (and gids). The first port gave each column a
// block of npc / 2 threads in shared memory and a __syncthreads after each
// of the network's stages (45 at npc 512): 0.0345 ms (sort) and 0.0543
// (pairs) at 2048 queries x npc 512, keep 128, 20x their bounds on an
// NVIDIA H100 80GB HBM3 at 700.00 W. Design: K4's, above: a warp a column
// in registers, 8 queries a block staged through shared memory, npc 2048
// on two warps.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int32_t kBig = 0x7FFFFFFF;
constexpr int kExtractThreads = 128;  // the y-form extraction's block
constexpr int kYBatch = 16;           // rows a thread loads before inserting
constexpr int kTeam = 8;              // lanes per (subgroup, query) column
constexpr int kCap = 16;              // distinct values a lane keeps
constexpr int kBatch = 8;             // rows a lane loads before inserting
constexpr int kTeamThreads = 256;
constexpr int kTeamCols = kTeamThreads / kTeam;  // queries per block

// Insert (x, mx) into the ascending list of distinct values (v, m): an
// equal value keeps the smaller meta; a value larger than a full list's
// last, or the one a full list evicts, sets `over`. x is never kBig.
__device__ __forceinline__ void list_insert(int32_t (&v)[kCap],
                                            int32_t (&m)[kCap], int32_t x,
                                            int32_t mx, bool& over) {
  if (x > v[kCap - 1]) {
    over = true;
    return;
  }
#pragma unroll
  for (int i = 0; i < kCap; ++i) {
    const bool eq = v[i] == x;
    const bool lt = x < v[i];
    const int32_t tv = v[i], tm = m[i];
    m[i] = eq ? min(tm, mx) : (lt ? mx : tm);
    v[i] = lt ? x : tv;
    // after a merge the carried pair is (kBig, kBig): it merges into the
    // empty slots without changing them and moves nothing
    x = eq ? kBig : (lt ? tv : x);
    mx = eq ? kBig : (lt ? tm : mx);
  }
  if (x != kBig) over = true;
}

// Read this lane's rows of the column and insert every value that is not
// kBig and, unless `all`, lies above `floor`.
__device__ __forceinline__ void list_scan(const int32_t* __restrict__ col,
                                          int nq, int lane, int sub,
                                          uint32_t base, bool all,
                                          int32_t floor, int32_t (&v)[kCap],
                                          int32_t (&m)[kCap], bool& over) {
  for (int p0 = lane; p0 < sub; p0 += kTeam * kBatch) {
    int32_t x[kBatch];
#pragma unroll
    for (int b = 0; b < kBatch; ++b) {
      const int p = p0 + b * kTeam;
      x[b] = p < sub ? __ldg(col + (size_t)p * nq) : kBig;
    }
#pragma unroll
    for (int b = 0; b < kBatch; ++b) {
      const uint32_t p = (uint32_t)(p0 + b * kTeam);
      if (x[b] != kBig && (all || x[b] > floor))
        list_insert(v, m, x[b],
                    (int32_t)(((base + p) << 7) | ((uint32_t)x[b] & 127u)),
                    over);
    }
  }
}

__device__ __forceinline__ int32_t team_min(int32_t x) {
#pragma unroll
  for (int off = kTeam / 2; off >= 1; off >>= 1)
    x = min(x, __shfl_xor_sync(0xffffffffu, x, off));
  return x;
}

__global__ void __launch_bounds__(kTeamThreads)
extract_pairs_kernel(const int32_t* __restrict__ mins,  // (n_groups, Q)
                     int32_t* __restrict__ out_y,       // (nsub * t, Q)
                     int32_t* __restrict__ out_m,       // (nsub * t, Q)
                     int nq, int sub, int t) {
  const int lane = threadIdx.x % kTeam;
  const int q_raw = blockIdx.x * kTeamCols + threadIdx.x / kTeam;
  // a ragged tail's teams run on the last query's column (every lane of
  // the warp takes part in the shuffles) and store nothing
  const bool live = q_raw < nq;
  const int q = live ? q_raw : nq - 1;
  const int j = blockIdx.y;
  const int32_t* col = mins + (size_t)j * sub * nq + q;
  const uint32_t base = (uint32_t)j * (uint32_t)sub;
  int32_t v[kCap], m[kCap];
#pragma unroll
  for (int i = 0; i < kCap; ++i) v[i] = m[i] = kBig;
  bool over = false;
  list_scan(col, nq, lane, sub, base, true, 0, v, m, over);
  const int32_t meta_all =
      (int32_t)((base << 7) | ((uint32_t)__ldg(col) & 127u));
  int32_t last = 0;
  for (int r = 0; r < t; ++r) {
    if (v[0] == kBig && over) {  // popped a full list: read past `last`
      over = false;
      list_scan(col, nq, lane, sub, base, false, last, v, m, over);
    }
    const int32_t cur = team_min(v[0]);
    const bool pop = v[0] == cur && cur != kBig;
    int32_t meta = team_min(pop ? m[0] : kBig);
    if (cur == kBig) meta = meta_all;
#pragma unroll
    for (int i = 0; i + 1 < kCap; ++i) {
      v[i] = pop ? v[i + 1] : v[i];
      m[i] = pop ? m[i + 1] : m[i];
    }
    if (pop) v[kCap - 1] = m[kCap - 1] = kBig;
    if (live && lane == 0) {
      const size_t o = ((size_t)j * t + r) * nq + q;
      out_y[o] = cur;
      out_m[o] = meta;
    }
    last = cur;
  }
}

// ---- bitonic_net_kernel: the network in registers, a warp a column

// The compare-exchange of a pair, a at the lower index and b at the upper:
// whether the two swap (a descending block puts hi first, so equal values
// swap there).
__device__ __forceinline__ bool swaps(int32_t a, int32_t b, bool desc) {
  return (a <= b) == desc;
}

// One stride of the network on a column laid out as j = lp * kE + e (lane
// place lp, register e). Strides below kE pair two registers of a lane;
// larger ones pair register e of lanes lp and lp ^ (stride / kE), and each
// lane evaluates the pair as the lower index's lane does, so both keep the
// same side of a tie. All indices are compile-time: nothing spills. With
// no meta (kMeta false) equal values cannot be told apart, so a pair is a
// plain min/max (the lower index takes the min in an ascending block) and
// a cross-lane stride one shuffle; m is then never read or written.
template <int kE, int kSize, int kStride, bool kMeta>
__device__ __forceinline__ void net_stage(int32_t (&v)[kE], int32_t (&m)[kE],
                                          int jb) {
  if constexpr (kStride >= kE) {
    constexpr int kX = kStride / kE;
    const bool lower = (jb & kStride) == 0;
    const bool desc = (jb & kSize) != 0;
#pragma unroll
    for (int e = 0; e < kE; ++e) {
      const int32_t pv = __shfl_xor_sync(0xffffffffu, v[e], kX);
      if constexpr (kMeta) {
        const int32_t pm = __shfl_xor_sync(0xffffffffu, m[e], kX);
        const bool sw = lower ? swaps(v[e], pv, desc) : swaps(pv, v[e], desc);
        v[e] = sw ? pv : v[e];
        m[e] = sw ? pm : m[e];
      } else {
        v[e] = lower != desc ? min(v[e], pv) : max(v[e], pv);
      }
    }
  } else {
#pragma unroll
    for (int e = 0; e < kE; ++e) {
      if (e & kStride) continue;
      constexpr int k = kStride;
      const bool desc = kSize < kE ? (e & kSize) != 0 : (jb & kSize) != 0;
      if constexpr (kMeta) {
        const bool sw = swaps(v[e], v[e + k], desc);
        const int32_t a = v[e], ma = m[e];
        v[e] = sw ? v[e + k] : a;
        v[e + k] = sw ? a : v[e + k];
        m[e] = sw ? m[e + k] : ma;
        m[e + k] = sw ? ma : m[e + k];
      } else {
        const int32_t lo = min(v[e], v[e + k]), hi = max(v[e], v[e + k]);
        v[e] = desc ? hi : lo;
        v[e + k] = desc ? lo : hi;
      }
    }
  }
}

// The strides kStride, kStride / 2, ..., 1 of the size-kSize merge.
template <int kE, int kSize, int kStride, bool kMeta>
__device__ __forceinline__ void net_merge(int32_t (&v)[kE], int32_t (&m)[kE],
                                          int jb) {
  net_stage<kE, kSize, kStride, kMeta>(v, m, jb);
  if constexpr (kStride > 1)
    net_merge<kE, kSize, kStride / 2, kMeta>(v, m, jb);
}

// The merges of sizes kSize, 2 kSize, ..., kTop.
template <int kE, int kSize, int kTop, bool kMeta>
__device__ __forceinline__ void net_sort(int32_t (&v)[kE], int32_t (&m)[kE],
                                         int jb) {
  net_merge<kE, kSize, kSize / 2, kMeta>(v, m, jb);
  if constexpr (kSize < kTop) net_sort<kE, kSize * 2, kTop, kMeta>(v, m, jb);
}

constexpr int kSortCols = 8;  // queries a block: a row's 8 int32 fill a sector

// The geometry of one column of npc survivors: kWarps warps of kLanes
// lanes, kE values (and metas) a lane. npc 2048 takes two warps (64 + 64
// registers a lane would spill); below 32 a column uses npc lanes and the
// others repeat them.
template <int kNpc>
struct Net {
  static constexpr int kWarps = kNpc == 2048 ? 2 : 1;
  static constexpr int kLanes = kNpc < 32 ? kNpc : 32;
  static constexpr int kE = kNpc / (kLanes * kWarps);
  static constexpr int kThreads = 32 * kWarps * kSortCols;
  // a column in shared memory: one pad word after each lane's kE values
  // (conflict-free register loads), the pitch 4 mod 32 (conflict-free
  // staging: a warp's load is 4 rows x 8 queries)
  static constexpr int kSpan = kNpc + kNpc / kE;
  static constexpr int kPitch = kSpan + (36 - kSpan % 32) % 32;
  __device__ static int slot(int j) { return j + j / kE; }
};

// What rides along with the values: K4's metas, read with them (kMetaIn);
// S5's gids, computed from the row and the value as they are staged
// (kGid); or nothing (kValues, S5's sort form).
constexpr int kMetaIn = 0, kGid = 1, kValues = 2;

template <int kNpc, int kForm>
constexpr int net_smem() {
  return (kForm == kValues ? 1 : 2) * kSortCols * Net<kNpc>::kPitch * 4;
}

template <int kNpc, int kForm>
__global__ void __launch_bounds__(Net<kNpc>::kThreads)
bitonic_net_kernel(const int32_t* __restrict__ y,     // (npc, Q)
                   const int32_t* __restrict__ meta,  // (npc, Q): kMetaIn
                   int32_t* __restrict__ out_y,       // (keep, Q)
                   int32_t* __restrict__ out_m,       // (keep, Q) unless
                                                      // kValues
                   int nq, int keep, int t, int sub) {
  using N = Net<kNpc>;
  constexpr int kE = N::kE;
  constexpr bool kMeta = kForm != kValues;
  extern __shared__ int32_t smem[];
  int32_t* sy = smem;
  int32_t* sm = smem + kSortCols * N::kPitch;  // unused where !kMeta
  // stage the block's (npc, 8) tile: each row's 8 queries are one sector
  const int q0 = blockIdx.x * kSortCols;
  const int cq = threadIdx.x % kSortCols;
  const bool q_ok = q0 + cq < nq;
#pragma unroll 4
  for (int i = threadIdx.x / kSortCols; i < kNpc;
       i += N::kThreads / kSortCols) {
    const size_t src = (size_t)i * nq + q0 + cq;
    const int32_t v = q_ok ? __ldg(y + src) : kBig;
    sy[cq * N::kPitch + N::slot(i)] = v;
    if constexpr (kForm == kMetaIn)
      sm[cq * N::kPitch + N::slot(i)] = q_ok ? __ldg(meta + src) : kBig;
    if constexpr (kForm == kGid)
      sm[cq * N::kPitch + N::slot(i)] = (i / t) * sub + (v & 127);
  }
  __syncthreads();
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int lp = (warp % N::kWarps) * N::kLanes + lane % N::kLanes;
  const int jb = lp * kE;
  int32_t* cy = sy + (warp / N::kWarps) * N::kPitch;
  int32_t* cm = sm + (warp / N::kWarps) * N::kPitch;
  int32_t v[kE], m[kE];
#pragma unroll
  for (int e = 0; e < kE; ++e) {
    v[e] = cy[N::slot(jb + e)];
    m[e] = kMeta ? cm[N::slot(jb + e)] : 0;
  }
  net_sort<kE, 2, kNpc / N::kWarps, kMeta>(v, m, jb);
  bool live = true;
  if constexpr (N::kWarps == 2) {
    // the last merge's stride npc / 2 pairs the two warps: one exchange
    // through the column's shared memory; where keep <= npc / 2 the upper
    // warp's half cannot reach the output and stops there
#pragma unroll
    for (int e = 0; e < kE; ++e) {
      cy[N::slot(jb + e)] = v[e];
      if constexpr (kMeta) cm[N::slot(jb + e)] = m[e];
    }
    __syncthreads();
    const bool lower = jb < kNpc / 2;
    const int pb = jb ^ (kNpc / 2);
#pragma unroll
    for (int e = 0; e < kE; ++e) {
      const int32_t pv = cy[N::slot(pb + e)];
      if constexpr (kMeta) {
        const int32_t pm = cm[N::slot(pb + e)];
        const bool sw =
            lower ? swaps(v[e], pv, false) : swaps(pv, v[e], false);
        v[e] = sw ? pv : v[e];
        m[e] = sw ? pm : m[e];
      } else {
        v[e] = lower ? min(v[e], pv) : max(v[e], pv);
      }
    }
    __syncthreads();
    live = lower || keep > kNpc / 2;
    if (live) net_merge<kE, kNpc, kNpc / 4, kMeta>(v, m, jb);
  }
  if (live && lane < N::kLanes) {
#pragma unroll
    for (int e = 0; e < kE; ++e) {
      cy[N::slot(jb + e)] = v[e];
      if constexpr (kMeta) cm[N::slot(jb + e)] = m[e];
    }
  }
  __syncthreads();
  if (!q_ok) return;
  for (int i = threadIdx.x / kSortCols; i < keep;
       i += N::kThreads / kSortCols) {
    const size_t dst = (size_t)i * nq + q0 + cq;
    out_y[dst] = sy[cq * N::kPitch + N::slot(i)];
    if constexpr (kMeta) out_m[dst] = sm[cq * N::kPitch + N::slot(i)];
  }
}

template <int kNpc, int kForm>
cudaError_t launch_bitonic(const int32_t* y, const int32_t* meta,
                           int32_t* out_y, int32_t* out_m, int nq, int keep,
                           int t, int sub, cudaStream_t stream) {
  using N = Net<kNpc>;
  constexpr int smem = net_smem<kNpc, kForm>();
  auto kernel = bitonic_net_kernel<kNpc, kForm>;
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return err;
  }
  kernel<<<(nq + kSortCols - 1) / kSortCols, N::kThreads, smem, stream>>>(
      y, meta, out_y, out_m, nq, keep, t, sub);
  return cudaGetLastError();
}

// The network's form for a column of npc (a power of two, 2 .. 2048).
template <int kForm>
cudaError_t dispatch_bitonic(int npc, const int32_t* y, const int32_t* meta,
                             int32_t* out_y, int32_t* out_m, int nq,
                             int keep, int t, int sub, cudaStream_t s) {
#define VSR_NPC(N_)                                                        \
  case N_:                                                                 \
    return launch_bitonic<N_, kForm>(y, meta, out_y, out_m, nq, keep, t,   \
                                     sub, s);
  switch (npc) {
    VSR_NPC(2) VSR_NPC(4) VSR_NPC(8) VSR_NPC(16) VSR_NPC(32) VSR_NPC(64)
    VSR_NPC(128) VSR_NPC(256) VSR_NPC(512) VSR_NPC(1024) VSR_NPC(2048)
    default:
      return cudaErrorInvalidValue;
  }
#undef VSR_NPC
}

// Insert y into the ascending list v: one min and one max an entry. The y
// of a column are distinct; inserting kBig changes nothing.
template <int kT>
__device__ __forceinline__ void y_insert(int32_t (&v)[kT], int32_t y) {
#pragma unroll
  for (int i = 0; i < kT; ++i) {
    const int32_t lo = min(v[i], y);
    y = max(v[i], y);
    v[i] = lo;
  }
}

// One read of a column: v = its kT smallest y (kBig past the last), among
// the y above `last` where kAbove.
template <int kT, bool kAbove>
__device__ __forceinline__ void y_scan(const int32_t* __restrict__ col,
                                       int nq, int sub, int32_t last,
                                       int32_t (&v)[kT]) {
#pragma unroll
  for (int i = 0; i < kT; ++i) v[i] = kBig;
  for (int p0 = 0; p0 < sub; p0 += kYBatch) {
    int32_t x[kYBatch];
#pragma unroll
    for (int b = 0; b < kYBatch; ++b)
      x[b] = p0 + b < sub ? __ldg(col + (size_t)(p0 + b) * nq) : kBig;
#pragma unroll
    for (int b = 0; b < kYBatch; ++b) {
      const int32_t y = (x[b] & ~127) | (p0 + b);
      const bool out = p0 + b >= sub || (kAbove && y <= last);
      y_insert<kT>(v, out ? kBig : y);
    }
  }
}

template <int kT>
__global__ void __launch_bounds__(kExtractThreads)
y_extract_kernel(const int32_t* __restrict__ mins,  // (n_groups, Q)
                 int32_t* __restrict__ out,         // (n_groups / sub * t, Q)
                 int nq, int sub, int t) {
  const int q = blockIdx.x * kExtractThreads + threadIdx.x;
  const int j = blockIdx.y;
  if (q >= nq) return;
  const int32_t* col = mins + (size_t)j * sub * nq + q;
  int32_t* dst = out + (size_t)j * t * nq + q;
  int32_t v[kT];
  y_scan<kT, false>(col, nq, sub, 0, v);
  for (int r0 = 0;;) {
#pragma unroll
    for (int r = 0; r < kT; ++r)
      if (r0 + r < t) dst[(size_t)(r0 + r) * nq] = v[r];
    r0 += kT;
    if (r0 >= t) break;
    // the next kT rounds: the y above the last one written (once the
    // column is drained that is kBig, and no y lies above it)
    y_scan<kT, true>(col, nq, sub, v[kT - 1], v);
  }
}

}  // namespace

extern "C" int vsr_extract_pairs(const void* mins, void* out_y, void* out_m,
                                 int nq, int nsub, int sub, int t,
                                 void* stream) {
  if (nq < 1 || nsub < 1 || nsub > 65535 || sub < 1 || t < 1 ||
      (long long)nsub * sub * 128 > kBig)
    return (int)cudaErrorInvalidValue;
  const dim3 grid((nq + kTeamCols - 1) / kTeamCols, nsub);
  extract_pairs_kernel<<<grid, kTeamThreads, 0,
                         static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(mins), static_cast<int32_t*>(out_y),
      static_cast<int32_t*>(out_m), nq, sub, t);
  return (int)cudaGetLastError();
}

extern "C" int vsr_bitonic_pairs(const void* y, const void* meta, void* out_y,
                                 void* out_m, int nq, int npc, int keep,
                                 void* stream) {
  if (nq < 1 || keep < 1 || keep > npc) return (int)cudaErrorInvalidValue;
  return (int)dispatch_bitonic<kMetaIn>(
      npc, static_cast<const int32_t*>(y), static_cast<const int32_t*>(meta),
      static_cast<int32_t*>(out_y), static_cast<int32_t*>(out_m), nq, keep, 1,
      1, static_cast<cudaStream_t>(stream));
}

// out: (n_groups / sub * t, Q); sub <= 128 (the position has 7 bits).
extern "C" int vsr_y_extract(const void* mins, void* out, int nq, int nsub,
                             int sub, int t, void* stream) {
  if (nq < 1 || nsub < 1 || nsub > 65535 || sub < 1 || sub > 128 || t < 1)
    return (int)cudaErrorInvalidValue;
  const dim3 grid((nq + kExtractThreads - 1) / kExtractThreads, nsub);
  auto kernel = t <= 8    ? y_extract_kernel<8>
                : t <= 16 ? y_extract_kernel<16>
                          : y_extract_kernel<32>;
  kernel<<<grid, kExtractThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(mins), static_cast<int32_t*>(out), nq, sub,
      t);
  return (int)cudaGetLastError();
}

// pairs 0: the sort form (out_g unused, may be null); 1: the pairs form.
extern "C" int vsr_bitonic_y(const void* y, void* out_y, void* out_g, int nq,
                             int npc, int keep, int t, int sub, int pairs,
                             void* stream) {
  if (nq < 1 || npc < 2 || npc > 2048 || (npc & (npc - 1)) != 0 || keep < 1 ||
      keep > npc || (pairs && (t < 1 || sub < 1 || sub > 128)))
    return (int)cudaErrorInvalidValue;
  const auto* yy = static_cast<const int32_t*>(y);
  auto* oy = static_cast<int32_t*>(out_y);
  auto* og = static_cast<int32_t*>(out_g);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  return (int)(pairs ? dispatch_bitonic<kGid>(npc, yy, nullptr, oy, og, nq,
                                              keep, t, sub, s)
                     : dispatch_bitonic<kValues>(npc, yy, nullptr, oy,
                                                 nullptr, nq, keep, 1, 1, s));
}
