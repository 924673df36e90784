// The HNSW graph search's kernels: the fused search (the whole iterative
// search in one launch), and the two kernels of one step of the step loop
// (candidate scoring from packed rows, the step's three stable merges),
// which the 2-hop harvest still runs.
//
// ---------------------------------------------------------------------------
// graph_search_fused_kernel replaces, on the packed-row path without the
// 2-hop harvest, the whole lax.while_loop of
// vectorsearch_rbac_tpu/ops/graph_search.py graph_beam_search_iterative
// (:343; the loop :607, its body :534-604) with the two TPU kernels of its
// step, scripts/r5_graph_fused_probe.py pallas_dma_gather (:233) and
// scripts/pallas_merge_probe.py merge_step (:107).
//
// Contract: for each query, from the entry's score to the last merge, the
// reference's state machine: the done test (frontier empty, or its nearest
// at least the window's ef-th with the results full, or the step budget
// spent), the pop of the beam's nearest, the neighbour row
// (graph[pids[q], node] or graph[node]), the dedup against the beam and the
// expansion history, the packed-row score (l2, or the inner-product form of
// ip and cosine arenas) and admit test (as graph_score_packed_kernel below,
// bit for bit), and the three stable merges
// (beam ef, window ef, results kk; ties to the lower position of the
// concatenation: the list before the candidates, the candidates in
// neighbour-row order: lax.top_k's order and torch.sort(stable=True)'s).
// Out: the results' values and ids (Q, kk) before the finish (the wrapper
// adds the query norm in PyTorch, as the plain loop does), and, where asked,
// the expansions and the scored candidates added to a device counter.
// Bit-equality holds on the final results, not on the reference's internal
// +inf tail: a candidate that scores +inf (id -1, or a row map entry -1)
// never reaches the output (the finish maps every +inf to -1, and a +inf
// beam entry is never popped: the done test stops first), so the kernel
// keeps only finite entries in its lists and pads them with +inf / -1. The
// one place where the tail's ids matter, the dedup against the beam, can
// only drop a candidate whose score is +inf again, so it changes nothing.
// The beam is sorted after every merge and the pop takes the first of
// equal minima, so the pop is always slot 0.
//
// What bounds it on an H100: memory latency, not bytes. A step is a chain of
// three dependent random reads (the neighbour row, the row map entries, the
// packed rows), and a query takes tens to hundreds of steps in order; the
// bytes (per expansion 4 M0 of graph row, per scored candidate 4 + d_pad +
// 4W + 4) are a few hundred KB a 4096-query chunk.
// Design: a warp per query, up to 4 a block, all of a query's state in the
// warp's shared memory (beam values and ids, window and results, each in
// two buffers that the merges alternate; the history as a list of the
// expanded nodes, which is the reference's history exactly; the step's
// candidates; a stage for packed rows), its query floats and its first 32
// mask words (a lane a word) in registers; past 32 words the role test
// loops over the lanes and reads the query's other words from L1
// (row_tail's kMany form, in instantiations of their own at 4 blocks an SM:
// below 32 words the forms are the ones before), so any role count runs. At the hybrid cell's shapes (ef 64, kk 18, M0 32, max_steps
// 128, d_pad 128) a warp takes 6.9 KB, so 8 blocks of 4 warps share an SM
// and a 4096-query chunk runs in one wave on 132 SMs. A step: the done test
// (warp-uniform reads), the pop, one coalesced read of the neighbour row (a
// lane a neighbour, two at M0 64), the dedup as broadcast 16-byte scans of
// the beam ids and the history, the row map reads, a ballot compaction of
// the valid candidates in row order, then cp.async brings every staged
// candidate's packed row at once (a lane a 4-byte word; rows are only
// 4-byte aligned at 148 bytes), so a step waits about one memory latency
// for its rows, not one a candidate; the warp scores each staged row as
// the step kernel does; the candidates are sorted by (value, row order) by
// counting ranks (at most M0 of them); and each merge places every element
// by a binary search into the other sorted list (i + #(b < a_i) for the
// list, j + #(a <= b_j) for the candidates), O(log) an element where the
// step kernel's merge walks over all ef + C values.
// Weighed and not taken: a visited bitmap (n_class bits a query: 8 KB at the
// hybrid slab, up to 128 KB without a row map, too large for shared memory
// at one wave; in device memory it adds a dependent read to every step),
// and a warp bitonic network for the candidates (by count, about as many
// instructions as the rank count at M0 32, with 64-bit keys to carry the
// position).
//
// ---------------------------------------------------------------------------
// graph_score_packed_kernel replaces the TPU kernel
// scripts/r5_graph_fused_probe.py pallas_dma_gather (per-row async DMA of
// packed rows, 8 in flight), whose rows feed the packed-row scoring of
// vectorsearch_rbac_tpu/ops/graph_search.py graph_beam_search_iterative
// (score_admit, packed_rows mode).
//
// Contract: for query q and candidate c with local id id = ids[q, c]:
//   row   = row_map[pids[q] * n_class + id]   (multi-graph slab)
//         | row_map[id]                       (one logical graph)
//         | id                                (no row map)
//   the packed row is [int8 code (d_pad) | W uint32 bitset words | f32 norm]
//   dots  = (sum_d qf[q, d] * code[d]) * dq_scale + qcd[q]
//   score = norm - 2 * dots                   (l2)
//         | -dots                             (ip and cosine: the kIp form;
//                                              cosine queries come unit)
//   admit = any_w (bits[w] & qmask[q, w]) != 0
// An id < 0 (or a row map entry < 0) gives score +inf and admit false. The
// dequant steps are rounded one at a time (__fmul_rn, __fadd_rn), as the
// plain version's separate PyTorch ops round them: on integer-valued data
// (the SIFT family) every partial sum of the dot is an integer below 2^24,
// so kernel, plain version and the JAX reference agree bit for bit there;
// elsewhere the dot's summation order differs (tolerance in ops/graph_step).
//
// What bounds it on an H100: memory traffic. Each candidate is one random
// d_pad + 4W + 4 byte row (148 B at SIFT shape), read once; the arithmetic
// is d_pad multiply-adds per candidate.
// Design: a block per query, a warp per candidate in turn. The warp reads
// the row's code as 32 consecutive 4-byte words (one coalesced 128-byte
// request at d_pad 128; rows are only 4-byte aligned at 148 bytes), each
// lane holding the matching 4 query floats in registers for all of the
// query's candidates (up to d_pad 1024; wider rows, the kWords 0 form,
// read the floats from L1 at each use), then the W + 1 tail words, a lane
// a word and, from 32 words on, a loop over the lanes (row_tail); a
// shuffle reduction sums the dot and a ballot ORs the bitset test.
//
// ---------------------------------------------------------------------------
// graph_merge_step_kernel replaces the TPU kernel
// scripts/pallas_merge_probe.py merge_step (the fused beam, window and
// result merges of one graph step), i.e. the three lax.top_k merges of
// graph_beam_search_iterative's body.
//
// Contract, per query, three merges of a list with its step's candidates:
//   beam   (ef):  concat(beam_d, nd)   by value, ids concat(beam_ids, nb)
//   window (ef):  concat(w_d, nd)      values only
//   result (kk):  concat(res_d, cand_d), ids concat(res_ids, cand_ids)
// each keeping the out-width smallest values in ascending order, ties
// broken by position in the concatenation (lax.top_k of the negated values
// keeps the lower index first; torch.sort(stable=True) does the same). The
// values must be NaN-free (+inf pads are fine).
//
// What bounds it on an H100: memory traffic, a few MB a launch (each list
// and candidate read once, each output written once), at tiny sizes (ef 64,
// M0 32, kk 18 on the path).
// Design: a warp per query. The warp stages a merge's values in shared
// memory; each lane takes elements i = lane, lane + 32, ... and counts its
// rank, the number of elements j with (v_j, j) < (v_i, i), by a broadcast
// walk over the staged values, then writes itself to output slot rank if
// the rank is below the out width. The ranks are a permutation, so every
// slot is written once. No list needs to be sorted: the beam after its pop
// is not (the popped slot holds +inf in place).

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "tma_wgmma.cuh"  // smem_addr, cp_async4

namespace {

constexpr int kWarp = 32;
constexpr int kScoreWarps = 4;   // warps (candidates in flight) per query
constexpr int kMergeWarps = 4;   // queries per block
constexpr unsigned kFull = 0xFFFFFFFFu;

// A packed row's role test and norm from its W + 1 tail words (t: the row's
// first bitset word): the warp's "any word meets the query's mask". Below
// 32 words (kMany false) a lane holds a word and the norm's word is among
// them (lane w); from 32 words on (kMany: worlds of 1,024 roles and more)
// the words past the first 32 are tested in a loop over the lanes, with
// the query's words read from L1 (qmask: the query's W words), and the
// norm is word w. my_mask: the query's word `lane`.
template <bool kMany>
__device__ __forceinline__ bool row_tail(const uint32_t* t, int w,
                                         uint32_t my_mask,
                                         const int32_t* qmask, int lane,
                                         float& norm) {
  const uint32_t tail = lane <= w ? t[lane] : 0u;
  bool hit = lane < w && (tail & my_mask) != 0u;
  if constexpr (kMany) {
    for (int m = lane + kWarp; m < w; m += kWarp)
      hit |= (t[m] & (uint32_t)__ldg(qmask + m)) != 0u;
    norm = __uint_as_float(t[w]);
  } else {
    norm = __uint_as_float(__shfl_sync(kFull, tail, w));
  }
  return __ballot_sync(kFull, hit) != 0u;
}

// The score of a packed row from its dot's parts: the dequant steps rounded
// one at a time as the plain version's PyTorch ops round them, then l2's
// norm - 2 dots or the inner-product form's -dots (kIp: ip and cosine
// arenas). The norm word is read with the bitset words in either form.
template <bool kIp>
__device__ __forceinline__ float packed_score(float part, float dq_scale,
                                              float center_dot, float norm) {
  const float dots = __fadd_rn(__fmul_rn(part, dq_scale), center_dot);
  return kIp ? -dots : __fsub_rn(norm, __fmul_rn(2.f, dots));
}

// kWords: code words per lane, d_pad / 128 (0: any d_pad, the query's
// floats read from memory, L1); kMany: 32 bitset words or more; kIp: the
// inner-product score form
template <int kWords, bool kMany, bool kIp>
__global__ void __launch_bounds__(kScoreWarps * kWarp)
graph_score_packed_kernel(const int32_t* __restrict__ ids,      // (Q, C)
                          const int32_t* __restrict__ row_map,  // or null
                          const int32_t* __restrict__ pids,     // or null
                          int n_class,
                          const uint32_t* __restrict__ packed,  // (Npad, unit/4)
                          int unit_words,
                          const float* __restrict__ qf,         // (Q, d_pad)
                          const int32_t* __restrict__ qmask,    // (Q, W)
                          const float* __restrict__ qcd,        // (Q,)
                          float dq_scale, float* __restrict__ out_s,
                          uint8_t* __restrict__ out_ok, int c_width, int w) {
  const int q = blockIdx.x;
  const int lane = threadIdx.x & (kWarp - 1);
  const int warp = threadIdx.x / kWarp;
  const int code_words = kWords ? kWords * kWarp : unit_words - w - 1;
  const float* qrow = qf + (size_t)q * code_words * 4;
  float qv[kWords ? kWords : 1][4];
#pragma unroll
  for (int j = 0; j < kWords; ++j)
#pragma unroll
    for (int b = 0; b < 4; ++b) qv[j][b] = qrow[(lane + j * kWarp) * 4 + b];
  const uint32_t my_mask =
      lane < w ? (uint32_t)qmask[(size_t)q * w + lane] : 0u;
  const float center_dot = qcd[q];
  const int32_t map_base = pids != nullptr ? pids[q] * n_class : 0;

  for (int c = warp; c < c_width; c += kScoreWarps) {
    const size_t o = (size_t)q * c_width + c;
    const int32_t id = ids[o];
    int32_t row = id;
    if (id >= 0 && row_map != nullptr) row = row_map[map_base + id];
    if (row < 0) {
      if (lane == 0) {
        out_s[o] = INFINITY;
        out_ok[o] = 0;
      }
      continue;
    }
    const uint32_t* r = packed + (size_t)row * unit_words;
    float part = 0.f;
    if (kWords) {
#pragma unroll
      for (int j = 0; j < kWords; ++j) {
        const uint32_t word = r[lane + j * kWarp];
#pragma unroll
        for (int b = 0; b < 4; ++b)
          part += (float)(int8_t)((word >> (8 * b)) & 0xFFu) * qv[j][b];
      }
    } else {
      for (int j = lane; j < code_words; j += kWarp) {
        const uint32_t word = r[j];
#pragma unroll
        for (int b = 0; b < 4; ++b)
          part += (float)(int8_t)((word >> (8 * b)) & 0xFFu) *
                  __ldg(qrow + 4 * j + b);
      }
    }
    float norm;
    const bool any = row_tail<kMany>(r + code_words, w, my_mask,
                                     qmask + (size_t)q * w, lane, norm);
#pragma unroll
    for (int off = kWarp / 2; off > 0; off >>= 1)
      part += __shfl_xor_sync(kFull, part, off);
    if (lane == 0) {
      out_s[o] = packed_score<kIp>(part, dq_scale, center_dot, norm);
      out_ok[o] = any;
    }
  }
}

// One merge of a warp: rank every element of concat(a, b) by (value,
// position) and write the first out_w of them. sv is the warp's staging area.
__device__ void merge_ranked(const float* __restrict__ a_d,
                             const int32_t* __restrict__ a_i, int la,
                             const float* __restrict__ b_d,
                             const int32_t* __restrict__ b_i, int lb,
                             float* __restrict__ out_d,
                             int32_t* __restrict__ out_i, int out_w,
                             float* sv, int lane) {
  const int n = la + lb;
  for (int i = lane; i < n; i += kWarp) sv[i] = i < la ? a_d[i] : b_d[i - la];
  __syncwarp();
  for (int i = lane; i < n; i += kWarp) {
    const float v = sv[i];
    int rank = 0;
    for (int j = 0; j < n; ++j) {
      const float u = sv[j];
      rank += (u < v) || (u == v && j < i);
    }
    if (rank < out_w) {
      out_d[rank] = v;
      if (out_i != nullptr) out_i[rank] = i < la ? a_i[i] : b_i[i - la];
    }
  }
  __syncwarp();
}

__global__ void __launch_bounds__(kMergeWarps * kWarp)
graph_merge_step_kernel(const float* __restrict__ beam_d,      // (Q, ef)
                        const int32_t* __restrict__ beam_i,    // (Q, ef)
                        const float* __restrict__ nd,          // (Q, C)
                        const int32_t* __restrict__ nb,        // (Q, C)
                        const float* __restrict__ w_d,         // (Q, ef)
                        const float* __restrict__ res_d,       // (Q, kk)
                        const int32_t* __restrict__ res_i,     // (Q, kk)
                        const float* __restrict__ cand_d,      // (Q, Cr)
                        const int32_t* __restrict__ cand_i,    // (Q, Cr)
                        float* __restrict__ o_beam_d, int32_t* __restrict__ o_beam_i,
                        float* __restrict__ o_w_d, float* __restrict__ o_res_d,
                        int32_t* __restrict__ o_res_i, int nq, int ef, int c,
                        int kk, int cr, int stage) {
  extern __shared__ float smem[];
  const int lane = threadIdx.x & (kWarp - 1);
  const int warp = threadIdx.x / kWarp;
  const int q = blockIdx.x * kMergeWarps + warp;
  if (q >= nq) return;  // whole warps leave together
  float* sv = smem + (size_t)warp * stage;
  const size_t qe = (size_t)q * ef, qc = (size_t)q * c;
  const size_t qk = (size_t)q * kk, qr = (size_t)q * cr;
  merge_ranked(beam_d + qe, beam_i + qe, ef, nd + qc, nb + qc, c,
               o_beam_d + qe, o_beam_i + qe, ef, sv, lane);
  merge_ranked(w_d + qe, nullptr, ef, nd + qc, nullptr, c, o_w_d + qe,
               nullptr, ef, sv, lane);
  merge_ranked(res_d + qk, res_i + qk, kk, cand_d + qr, cand_i + qr, cr,
               o_res_d + qk, o_res_i + qk, kk, sv, lane);
}

// ---------------------------------------------------------------------------
// The fused search: graph_search_fused_kernel runs the whole iterative
// search of graph_beam_search_iterative for its queries in one launch.

constexpr int kSearchWarps = 4;       // queries (warps) per block, at most
constexpr int kMaxSearchEf = 512;
constexpr int kMaxSearchM0 = 64;
constexpr int kMaxSearchSteps = 4096;
constexpr int kMinStageRows = 8;
// Shared memory a warp may take so that 8 blocks of 4 warps share an SM
// (228 KB less 1 KB reserved a block): 32 warps, one wave of a 4096-query
// chunk on 132 SMs.
constexpr int kWarpBytesTarget = (228 * 1024 / 8 - 1024) / kSearchWarps;
constexpr int kBlockBytesMax = 227 * 1024;

__host__ __device__ inline int round4(int x) { return (x + 3) & ~3; }

// A warp's shared area, in 4-byte words; every array starts on 16 bytes.
struct SearchLayout {
  int bd, bi;   // beam values and ids (ef)
  int wd;       // window values (ef)
  int rd, ri;   // results (kk)
  int buf;      // words from a list's first buffer to its second: the
                // merges alternate between the two
  int hist;     // expanded nodes, in step order (max_steps)
  int cid, crow, cd, cok;   // the step's valid candidates, in row order
  int sd, sid, sok;         // the same, sorted by (value, row order)
  int ad, ai;               // the admissible ones among them, sorted
  int stage;                // staged packed rows (stage_rows x stride)
  int words;
};

__host__ __device__ inline SearchLayout search_layout(int ef, int kk, int m0,
                                                      int max_steps,
                                                      int stage_rows,
                                                      int stride) {
  SearchLayout l;
  const int e = round4(ef), k = round4(kk), c = round4(m0);
  l.bd = 0;
  l.bi = e;
  l.wd = 2 * e;
  l.rd = 3 * e;
  l.ri = 3 * e + k;
  l.buf = 3 * e + 2 * k;
  l.hist = 2 * l.buf;
  l.cid = l.hist + round4(max_steps + 1);
  l.crow = l.cid + c;
  l.cd = l.crow + c;
  l.cok = l.cd + c;
  l.sd = l.cok + c;
  l.sid = l.sd + c;
  l.sok = l.sid + c;
  l.ad = l.sok + c;
  l.ai = l.ad + c;
  l.stage = l.ai + c;
  l.words = l.stage + round4(stage_rows * stride);
  return l;
}

struct SearchArgs {
  const float* qf;          // (Q, d_pad)
  const int32_t* qmask;     // (Q, W)
  const float* qcd;         // (Q,)
  const uint32_t* packed;   // (Npad, unit_words)
  const int32_t* graph;     // (n, M0) or (P, n_class, M0)
  const int32_t* row_map;   // null, (n_local,) or (P, n_class)
  const int32_t* pids;      // null or (Q,)
  const int32_t* entries;   // (Q,)
  const int32_t* budget;    // null or (Q,)
  float* out_d;             // (Q, kk)
  int32_t* out_i;           // (Q, kk)
  unsigned long long* stats;  // null or [expansions, scored candidates]
  float dq_scale;
  int nq, w, unit_words, stride, m0, n_class, ef, kk, max_steps, stage_rows;
};

// # of v[0..n) below x (strict) or at most x: v ascending.
__device__ __forceinline__ int count_below(const float* v, int n, float x,
                                           bool or_equal) {
  int lo = 0, hi = n;
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    const float u = v[mid];
    if (u < x || (or_equal && u == x)) lo = mid + 1;
    else hi = mid;
  }
  return lo;
}

// Merge two ascending lists into the first out_w slots of (od, oi), ties
// to a: a[i] lands at i + #(b < a[i]), b[j] at j + #(a <= b[j]); the slots
// past la + lb get +inf / -1. Ids ride along where ai is not null.
__device__ __forceinline__ void merge_sorted(const float* ad,
                                             const int32_t* ai, int la,
                                             const float* bd,
                                             const int32_t* bi, int lb,
                                             float* od, int32_t* oi,
                                             int out_w, int lane) {
  for (int i = lane; i < min(la, out_w); i += kWarp) {
    const float v = ad[i];
    const int p = i + count_below(bd, lb, v, false);
    if (p < out_w) {
      od[p] = v;
      if (ai != nullptr) oi[p] = ai[i];
    }
  }
  for (int j = lane; j < min(lb, out_w); j += kWarp) {
    const float v = bd[j];
    const int p = j + count_below(ad, la, v, true);
    if (p < out_w) {
      od[p] = v;
      if (ai != nullptr) oi[p] = bi[j];
    }
  }
  for (int p = min(la + lb, out_w) + lane; p < out_w; p += kWarp) {
    od[p] = INFINITY;
    if (ai != nullptr) oi[p] = -1;
  }
}

// Score the n rows crow[0..n): cp.async brings up to stage_rows of them
// into the stage at once (every lane its words of each row, so all the
// batch's rows are in flight together), then the warp scores each staged
// row as graph_score_packed_kernel does (same products, same shuffle tree,
// same rounding of the dequant steps, the same score form) into cd / cok.
template <int kWords, bool kMany, bool kIp>
__device__ __forceinline__ void score_rows(
    const SearchArgs& a, int n, const int32_t* crow, uint32_t* stage,
    float* cd, int32_t* cok, const float (&qv)[kWords][4], uint32_t my_mask,
    int q, float center_dot, int lane) {
  constexpr int code_words = kWords * kWarp;
  for (int k0 = 0; k0 < n; k0 += a.stage_rows) {
    const int nb = min(a.stage_rows, n - k0);
    for (int k = 0; k < nb; ++k) {
      const uint32_t* r = a.packed + (size_t)crow[k0 + k] * a.unit_words;
      const uint32_t s = smem_addr(stage + k * a.stride);
#pragma unroll
      for (int j = 0; j < kWords; ++j)
        cp_async4(s + 4 * (lane + j * kWarp), r + lane + j * kWarp, 4);
      if (kMany) {  // the W words and the norm, a lane a word in turns
        for (int m = lane; m <= a.w; m += kWarp)
          cp_async4(s + 4 * (code_words + m), r + code_words + m, 4);
      } else if (lane <= a.w) {
        cp_async4(s + 4 * (code_words + lane), r + code_words + lane, 4);
      }
    }
    asm volatile("cp.async.commit_group;\n" ::: "memory");
    asm volatile("cp.async.wait_group 0;\n" ::: "memory");
    __syncwarp();
    for (int k = 0; k < nb; ++k) {
      const uint32_t* r = stage + k * a.stride;
      float part = 0.f;
#pragma unroll
      for (int j = 0; j < kWords; ++j) {
        const uint32_t word = r[lane + j * kWarp];
#pragma unroll
        for (int b = 0; b < 4; ++b)
          part += (float)(int8_t)((word >> (8 * b)) & 0xFFu) * qv[j][b];
      }
      float norm;
      const bool any = row_tail<kMany>(r + code_words, a.w, my_mask,
                                       a.qmask + (size_t)q * a.w, lane, norm);
#pragma unroll
      for (int off = kWarp / 2; off > 0; off >>= 1)
        part += __shfl_xor_sync(kFull, part, off);
      if (lane == 0) {
        cd[k0 + k] = packed_score<kIp>(part, a.dq_scale, center_dot, norm);
        cok[k0 + k] = any;
      }
    }
    __syncwarp();   // scores visible; the stage may be refilled
  }
}

// kPer: neighbours a lane (M0 <= 32 kPer); kMany: 32 bitset words or more
// (at most 4 blocks an SM there, so the words' loop has registers: the
// 64 a thread of 8 blocks spill); kIp: the inner-product score form
template <int kWords, int kPer, bool kMany, bool kIp>
__global__ void __launch_bounds__(kSearchWarps * kWarp,
                                  kWords <= 2 && !kMany ? 8 : 4)
graph_search_fused_kernel(const __grid_constant__ SearchArgs a) {
  extern __shared__ __align__(16) uint32_t search_smem[];
  const int lane = threadIdx.x & (kWarp - 1);
  const int q = blockIdx.x * (blockDim.x / kWarp) + threadIdx.x / kWarp;
  if (q >= a.nq) return;  // whole warps leave together
  const SearchLayout l = search_layout(a.ef, a.kk, a.m0, a.max_steps,
                                       a.stage_rows, a.stride);
  uint32_t* sm = search_smem + (size_t)(threadIdx.x / kWarp) * l.words;
  float* fs = reinterpret_cast<float*>(sm);
  int32_t* is = reinterpret_cast<int32_t*>(sm);

  constexpr int code_words = kWords * kWarp;
  float qv[kWords][4];
#pragma unroll
  for (int j = 0; j < kWords; ++j)
#pragma unroll
    for (int b = 0; b < 4; ++b)
      qv[j][b] = a.qf[(size_t)q * code_words * 4 + (lane + j * kWarp) * 4 + b];
  const uint32_t my_mask =
      lane < a.w ? (uint32_t)a.qmask[(size_t)q * a.w + lane] : 0u;
  const float center_dot = a.qcd[q];
  const size_t slot = a.pids != nullptr ? (size_t)a.pids[q] : 0;
  const int32_t* gbase = a.graph + slot * a.n_class * a.m0;
  const int32_t* rmap =
      a.row_map != nullptr ? a.row_map + slot * a.n_class : nullptr;
  const int budget = a.budget != nullptr ? a.budget[q] : a.max_steps;

  // empty lists (+inf / -1), padded to 16 bytes; the history all -1
  for (int b = 0; b < 2 * l.buf; b += l.buf) {
    for (int i = lane; i < round4(a.ef); i += kWarp) {
      fs[b + l.bd + i] = INFINITY;
      is[b + l.bi + i] = -1;
      fs[b + l.wd + i] = INFINITY;
    }
    for (int i = lane; i < round4(a.kk); i += kWarp) {
      fs[b + l.rd + i] = INFINITY;
      is[b + l.ri + i] = -1;
    }
  }
  for (int i = lane; i < round4(a.max_steps + 1); i += kWarp)
    is[l.hist + i] = -1;
  // the entry: beam, window and (if admissible) results hold it alone
  const int32_t entry = a.entries[q];
  const int32_t entry_row =
      entry < 0 ? -1 : (rmap != nullptr ? rmap[entry] : entry);
  if (lane == 0) is[l.crow] = entry_row;
  __syncwarp();
  int cnt = 0, wcnt = 0, rcnt = 0;
  if (entry_row >= 0) {
    score_rows<kWords, kMany, kIp>(a, 1, is + l.crow, sm + l.stage, fs + l.cd,
                              is + l.cok, qv, my_mask, q, center_dot, lane);
    const float e_d = fs[l.cd];
    if (lane == 0) {
      fs[l.bd] = e_d;
      is[l.bi] = entry;
      fs[l.wd] = e_d;
      if (is[l.cok]) {
        fs[l.rd] = e_d;
        is[l.ri] = entry;
      }
    }
    cnt = wcnt = 1;
    rcnt = is[l.cok] ? 1 : 0;
    __syncwarp();
  }

  int cur = 0, t = 0;   // cur: the current buffer's offset (0 or l.buf)
  unsigned long long scored = 0;
  const unsigned lt_mask = (1u << lane) - 1u;
  for (; t < a.max_steps; ++t) {
    const float* bd = fs + cur + l.bd;
    const int32_t* bi = is + cur + l.bi;
    // the reference's done test: the beam's minimum is its first slot,
    // and the padded slots hold +inf
    const float fmin = bd[0];
    if (!isfinite(fmin) || t >= budget ||
        (fmin >= fs[cur + l.wd + a.ef - 1] &&
         isfinite(fs[cur + l.rd + a.kk - 1])))
      break;
    const int32_t node = bi[0];   // the pop: argmin is slot 0
    if (lane == 0) is[l.hist + t] = node;
    const int32_t* grow = gbase + (size_t)node * a.m0;
    int32_t nb[kPer];
#pragma unroll
    for (int p = 0; p < kPer; ++p) {
      const int j = lane + p * kWarp;
      nb[p] = j < a.m0 ? grow[j] : -1;
    }
    __syncwarp();
    // dedup: drop a neighbour that sits in the beam or in the history
    bool seen[kPer];
#pragma unroll
    for (int p = 0; p < kPer; ++p) seen[p] = nb[p] < 0;
    const int4* b4 = reinterpret_cast<const int4*>(bi);
    for (int i = 0; i < (cnt + 3) >> 2; ++i) {
      const int4 x = b4[i];
#pragma unroll
      for (int p = 0; p < kPer; ++p)
        seen[p] |= (x.x == nb[p]) | (x.y == nb[p]) | (x.z == nb[p]) |
                   (x.w == nb[p]);
    }
    const int4* h4 = reinterpret_cast<const int4*>(is + l.hist);
    for (int i = 0; i < (t + 4) >> 2; ++i) {
      const int4 x = h4[i];
#pragma unroll
      for (int p = 0; p < kPer; ++p)
        seen[p] |= (x.x == nb[p]) | (x.y == nb[p]) | (x.z == nb[p]) |
                   (x.w == nb[p]);
    }
    // rows; a candidate without one (row map -1) would score +inf, which
    // no list keeps (see the note), so it is dropped with the seen ones
    int n = 0;
#pragma unroll
    for (int p = 0; p < kPer; ++p) {
      int32_t row = -1;
      if (!seen[p]) row = rmap != nullptr ? rmap[nb[p]] : nb[p];
      const unsigned m = __ballot_sync(kFull, row >= 0);
      if (row >= 0) {
        const int k = n + __popc(m & lt_mask);
        is[l.cid + k] = nb[p];
        is[l.crow + k] = row;
      }
      n += __popc(m);
    }
    __syncwarp();
    scored += n;
    score_rows<kWords, kMany, kIp>(a, n, is + l.crow, sm + l.stage, fs + l.cd,
                              is + l.cok, qv, my_mask, q, center_dot, lane);
    // sort the candidates by (value, row order): rank by counting
    for (int k = lane; k < n; k += kWarp) {
      const float v = fs[l.cd + k];
      int r = 0;
      for (int k2 = 0; k2 < n; ++k2) {
        const float u = fs[l.cd + k2];
        r += (u < v) || (u == v && k2 < k);
      }
      fs[l.sd + r] = v;
      is[l.sid + r] = is[l.cid + k];
      is[l.sok + r] = is[l.cok + k];
    }
    __syncwarp();
    int na = 0;
#pragma unroll
    for (int p = 0; p < kPer; ++p) {
      const int r = lane + p * kWarp;
      const bool ok = r < n && is[l.sok + r] != 0;
      const unsigned m = __ballot_sync(kFull, ok);
      if (ok) {
        const int k = na + __popc(m & lt_mask);
        fs[l.ad + k] = fs[l.sd + r];
        is[l.ai + k] = is[l.sid + r];
      }
      na += __popc(m);
    }
    __syncwarp();
    const int nx = l.buf - cur;
    merge_sorted(bd + 1, bi + 1, cnt - 1, fs + l.sd, is + l.sid, n,
                 fs + nx + l.bd, is + nx + l.bi, a.ef, lane);
    merge_sorted(fs + cur + l.wd, nullptr, wcnt, fs + l.sd, nullptr, n,
                 fs + nx + l.wd, nullptr, a.ef, lane);
    merge_sorted(fs + cur + l.rd, is + cur + l.ri, rcnt, fs + l.ad,
                 is + l.ai, na, fs + nx + l.rd, is + nx + l.ri, a.kk, lane);
    cnt = min(a.ef, cnt - 1 + n);
    wcnt = min(a.ef, wcnt + n);
    rcnt = min(a.kk, rcnt + na);
    cur = nx;
    __syncwarp();
  }
  for (int i = lane; i < a.kk; i += kWarp) {
    a.out_d[(size_t)q * a.kk + i] = fs[cur + l.rd + i];
    a.out_i[(size_t)q * a.kk + i] = is[cur + l.ri + i];
  }
  if (a.stats != nullptr && lane == 0) {
    atomicAdd(a.stats, (unsigned long long)t);
    atomicAdd(a.stats + 1, scored);
  }
}

}  // namespace

extern "C" int vsr_graph_score_packed(const void* ids, const void* row_map,
                                      const void* pids, int n_class,
                                      const void* packed, int unit_bytes,
                                      const void* qf, const void* qmask,
                                      const void* qcd, float dq_scale,
                                      void* out_s, void* out_ok, int nq,
                                      int c_width, int d_pad, int w, int ip,
                                      void* stream) {
  if (nq < 1 || c_width < 1 || w < 1 || d_pad < 128 || d_pad % 128 != 0 ||
      unit_bytes != d_pad + 4 * w + 4)
    return (int)cudaErrorInvalidValue;
  const int unit_words = unit_bytes / 4;
  const bool many = w >= kWarp;
  const auto s = static_cast<cudaStream_t>(stream);
  const dim3 grid(nq), block(kScoreWarps * kWarp);
#define VSR_SCORE_ARGS                                                        \
  static_cast<const int32_t*>(ids), static_cast<const int32_t*>(row_map),     \
      static_cast<const int32_t*>(pids), n_class,                             \
      static_cast<const uint32_t*>(packed), unit_words,                       \
      static_cast<const float*>(qf), static_cast<const int32_t*>(qmask),      \
      static_cast<const float*>(qcd), dq_scale, static_cast<float*>(out_s),   \
      static_cast<uint8_t*>(out_ok), c_width, w
#define VSR_SCORE_LAUNCH(N_)                                                  \
  do {                                                                        \
    auto kern = many ? (ip ? graph_score_packed_kernel<N_, true, true>        \
                           : graph_score_packed_kernel<N_, true, false>)      \
                     : (ip ? graph_score_packed_kernel<N_, false, true>       \
                           : graph_score_packed_kernel<N_, false, false>);    \
    kern<<<grid, block, 0, s>>>(VSR_SCORE_ARGS);                              \
  } while (0)
#define VSR_SCORE_CASE(N_)                                                    \
  case N_:                                                                    \
    VSR_SCORE_LAUNCH(N_);                                                     \
    break;
  switch (d_pad / 128) {  // 128 .. 1024 in registers, wider from memory
    VSR_SCORE_CASE(1)
    VSR_SCORE_CASE(2)
    VSR_SCORE_CASE(3)
    VSR_SCORE_CASE(4)
    VSR_SCORE_CASE(5)
    VSR_SCORE_CASE(6)
    VSR_SCORE_CASE(7)
    VSR_SCORE_CASE(8)
    default:
      VSR_SCORE_LAUNCH(0);
  }
#undef VSR_SCORE_CASE
#undef VSR_SCORE_LAUNCH
#undef VSR_SCORE_ARGS
  return (int)cudaGetLastError();
}

extern "C" int vsr_graph_merge_step(
    const void* beam_d, const void* beam_i, const void* nd, const void* nb,
    const void* w_d, const void* res_d, const void* res_i, const void* cand_d,
    const void* cand_i, void* o_beam_d, void* o_beam_i, void* o_w_d,
    void* o_res_d, void* o_res_i, int nq, int ef, int c, int kk, int cr,
    void* stream) {
  if (nq < 1 || ef < 1 || c < 1 || kk < 1 || cr < 1)
    return (int)cudaErrorInvalidValue;
  const int stage = (ef + c > kk + cr) ? ef + c : kk + cr;
  const size_t smem = (size_t)kMergeWarps * stage * sizeof(float);
  if (smem > 48 * 1024) return (int)cudaErrorInvalidValue;
  const dim3 grid((nq + kMergeWarps - 1) / kMergeWarps);
  graph_merge_step_kernel<<<grid, kMergeWarps * kWarp, smem,
                            static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(beam_d), static_cast<const int32_t*>(beam_i),
      static_cast<const float*>(nd), static_cast<const int32_t*>(nb),
      static_cast<const float*>(w_d), static_cast<const float*>(res_d),
      static_cast<const int32_t*>(res_i), static_cast<const float*>(cand_d),
      static_cast<const int32_t*>(cand_i), static_cast<float*>(o_beam_d),
      static_cast<int32_t*>(o_beam_i), static_cast<float*>(o_w_d),
      static_cast<float*>(o_res_d), static_cast<int32_t*>(o_res_i), nq, ef, c,
      kk, cr, stage);
  return (int)cudaGetLastError();
}

extern "C" int vsr_graph_search_fused(
    const void* qf, const void* qmask, const void* qcd, float dq_scale,
    const void* packed, int unit_bytes, const void* graph, int m0,
    const void* row_map, const void* pids, int n_class, const void* entries,
    const void* step_budget, void* out_d, void* out_i, void* stats, int nq,
    int d_pad, int w, int ef, int kk, int max_steps, int ip, void* stream) {
  if (nq < 1 || w < 1 || unit_bytes != d_pad + 4 * w + 4 ||
      m0 < 1 || m0 > kMaxSearchM0 || kk < 1 || kk > ef ||
      ef > kMaxSearchEf || max_steps < 0 || max_steps > kMaxSearchSteps ||
      (pids != nullptr && (row_map == nullptr || n_class < 1)))
    return (int)cudaErrorInvalidValue;
  SearchArgs a;
  a.qf = static_cast<const float*>(qf);
  a.qmask = static_cast<const int32_t*>(qmask);
  a.qcd = static_cast<const float*>(qcd);
  a.packed = static_cast<const uint32_t*>(packed);
  a.graph = static_cast<const int32_t*>(graph);
  a.row_map = static_cast<const int32_t*>(row_map);
  a.pids = static_cast<const int32_t*>(pids);
  a.entries = static_cast<const int32_t*>(entries);
  a.budget = static_cast<const int32_t*>(step_budget);
  a.out_d = static_cast<float*>(out_d);
  a.out_i = static_cast<int32_t*>(out_i);
  a.stats = static_cast<unsigned long long*>(stats);
  a.dq_scale = dq_scale;
  a.nq = nq;
  a.w = w;
  a.unit_words = unit_bytes / 4;
  a.stride = a.unit_words | 1;   // odd: a lane's words of a row, no conflict
  a.m0 = m0;
  a.n_class = pids != nullptr ? n_class : 0;
  a.ef = ef;
  a.kk = kk;
  a.max_steps = max_steps;
  // as many staged rows as keep a warp within its share of the SM
  const int state = search_layout(ef, kk, m0, max_steps, 0, a.stride).words;
  int rows = (kWarpBytesTarget / 4 - state) / a.stride;
  a.stage_rows = rows < kMinStageRows ? kMinStageRows
                                      : (rows > m0 ? m0 : rows);
  const size_t warp_bytes =
      4 * (size_t)search_layout(ef, kk, m0, max_steps, a.stage_rows,
                                a.stride).words;
  int warps = (int)(kBlockBytesMax / warp_bytes);
  warps = warps > kSearchWarps ? kSearchWarps : warps;
  if (warps < 1) return (int)cudaErrorInvalidValue;
  const size_t smem = warps * warp_bytes;
  const dim3 grid((nq + warps - 1) / warps), block(warps * kWarp);
  const auto s = static_cast<cudaStream_t>(stream);
#define VSR_SEARCH_LAUNCH(W_, P_)                                            \
  do {                                                                       \
    auto kern =                                                              \
        many ? (ip ? graph_search_fused_kernel<W_, P_, true, true>           \
                   : graph_search_fused_kernel<W_, P_, true, false>)         \
             : (ip ? graph_search_fused_kernel<W_, P_, false, true>          \
                   : graph_search_fused_kernel<W_, P_, false, false>);       \
    cudaError_t e = cudaFuncSetAttribute(                                    \
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);       \
    if (e != cudaSuccess) return (int)e;                                     \
    kern<<<grid, block, smem, s>>>(a);                                       \
  } while (0)
  const bool two = m0 > kWarp;
  const bool many = w >= kWarp;
  switch (d_pad) {
    case 128:
      if (two) VSR_SEARCH_LAUNCH(1, 2); else VSR_SEARCH_LAUNCH(1, 1);
      break;
    case 256:
      if (two) VSR_SEARCH_LAUNCH(2, 2); else VSR_SEARCH_LAUNCH(2, 1);
      break;
    case 768:
      if (two) VSR_SEARCH_LAUNCH(6, 2); else VSR_SEARCH_LAUNCH(6, 1);
      break;
    default:
      return (int)cudaErrorInvalidValue;
  }
#undef VSR_SEARCH_LAUNCH
  return (int)cudaGetLastError();
}
