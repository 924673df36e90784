// The two kernels of one HNSW graph step: candidate scoring from packed rows,
// and the step's three stable merges.
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
// query's candidates, then the W + 1 tail words; a shuffle reduction sums
// the dot and a ballot ORs the bitset test.
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

namespace {

constexpr int kWarp = 32;
constexpr int kScoreWarps = 4;   // warps (candidates in flight) per query
constexpr int kMergeWarps = 4;   // queries per block
constexpr unsigned kFull = 0xFFFFFFFFu;

template <int kWords>  // code words per lane: d_pad / 128
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
  const int code_words = kWords * kWarp;
  float qv[kWords][4];
#pragma unroll
  for (int j = 0; j < kWords; ++j)
#pragma unroll
    for (int b = 0; b < 4; ++b)
      qv[j][b] = qf[(size_t)q * code_words * 4 + (lane + j * kWarp) * 4 + b];
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
#pragma unroll
    for (int j = 0; j < kWords; ++j) {
      const uint32_t word = r[lane + j * kWarp];
#pragma unroll
      for (int b = 0; b < 4; ++b)
        part += (float)(int8_t)((word >> (8 * b)) & 0xFFu) * qv[j][b];
    }
    const uint32_t tail = lane <= w ? r[code_words + lane] : 0u;
    const bool hit = lane < w && (tail & my_mask) != 0u;
    const unsigned any = __ballot_sync(kFull, hit);
    const float norm = __uint_as_float(__shfl_sync(kFull, tail, w));
#pragma unroll
    for (int off = kWarp / 2; off > 0; off >>= 1)
      part += __shfl_xor_sync(kFull, part, off);
    if (lane == 0) {
      const float dots = __fadd_rn(__fmul_rn(part, dq_scale), center_dot);
      out_s[o] = __fsub_rn(norm, __fmul_rn(2.f, dots));
      out_ok[o] = any != 0u;
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

}  // namespace

extern "C" int vsr_graph_score_packed(const void* ids, const void* row_map,
                                      const void* pids, int n_class,
                                      const void* packed, int unit_bytes,
                                      const void* qf, const void* qmask,
                                      const void* qcd, float dq_scale,
                                      void* out_s, void* out_ok, int nq,
                                      int c_width, int d_pad, int w,
                                      void* stream) {
  if (nq < 1 || c_width < 1 || w < 1 || w >= kWarp ||
      d_pad % 128 != 0 || unit_bytes != d_pad + 4 * w + 4)
    return (int)cudaErrorInvalidValue;
  const int unit_words = unit_bytes / 4;
  const auto s = static_cast<cudaStream_t>(stream);
  const dim3 grid(nq), block(kScoreWarps * kWarp);
#define VSR_SCORE_ARGS                                                        \
  static_cast<const int32_t*>(ids), static_cast<const int32_t*>(row_map),     \
      static_cast<const int32_t*>(pids), n_class,                             \
      static_cast<const uint32_t*>(packed), unit_words,                       \
      static_cast<const float*>(qf), static_cast<const int32_t*>(qmask),      \
      static_cast<const float*>(qcd), dq_scale, static_cast<float*>(out_s),   \
      static_cast<uint8_t*>(out_ok), c_width, w
  switch (d_pad / 128) {
    case 1:
      graph_score_packed_kernel<1><<<grid, block, 0, s>>>(VSR_SCORE_ARGS);
      break;
    case 2:
      graph_score_packed_kernel<2><<<grid, block, 0, s>>>(VSR_SCORE_ARGS);
      break;
    case 6:
      graph_score_packed_kernel<6><<<grid, block, 0, s>>>(VSR_SCORE_ARGS);
      break;
    default:
      return (int)cudaErrorInvalidValue;
  }
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
