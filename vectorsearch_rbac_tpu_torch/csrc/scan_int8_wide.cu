// Fused RBAC-masked int8 scan for wide rows (d_pad > 256), with the packed
// group-minimum epilogue.
//
// Replaces the TPU kernel vectorsearch_rbac_tpu/ops/pallas_scan_int8.py
// _make_wide_kernel (launched by int8_masked_topk_wide), the 768-d path,
// with and without its admit-dedup `mask_sb` slot form.
//
// Contract, bit for bit the narrow kernel's (scan_int8.cu) at any d_pad that
// is a multiple of 128: for query q and arena row r
//   dots   = sum_d x8[r, d] * q8[q, d]                       (int32, exact)
//   score  = (l2 ? norms[r] - 2 * dots : -dots) >> score_shift  (arithmetic)
//   admit  = any_w (row_bits[r, w] & query_bits[q, w]) != 0
//   packed = admit ? (score << 7) | (r % group) : 0x7F000000
//   out[r / group, q] = min of packed over the group's rows
// The TPU kernel puts d on a third grid axis and carries the partial dots in
// a VMEM scratch from one grid step to the next. Blocks here run in no order
// and share nothing, so the d sweep is a loop inside the block and the
// partial dots stay in registers; the epilogue runs once, after the loop.
//
// Why not the narrow kernel: it keeps a thread's whole query row in
// registers (int4 qv[d_pad / 16]); at 768-d that is 192 registers for the
// query alone and ptxas spills.
//
// What bounds it on an H100: integer issue rate. Every (row, query) pair
// costs d_pad / 4 __dp4a (192 at 768-d) plus ~W + 8 epilogue operations. A
// block's 128 x 768 row tile (96 KB) is used by 64 queries and then by the
// next query tiles while it sits in L2 (query tiles are the fast grid
// index), so the arena is read from device memory about once per batch: at
// a 2048-query batch that is ~2,000 dp4a per byte from device memory, far
// above what the memory system would limit.
//
// The slot form (mask_sb > 0, the kSlots template flag) reads the mask words of
// query q from row slot(q) of a (Q / mask_sb, W) tensor, in the narrow
// kernel's two layouts (scan_int8.cu): contiguous (slot_tile 0, slot =
// q / mask_sb) or interleaved within tiles of slot_tile queries (slot =
// (q / slot_tile) * nsb + q % nsb, nsb = slot_tile / mask_sb: the TPU
// kernel's pltpu.repeat). Only the block's load of its 64 queries' mask words
// changes, so its output is bit for bit the per-query form's on the expanded
// masks. On the TPU the slot form shrinks the admissibility matmul; here
// admissibility is a W-word AND per pair and the form saves nothing but the
// mask bytes (the reference keeps admit-dedup off on wide rows; the kernel
// lab's wide-admit leg measures it).
//
// Design: a block computes a tile of 128 rows x 64 queries with 256 threads.
// Thread (tr, tq) = (tid % 16, tid / 16) owns 8 contiguous rows tr*8 .. +7
// and 4 queries tq + 16 j, a register tile of 32 int32 dots. The block
// stages 128-byte d-chunks of the row tile and of the query tile in shared
// memory; per 16-byte step a thread reads 8 row words and 4 query words
// (12 loads for 128 __dp4a). Row words are stored with an XOR swizzle of the
// 16-byte slot by (row / 8) % 8, so the 8 threads of a quarter warp, which
// read rows 8 apart, hit 8 different bank groups; the query words are read
// by only two threads' worth of addresses per warp (broadcast). In the
// epilogue a thread reduces its 8 rows, then the group minimum crosses the
// group / 8 threads that share a group, with warp shuffles (they are
// neighbouring lanes). Groups of 8 .. 128 rows all reduce inside their own
// rows. Ragged query tiles load zero queries and store nothing.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kRows = 128;           // rows per block tile
constexpr int kQueries = 64;         // queries per block tile
constexpr int kThreads = 256;
constexpr int kRowsPerThread = 8;    // contiguous rows tr*8 .. tr*8+7
constexpr int kQPerThread = 4;       // queries tq + 16 j
constexpr int kRowSlots = 16;        // threads along the row axis
constexpr int kChunk16 = 8;          // 16-byte words per row per d-chunk
constexpr int kMaxWords = 8;         // role bitset words: up to 256 roles
constexpr int32_t kMasked = 0x7F000000;

static_assert(kRowSlots * kRowsPerThread == kRows, "row tiling");
static_assert((kThreads / kRowSlots) * kQPerThread == kQueries,
              "query tiling");

template <bool kSlots>
__global__ void __launch_bounds__(kThreads, 2)
scan_int8_wide_kernel(const int8_t* __restrict__ q8,         // (Q, d_pad)
                      const int8_t* __restrict__ x8,         // (Npad, d_pad)
                      const int32_t* __restrict__ norms,     // (Npad,)
                      const int32_t* __restrict__ row_bits,  // (Npad, W)
                      const int32_t* __restrict__ q_bits,    // (Q or Q/sb, W)
                      int32_t* __restrict__ out,             // (Npad/group, Q)
                      int nq, int n_qtiles, int d_pad, int w, int group,
                      int l2, int score_shift, int mask_sb, int slot_tile) {
  __shared__ int4 xs[kRows * kChunk16];         // 16 KB, slot-swizzled
  __shared__ int4 qs[kQueries * kChunk16];      // 8 KB
  __shared__ int32_t ns[kRows];
  __shared__ int32_t rb[kRows * kMaxWords];     // word-swizzled like xs
  __shared__ int32_t qb[kQueries * kMaxWords];

  const int tid = threadIdx.x;
  const int tr = tid % kRowSlots;
  const int tq = tid / kRowSlots;
  const int swz = tr & 7;  // == (row / 8) % 8 for each of the thread's rows
  // query tiles vary fastest, so consecutive blocks reuse a row tile from L2
  const int q0 = (blockIdx.x % n_qtiles) * kQueries;
  const size_t row0 = (size_t)(blockIdx.x / n_qtiles) * kRows;
  const int d16 = d_pad / 16;

  for (int i = tid; i < kRows; i += kThreads) ns[i] = norms[row0 + i];
  for (int i = tid; i < kRows * kMaxWords; i += kThreads) {
    const int r = i / kMaxWords, m = i % kMaxWords;
    rb[r * kMaxWords + (m ^ ((r >> 3) & 7))] =
        m < w ? row_bits[(row0 + r) * w + m] : 0;
  }
  for (int i = tid; i < kQueries * kMaxWords; i += kThreads) {
    const int ql = i / kMaxWords, m = i % kMaxWords, q = q0 + ql;
    int row = q;  // the per-query form: row q of (Q, W)
    if (kSlots) {
      const int nsb = slot_tile / mask_sb;
      row = slot_tile > 0 ? (q / slot_tile) * nsb + q % nsb : q / mask_sb;
    }
    qb[i] = (m < w && q < nq) ? q_bits[(size_t)row * w + m] : 0;
  }

  int32_t acc[kRowsPerThread][kQPerThread];
#pragma unroll
  for (int i = 0; i < kRowsPerThread; ++i)
#pragma unroll
    for (int j = 0; j < kQPerThread; ++j) acc[i][j] = 0;

  const int4* xg = reinterpret_cast<const int4*>(x8) + row0 * d16;
  const int4* qg = reinterpret_cast<const int4*>(q8);
  for (int c = 0; c < d16; c += kChunk16) {
    __syncthreads();  // the previous chunk's reads are done
    for (int i = tid; i < kRows * kChunk16; i += kThreads) {
      const int r = i / kChunk16, k = i % kChunk16;
      xs[r * kChunk16 + (k ^ ((r >> 3) & 7))] = xg[(size_t)r * d16 + c + k];
    }
    for (int i = tid; i < kQueries * kChunk16; i += kThreads) {
      const int ql = i / kChunk16, k = i % kChunk16;
      qs[i] = q0 + ql < nq ? qg[(size_t)(q0 + ql) * d16 + c + k]
                           : make_int4(0, 0, 0, 0);
    }
    __syncthreads();
#pragma unroll
    for (int k = 0; k < kChunk16; ++k) {
      int4 a[kRowsPerThread], b[kQPerThread];
#pragma unroll
      for (int i = 0; i < kRowsPerThread; ++i)
        a[i] = xs[(tr * kRowsPerThread + i) * kChunk16 + (k ^ swz)];
#pragma unroll
      for (int j = 0; j < kQPerThread; ++j)
        b[j] = qs[(tq + kRowSlots * j) * kChunk16 + k];
#pragma unroll
      for (int i = 0; i < kRowsPerThread; ++i)
#pragma unroll
        for (int j = 0; j < kQPerThread; ++j) {
          acc[i][j] = __dp4a(a[i].x, b[j].x, acc[i][j]);
          acc[i][j] = __dp4a(a[i].y, b[j].y, acc[i][j]);
          acc[i][j] = __dp4a(a[i].z, b[j].z, acc[i][j]);
          acc[i][j] = __dp4a(a[i].w, b[j].w, acc[i][j]);
        }
    }
  }

  // epilogue: score, shift, admissibility, pack, group minimum
  int32_t qw[kQPerThread][kMaxWords];
#pragma unroll
  for (int j = 0; j < kQPerThread; ++j)
#pragma unroll
    for (int m = 0; m < kMaxWords; ++m)
      qw[j][m] = qb[(tq + kRowSlots * j) * kMaxWords + m];
  int32_t best[kQPerThread];
#pragma unroll
  for (int j = 0; j < kQPerThread; ++j) best[j] = kMasked;
  const int lane_mask = group - 1;  // group is a power of two in [8, 128]
#pragma unroll
  for (int i = 0; i < kRowsPerThread; ++i) {
    const int r = tr * kRowsPerThread + i;
    int32_t rw[kMaxWords];
#pragma unroll
    for (int m = 0; m < kMaxWords; ++m)
      rw[m] = m < w ? rb[r * kMaxWords + (m ^ swz)] : 0;
    const int32_t nr = l2 ? ns[r] : 0;
#pragma unroll
    for (int j = 0; j < kQPerThread; ++j) {
      int32_t hit = 0;
#pragma unroll
      for (int m = 0; m < kMaxWords; ++m) hit |= rw[m] & qw[j][m];
      int32_t score = l2 ? nr - 2 * acc[i][j] : -acc[i][j];
      score >>= score_shift;
      // the unsigned shift: a left shift of a negative int is undefined
      const int32_t packed =
          hit ? (int32_t)(((uint32_t)score << 7) | (uint32_t)(r & lane_mask))
              : kMasked;
      best[j] = min(best[j], packed);
    }
  }
  const int span = group / kRowsPerThread;  // threads per group: 1 .. 16
#pragma unroll
  for (int j = 0; j < kQPerThread; ++j) {
    for (int off = 1; off < span; off <<= 1)
      best[j] = min(best[j], __shfl_xor_sync(0xffffffffu, best[j], off));
    const int q = q0 + tq + kRowSlots * j;
    if ((tr & (span - 1)) == 0 && q < nq)
      out[((row0 + tr * kRowsPerThread) / group) * (size_t)nq + q] = best[j];
  }
}

}  // namespace

// Returns a cudaError_t: cudaErrorInvalidValue for shapes the kernel does not
// take, else the launch's own status. mask_sb and slot_tile as in
// vsr_scan_int8 (0: per-query masks).
extern "C" int vsr_scan_int8_wide(const void* q8, const void* x8,
                                  const void* norms, const void* row_bits,
                                  const void* q_bits, void* out, int nq,
                                  int npad, int d_pad, int w, int group,
                                  int l2, int score_shift, int mask_sb,
                                  int slot_tile, void* stream) {
  const bool group_ok = group >= kRowsPerThread && group <= kRows &&
                        (group & (group - 1)) == 0;
  const bool slots_ok =
      mask_sb == 0 ||
      (mask_sb > 0 && nq % mask_sb == 0 &&
       (slot_tile == 0 ||
        (slot_tile > 0 && slot_tile % mask_sb == 0 && nq % slot_tile == 0)));
  if (nq < 1 || npad < kRows || npad % kRows != 0 || d_pad < 128 ||
      d_pad % 128 != 0 || !group_ok || w < 1 || w > kMaxWords ||
      score_shift < 0 || score_shift > 31 || !slots_ok)
    return (int)cudaErrorInvalidValue;
  const long long n_qtiles = (nq + kQueries - 1) / kQueries;
  const long long blocks = n_qtiles * (npad / kRows);
  if (blocks > 0x7FFFFFFFLL) return (int)cudaErrorInvalidValue;
  auto kernel = mask_sb > 0 ? scan_int8_wide_kernel<true>
                            : scan_int8_wide_kernel<false>;
  kernel<<<(unsigned)blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int8_t*>(q8), static_cast<const int8_t*>(x8),
      static_cast<const int32_t*>(norms), static_cast<const int32_t*>(row_bits),
      static_cast<const int32_t*>(q_bits), static_cast<int32_t*>(out), nq,
      (int)n_qtiles, d_pad, w, group, l2, score_shift, mask_sb, slot_tile);
  return (int)cudaGetLastError();
}
