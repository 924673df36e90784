// Fused RBAC-masked int8 scan with a packed group-minimum epilogue.
//
// Replaces the TPU kernel vectorsearch_rbac_tpu/ops/pallas_scan_int8.py
// _make_kernel (launched by int8_masked_topk), the narrow d_pad <= 256 form.
//
// Contract, bit for bit the TPU kernel's output: for query q and arena row r
//   dots   = sum_d x8[r, d] * q8[q, d]                       (int32, exact)
//   score  = (l2 ? norms[r] - 2 * dots : -dots) >> score_shift  (arithmetic)
//   admit  = any_w (row_bits[r, w] & query_bits[q, w]) != 0
//   packed = admit ? (score << 7) | (r % group) : 0x7F000000
//   out[r / group, q] = min of packed over the group's rows
// The TPU kernel tests admissibility as an int8 matmul of role one-hots
// (roles8 . onehot8 > 0). core.bits_to_onehot8 expands the same bitsets bit
// for bit, so the W-word AND here is the same predicate at W = 4 operations
// per pair instead of a 128-deep dot. The shift is done on the unsigned
// value: a left shift of a negative int is undefined in C++17, and L2 scores
// before the query norm is added are often negative.
//
// What bounds it on an H100: integer issue rate. Every (row, query) pair
// costs d_pad / 4 __dp4a plus ~W + 8 epilogue operations, while a row's
// d_pad + 4 + 4W bytes are shared by every query of a tile: at a 2048-query
// batch that is thousands of operations per byte read from device memory,
// so the arena stream is far from the limit and the dp4a pipe is the limit.
// The int8 tensor cores (wgmma) are not used yet; moving the dots there is
// the next step for this kernel.
//
// Design: one thread per query keeps its int8 query row and its W mask words
// in registers for the whole block. The block stages 128-row tiles of the
// arena (rows, norms, bitsets) in shared memory, where all threads of a warp
// read the same word at once (a broadcast, no bank conflict), and walks
// kTilesPerBlock tiles so the query registers are loaded once per 1024 rows.
// The group minimum is a running minimum in a register, stored once per
// group as a coalesced row of the (n_groups, Q) output.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kTileRows = 128;      // rows staged in shared memory at a time
constexpr int kThreads = 256;       // queries per block
constexpr int kTilesPerBlock = 8;   // tiles a block walks with one query load
constexpr int kMaxWords = 8;        // role bitset words: up to 256 roles
constexpr int32_t kMasked = 0x7F000000;

template <int D16>  // d_pad / 16: 16-byte words per int8 row
__global__ void __launch_bounds__(kThreads)
scan_int8_kernel(const int8_t* __restrict__ q8,         // (Q, d_pad)
                 const int8_t* __restrict__ x8,         // (Npad, d_pad)
                 const int32_t* __restrict__ norms,     // (Npad,)
                 const int32_t* __restrict__ row_bits,  // (Npad, W)
                 const int32_t* __restrict__ q_bits,    // (Q, W)
                 int32_t* __restrict__ out,             // (Npad / group, Q)
                 int nq, int n_tiles, int w, int group, int l2,
                 int score_shift) {
  __shared__ int4 xs[kTileRows * D16];
  __shared__ int32_t ns[kTileRows];
  __shared__ int32_t bs[kTileRows * kMaxWords];

  const int q = blockIdx.y * kThreads + threadIdx.x;
  const bool active = q < nq;
  int4 qv[D16];
  int32_t qb[kMaxWords];
#pragma unroll
  for (int i = 0; i < D16; ++i) qv[i] = make_int4(0, 0, 0, 0);
#pragma unroll
  for (int j = 0; j < kMaxWords; ++j) qb[j] = 0;
  if (active) {
    const int4* qrow = reinterpret_cast<const int4*>(q8) + (size_t)q * D16;
#pragma unroll
    for (int i = 0; i < D16; ++i) qv[i] = qrow[i];
#pragma unroll
    for (int j = 0; j < kMaxWords; ++j)
      if (j < w) qb[j] = q_bits[(size_t)q * w + j];
  }

  const int lane_mask = group - 1;  // group is a power of two <= 128
  for (int t = 0; t < kTilesPerBlock; ++t) {
    const int tile = blockIdx.x * kTilesPerBlock + t;
    if (tile >= n_tiles) break;  // uniform across the block
    const size_t row0 = (size_t)tile * kTileRows;
    __syncthreads();  // the previous tile's reads are done
    const int4* xsrc = reinterpret_cast<const int4*>(x8) + row0 * D16;
    for (int i = threadIdx.x; i < kTileRows * D16; i += kThreads)
      xs[i] = xsrc[i];
    for (int i = threadIdx.x; i < kTileRows; i += kThreads)
      ns[i] = norms[row0 + i];
    for (int i = threadIdx.x; i < kTileRows * w; i += kThreads)
      bs[(i / w) * kMaxWords + i % w] = row_bits[row0 * w + i];
    __syncthreads();
    if (!active) continue;

    int32_t best = kMasked;
#pragma unroll 4
    for (int r = 0; r < kTileRows; ++r) {
      int32_t dot = 0;
#pragma unroll
      for (int i = 0; i < D16; ++i) {
        const int4 xv = xs[r * D16 + i];
        dot = __dp4a(xv.x, qv[i].x, dot);
        dot = __dp4a(xv.y, qv[i].y, dot);
        dot = __dp4a(xv.z, qv[i].z, dot);
        dot = __dp4a(xv.w, qv[i].w, dot);
      }
      int32_t score = l2 ? ns[r] - 2 * dot : -dot;
      score >>= score_shift;
      int32_t hit = 0;
#pragma unroll
      for (int j = 0; j < kMaxWords; ++j) hit |= bs[r * kMaxWords + j] & qb[j];
      const int lane = r & lane_mask;  // row0 is a multiple of group
      const int32_t packed =
          hit ? (int32_t)(((uint32_t)score << 7) | (uint32_t)lane) : kMasked;
      best = lane == 0 ? packed : min(best, packed);
      if (lane == lane_mask)
        out[((row0 + r) / group) * (size_t)nq + q] = best;
    }
  }
}

template <int D16>
void launch(const void* q8, const void* x8, const void* norms,
            const void* row_bits, const void* q_bits, void* out, int nq,
            int npad, int w, int group, int l2, int score_shift,
            cudaStream_t stream) {
  const int n_tiles = npad / kTileRows;
  const dim3 grid((n_tiles + kTilesPerBlock - 1) / kTilesPerBlock,
                  (nq + kThreads - 1) / kThreads);
  scan_int8_kernel<D16><<<grid, kThreads, 0, stream>>>(
      static_cast<const int8_t*>(q8), static_cast<const int8_t*>(x8),
      static_cast<const int32_t*>(norms), static_cast<const int32_t*>(row_bits),
      static_cast<const int32_t*>(q_bits), static_cast<int32_t*>(out), nq,
      n_tiles, w, group, l2, score_shift);
}

}  // namespace

// Returns a cudaError_t: cudaErrorInvalidValue for shapes the kernel does not
// take, else the launch's own status.
extern "C" int vsr_scan_int8(const void* q8, const void* x8, const void* norms,
                             const void* row_bits, const void* q_bits,
                             void* out, int nq, int npad, int d_pad, int w,
                             int group, int l2, int score_shift,
                             void* stream) {
  const bool group_ok = group >= 1 && group <= kTileRows &&
                        (group & (group - 1)) == 0;
  if (nq < 1 || npad < kTileRows || npad % kTileRows != 0 || !group_ok ||
      w < 1 || w > kMaxWords || score_shift < 0 || score_shift > 31)
    return (int)cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (d_pad) {
    case 128:
      launch<8>(q8, x8, norms, row_bits, q_bits, out, nq, npad, w, group, l2,
                score_shift, s);
      break;
    case 256:
      launch<16>(q8, x8, norms, row_bits, q_bits, out, nq, npad, w, group, l2,
                 score_shift, s);
      break;
    default:
      return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

extern "C" const char* vsr_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
