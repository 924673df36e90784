// Fused RBAC-masked int8 scan with a packed group-minimum epilogue.
//
// Replaces the TPU kernel vectorsearch_rbac_tpu/ops/pallas_scan_int8.py
// _make_kernel (launched by int8_masked_topk), the narrow d_pad <= 256 form,
// with and without its admit-dedup `mask_sub_block` slot form (also the lab
// kernel scripts/r4_admit_lab.py scan_sb, in both of its slot layouts).
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
// The slot form (mask_sb > 0) reads the mask words of query q from row
// slot(q) of a (Q / mask_sb, W) tensor instead of row q of a (Q, W) one:
//   slot_tile == 0: slot = q / mask_sb            (contiguous slots)
//   slot_tile  > 0: slot = (q / slot_tile) * nsb + q % nsb,
//                   nsb = slot_tile / mask_sb      (interleaved slots: the
//                   TPU kernel's tile-style pltpu.repeat inside each q_tile)
// and its output is bit for bit that of the per-query form on the expanded
// masks. In the slot form a warp whose queries share one or two slots (the
// contiguous layout with mask_sb >= 16) mostly agrees on admissibility, so
// each row is first voted on across the warp (__any_sync) and its dots are
// skipped when no query of the warp may read it: such a row packs to
// 0x7F000000 whatever its score, so the output does not change.
//
// The lab's epilogue variants (also the lab kernel scripts/r4_kernel_variants.py
// int8_masked_topk_lab, S1), selected by the kEpi template flag, per-query
// masks only, as the lab's:
//   kTrim:  the pack folded into the score arithmetic: l2 without a shift
//           packs (norms[r] << 7) - (dots << 8) | lane, ip -dots << 7 | lane;
//           with a shift the shift-then-pack chain above. Both are (score <<
//           7) | lane in 32-bit arithmetic, so the output equals kPlain's bit
//           for bit; the variant times the cheaper instruction chain.
//   kFloor: a lower-bound probe, not a correct kernel: out[g, q] = min over
//           the group of (dots + admit), where admit is the number of roles
//           row and query share (the TPU's one-hot matmul count: the popcount
//           of the AND summed over the W words). No pack, no lane, no mask.
// The TPU lab's unroll and chunk knobs schedule Mosaic and size VMEM; they
// have no counterpart here.
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
constexpr int kPlain = 0, kTrim = 1, kFloor = 2;  // epilogue variants (kEpi)

template <int D16>
__device__ __forceinline__ int32_t row_dot(const int4* x, const int4* qv) {
  int32_t dot = 0;
#pragma unroll
  for (int i = 0; i < D16; ++i) {
    const int4 xv = x[i];
    dot = __dp4a(xv.x, qv[i].x, dot);
    dot = __dp4a(xv.y, qv[i].y, dot);
    dot = __dp4a(xv.z, qv[i].z, dot);
    dot = __dp4a(xv.w, qv[i].w, dot);
  }
  return dot;
}

// kSlots selects the slot form and kEpi the epilogue at compile time, so that
// the per-query form keeps the instruction stream it had before either
// existed (a run-time slot flag cost 12%).
template <int D16, bool kSlots, int kEpi>  // D16 = d_pad / 16: words per row
__global__ void __launch_bounds__(kThreads)
scan_int8_kernel(const int8_t* __restrict__ q8,         // (Q, d_pad)
                 const int8_t* __restrict__ x8,         // (Npad, d_pad)
                 const int32_t* __restrict__ norms,     // (Npad,)
                 const int32_t* __restrict__ row_bits,  // (Npad, W)
                 const int32_t* __restrict__ q_bits,    // (Q or Q / mask_sb, W)
                 int32_t* __restrict__ out,             // (Npad / group, Q)
                 int nq, int n_tiles, int w, int group, int l2,
                 int score_shift, int mask_sb, int slot_tile) {
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
    int row = q;  // the per-query form: row q of (Q, W)
    if (kSlots) {
      const int nsb = slot_tile / mask_sb;
      row = slot_tile > 0 ? (q / slot_tile) * nsb + q % nsb : q / mask_sb;
    }
#pragma unroll
    for (int j = 0; j < kMaxWords; ++j)
      if (j < w) qb[j] = q_bits[(size_t)row * w + j];
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
    // the slot form votes each row across the warp, so every lane of the
    // warp walks every tile (an inactive lane's words stay 0: it admits
    // nothing and stores nothing)
    if (!kSlots && !active) continue;

    int32_t best = kMasked;
#pragma unroll 4
    for (int r = 0; r < kTileRows; ++r) {
      int32_t dot = 0, hit = 0;
      if (kSlots) {
#pragma unroll
        for (int j = 0; j < kMaxWords; ++j)
          hit |= bs[r * kMaxWords + j] & qb[j];
        // warp-uniform: the whole warp takes the dots or skips them
        if (__any_sync(0xffffffffu, hit != 0))
          dot = row_dot<D16>(xs + r * D16, qv);
      } else {
        dot = row_dot<D16>(xs + r * D16, qv);
      }
      const int lane = r & lane_mask;  // row0 is a multiple of group
      int32_t packed;
      if (kEpi == kFloor) {
        int32_t count = 0;
#pragma unroll
        for (int j = 0; j < kMaxWords; ++j)
          count += __popc(bs[r * kMaxWords + j] & qb[j]);
        packed = dot + count;
      } else {
        uint32_t p;  // the score << 7, in unsigned arithmetic
        if (kEpi == kTrim && score_shift == 0) {
          p = l2 ? ((uint32_t)ns[r] << 7) - ((uint32_t)dot << 8)
                 : (uint32_t)(-dot) << 7;
        } else {
          int32_t score = l2 ? ns[r] - 2 * dot : -dot;
          score >>= score_shift;
          p = (uint32_t)score << 7;
        }
        if (!kSlots) {
#pragma unroll
          for (int j = 0; j < kMaxWords; ++j)
            hit |= bs[r * kMaxWords + j] & qb[j];
        }
        packed = hit ? (int32_t)(p | (uint32_t)lane) : kMasked;
      }
      best = lane == 0 ? packed : min(best, packed);
      if (lane == lane_mask && (!kSlots || active))
        out[((row0 + r) / group) * (size_t)nq + q] = best;
    }
  }
}

template <int D16>
void launch(const void* q8, const void* x8, const void* norms,
            const void* row_bits, const void* q_bits, void* out, int nq,
            int npad, int w, int group, int l2, int score_shift, int mask_sb,
            int slot_tile, int variant, cudaStream_t stream) {
  const int n_tiles = npad / kTileRows;
  const dim3 grid((n_tiles + kTilesPerBlock - 1) / kTilesPerBlock,
                  (nq + kThreads - 1) / kThreads);
  auto kernel = mask_sb > 0          ? scan_int8_kernel<D16, true, kPlain>
                : variant == kTrim   ? scan_int8_kernel<D16, false, kTrim>
                : variant == kFloor  ? scan_int8_kernel<D16, false, kFloor>
                                     : scan_int8_kernel<D16, false, kPlain>;
  kernel<<<grid, kThreads, 0, stream>>>(
      static_cast<const int8_t*>(q8), static_cast<const int8_t*>(x8),
      static_cast<const int32_t*>(norms), static_cast<const int32_t*>(row_bits),
      static_cast<const int32_t*>(q_bits), static_cast<int32_t*>(out), nq,
      n_tiles, w, group, l2, score_shift, mask_sb, slot_tile);
}

int scan(const void* q8, const void* x8, const void* norms,
         const void* row_bits, const void* q_bits, void* out, int nq,
         int npad, int d_pad, int w, int group, int l2, int score_shift,
         int mask_sb, int slot_tile, int variant, void* stream) {
  const bool group_ok = group >= 1 && group <= kTileRows &&
                        (group & (group - 1)) == 0;
  const bool slots_ok =
      mask_sb == 0 ||
      (mask_sb > 0 && variant == kPlain && nq % mask_sb == 0 &&
       (slot_tile == 0 ||
        (slot_tile > 0 && slot_tile % mask_sb == 0 && nq % slot_tile == 0)));
  if (nq < 1 || npad < kTileRows || npad % kTileRows != 0 || !group_ok ||
      w < 1 || w > kMaxWords || score_shift < 0 || score_shift > 31 ||
      !slots_ok || variant < kPlain || variant > kFloor)
    return (int)cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (d_pad) {
    case 128:
      launch<8>(q8, x8, norms, row_bits, q_bits, out, nq, npad, w, group, l2,
                score_shift, mask_sb, slot_tile, variant, s);
      break;
    case 256:
      launch<16>(q8, x8, norms, row_bits, q_bits, out, nq, npad, w, group, l2,
                 score_shift, mask_sb, slot_tile, variant, s);
      break;
    default:
      return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

}  // namespace

// Returns a cudaError_t: cudaErrorInvalidValue for shapes the kernel does not
// take, else the launch's own status. mask_sb 0 is the per-query form; > 0
// the slot form (q_bits holds Q / mask_sb rows), contiguous with slot_tile
// 0, interleaved within tiles of slot_tile queries otherwise.
extern "C" int vsr_scan_int8(const void* q8, const void* x8, const void* norms,
                             const void* row_bits, const void* q_bits,
                             void* out, int nq, int npad, int d_pad, int w,
                             int group, int l2, int score_shift, int mask_sb,
                             int slot_tile, void* stream) {
  return scan(q8, x8, norms, row_bits, q_bits, out, nq, npad, d_pad, w, group,
              l2, score_shift, mask_sb, slot_tile, kPlain, stream);
}

// The lab's epilogue variants on per-query masks: variant 1 trim, 2 floor.
extern "C" int vsr_scan_int8_lab(const void* q8, const void* x8,
                                 const void* norms, const void* row_bits,
                                 const void* q_bits, void* out, int nq,
                                 int npad, int d_pad, int w, int group, int l2,
                                 int score_shift, int variant, void* stream) {
  if (variant != kTrim && variant != kFloor) return (int)cudaErrorInvalidValue;
  return scan(q8, x8, norms, row_bits, q_bits, out, nq, npad, d_pad, w, group,
              l2, score_shift, 0, 0, variant, stream);
}

extern "C" const char* vsr_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
