// Fused RBAC-masked int8 scan for wide rows (d_pad > 256), with the packed
// group-minimum epilogue; the dots run on the int8 tensor cores (wgmma).
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
// a VMEM scratch from one grid step to the next, computing them on its
// matrix unit (an int8 dot_general into int32). Blocks here run in no order
// and share nothing, so the d sweep is a loop inside the block; the
// tensor cores' int32 accumulators stay in registers and the epilogue runs
// once, after the loop. int8 products summed in int32 are exact (768 * 128
// * 128 is far from 2^31), so the output is the plain version's bit for bit.
//
// What bounds it on an H100: the int8 tensor cores, 2 * d_pad operations a
// (query, row) pair (1.667 ms for 2048 queries x 1M rows x 768 at 1,979
// TOP/s). The first port computed the dots with __dp4a on the CUDA cores,
// 192 a pair at 768-d: 34.7 ms, near what dp4a can issue on this card.
// Query tiles are the fast grid index, so the blocks of one row tile run
// together and share it in L2, and the arena is read from device memory
// about once a batch (768 MB, 0.23 ms). What keeps it above the bound: the
// epilogue (~W + 4 integer operations a pair on the CUDA cores) runs after
// a block's dots, not under them, and the two blocks of an SM, which start
// together, do not hide it for each other; each row tile is also read
// from L2 once per query tile. Persistent forms that let two warpgroups
// take turns on the tensor cores (one's epilogue under the other's dots)
// ran slower in this form; by my reading, not measured apart, one
// warpgroup's stream of m64n128 products at a time does not fill the
// tensor cores.
//
// The slot form (mask_sb > 0, the kSlots template flag) reads the mask words of
// query q from row slot(q) of a (Q / mask_sb, W) tensor, in the narrow
// kernel's two layouts (scan_int8.cu): contiguous (slot_tile 0, slot =
// q / mask_sb) or interleaved within tiles of slot_tile queries (slot =
// (q / slot_tile) * nsb + q % nsb, nsb = slot_tile / mask_sb: the TPU
// kernel's pltpu.repeat). Only the threads' load of their queries' mask
// words changes, so its output is bit for bit the per-query form's on the
// expanded masks. On the TPU the slot form shrinks the admissibility
// matmul; here admissibility is a W-word AND per pair and the form saves
// nothing but the mask bytes (the reference keeps admit-dedup off on wide
// rows; the kernel lab's wide-admit leg measures it).
//
// Design: a block computes a tile of 128 queries x 128 rows with two
// warpgroups; warpgroup g owns queries 64 g .. 64 g + 63 and issues
// wgmma.mma_async m64n128k32 s32.s8.s8, queries on the M side and rows on
// the N side, both operands K-major from shared memory (as q8 (Q, d_pad)
// and x8 (Npad, d_pad) lie), four instructions per 128-byte d-chunk. One
// thread keeps the chunks in flight with TMA (cp.async.bulk.tensor, one
// 128-byte x 128-row box of each operand a stage, in the 128-byte swizzle
// wgmma reads; query rows past nq arrive as zeros) into a ring of kStages
// stages: full[s] counts the bytes in, empty[s] the warpgroups done with
// the stage. Each warpgroup keeps one chunk's wgmma in flight while it
// waits for the one before, so the tensor cores see no barrier between
// chunks. The row tile's words (two planes of 4 words a row: a quad's 4
// rows sit 16 bytes apart, in 4 bank groups) and norms come by cp.async
// under the dots. A thread's accumulators hold 2 queries (lane / 4 and
// lane / 4 + 8 of its warp's 16) x 32 rows (2 adjacent rows in each 8-row
// slice), so a group of 8 .. 128 rows reduces over the thread's own
// columns and then across the 4 lanes of its quad with two shuffles: no
// shared memory. The epilogue keeps its 2 queries' words in registers and
// reads the second plane only where W > 4. Two blocks fit an SM (~104 KB
// of shared memory, 114 registers, no spills).
//
// The wide-world forms (kWords 16 and 32: W 9-16 and 17-32, 257 to 1,024
// roles) count the shared roles of each (query, row) pair on the binary
// tensor cores, as the narrow kernel's do (scan_int8.cu): the row words
// come as kWords / 4 planes, and the epilogue takes one mma.sync
// m16n8k256 b1 AND.POPC an 8-row slice and 256 roles into four registers
// in the places of the slice's accumulators, then scores and keeps a pair
// where its count is not 0. The query side is the binary product's A
// fragment (kWords / 2 registers), not 2 W words. At kWords 32 the ring
// has 2 stages, so that two blocks still fit an SM beside the 16 KB of
// planes.
//
// The huge forms (kHugeWords: any W past 32, worlds past 1,024 roles)
// stage no words before the epilogue; it tests a pair 32 words at a time
// (huge_tile_bits in tma_wgmma.cuh): the block's 256 threads copy the
// chunk's words of the tile's rows and of its 128 queries into the planes'
// place, and each warp runs 4 binary products a slice, one admit bit a
// pair; the pair is then scored and kept where its bit is set. A first
// design read the row words past 32 from L2 in every warp, spilled, and
// took 18-41 ms at W 64-128 (PERF.md).

#include "tma_wgmma.cuh"

namespace {

constexpr int kRows = 128;       // arena rows per tile: the wgmma N
constexpr int kQueries = 128;    // queries per tile: 2 x the wgmma M
constexpr int kThreads = 256;    // two warpgroups
constexpr int kChunk = 128;      // d bytes per stage: one swizzled line
constexpr int kMaxWords = 8;     // bitset words of the W <= 8 forms
constexpr int kWideWords = 32;   // of the wide-world forms: 1,024 roles
constexpr int kHugeWords = 64;   // the huge forms' tag: any W past 32
constexpr int32_t kMasked = 0x7F000000;
constexpr int kTileBytes = kRows * kChunk;   // 16 KB, also kQueries * kChunk
constexpr int kStageBytes = 2 * kTileBytes;  // the query tile, then the rows

static_assert(kQueries * kChunk == kTileBytes, "tile bytes");

// A form's ring and row data: the tile's words as planes of (kRows, 4)
// words (two where W <= 8), then its norms.
template <int kWords>
struct Geo {
  static constexpr bool kWide = kWords > kMaxWords;
  // the huge forms stage no words before the epilogue: it copies them 32
  // at a time into the planes' place (huge_tile_bits)
  static constexpr bool kHuge = kWords > kWideWords;
  static constexpr int kStages = kWords <= 16 ? 3 : 2;
  static constexpr int kPlanes = kHuge ? 0 : kWide ? kWords / 4 : 2;
  static constexpr int kPlaneBytes =
      kHuge ? HugeChunk<kQueries>::kBytes : kPlanes * kRows * 16;
  static constexpr int kRowDataBytes = kPlaneBytes + kRows * 4;
  static constexpr int kSmemBytes = 1024  // slack to align the ring
                                    + kStages * kStageBytes + kRowDataBytes
                                    + 2 * kStages * 8;  // full and empty
  // two blocks an SM (228 KB, 1 KB of it reserved a block)
  static_assert(2 * (kSmemBytes + 1024) <= 233472, "two blocks an SM");
};

// The epilogue of one tile: score, shift, admissibility, pack, group
// minimum, store. Thread (warp, lane) of a warpgroup holds queries qa and
// qa + 8 and, in slice n8 of 8 rows, rows 8 n8 + 2 (lane % 4) + {0, 1}:
// acc[4 n8 + 2 i + j]. kWords is 4 (W <= 4: the second plane of row words
// is not read) or 8. The packed score (v >> s) << 7, v = norms - 2 dots or
// -dots, is v << (7 - s) with its low 7 bits cleared when s <= 7 (one
// multiply-add a pair, exact in 32-bit wrapping arithmetic) and
// (v >> (s - 7)) with them cleared when s > 7 (kDown).
template <int kWords, bool kDown>
__device__ __forceinline__ void tile_epilogue(
    const int32_t (&acc)[64], const int32_t (&qw)[2][kMaxWords],
    const int4* __restrict__ planes, const int32_t* __restrict__ ns,
    int32_t* __restrict__ out, size_t row0, int qa, int nq, int group, int l2,
    int score_shift) {
  const int lane = threadIdx.x % 32;
  const int lane_mask = group - 1;  // group is a power of two in [8, 128]
  const int span = group / 8;       // 8-row slices per group: 1 .. 16
  const int up = kDown ? 0 : 7 - score_shift;
  const int down = kDown ? score_shift - 7 : 0;
  const uint32_t mul = (uint32_t)(l2 ? -2 : -1) << up;
  int32_t best[2] = {kMasked, kMasked};
#pragma unroll
  for (int n8 = 0; n8 < kRows / 8; ++n8) {
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const int n = n8 * 8 + (lane % 4) * 2 + j;
      const int4 b0 = planes[n];
      const int4 b1 = kWords > 4 ? planes[kRows + n] : make_int4(0, 0, 0, 0);
      const uint32_t base = l2 ? (uint32_t)ns[n] << up : 0u;
      const uint32_t rank = (uint32_t)(n & lane_mask);
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        int32_t hit = (b0.x & qw[i][0]) | (b0.y & qw[i][1]) |
                      (b0.z & qw[i][2]) | (b0.w & qw[i][3]);
        if (kWords > 4)
          hit |= (b1.x & qw[i][4]) | (b1.y & qw[i][5]) | (b1.z & qw[i][6]) |
                 (b1.w & qw[i][7]);
        uint32_t v = (uint32_t)acc[4 * n8 + 2 * i + j] * mul + base;
        if (kDown) v = (uint32_t)((int32_t)v >> down);
        const int32_t packed = (int32_t)((v & ~127u) | rank);
        if (hit) best[i] = min(best[i], packed);
      }
    }
    if (((n8 + 1) & (span - 1)) == 0) {  // slice n8 closes a group
      const size_t g = (row0 + n8 * 8) / group;
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        best[i] = min(best[i], __shfl_xor_sync(0xffffffffu, best[i], 1));
        best[i] = min(best[i], __shfl_xor_sync(0xffffffffu, best[i], 2));
        const int q = qa + 8 * i;
        if (lane % 4 == 0 && q < nq) out[g * (size_t)nq + q] = best[i];
        best[i] = kMasked;
      }
    }
  }
}

// The wide forms' epilogue of the tile: for each 8-row slice, the shared
// roles of the thread's 4 (query, row) pairs by one binary product a
// 256-role chunk (qf: words 8c + lane % 4 and + 4 of queries qa and qa + 8;
// B from planes 2c and 2c + 1, row 8 n8 + lane / 4), in the places of the
// slice's accumulators; a slice none of whose pairs the warp admits is
// skipped by the whole warp, otherwise a pair is scored, packed and kept
// where its count is not 0. Then as tile_epilogue.
template <int kWords, bool kDown>
__device__ __forceinline__ void tile_epilogue_wide(
    const int32_t (&acc)[64], const uint32_t (&qf)[kWords / 8][4],
    const int4* __restrict__ planes, const int32_t* __restrict__ ns,
    int32_t* __restrict__ out, size_t row0, int qa, int nq, int group, int l2,
    int score_shift) {
  const int32_t* words = reinterpret_cast<const int32_t*>(planes);
  const int lane = threadIdx.x % 32;
  const int lane_mask = group - 1;
  const int span = group / 8;
  const int up = kDown ? 0 : 7 - score_shift;
  const int down = kDown ? score_shift - 7 : 0;
  const uint32_t mul = (uint32_t)(l2 ? -2 : -1) << up;
  int32_t best[2] = {kMasked, kMasked};
#pragma unroll
  for (int n8 = 0; n8 < kRows / 8; ++n8) {
    const int r = 8 * n8 + lane / 4;
    int32_t c[4] = {0, 0, 0, 0};
#pragma unroll
    for (int k = 0; k < kWords / 8; ++k)
      bmma_and_popc(c[0], c[1], c[2], c[3], qf[k],
                    (uint32_t)words[4 * (2 * k * kRows + r) + lane % 4],
                    (uint32_t)words[4 * ((2 * k + 1) * kRows + r) + lane % 4]);
    if (__any_sync(0xffffffffu, c[0] | c[1] | c[2] | c[3])) {  // uniform
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const int n = n8 * 8 + (lane % 4) * 2 + j;
        const uint32_t base = l2 ? (uint32_t)ns[n] << up : 0u;
        const uint32_t rank = (uint32_t)(n & lane_mask);
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          uint32_t v = (uint32_t)acc[4 * n8 + 2 * i + j] * mul + base;
          if (kDown) v = (uint32_t)((int32_t)v >> down);
          const int32_t packed = (int32_t)((v & ~127u) | rank);
          if (c[2 * i + j]) best[i] = min(best[i], packed);
        }
      }
    }
    asm volatile("" ::: "memory");  // one slice's reads at a time
    if (((n8 + 1) & (span - 1)) == 0) {  // slice n8 closes a group
      const size_t g = (row0 + n8 * 8) / group;
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        best[i] = min(best[i], __shfl_xor_sync(0xffffffffu, best[i], 1));
        best[i] = min(best[i], __shfl_xor_sync(0xffffffffu, best[i], 2));
        const int q = qa + 8 * i;
        if (lane % 4 == 0 && q < nq) out[g * (size_t)nq + q] = best[i];
        best[i] = kMasked;
      }
    }
  }
}

// The huge forms' epilogue of the tile (W > 32): as tile_epilogue_wide,
// with each pair's shared-role bit from huge_tile_bits (adm[h]: bit 4 n +
// 2 i + j of slice 8 h + n) in the place of its count.
template <bool kDown>
__device__ __forceinline__ void tile_epilogue_huge(
    const int32_t (&acc)[64], const uint32_t (&adm)[2],
    const int32_t* __restrict__ ns, int32_t* __restrict__ out, size_t row0,
    int qa, int nq, int group, int l2, int score_shift) {
  const int lane = threadIdx.x % 32;
  const int lane_mask = group - 1;
  const int span = group / 8;
  const int up = kDown ? 0 : 7 - score_shift;
  const int down = kDown ? score_shift - 7 : 0;
  const uint32_t mul = (uint32_t)(l2 ? -2 : -1) << up;
  int32_t best[2] = {kMasked, kMasked};
#pragma unroll
  for (int n8 = 0; n8 < kRows / 8; ++n8) {
    const uint32_t mine = (adm[n8 / 8] >> (4 * (n8 % 8))) & 15u;
    if (__any_sync(0xffffffffu, mine)) {  // uniform
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const int n = n8 * 8 + (lane % 4) * 2 + j;
        const uint32_t base = l2 ? (uint32_t)ns[n] << up : 0u;
        const uint32_t rank = (uint32_t)(n & lane_mask);
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          uint32_t v = (uint32_t)acc[4 * n8 + 2 * i + j] * mul + base;
          if (kDown) v = (uint32_t)((int32_t)v >> down);
          const int32_t packed = (int32_t)((v & ~127u) | rank);
          if ((mine >> (2 * i + j)) & 1u) best[i] = min(best[i], packed);
        }
      }
    }
    if (((n8 + 1) & (span - 1)) == 0) {  // slice n8 closes a group
      const size_t g = (row0 + n8 * 8) / group;
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        best[i] = min(best[i], __shfl_xor_sync(0xffffffffu, best[i], 1));
        best[i] = min(best[i], __shfl_xor_sync(0xffffffffu, best[i], 2));
        const int q = qa + 8 * i;
        if (lane % 4 == 0 && q < nq) out[g * (size_t)nq + q] = best[i];
        best[i] = kMasked;
      }
    }
  }
}

template <bool kSlots, int kWords>
__global__ void __launch_bounds__(kThreads, 2)
scan_int8_wide_kernel(const __grid_constant__ CUtensorMap q_map,  // q8
                      const __grid_constant__ CUtensorMap x_map,  // x8
                      const int32_t* __restrict__ norms,     // (Npad,)
                      const int32_t* __restrict__ row_bits,  // (Npad, W)
                      const int32_t* __restrict__ q_bits,    // (Q or Q/sb, W)
                      int32_t* __restrict__ out,             // (Npad/group, Q)
                      int nq, int n_qtiles, int d_pad, int w, int group,
                      int l2, int score_shift, int mask_sb, int slot_tile) {
  using G = Geo<kWords>;
  constexpr int kStages = G::kStages;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = smem_addr(smem_raw);
  uint8_t* smem = smem_raw + (((raw + 1023u) & ~1023u) - raw);
  const uint32_t ring = smem_addr(smem);  // 1024-aligned: swizzle atoms
  uint8_t* row_data = smem + kStages * kStageBytes;
  // full[s]: stage s's two boxes landed; empty[s]: both warpgroups' wgmma
  // finished reading it
  const uint32_t bars = smem_addr(row_data + G::kRowDataBytes);
  auto full = [&](int s) { return bars + 8 * s; };
  auto empty = [&](int s) { return bars + 8 * (kStages + s); };

  const int tid = threadIdx.x;
  const int wg = tid / 128;
  // query tiles vary fastest, so consecutive blocks share a row tile in L2
  const int q0 = (blockIdx.x % n_qtiles) * kQueries;
  const size_t row0 = (size_t)(blockIdx.x / n_qtiles) * kRows;
  const int nk = d_pad / kChunk;

  // stage d-chunk c of the query tile and of the row tile into stage s
  auto load_chunk = [&](int c, int s) {
    const uint32_t a_s = ring + s * kStageBytes;
    mbar_expect(full(s), kStageBytes);
    tma_load(a_s, &q_map, c * kChunk, q0, full(s));
    tma_load(a_s + kTileBytes, &x_map, c * kChunk, (int)row0, full(s));
  };
  if (tid == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(full(s), 1);
      mbar_init(empty(s), 2);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    for (int s = 0; s < kStages && s < nk; ++s) load_chunk(s, s);
  }
  // the row tile's words (zero past w; as many planes as the form reads)
  // and norms, waited for before the epilogue
  constexpr int kStaged = G::kHuge ? 0 : G::kWide ? kWords : kMaxWords;
  for (int i = tid; i < kRows * kStaged; i += kThreads) {
    const int r = i / kStaged, m = i % kStaged;
    cp_async4(smem_addr(row_data + (m / 4) * kRows * 16 + r * 16 + m % 4 * 4),
              row_bits + (row0 + r) * w + (m < w ? m : 0), m < w ? 4 : 0);
  }
  for (int i = tid; i < kRows; i += kThreads)
    cp_async4(smem_addr(row_data + G::kPlaneBytes + i * 4),
              norms + row0 + i, 4);
  asm volatile("cp.async.commit_group;\n" ::: "memory");
  __syncthreads();  // the barriers are initialised

  int32_t acc[64];
#pragma unroll
  for (int i = 0; i < 64; ++i) acc[i] = 0;
  for (int c = 0; c < nk; ++c) {
    const int s = c % kStages;
    mbar_wait(full(s), (c / kStages) & 1);
    const uint32_t a_s = ring + s * kStageBytes + wg * 64 * 128;
    const uint32_t b_s = ring + s * kStageBytes + kTileBytes;
    fence_acc(acc);
    asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
#pragma unroll
    for (int k = 0; k < kChunk / 32; ++k)
      wgmma_m64n128k32(acc, sw128_desc(a_s + 32 * k),
                       sw128_desc(b_s + 32 * k));
    asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
    // chunk c stays in flight; chunk c - 1's reads are done
    asm volatile("wgmma.wait_group.sync.aligned 1;\n" ::: "memory");
    fence_acc(acc);
    if (c == 0) continue;
    const int sp = (c - 1) % kStages;
    if (tid % 128 == 0) mbar_arrive(empty(sp));
    const int n = c - 1 + kStages;  // the chunk that refills stage sp
    if (tid == 0 && n < nk) {
      mbar_wait(empty(sp), ((c - 1) / kStages) & 1);
      load_chunk(n, sp);
    }
  }
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
  fence_acc(acc);

  const int qa =
      q0 + wg * 64 + ((tid % 128) / 32) * 16 + (tid % 32) / 4;
  int32_t qw[2][kMaxWords];
  // the wide forms: the binary products' A fragments, words 8c + lane % 4
  // and + 4 of queries qa (k even) and qa + 8 (k odd)
  constexpr int kFrag = G::kWide && !G::kHuge ? kWords / 8 : 1;
  uint32_t qf[kFrag][4];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int q = qa + 8 * i;
    int row = q;  // the per-query form: row q of (Q, W)
    if (kSlots) {
      const int nsb = slot_tile / mask_sb;
      row = slot_tile > 0 ? (q / slot_tile) * nsb + q % nsb : q / mask_sb;
    }
#pragma unroll
    for (int m = 0; m < kMaxWords; ++m)
      qw[i][m] = (!G::kWide && m < w && q < nq) ? q_bits[(size_t)row * w + m]
                                                 : 0;
    if constexpr (G::kWide && !G::kHuge) {
#pragma unroll
      for (int c = 0; c < kWords / 8; ++c)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int m = 8 * c + tid % 4 + 4 * h;
          qf[c][i + 2 * h] =
              (m < w && q < nq) ? (uint32_t)q_bits[(size_t)row * w + m] : 0u;
        }
    }
  }
  asm volatile("cp.async.wait_all;\n" ::: "memory");
  __syncthreads();  // every thread's row words and norms landed
  const int4* planes = reinterpret_cast<const int4*>(row_data);
  const int32_t* ns =
      reinterpret_cast<const int32_t*>(row_data + G::kPlaneBytes);
  const bool down = score_shift > 7;
  if constexpr (G::kHuge) {
    // the block's 128 queries against the tile, 32 words at a time, in
    // the planes' place
    uint32_t adm[2];
    const bool huge16 =
        ((uintptr_t)row_bits | (uintptr_t)q_bits) % 16 == 0 && w % 4 == 0;
    huge_tile_bits<kThreads, kQueries>(
        adm, row_data, row_bits + row0 * w, w, huge16, tid, 0,
        16 * (tid / 32), [&](int qi) -> const int32_t* {
          const int q = q0 + qi;
          int row = q;
          if (kSlots) {
            const int nsb = slot_tile / mask_sb;
            row = slot_tile > 0 ? (q / slot_tile) * nsb + q % nsb
                                : q / mask_sb;
          }
          return q < nq ? q_bits + (size_t)row * w : nullptr;
        });
    if (!down)
      tile_epilogue_huge<false>(acc, adm, ns, out, row0, qa, nq, group, l2,
                                score_shift);
    else
      tile_epilogue_huge<true>(acc, adm, ns, out, row0, qa, nq, group, l2,
                               score_shift);
  } else if constexpr (G::kWide) {
    if (!down)
      tile_epilogue_wide<kWords, false>(acc, qf, planes, ns, out, row0, qa,
                                        nq, group, l2, score_shift);
    else
      tile_epilogue_wide<kWords, true>(acc, qf, planes, ns, out, row0, qa,
                                       nq, group, l2, score_shift);
  } else if (w <= 4 && !down) {
    tile_epilogue<4, false>(acc, qw, planes, ns, out, row0, qa, nq, group, l2,
                            score_shift);
  } else if (w <= 4) {
    tile_epilogue<4, true>(acc, qw, planes, ns, out, row0, qa, nq, group, l2,
                           score_shift);
  } else if (!down) {
    tile_epilogue<8, false>(acc, qw, planes, ns, out, row0, qa, nq, group, l2,
                            score_shift);
  } else {
    tile_epilogue<8, true>(acc, qw, planes, ns, out, row0, qa, nq, group, l2,
                           score_shift);
  }
}

// The form for W and the slot layout.
template <bool kSlots, int kWords>
cudaError_t launch_wide(const CUtensorMap& q_map, const CUtensorMap& x_map,
                        unsigned blocks, cudaStream_t stream,
                        const int32_t* norms, const int32_t* row_bits,
                        const int32_t* q_bits, int32_t* out, int nq,
                        int n_qtiles, int d_pad, int w, int group, int l2,
                        int score_shift, int mask_sb, int slot_tile) {
  constexpr int smem = Geo<kWords>::kSmemBytes;
  auto kernel = scan_int8_wide_kernel<kSlots, kWords>;
  const cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  kernel<<<blocks, kThreads, smem, stream>>>(
      q_map, x_map, norms, row_bits, q_bits, out, nq, n_qtiles, d_pad, w,
      group, l2, score_shift, mask_sb, slot_tile);
  return cudaGetLastError();
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
  const bool group_ok =
      group >= 8 && group <= kRows && (group & (group - 1)) == 0;
  const bool slots_ok =
      mask_sb == 0 ||
      (mask_sb > 0 && nq % mask_sb == 0 &&
       (slot_tile == 0 ||
        (slot_tile > 0 && slot_tile % mask_sb == 0 && nq % slot_tile == 0)));
  if (nq < 1 || npad < kRows || npad % kRows != 0 || d_pad < kChunk ||
      d_pad % kChunk != 0 || !group_ok || w < 1 ||
      score_shift < 0 || score_shift > 31 || !slots_ok)
    return (int)cudaErrorInvalidValue;
  const long long n_qtiles = (nq + kQueries - 1) / kQueries;
  const long long blocks = n_qtiles * (npad / kRows);
  if (blocks > 0x7FFFFFFFLL) return (int)cudaErrorInvalidValue;
  CUtensorMap q_map, x_map;
  cudaError_t err = box_map(&q_map, q8, nq, d_pad, kQueries);
  if (err == cudaSuccess) err = box_map(&x_map, x8, npad, d_pad, kRows);
  if (err != cudaSuccess) return (int)err;
  const bool slots = mask_sb > 0;
  // W <= 8: the forms of before; 9-16 and 17-32: the wide-world forms;
  // past 32: the huge forms
  const int words = w <= kMaxWords    ? kMaxWords
                    : w <= 16         ? 16
                    : w <= kWideWords ? kWideWords
                                      : kHugeWords;
#define VSR_WIDE(S_, W_)                                                      \
  launch_wide<S_, W_>(q_map, x_map, (unsigned)blocks,                        \
                      static_cast<cudaStream_t>(stream),                     \
                      static_cast<const int32_t*>(norms),                    \
                      static_cast<const int32_t*>(row_bits),                 \
                      static_cast<const int32_t*>(q_bits),                   \
                      static_cast<int32_t*>(out), nq, (int)n_qtiles, d_pad,  \
                      w, group, l2, score_shift, mask_sb, slot_tile)
  if (words == kMaxWords)
    err = slots ? VSR_WIDE(true, kMaxWords) : VSR_WIDE(false, kMaxWords);
  else if (words == 16)
    err = slots ? VSR_WIDE(true, 16) : VSR_WIDE(false, 16);
  else if (words == kWideWords)
    err = slots ? VSR_WIDE(true, kWideWords) : VSR_WIDE(false, kWideWords);
  else
    err = slots ? VSR_WIDE(true, kHugeWords) : VSR_WIDE(false, kHugeWords);
#undef VSR_WIDE
  return (int)err;
}
