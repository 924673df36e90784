// Fused RBAC-masked int8 scan with a packed group-minimum epilogue, for rows
// of d_pad 128 or 256; the dots run on the int8 tensor cores (wgmma).
//
// Replaces the TPU kernel vectorsearch_rbac_tpu/ops/pallas_scan_int8.py
// _make_kernel (launched by int8_masked_topk), the narrow d_pad <= 256 form,
// with and without its admit-dedup `mask_sub_block` slot form (also the lab
// kernel scripts/r4_admit_lab.py scan_sb, in both of its slot layouts); its
// per-query form is also the lab kernel S1 trim
// (scripts/r4_kernel_variants.py _make_kernel_trim), and the lab's floor
// probe and trim's control, the reference's literal epilogue chain, are
// forms of their own (kFloor, kChain, below).
//
// Contract, bit for bit the TPU kernel's output: for query q and arena row r
//   dots   = sum_d x8[r, d] * q8[q, d]                       (int32, exact)
//   score  = (l2 ? norms[r] - 2 * dots : -dots) >> score_shift  (arithmetic)
//   admit  = any_w (row_bits[r, w] & query_bits[q, w]) != 0
//   packed = admit ? (score << 7) | (r % group) : 0x7F000000
//   out[r / group, q] = min of packed over the group's rows
// The TPU kernel tests admissibility as an int8 matmul of role one-hots
// (roles8 . onehot8 > 0). core.bits_to_onehot8 expands the same bitsets bit
// for bit, so the W-word AND here is the same predicate. (That matmul as a
// second wgmma took W <= 4 and no slot layout, and lost at d_pad 256:
// PERF.md.) Shifts and packs are done on unsigned values: a left shift of a
// negative int is undefined in C++17, and L2 scores before the query norm
// is added are often negative.
//
// The slot form (mask_sb > 0) reads the mask words of query q from row
// slot(q) of a (Q / mask_sb, W) tensor instead of row q of a (Q, W) one:
//   slot_tile == 0: slot = q / mask_sb            (contiguous slots)
//   slot_tile  > 0: slot = (q / slot_tile) * nsb + q % nsb,
//                   nsb = slot_tile / mask_sb      (interleaved slots: the
//                   TPU kernel's tile-style pltpu.repeat inside each q_tile)
// and its output is bit for bit that of the per-query form on the expanded
// masks.
//
// What bounds it on an H100. The dots are 2 * d_pad int8 operations a
// (query, row) pair, 0.28 ms for 2048 queries x 1M rows x 128 on the tensor
// cores; the first port ran them as d_pad / 4 __dp4a a pair on the CUDA
// cores (7.1 ms, near what dp4a can issue). What is left on the CUDA cores
// is the epilogue: per pair W AND/ORs for the admit test, one multiply-add
// that scores and packs (the row's norm, pre-shifted, and its rank in the
// group are one per-row base), and one predicated minimum: W + 2 integer
// operations, 6 at W = 4, 0.77 ms at the card's 64 integer lanes an SM.
// The design keeps everything else off that path.
//
// Design (scan_tc_kernel): a block holds 192 queries, three consumer
// warpgroups of 64, and walks a run of 128-row tiles; the blocks are one
// wave (q-tiles x runs <= the SMs, one block an SM), the q-tiles of a run
// side by side, so that they read each row tile from L2 together. The
// query tile comes once by TMA (128-byte swizzle, rows past nq as zeros).
// One producer warp fills a ring of row-tile stages (6 at d_pad 128, 4 at
// 256): the int8 rows by TMA; the tile's words and norms,
// staged by cp.async one tile ahead, rewritten as two zero-padded planes
// of 4 words a row, a base a row (norms[r] << (7 - shift) for l2, plus
// r % group where the shift is 0, so that one multiply-add gives the
// packed score), and one flag a consumer warpgroup: whether the tile's
// roles meet the union of its queries' masks, so that a warpgroup skips
// the dots and the epilogue of a tile it cannot read and writes its
// minima as 0x7F000000. A consumer warpgroup issues wgmma.mma_async
// m64n128k32 s32.s8.s8, queries on the M side and rows on the N side,
// both K-major from shared memory, waits for it and runs the epilogue on
// its accumulators; the warpgroups drift apart on the ring, so one's
// epilogue runs under another's dots. A thread holds queries lane / 4 and
// lane / 4 + 8 of its warp's 16 and, in each 8-row slice, 2 adjacent
// rows: the group minimum is taken over its own columns and finished with
// two quad shuffles (no shared memory). 13 warps put at most 4 on an SM
// sub-partition: 128 registers a thread and no spills (a fourth consumer
// warpgroup would leave 96 and spill; setmaxnreg cannot move registers
// from the producer warp to the consumers, since it moves only what warps
// of the block gave back). A second producer warp taking alternate tiles
// was no faster: the producer is not what holds the kernel (PERF.md).
//
// Admissibility off the per-pair path (kWarpSlot): in the contiguous slot
// layout with mask_sb a multiple of 16 -- the index's layout, mask_sb 16 --
// a warp's 16 queries are one slot, so admission is the same for the whole
// warp for each row. The warp takes the tile's 128 admit bits once (a lane
// tests a row of each 32, W words, then a ballot) and gates each of its two
// columns of a slice on one bit: per pair one multiply-add and one
// predicated minimum, with no branch (half_slot). Other slot layouts read
// their queries' slot rows in the per-query path.
//
// The floor form (kFloor; the lab kernel scripts/r4_kernel_variants.py
// _make_kernel_floor, S1's lower-bound probe, per-query masks only):
//   out[g, q] = min over the group's rows r of
//               dots + sum_w popc(row_bits[r, w] & query_bits[q, w])
// as int32: no score, no pack, no admissibility select and no skip. It runs
// on this kernel's own schedule (ring, producer warp, wgmma), so its time
// beside K1's is what K1's epilogue costs there. The role count comes from
// the tensor cores too: one mma.sync m16n8k256 b1 AND.POPC an 8-row slice
// and warp (the 256 bits are the 8 words the producer lays out as two
// planes a row), whose D fragment is the warp's slice of the wgmma
// accumulator, so the count adds in place (BMMA is native on sm_90a, at
// IMMA m16n8k32's instruction rate: a probe, PERF.md). Counting on the CUDA
// cores would cost W ANDs, W POPCs and W adds a pair, more than K1's W + 2
// operations: no floor. The epilogue is then one minimum a pair and the
// group's two quad shuffles, with no branch.
//
// The chain form (kPack == kChain; the lab's control of S1 trim, per-query
// masks only): the reference K1's literal epilogue
// (vectorsearch_rbac_tpu/ops/pallas_scan_int8.py:74-97) on this kernel's
// schedule. Per pair
//   s = (l2 ? norms[r] - 2 * dots : -dots) >> shift     (arithmetic)
//   v = ((uint32_t)s << 7) | (r & (group - 1))
// then the same predicated minimum; the producer writes the raw norms (0
// for ip) as the base plane. The lab kernel S1 trim
// (scripts/r4_kernel_variants.py _make_kernel_trim) folds the << 7 pack into
// the score arithmetic; here that fold is K1's own epilogue (pack<kFold>:
// one multiply-add over a base shifted in advance), so the lab's trim is
// K1's per-query form, and the chain beside it, on the same schedule, shows
// what the fold saves: the shift and the shift-or of the pack, two integer
// operations a pair. It covers every shift K1 takes (0-31): the sign of a
// negative score survives the arithmetic shift before the unsigned << 7.
//
// The wide-world forms (kWords 16 and 32) take W 9-16 and 17-32, worlds
// of 257 to 1,024 roles, with per-query masks and in every slot layout
// (their words read through mask_row). W AND/ORs a pair would cost about
// 0.13 ms an operation a pair at 2048 queries x 1M rows (the epilogue is
// bound by integer issue: PERF.md), 1-4 ms more at W 16-32, and the query
// words would take 2W registers a thread. So the admit test moves to the
// binary tensor cores, as the floor form's count did: in the epilogue,
// each consumer warp counts the shared roles of an 8-row slice's 16 x 8
// (query, row) pairs with one mma.sync m16n8k256 b1 AND.POPC a 256-role
// chunk (W / 8 a slice), into four registers in the places of the slice's
// accumulators. The query side is the A fragment, kWords / 2 registers a
// thread; a pair is then the multiply-add and the minimum predicated on
// its count, whatever W, and a slice none of whose pairs a warp admits is
// skipped by the whole warp (so the contiguous slot layout, 16 queries a
// slot and one mask a warp, skips as the warp-slot path does). The
// producer lays a tile's words out as kWords / 4 planes of (kRows, 4)
// words, the binary product's B fragments in conflict-free reads; it
// stages the raw words with a row pitch of 4 x an odd number of words, so
// its own reads of a row's 16-byte pieces are conflict-free too. The ring
// drops stages to fit the planes (Ring below). W <= 8 keeps the forms
// above, unchanged. Weighed and not taken: counting before the dots into
// the tile's own accumulators, then one admit bit a pair; it spilled and
// was 1.33x slower at W 10 (PERF.md).
//
// The huge forms (kHugeWords, any W past 32: worlds past 1,024 roles, any
// mask layout). A warp's A fragments for all W words would take W / 2
// registers a thread, and a stage's planes W / 2 KB: neither fits for
// every W. So the ring stages no words (it keeps 6 stages at d_pad 128, 3
// at 256), and each consumer warpgroup tests its 64 queries against a tile
// 32 words at a time (huge_tile_bits in tma_wgmma.cuh): its 128 threads
// copy the chunk's words of the tile's rows and of its queries into the
// warpgroup's own 25 KB of shared memory (cp.async, named barrier 1 + g),
// and each warp runs 4 binary products a slice, one admit bit a pair; a
// pair is then the multiply-add and the minimum predicated on its bit, as
// in the wide forms. The producer flags every tile (it keeps no union of
// the words), so the huge forms skip only the slices no pair of a warp
// admits. A first design read the words past 32 from L2 in every warp and
// took 19-50 ms at W 64-128 (PERF.md).
//
// The dp4a kernel (scan_int8_kernel below) is the first port's design of
// K1, kept for the kernel lab only (vsr_scan_int8_lab variant dp4a, per-query
// masks): the old design's time beside K1's. The TPU lab's unroll and chunk
// knobs schedule Mosaic and size VMEM; they have no counterpart here. Its
// design: one thread per query keeps its int8 query row and its W mask words
// in registers, the block stages 128-row tiles in shared memory (broadcast
// reads) and walks kTilesPerBlock of them; the group minimum is a running
// minimum in a register.

#include "tma_wgmma.cuh"

namespace {

constexpr int kMaxWords = 8;    // bitset words of the W <= 8 forms
constexpr int kWideWords = 32;  // of the wide-world forms: 1,024 roles
constexpr int kHugeWords = 64;  // the huge forms' tag: any W past 32
constexpr int kAnyWords = 1 << 24;  // the served scan's bound on W: none
constexpr int32_t kMasked = 0x7F000000;
// how an accumulator becomes a packed key (pack<kPack> below): K1's fold at
// score shift 0, K1's shifted form otherwise, and the reference's chain
constexpr int kFold = 0, kShifted = 1, kChain = 2;

// ------------------------------------------------- the tensor-core kernel

constexpr int kRows = 128;  // rows per tile: the wgmma N
// Consumer warpgroups of 64 queries. With the producer warp they are 13
// warps, at most 4 on each of the SM's sub-partitions, which have 16,384
// registers each: 128 a thread. A fourth would leave 96, and spill.
constexpr int kConsumers = 3;
constexpr int kQueries = 64 * kConsumers;   // queries per block
constexpr int kProducer = 4 * kConsumers;   // the producer's warp
constexpr int kTcThreads = 32 * (kProducer + 1);
template <int D, int kWords>
struct Ring {
  static constexpr bool kWide = kWords > kMaxWords;
  // the huge forms stage no words in the ring: each consumer warpgroup
  // copies them 32 at a time into its own scratch (huge_tile_bits)
  static constexpr bool kHuge = kWords > kWideWords;
  static constexpr int kChunks = D / 128;  // 128-byte d-chunks
  // the ring's stages: as many as fit beside the wide forms' planes, or
  // the huge forms' scratch
  static constexpr int kStages = D == 128 ? (kWords <= 16 || kHuge ? 6 : 5)
                                 : kWords <= kMaxWords ? 4
                                 : kWords <= 16 || kHuge ? 3
                                                         : 2;
  static constexpr int kQBytes = kQueries * D;
  static constexpr int kRowBytes = kRows * D;
  // a stage's row data: planes of (kRows, 4) words (two where W <= 8),
  // the bases, the flags
  static constexpr int kPlanes = kHuge ? 0 : kWide ? kWords / 4 : 2;
  static constexpr int kPlaneBytes = kPlanes * kRows * 16;
  static constexpr int kAuxBytes = kPlaneBytes + kRows * 4 + 16;
  // the producer's staging of one tile's raw words (a row every kPitch
  // words: 4 x an odd number in the wide forms) and norms (two buffers)
  static constexpr int kPitch = kHuge ? 0 : kWide ? kWords + 4 : kMaxWords;
  static constexpr int kStagingBytes = kRows * (kPitch + 1) * 4;
  static constexpr int kScratchBytes =
      kHuge ? kConsumers * HugeChunk<64>::kBytes : 0;
  static constexpr int kSmem =
      1024  // slack to align to 1024 bytes
      + kQBytes + kStages * (kRowBytes + kAuxBytes) + kScratchBytes +
      2 * kStagingBytes + (2 * kStages + 1) * 8;  // mbarriers
  static_assert(kSmem <= 232448, "a block's shared memory");
  static_assert(!kWide || kHuge || (kPitch / 4) % 2 == 1,
                "odd pitch in 16 bytes");
};

struct ScanArgs {
  const int32_t* norms;     // (Npad,)
  const int32_t* row_bits;  // (Npad, W)
  const int32_t* q_bits;    // (Q or Q / mask_sb, W)
  int32_t* out;             // (Npad / group, Q)
  int nq, n_tiles, n_qtiles, runs, w, group, l2, score_shift, mask_sb,
      slot_tile;
  int aligned16;  // row_bits and norms start on 16 bytes: 16-byte copies
};

// Where a block's shared memory lies.
template <int D, int kWords>
struct Smem {
  using R = Ring<D, kWords>;
  uint32_t qtile;  // the query tile (1024-aligned: swizzle atoms)
  uint32_t rows;   // the ring's row tiles
  uint8_t* scratch;  // the huge forms' chunks, one a consumer warpgroup
  uint8_t* aux;    // the ring's row data
  uint8_t* staging;
  uint32_t bars;
  __device__ Smem(uint8_t* smem_raw) {
    const uint32_t raw = smem_addr(smem_raw);
    uint8_t* p = smem_raw + (((raw + 1023u) & ~1023u) - raw);
    qtile = smem_addr(p);
    rows = qtile + R::kQBytes;
    scratch = p + R::kQBytes + R::kStages * R::kRowBytes;
    aux = scratch + R::kScratchBytes;
    staging = aux + R::kStages * R::kAuxBytes;
    bars = smem_addr(staging + 2 * R::kStagingBytes);
  }
  // full[s]: stage s's rows landed and its row data is written (the
  // producer's 32 lanes and its byte count); empty[s]: the 12 consumer
  // warps are done with it; qfull: the query tile landed
  __device__ uint32_t full(int s) const { return bars + 8 * s; }
  __device__ uint32_t empty(int s) const {
    return bars + 8 * (R::kStages + s);
  }
  __device__ uint32_t qfull() const { return bars + 16 * R::kStages; }
  __device__ const int4* planes(int s) const {
    return reinterpret_cast<const int4*>(aux + s * R::kAuxBytes);
  }
  __device__ const int32_t* base(int s) const {
    return reinterpret_cast<const int32_t*>(aux + s * R::kAuxBytes +
                                            R::kPlaneBytes);
  }
  __device__ uint32_t* flags(int s) const {
    return reinterpret_cast<uint32_t*>(aux + s * R::kAuxBytes +
                                       R::kPlaneBytes + kRows * 4);
  }
};

// The row of q_bits that query q reads.
__device__ __forceinline__ int mask_row(const ScanArgs& a, int q) {
  if (a.mask_sb == 0) return q;
  if (a.slot_tile == 0) return q / a.mask_sb;
  const int nsb = a.slot_tile / a.mask_sb;
  return (q / a.slot_tile) * nsb + q % nsb;
}

// The producer warp: the query tile once, then for each row tile of the
// block's run its stage of the ring: the rows by TMA; the words, staged by
// cp.async one tile ahead (before the wait for the stage), as planes; the
// bases; and one flag a consumer warpgroup: whether the tile's roles meet
// the union of its queries' masks (any_r (row_r & U) != 0 is (OR_r row_r) &
// U != 0).
template <int D, int kWords, int kPack, bool kFloor>
__device__ __forceinline__ void produce(const CUtensorMap* q_map,
                                        const CUtensorMap* x_map,
                                        const ScanArgs& a,
                                        const Smem<D, kWords>& sm, int q0,
                                        int t_begin, int t_end) {
  using R = Ring<D, kWords>;
  constexpr int kU = R::kHuge ? 1 : kWords;  // the unions' words
  const int lane = threadIdx.x % 32;
  if (lane == 0) {
    mbar_expect(sm.qfull(), R::kQBytes);
#pragma unroll
    for (int c = 0; c < R::kChunks; ++c)
      tma_load(sm.qtile + c * kQueries * 128, q_map, c * 128, q0, sm.qfull());
  }
  // lane g < kConsumers keeps the union of warpgroup g's masks (the floor
  // skips nothing and needs none; nor do the huge forms, which flag every
  // tile)
  uint32_t uni[kU];
#pragma unroll
  for (int m = 0; m < kU; ++m) uni[m] = 0;
#pragma unroll 1
  for (int g = 0; g < (kFloor || R::kHuge ? 0 : kConsumers); ++g)
#pragma unroll
    for (int m = 0; m < kU; ++m) {
      uint32_t u = 0;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int q = q0 + 64 * g + 32 * h + lane;
        if (q < a.nq && m < a.w)
          u |= (uint32_t)a.q_bits[(size_t)mask_row(a, q) * a.w + m];
      }
      u = __reduce_or_sync(0xffffffffu, u);
      if (lane == g) uni[m] = u;
    }
  // the wide forms stage row r's words at r * kPitch: a 16-byte piece j
  // of a row (W a multiple of 4 and 16-byte rows) or a word m is element
  // e = r * pieces + j (e = r * W + m) of the tile's words; e / pieces
  // by one multiply-high with the rounded-up reciprocal (exact: e < 2^12,
  // pieces <= 32)
  const bool wide16 = R::kWide && a.aligned16 && a.w % 4 == 0;
  const uint32_t pieces = wide16 ? a.w / 4 : a.w;
  const uint32_t recip = 0xFFFFFFFFu / pieces + 1u;
  // staging buffer b: the tile's raw words (kRows x W), then its norms
  auto stage_in = [&](int tile, int b) {
    if (tile < t_end) {
      const uint32_t dst = smem_addr(sm.staging + b * R::kStagingBytes);
      const int32_t* words = a.row_bits + (size_t)tile * kRows * a.w;
      const int32_t* norms = a.norms + (size_t)tile * kRows;
      if (R::kHuge) {
        // no words: the consumers copy them
      } else if (R::kWide) {
        for (uint32_t e = lane; e < kRows * pieces; e += 32) {
          const uint32_t r = __umulhi(e, recip), j = e - r * pieces;
          if (wide16)
            cp_async16(dst + 4 * (r * R::kPitch + 4 * j), words + 4 * e);
          else
            cp_async4(dst + 4 * (r * R::kPitch + j), words + e, 4);
        }
      } else if (a.aligned16) {  // kRows * W words: W 16-byte pieces a lane
        for (int e = lane; e < kRows * a.w / 4; e += 32)
          cp_async16(dst + 16 * e, words + 4 * e);
      } else {
        for (int e = lane; e < kRows * a.w; e += 32)
          cp_async4(dst + 4 * e, words + e, 4);
      }
      if (a.aligned16) {
        cp_async16(dst + 4 * kRows * R::kPitch + 16 * lane, norms + 4 * lane);
      } else {
#pragma unroll
        for (int k = 0; k < kRows / 32; ++k)
          cp_async4(dst + 4 * (kRows * R::kPitch + lane + 32 * k),
                    norms + lane + 32 * k, 4);
      }
    }
    asm volatile("cp.async.commit_group;\n" ::: "memory");
  };
  const int gm = a.group - 1;
  const int up = a.score_shift <= 7 ? 7 - a.score_shift : 0;
  stage_in(t_begin, 0);
#pragma unroll 1
  for (int t = t_begin; t < t_end; ++t) {
    const int i = t - t_begin, s = i % R::kStages;
    stage_in(t + 1, (i + 1) & 1);
    if (i >= R::kStages) mbar_wait(sm.empty(s), ((i / R::kStages) + 1) & 1);
    if (lane == 0) {
      mbar_expect(sm.full(s), R::kRowBytes);
#pragma unroll
      for (int c = 0; c < R::kChunks; ++c)
        tma_load(sm.rows + s * R::kRowBytes + c * kRows * 128, x_map,
                 c * 128, t * kRows, sm.full(s));
    }
    asm volatile("cp.async.wait_group 1;\n" ::: "memory");
    __syncwarp();  // every lane's staged words are in
    const int32_t* stg = reinterpret_cast<const int32_t*>(
        sm.staging + (i & 1) * R::kStagingBytes);
    int4* planes = const_cast<int4*>(sm.planes(s));
    int32_t* base = const_cast<int32_t*>(sm.base(s));
    uint32_t wide_hit = 0;  // the wide forms' flag test, plane by plane
    if constexpr (R::kWide) {
      // plane p: words 4p .. 4p + 3 of each row, one 16-byte read of the
      // staged row (the odd pitch spreads a warp's reads over every bank)
      // and one 16-byte store, then those words' OR over the tile's rows
      // against the unions. Words past W are left as they are: the query
      // words and the unions are 0 there.
#pragma unroll
      for (int p = 0; p < R::kPlanes; ++p) {
        if (4 * p >= a.w) break;
        uint32_t any4[4] = {0u, 0u, 0u, 0u};
#pragma unroll
        for (int k = 0; k < kRows / 32; ++k) {
          const int r = lane + 32 * k;
          const int4 v =
              reinterpret_cast<const int4*>(stg)[r * (R::kPitch / 4) + p];
          planes[p * kRows + r] = v;
          any4[0] |= (uint32_t)v.x;
          any4[1] |= (uint32_t)v.y;
          any4[2] |= (uint32_t)v.z;
          any4[3] |= (uint32_t)v.w;
        }
#pragma unroll
        for (int j = 0; j < 4; ++j)
          wide_hit |=
              __reduce_or_sync(0xffffffffu, any4[j]) & uni[4 * p + j];
      }
    }
    uint32_t any[R::kWide ? 1 : kWords];
#pragma unroll
    for (int m = 0; m < (R::kWide ? 1 : kWords); ++m) any[m] = 0;
#pragma unroll
    for (int k = 0; k < kRows / 32; ++k) {
      const int r = lane + 32 * k;
      if constexpr (!R::kWide) {
        int32_t wd[kWords];
#pragma unroll
        for (int m = 0; m < kWords; ++m) {
          wd[m] = m < a.w ? stg[r * a.w + m] : 0;
          any[m] |= (uint32_t)wd[m];
        }
        planes[r] = make_int4(wd[0], wd[1], wd[2], wd[3]);
        if (kWords > 4)
          planes[kRows + r] = make_int4(wd[4 % kWords], wd[5 % kWords],
                                        wd[6 % kWords], wd[7 % kWords]);
      }
      const uint32_t nr = (uint32_t)stg[kRows * R::kPitch + r];
      if (!kFloor)
        base[r] = (int32_t)(kPack == kFold
                                ? (a.l2 ? nr << 7 : 0u) + (uint32_t)(r & gm)
                            : kPack == kShifted ? (a.l2 ? nr << up : 0u)
                                                : (a.l2 ? nr : 0u));
    }
    if (!kFloor) {
      uint32_t hit = wide_hit;
#pragma unroll
      for (int m = 0; m < (R::kWide ? 0 : kWords); ++m)
        hit |= __reduce_or_sync(0xffffffffu, any[m]) & uni[m];
      const uint32_t flags =
          R::kHuge ? (1u << kConsumers) - 1
                   : __ballot_sync(0xffffffffu, hit != 0) &
                         ((1u << kConsumers) - 1);
      if (lane == 0) *sm.flags(s) = flags;
    }
    mbar_arrive(sm.full(s));
    __syncwarp();  // staging buffer i & 1 is read: it may be refilled
  }
}

// The min of best and v where hit is nonzero: one predicated instruction.
__device__ __forceinline__ void min_if(int32_t& best, int32_t hit,
                                       int32_t v) {
  asm("{\n.reg .pred p;\nsetp.ne.b32 p, %1, 0;\n@p min.s32 %0, %0, %2;\n}"
      : "+r"(best)
      : "r"(hit), "r"(v));
}

// The packed score of one accumulator: v = dots * mul + base is the packed
// key itself where the shift is 0 (kFold); with a shift (kShifted) it is the
// score shifted up by 7 - shift (down by `down` past 7), whose low 7 bits
// give way to the row's rank in its group; in the chain (kChain) it is the
// score itself (the base is the raw norm), shifted down by the score shift
// and then packed.
template <int kPack>
__device__ __forceinline__ int32_t pack(int32_t dots, uint32_t mul,
                                        uint32_t base, int down,
                                        uint32_t rank) {
  uint32_t v = (uint32_t)dots * mul + base;
  if (kPack == kShifted) v = ((uint32_t)((int32_t)v >> down) & ~127u) | rank;
  if (kPack == kChain) v = ((uint32_t)((int32_t)v >> down) << 7) | rank;
  return (int32_t)v;
}

// A consumer thread's running state: the packed minima of its two queries
// (qa, qa + 8) in the open group, and where the next group's go.
struct Epi {
  int32_t best[2];
  int32_t* out;  // &out[g, qa] of the open group
  size_t nq;
  bool store[2];  // lane % 4 == 0 and the query exists
  int gm, span;   // group - 1; 8-row slices a group
  uint32_t mul;
  int down;
  uint32_t row0;  // the tile's first arena row (the chain's ranks)
};

__device__ __forceinline__ void close_group(Epi& e) {
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    e.best[i] = min(e.best[i], __shfl_xor_sync(0xffffffffu, e.best[i], 1));
    e.best[i] = min(e.best[i], __shfl_xor_sync(0xffffffffu, e.best[i], 2));
    if (e.store[i]) e.out[8 * i] = e.best[i];
    e.best[i] = kMasked;
  }
  e.out += e.nq;
}

// The per-query epilogue of one 64-row half of a tile: acc[4 n + 2 i + j]
// holds query qa + 8 i and row 64 kHalf + 8 n + 2 (lane % 4) + j.
// kWords is 4 (W <= 4: the second plane is not read) or 8.
template <int kHalf, int kWords, int kPack, bool kWhole>
__device__ __forceinline__ void half_pairs(const int32_t (&acc)[32],
                                           const int32_t (&qw)[2][kWords],
                                           const int4* __restrict__ planes,
                                           const int32_t* __restrict__ base,
                                           Epi& e) {
  const int cl = 2 * (threadIdx.x % 4);
#pragma unroll
  for (int n = 0; n < 8; ++n) {
    const int n8 = 8 * kHalf + n;
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const int r = 8 * n8 + cl + j;
      const int4 b0 = planes[r];
      const int4 b1 = kWords > 4 ? planes[kRows + r] : make_int4(0, 0, 0, 0);
      const uint32_t bs = (uint32_t)base[r];
      // the chain's rank is its arena row's, as the reference takes it (a
      // tile-invariant r & gm would be hoisted out of the tile loop, 32
      // registers a thread, and spill at W 8)
      const uint32_t rank =
          kPack == kFold    ? 0u
          : kPack == kChain ? (e.row0 + (uint32_t)r) & (uint32_t)e.gm
                            : (uint32_t)(r & e.gm);
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        int32_t hit = (b0.x & qw[i][0]) | (b0.y & qw[i][1]) |
                      (b0.z & qw[i][2]) | (b0.w & qw[i][3]);
        if (kWords > 4)
          hit |= (b1.x & qw[i][4]) | (b1.y & qw[i][5]) | (b1.z & qw[i][6]) |
                 (b1.w & qw[i][7]);
        min_if(e.best[i], hit,
               pack<kPack>(acc[4 * n + 2 * i + j], e.mul, bs, e.down, rank));
      }
    }
    if (kWhole ? n8 == 15 : ((n8 + 1) & (e.span - 1)) == 0) close_group(e);
  }
}

// The warp slot's admit bits of one half: adm[k] bit l says whether the
// slot admits row 64 kHalf + 32 k + l (the same in every lane).
// kWords is 4 (W <= 4: the second plane is not read) or 8.
template <int kHalf, int kWords>
__device__ __forceinline__ void half_admit(uint32_t (&adm)[2],
                                           const uint32_t (&sw)[kMaxWords],
                                           const int4* __restrict__ planes) {
  const int lane = threadIdx.x % 32;
#pragma unroll
  for (int k = 0; k < 2; ++k) {
    const int r = 64 * kHalf + 32 * k + lane;
    const int4 b0 = planes[r];
    uint32_t hit = (b0.x & sw[0]) | (b0.y & sw[1]) | (b0.z & sw[2]) |
                   (b0.w & sw[3]);
    if (kWords > 4) {
      const int4 b1 = planes[kRows + r];
      hit |= (b1.x & sw[4]) | (b1.y & sw[5]) | (b1.z & sw[6]) | (b1.w & sw[7]);
    }
    adm[k] = __ballot_sync(0xffffffffu, hit != 0);
  }
}

// The minima of b0 with v0 and of b1 with v1 where hit is nonzero: one
// predicate, two predicated instructions.
__device__ __forceinline__ void min2_if(int32_t& b0, int32_t& b1, int32_t hit,
                                        int32_t v0, int32_t v1) {
  asm("{\n.reg .pred p;\nsetp.ne.b32 p, %2, 0;\n@p min.s32 %0, %0, %3;\n"
      "@p min.s32 %1, %1, %4;\n}"
      : "+r"(b0), "+r"(b1)
      : "r"(hit), "r"(v0), "r"(v1));
}

// The warp-slot epilogue of one half: a thread's two rows of each 8-row
// slice are gated by one admit bit each, the minima of both its queries
// predicated on it, with no test a pair and no branch (a branch a slice
// and one a row, to skip the slices and rows the slot does not admit, cost
// more than the work they saved: PERF.md).
template <int kHalf, int kPack, bool kWhole>
__device__ __forceinline__ void half_slot(const int32_t (&acc)[32],
                                          const uint32_t (&adm)[2],
                                          const int32_t* __restrict__ base,
                                          Epi& e) {
  const int cl = 2 * (threadIdx.x % 4);
#pragma unroll
  for (int n = 0; n < 8; ++n) {
    const int n8 = 8 * kHalf + n;
    // bits 0, 1: this thread's rows of the slice
    const uint32_t mine = adm[n / 4] >> (8 * (n % 4) + cl);
    const int2 bs = *reinterpret_cast<const int2*>(base + 8 * n8 + cl);
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const int r = 8 * n8 + cl + j;
      const uint32_t rank = kPack == kFold ? 0u : (uint32_t)(r & e.gm);
      const uint32_t b = (uint32_t)(j ? bs.y : bs.x);
      min2_if(e.best[0], e.best[1], (int32_t)(mine & (1u << j)),
              pack<kPack>(acc[4 * n + j], e.mul, b, e.down, rank),
              pack<kPack>(acc[4 * n + 2 + j], e.mul, b, e.down, rank));
    }
    if (kWhole ? n8 == 15 : ((n8 + 1) & (e.span - 1)) == 0) close_group(e);
  }
}

// One half's epilogue, in the path the template selects. kWhole: the group
// is the whole tile (group 128), so its one group closes after the last
// slice; a group width known only at run time puts a test after every
// slice, which cost the epilogue a fifth of K1's time at group 128
// (PERF.md).
template <int kHalf, int kWords, int kPack, bool kWarpSlot, bool kWhole>
__device__ __forceinline__ void half_epilogue(const int32_t (&acc)[32],
                                              const int32_t (&qw)[2][kWords],
                                              const uint32_t (&sw)[kMaxWords],
                                              const int4* planes,
                                              const int32_t* base, Epi& e) {
  if (kWarpSlot) {
    uint32_t adm[2];
    half_admit<kHalf, kWords>(adm, sw, planes);
    half_slot<kHalf, kPack, kWhole>(acc, adm, base, e);
  } else {
    half_pairs<kHalf, kWords, kPack, kWhole>(acc, qw, planes, base, e);
  }
}

// The floor's role counts of one 64-row half: one binary product an 8-row
// slice, B read from the planes (row 64 kHalf + 8 n + lane / 4).
template <int kHalf, int kWords>
__device__ __forceinline__ void half_counts(int32_t (&acc)[32],
                                            const uint32_t (&qf)[4],
                                            const int4* __restrict__ planes) {
  const int32_t* words = reinterpret_cast<const int32_t*>(planes);
  const int lane = threadIdx.x % 32;
#pragma unroll
  for (int n = 0; n < 8; ++n) {
    const int r = 64 * kHalf + 8 * n + lane / 4;
    const uint32_t b0 = (uint32_t)words[4 * r + lane % 4];
    const uint32_t b1 =
        kWords > 4 ? (uint32_t)words[4 * (kRows + r) + lane % 4] : 0u;
    bmma_and_popc(acc[4 * n], acc[4 * n + 1], acc[4 * n + 2],
                  acc[4 * n + 3], qf, b0, b1);
  }
}

// The floor's epilogue of one half: the group minimum of dots + count, no
// pack and no mask.
template <int kHalf>
__device__ __forceinline__ void half_floor(const int32_t (&acc)[32], Epi& e) {
#pragma unroll
  for (int n = 0; n < 8; ++n) {
#pragma unroll
    for (int i = 0; i < 2; ++i)
      e.best[i] =
          min(e.best[i], min(acc[4 * n + 2 * i], acc[4 * n + 2 * i + 1]));
    if (((8 * kHalf + n + 1) & (e.span - 1)) == 0) close_group(e);
  }
}

// The wide forms' epilogue of one 64-row half, after the tile's dots: for
// each 8-row slice, the shared roles of the thread's 4 (query, row) pairs
// by one binary product a 256-role chunk, B read from planes 2c and 2c + 1
// (row 64 kHalf + 8 n + lane / 4); d lands in the accumulator's places
// (c[2 i + j]: query qa + 8 i, row 64 kHalf + 8 n + 2 (lane % 4) + j). A
// slice none of whose pairs the warp admits is skipped by the whole warp;
// otherwise a pair is the multiply-add and the minimum predicated on its
// count.
template <int kHalf, int kWords, int kPack>
__device__ __forceinline__ void half_wide(const int32_t (&acc)[32],
                                          const uint32_t (&qf)[kWords / 8][4],
                                          const int4* __restrict__ planes,
                                          const int32_t* __restrict__ base,
                                          Epi& e) {
  const int32_t* words = reinterpret_cast<const int32_t*>(planes);
  const int lane = threadIdx.x % 32;
  const int cl = 2 * (lane % 4);
#pragma unroll
  for (int n = 0; n < 8; ++n) {
    const int n8 = 8 * kHalf + n;
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
        const int rr = 8 * n8 + cl + j;
        const uint32_t bs = (uint32_t)base[rr];
        const uint32_t rank = kPack == kFold ? 0u : (uint32_t)(rr & e.gm);
#pragma unroll
        for (int i = 0; i < 2; ++i)
          min_if(e.best[i], c[2 * i + j],
                 pack<kPack>(acc[4 * n + 2 * i + j], e.mul, bs, e.down,
                             rank));
      }
    }
    asm volatile("" ::: "memory");  // one slice's reads at a time
    if (((n8 + 1) & (e.span - 1)) == 0) close_group(e);
  }
}

// The huge forms' epilogue of one 64-row half (W > 32): as half_wide, with
// the pair's shared-role bit from huge_tile_bits (adm: bit 4 n + 2 i + j)
// in the place of its count.
template <int kHalf, int kPack>
__device__ __forceinline__ void half_huge(const int32_t (&acc)[32],
                                          uint32_t adm,
                                          const int32_t* __restrict__ base,
                                          Epi& e) {
  const int cl = 2 * (threadIdx.x % 4);
#pragma unroll
  for (int n = 0; n < 8; ++n) {
    const int n8 = 8 * kHalf + n;
    const uint32_t mine = (adm >> (4 * n)) & 15u;
    if (__any_sync(0xffffffffu, mine)) {  // uniform
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const int rr = 8 * n8 + cl + j;
        const uint32_t bs = (uint32_t)base[rr];
        const uint32_t rank = kPack == kFold ? 0u : (uint32_t)(rr & e.gm);
#pragma unroll
        for (int i = 0; i < 2; ++i)
          min_if(e.best[i], (int32_t)((mine >> (2 * i + j)) & 1u),
                 pack<kPack>(acc[4 * n + 2 * i + j], e.mul, bs, e.down,
                             rank));
      }
    }
    if (((n8 + 1) & (e.span - 1)) == 0) close_group(e);
  }
}

// The dots of one row tile, one m64n128 product into lo (rows 0-63) and hi
// (rows 64-127), committed as one wgmma group.
template <int D>
__device__ __forceinline__ void issue_dots(int32_t (&lo)[32],
                                           int32_t (&hi)[32], uint32_t a_wg,
                                           uint32_t b_s) {
  fence_acc(lo);
  fence_acc(hi);
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
#pragma unroll
  for (int c = 0; c < D / 128; ++c)
#pragma unroll
    for (int k = 0; k < 4; ++k)
      wgmma_m64n128k32(lo, hi, sw128_desc(a_wg + c * kQueries * 128 + 32 * k),
                       sw128_desc(b_s + c * kRows * 128 + 32 * k),
                       (c | k) != 0);
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// A consumer warpgroup: 64 queries against every row tile of the run, one
// m64n128 product a tile, waited for before its epilogue; the warpgroups'
// drift overlaps one's epilogue with another's dots. (Each tile's dots as
// two 64-row halves, each half's epilogue under the next half's dots, was
// 15-19% slower: PERF.md.)
template <int D, int kWords, int kPack, bool kWarpSlot, bool kFloor>
__device__ __forceinline__ void consume(const ScanArgs& a,
                                        const Smem<D, kWords>& sm, int q0,
                                        int t_begin, int t_end) {
  using R = Ring<D, kWords>;
  constexpr bool kWide = R::kWide;
  constexpr int kFrag = kWide && !R::kHuge ? kWords / 8 : 1;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int wg = warp / 4;
  const int qw0 = q0 + 64 * wg + 16 * (warp % 4);  // the warp's first query
  const int qa = qw0 + lane / 4;                   // and qa + 8
  const int lg = __ffs(a.group) - 1;
  Epi e;
  e.best[0] = e.best[1] = kMasked;
  e.out = a.out;
  e.nq = (size_t)a.nq;
  e.store[0] = lane % 4 == 0 && qa < a.nq;
  e.store[1] = lane % 4 == 0 && qa + 8 < a.nq;
  e.gm = a.group - 1;
  e.span = a.group / 8;
  const bool down = a.score_shift > 7;
  e.mul = (uint32_t)(a.l2 ? -2 : -1)
          << (kPack == kChain || down ? 0 : 7 - a.score_shift);
  e.down = kPack == kChain ? a.score_shift : down ? a.score_shift - 7 : 0;
  int32_t qw[2][kWide ? 1 : kWords];  // the per-query path: both queries'
                                      // words
  uint32_t sw[kMaxWords];  // the warp-slot path: the slot's words
  uint32_t qf[4];          // the floor: the binary product's A fragment
  // the wide forms: the A fragments of the binary products, 256 roles each
  uint32_t qa_bits[kFrag][4];
#pragma unroll
  for (int c = 0; c < kFrag; ++c)
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const int q = qa + 8 * (k & 1), m = 8 * c + lane % 4 + 4 * (k >> 1);
      qa_bits[c][k] = (kWide && !R::kHuge && m < a.w && q < a.nq)
                          ? (uint32_t)a.q_bits[(size_t)mask_row(a, q) * a.w +
                                               m]
                          : 0u;
    }
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const int q = qa + 8 * (k & 1), m = lane % 4 + 4 * (k >> 1);
    qf[k] = (kFloor && m < a.w && q < a.nq)
                ? (uint32_t)a.q_bits[(size_t)q * a.w + m]
                : 0u;
  }
#pragma unroll
  for (int m = 0; m < kMaxWords; ++m)
    sw[m] = (kWarpSlot && m < a.w && qw0 < a.nq)
                ? (uint32_t)a.q_bits[(size_t)(qw0 / a.mask_sb) * a.w + m]
                : 0u;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int q = qa + 8 * i;
#pragma unroll
    for (int m = 0; m < (kWide ? 1 : kWords); ++m)
      qw[i][m] = (!kWide && !kWarpSlot && !kFloor && m < a.w && q < a.nq)
                     ? a.q_bits[(size_t)mask_row(a, q) * a.w + m]
                     : 0;
  }
  mbar_wait(sm.qfull(), 0);
  const uint32_t a_wg = sm.qtile + wg * 64 * 128;
  int32_t lo[32], hi[32];
#pragma unroll
  for (int i = 0; i < 32; ++i) lo[i] = hi[i] = 0;
#pragma unroll 1
  for (int t = t_begin; t < t_end; ++t) {
    const int i = t - t_begin, s = i % R::kStages;
    mbar_wait(sm.full(s), (i / R::kStages) & 1);
    e.out = a.out + ((size_t)t * kRows >> lg) * e.nq + qa;
    e.row0 = (uint32_t)t * kRows;
    if (kFloor || (*sm.flags(s) >> wg) & 1u) {  // warpgroup-uniform
      issue_dots<D>(lo, hi, a_wg, sm.rows + s * R::kRowBytes);
      wgmma_wait<0>();
      fence_acc(lo);
      fence_acc(hi);
      if constexpr (kFloor) {  // the role counts onto the dots, the minima
        half_counts<0, kWords>(lo, qf, sm.planes(s));
        half_counts<1, kWords>(hi, qf, sm.planes(s));
        half_floor<0>(lo, e);
        half_floor<1>(hi, e);
      } else if constexpr (R::kHuge) {
        // the warpgroup's 64 queries against the tile, 32 words at a time
        // (16-byte copies where the words allow them)
        uint32_t adm[2];
        const int q_wg = q0 + 64 * wg;
        const bool huge16 = ((uintptr_t)a.row_bits | (uintptr_t)a.q_bits) %
                                    16 == 0 &&
                            a.w % 4 == 0;
        huge_tile_bits<128, 64>(
            adm, sm.scratch + wg * HugeChunk<64>::kBytes,
            a.row_bits + (size_t)t * kRows * a.w, a.w, huge16,
            threadIdx.x % 128, 1 + wg, 16 * (warp % 4),
            [&](int qi) -> const int32_t* {
              const int q = q_wg + qi;
              return q < a.nq ? a.q_bits + (size_t)mask_row(a, q) * a.w
                              : nullptr;
            });
        half_huge<0, kPack>(lo, adm[0], sm.base(s), e);
        half_huge<1, kPack>(hi, adm[1], sm.base(s), e);
      } else if constexpr (kWide) {
        half_wide<0, kWords, kPack>(lo, qa_bits, sm.planes(s), sm.base(s),
                                    e);
        half_wide<1, kWords, kPack>(hi, qa_bits, sm.planes(s), sm.base(s),
                                    e);
      } else if (kPack != kChain && a.group == kRows) {
        half_epilogue<0, kWords, kPack, kWarpSlot, true>(
            lo, qw, sw, sm.planes(s), sm.base(s), e);
        half_epilogue<1, kWords, kPack, kWarpSlot, true>(
            hi, qw, sw, sm.planes(s), sm.base(s), e);
      } else {  // the chain (the lab's control) keeps its schedule
        half_epilogue<0, kWords, kPack, kWarpSlot, false>(
            lo, qw, sw, sm.planes(s), sm.base(s), e);
        half_epilogue<1, kWords, kPack, kWarpSlot, false>(
            hi, qw, sw, sm.planes(s), sm.base(s), e);
      }
    } else {  // no query of the warpgroup admits a row of the tile
#pragma unroll 1
      for (int g = 0; g < (kRows >> lg); ++g) {
#pragma unroll
        for (int i = 0; i < 2; ++i)
          if (e.store[i]) e.out[8 * i] = kMasked;
        e.out += e.nq;
      }
    }
    __syncwarp();
    if (lane == 0) mbar_arrive(sm.empty(s));
  }
}

template <int D, int kWords, int kPack, bool kWarpSlot, bool kFloor>
__global__ void __launch_bounds__(kTcThreads, 1)
scan_tc_kernel(const __grid_constant__ CUtensorMap q_map,  // q8 (Q, D)
               const __grid_constant__ CUtensorMap x_map,  // x8 (Npad, D)
               const ScanArgs a) {
  extern __shared__ uint8_t smem_raw[];
  const Smem<D, kWords> sm(smem_raw);
  const int q0 = (blockIdx.x % a.n_qtiles) * kQueries;
  const int run = blockIdx.x / a.n_qtiles;
  const int t_begin = (int)((long long)run * a.n_tiles / a.runs);
  const int t_end = (int)((long long)(run + 1) * a.n_tiles / a.runs);
  if (threadIdx.x == 32 * kProducer) {
    for (int s = 0; s < Ring<D, kWords>::kStages; ++s) {
      mbar_init(sm.full(s), 33);
      mbar_init(sm.empty(s), 4 * kConsumers);
    }
    mbar_init(sm.qfull(), 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  if (threadIdx.x / 32 == kProducer)
    produce<D, kWords, kPack, kFloor>(&q_map, &x_map, a, sm, q0, t_begin,
                                       t_end);
  else
    consume<D, kWords, kPack, kWarpSlot, kFloor>(a, sm, q0, t_begin, t_end);
}

template <int D, int kWords, int kPack, bool kWarpSlot, bool kFloor = false>
cudaError_t launch_tc(const CUtensorMap& q_map, const CUtensorMap& x_map,
                      const ScanArgs& a, int blocks, cudaStream_t stream) {
  auto kernel = scan_tc_kernel<D, kWords, kPack, kWarpSlot, kFloor>;
  constexpr int smem = Ring<D, kWords>::kSmem;
  const cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  kernel<<<blocks, kTcThreads, smem, stream>>>(q_map, x_map, a);
  return cudaGetLastError();
}

template <int D, int kPack>
cudaError_t dispatch_tc(const CUtensorMap& q_map, const CUtensorMap& x_map,
                        const ScanArgs& a, int blocks, cudaStream_t stream) {
  // more than 256 roles: the wide-world forms, every mask layout; past
  // 1,024 the huge forms
  if (a.w > kWideWords)
    return launch_tc<D, kHugeWords, kPack, false>(q_map, x_map, a, blocks,
                                                  stream);
  if (a.w > 16)
    return launch_tc<D, 32, kPack, false>(q_map, x_map, a, blocks, stream);
  if (a.w > kMaxWords)
    return launch_tc<D, 16, kPack, false>(q_map, x_map, a, blocks, stream);
  if (a.mask_sb > 0 && a.slot_tile == 0 && a.mask_sb % 16 == 0)
    return a.w <= 4
               ? launch_tc<D, 4, kPack, true>(q_map, x_map, a, blocks, stream)
               : launch_tc<D, 8, kPack, true>(q_map, x_map, a, blocks, stream);
  if (a.w <= 4)
    return launch_tc<D, 4, kPack, false>(q_map, x_map, a, blocks, stream);
  return launch_tc<D, 8, kPack, false>(q_map, x_map, a, blocks, stream);
}

// The floor (per-query masks only; the score arithmetic does not enter).
template <int D>
cudaError_t dispatch_floor(const CUtensorMap& q_map, const CUtensorMap& x_map,
                           const ScanArgs& a, int blocks, cudaStream_t stream) {
  if (a.w <= 4)
    return launch_tc<D, 4, kShifted, false, true>(q_map, x_map, a, blocks,
                                                  stream);
  return launch_tc<D, 8, kShifted, false, true>(q_map, x_map, a, blocks,
                                                stream);
}

// The chain (per-query masks only): every shift by the one form.
template <int D>
cudaError_t dispatch_chain(const CUtensorMap& q_map, const CUtensorMap& x_map,
                           const ScanArgs& a, int blocks, cudaStream_t stream) {
  if (a.w <= 4)
    return launch_tc<D, 4, kChain, false>(q_map, x_map, a, blocks, stream);
  return launch_tc<D, 8, kChain, false>(q_map, x_map, a, blocks, stream);
}

// ------------------------------------------------- the dp4a kernel (lab)

constexpr int kTileRows = 128;     // rows staged in shared memory at a time
constexpr int kThreads = 256;      // queries per block
constexpr int kTilesPerBlock = 8;  // tiles a block walks with one query load
// the lab's variants (vsr_scan_int8_lab): the dp4a kernel, and three forms
// of the tensor-core kernel: K1's own (the lab's trim), the floor, the chain
constexpr int kLabDp4a = 0, kLabTrim = 1, kLabFloor = 2, kLabChain = 3;

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

template <int D16>  // D16 = d_pad / 16: words per row
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
      const int32_t dot = row_dot<D16>(xs + r * D16, qv);
      const int lane = r & lane_mask;  // row0 is a multiple of group
      int32_t score = l2 ? ns[r] - 2 * dot : -dot;
      score >>= score_shift;
      const uint32_t p = (uint32_t)score << 7;  // unsigned: see the header
      int32_t hit = 0;
#pragma unroll
      for (int j = 0; j < kMaxWords; ++j)
        hit |= bs[r * kMaxWords + j] & qb[j];
      const int32_t packed = hit ? (int32_t)(p | (uint32_t)lane) : kMasked;
      best = lane == 0 ? packed : min(best, packed);
      if (lane == lane_mask) out[((row0 + r) / group) * (size_t)nq + q] = best;
    }
  }
}

template <int D16>
void launch_dp4a(const void* q8, const void* x8, const void* norms,
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

bool shapes_ok(int nq, int npad, int d_pad, int w, int max_words, int group,
               int score_shift, int mask_sb, int slot_tile) {
  const bool group_ok =
      group >= 8 && group <= kRows && (group & (group - 1)) == 0;
  const bool slots_ok =
      mask_sb == 0 ||
      (mask_sb > 0 && nq % mask_sb == 0 &&
       (slot_tile == 0 ||
        (slot_tile > 0 && slot_tile % mask_sb == 0 && nq % slot_tile == 0)));
  return nq >= 1 && npad >= kRows && npad % kRows == 0 &&
         (d_pad == 128 || d_pad == 256) && group_ok && w >= 1 &&
         w <= max_words && score_shift >= 0 && score_shift <= 31 && slots_ok;
}

int sm_count() {
  int dev = 0, n = 0;
  if (cudaGetDevice(&dev) != cudaSuccess ||
      cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev) !=
          cudaSuccess)
    return 1;
  return n;
}

// The tensor-core kernel in the form `lab` names by its lab variant code:
// kLabTrim is K1's own (the served scan), kLabFloor and kLabChain the lab's.
int scan_tc(const void* q8, const void* x8, const void* norms,
            const void* row_bits, const void* q_bits, void* out, int nq,
            int npad, int d_pad, int w, int group, int l2, int score_shift,
            int mask_sb, int slot_tile, int lab, void* stream) {
  if (!shapes_ok(nq, npad, d_pad, w, lab == kLabTrim ? kAnyWords : kMaxWords,
                 group, score_shift, mask_sb, slot_tile))
    return (int)cudaErrorInvalidValue;
  ScanArgs a;
  a.norms = static_cast<const int32_t*>(norms);
  a.row_bits = static_cast<const int32_t*>(row_bits);
  a.q_bits = static_cast<const int32_t*>(q_bits);
  a.out = static_cast<int32_t*>(out);
  a.nq = nq;
  a.n_tiles = npad / kRows;
  a.n_qtiles = (nq + kQueries - 1) / kQueries;
  // one wave: the q-tiles of a run side by side, as many runs as fill the
  // SMs (one block an SM)
  a.runs = sm_count() / a.n_qtiles;
  if (a.runs < 1) a.runs = 1;
  if (a.runs > a.n_tiles) a.runs = a.n_tiles;
  a.w = w;
  a.group = group;
  a.l2 = l2;
  a.score_shift = score_shift;
  a.mask_sb = mask_sb;
  a.slot_tile = slot_tile;
  a.aligned16 = ((uintptr_t)row_bits | (uintptr_t)norms) % 16 == 0;
  const long long blocks = (long long)a.n_qtiles * a.runs;
  if (blocks > 0x7FFFFFFFLL) return (int)cudaErrorInvalidValue;
  CUtensorMap q_map, x_map;
  cudaError_t err = box_map(&q_map, q8, nq, d_pad, kQueries);
  if (err == cudaSuccess) err = box_map(&x_map, x8, npad, d_pad, kRows);
  if (err != cudaSuccess) return (int)err;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int nb = (int)blocks;
  if (lab == kLabFloor)
    err = d_pad == 128 ? dispatch_floor<128>(q_map, x_map, a, nb, s)
                       : dispatch_floor<256>(q_map, x_map, a, nb, s);
  else if (lab == kLabChain)
    err = d_pad == 128 ? dispatch_chain<128>(q_map, x_map, a, nb, s)
                       : dispatch_chain<256>(q_map, x_map, a, nb, s);
  else if (d_pad == 128)
    err = score_shift == 0
              ? dispatch_tc<128, kFold>(q_map, x_map, a, nb, s)
              : dispatch_tc<128, kShifted>(q_map, x_map, a, nb, s);
  else
    err = score_shift == 0
              ? dispatch_tc<256, kFold>(q_map, x_map, a, nb, s)
              : dispatch_tc<256, kShifted>(q_map, x_map, a, nb, s);
  return (int)err;
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
  return scan_tc(q8, x8, norms, row_bits, q_bits, out, nq, npad, d_pad, w,
                 group, l2, score_shift, mask_sb, slot_tile, kLabTrim,
                 stream);
}

// The kernel lab's scans on per-query masks: variant 0 the dp4a kernel (the
// first port's K1), 1 trim (K1's own form: the pack folded into the score),
// 2 the floor and 3 the chain (the reference's epilogue, trim's control),
// both forms of the tensor-core kernel.
extern "C" int vsr_scan_int8_lab(const void* q8, const void* x8,
                                 const void* norms, const void* row_bits,
                                 const void* q_bits, void* out, int nq,
                                 int npad, int d_pad, int w, int group, int l2,
                                 int score_shift, int variant, void* stream) {
  // the lab's forms keep the W <= 8 kernels (trim among them)
  if (!shapes_ok(nq, npad, d_pad, w, kMaxWords, group, score_shift, 0, 0) ||
      variant < kLabDp4a || variant > kLabChain)
    return (int)cudaErrorInvalidValue;
  if (variant != kLabDp4a)
    return scan_tc(q8, x8, norms, row_bits, q_bits, out, nq, npad, d_pad, w,
                   group, l2, score_shift, 0, 0, variant, stream);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (d_pad == 128)
    launch_dp4a<8>(q8, x8, norms, row_bits, q_bits, out, nq, npad, w, group,
                   l2, score_shift, s);
  else
    launch_dp4a<16>(q8, x8, norms, row_bits, q_bits, out, nq, npad, w, group,
                    l2, score_shift, s);
  return (int)cudaGetLastError();
}

extern "C" const char* vsr_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
