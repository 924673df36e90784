// Hopper building blocks shared by the tensor-core scans (scan_int8.cu,
// scan_int8_wide.cu): mbarriers, TMA box loads in the 128-byte swizzle, the
// wgmma shared-memory descriptor and the m64n128k32 s32.s8.s8 product, the
// binary m16n8k256 AND.POPC product that counts shared roles in the same
// accumulator places (and, past 32 bitset words, the role test built on
// it), and the tensor maps the C entry points encode per call.
//
// Each source that includes this header compiles it on its own (the build
// runs one nvcc per .cu); ops/_build.py hashes the header with the sources.

#pragma once

#include <cuda.h>  // CUtensorMap and its enums; cuTensorMapEncodeTiled
                   // comes from the runtime's entry-point query (no -lcuda)
#include <cuda_runtime.h>
#include <cudaTypedefs.h>
#include <stdint.h>

namespace {

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async4(uint32_t dst, const void* src,
                                          int src_bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(dst),
               "l"(src), "r"(src_bytes)
               : "memory");
}

__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(dst),
               "l"(src)
               : "memory");
}

__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar)
               : "memory");
}

// arrive, and expect `bytes` more from the copies that complete on `bar`
__device__ __forceinline__ void mbar_expect(uint32_t bar, int bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::
                   "r"(bar),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done = 0;
  while (!done)
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
}

// one 128-byte-wide box of a K-major int8 matrix into shared memory, in the
// 128-byte swizzle; rows past the matrix arrive as zeros
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map,
                                         int col, int row, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%2, %3}], [%4];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(col), "r"(row), "r"(bar)
      : "memory");
}

// K-major operand in the 128-byte swizzle: 8-row atoms of 1024 bytes, one
// atom after another (stride byte offset 1024; the leading byte offset is
// not read for this layout), layout type 1 (SWIZZLE_128B) in bits 62-63.
__device__ __forceinline__ uint64_t sw128_desc(uint32_t saddr) {
  return (uint64_t)((saddr & 0x3FFFF) >> 4) | ((uint64_t)1 << 16) |
         ((uint64_t)(1024 >> 4) << 32) | ((uint64_t)1 << 62);
}

// Keeps the compiler from moving accumulator reads or writes across the
// asynchronous wgmma.
__device__ __forceinline__ void fence_acc(int32_t (&d)[64]) {
#pragma unroll
  for (int i = 0; i < 64; ++i) asm volatile("" : "+r"(d[i])::"memory");
}

// d (64 queries x 128 rows, int32) = A (64 x 32 int8) . B (128 x 32 int8)^T
// + (accumulate ? d : 0)
__device__ __forceinline__ void wgmma_m64n128k32(int32_t (&d)[64],
                                                 uint64_t desc_a,
                                                 uint64_t desc_b,
                                                 int accumulate = 1) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k32.s32.s8.s8 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, "
      "%29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, "
      "%43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, "
      "%57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p;\n"
      "}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]),
        "+r"(d[5]), "+r"(d[6]), "+r"(d[7]), "+r"(d[8]), "+r"(d[9]),
        "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]), "+r"(d[14]),
        "+r"(d[15]), "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]),
        "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]), "+r"(d[24]),
        "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]),
        "+r"(d[30]), "+r"(d[31]), "+r"(d[32]), "+r"(d[33]), "+r"(d[34]),
        "+r"(d[35]), "+r"(d[36]), "+r"(d[37]), "+r"(d[38]), "+r"(d[39]),
        "+r"(d[40]), "+r"(d[41]), "+r"(d[42]), "+r"(d[43]), "+r"(d[44]),
        "+r"(d[45]), "+r"(d[46]), "+r"(d[47]), "+r"(d[48]), "+r"(d[49]),
        "+r"(d[50]), "+r"(d[51]), "+r"(d[52]), "+r"(d[53]), "+r"(d[54]),
        "+r"(d[55]), "+r"(d[56]), "+r"(d[57]), "+r"(d[58]), "+r"(d[59]),
        "+r"(d[60]), "+r"(d[61]), "+r"(d[62]), "+r"(d[63])
      : "l"(desc_a), "l"(desc_b), "r"(accumulate));
}

// The same product as two 64-row halves of B: lo holds rows 0-63 of the
// 128 (acc[4 n8 + ...] for n8 < 8), hi rows 64-127.
__device__ __forceinline__ void wgmma_m64n128k32(int32_t (&lo)[32],
                                                 int32_t (&hi)[32],
                                                 uint64_t desc_a,
                                                 uint64_t desc_b,
                                                 int accumulate) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k32.s32.s8.s8 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, "
      "%29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, "
      "%43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, "
      "%57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p;\n"
      "}\n"
      : "+r"(lo[0]), "+r"(lo[1]), "+r"(lo[2]), "+r"(lo[3]), "+r"(lo[4]),
        "+r"(lo[5]), "+r"(lo[6]), "+r"(lo[7]), "+r"(lo[8]), "+r"(lo[9]),
        "+r"(lo[10]), "+r"(lo[11]), "+r"(lo[12]), "+r"(lo[13]), "+r"(lo[14]),
        "+r"(lo[15]), "+r"(lo[16]), "+r"(lo[17]), "+r"(lo[18]), "+r"(lo[19]),
        "+r"(lo[20]), "+r"(lo[21]), "+r"(lo[22]), "+r"(lo[23]), "+r"(lo[24]),
        "+r"(lo[25]), "+r"(lo[26]), "+r"(lo[27]), "+r"(lo[28]), "+r"(lo[29]),
        "+r"(lo[30]), "+r"(lo[31]), "+r"(hi[0]), "+r"(hi[1]), "+r"(hi[2]),
        "+r"(hi[3]), "+r"(hi[4]), "+r"(hi[5]), "+r"(hi[6]), "+r"(hi[7]),
        "+r"(hi[8]), "+r"(hi[9]), "+r"(hi[10]), "+r"(hi[11]), "+r"(hi[12]),
        "+r"(hi[13]), "+r"(hi[14]), "+r"(hi[15]), "+r"(hi[16]), "+r"(hi[17]),
        "+r"(hi[18]), "+r"(hi[19]), "+r"(hi[20]), "+r"(hi[21]), "+r"(hi[22]),
        "+r"(hi[23]), "+r"(hi[24]), "+r"(hi[25]), "+r"(hi[26]), "+r"(hi[27]),
        "+r"(hi[28]), "+r"(hi[29]), "+r"(hi[30]), "+r"(hi[31])
      : "l"(desc_a), "l"(desc_b), "r"(accumulate));
}

__device__ __forceinline__ void fence_acc(int32_t (&d)[32]) {
#pragma unroll
  for (int i = 0; i < 32; ++i) asm volatile("" : "+r"(d[i])::"memory");
}

// d += the 16 x 8 popcount product of one m16n8k256 b1 tile: A's row g
// (the warp's queries lane / 4 and lane / 4 + 8) holds words t and t + 4
// (t = lane % 4) of a query's 256 role bits, B's column g words t and
// t + 4 of a row's; d holds (query, row) = (g, 2t), (g, 2t + 1),
// (g + 8, 2t), (g + 8, 2t + 1): the wgmma accumulator's place for the
// same pairs, so the count adds in place.
__device__ __forceinline__ void bmma_and_popc(int32_t& d0, int32_t& d1,
                                              int32_t& d2, int32_t& d3,
                                              const uint32_t (&qf)[4],
                                              uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k256.row.col.s32.b1.b1.s32.and.popc "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+r"(d0), "+r"(d1), "+r"(d2), "+r"(d3)
      : "r"(qf[0]), "r"(qf[1]), "r"(qf[2]), "r"(qf[3]), "r"(b0), "r"(b1));
}

// Worlds past 1,024 roles (W > 32 bitset words): the scans' huge forms
// test a pair's shared roles 32 words at a time. For each chunk of 32
// words the kThreads threads that share a tile (a consumer warpgroup of
// K1, K2's block) copy the chunk's words of the tile's 128 rows and of
// their kQueries queries into shared memory together (cp.async, 16-byte
// pieces where W % 4 == 0 and the arrays are 16-byte aligned; zeros past
// W and past the batch), then each warp runs 4 binary products an 8-row
// slice (mma.sync m16n8k256 b1 AND.POPC, bmma_and_popc's places) and keeps
// one bit a pair. The rows' words lie as 8 planes of (128, 4) words, B
// fragments in conflict-free reads as in the wide forms; the queries'
// words at a pitch of 36 words, so a warp's A fragment reads hit 32
// distinct banks: HugeChunk<kQueries>::kBytes of shared memory a group.
constexpr int kHugeWordsStep = 32;   // words a chunk
constexpr int kHugeQPitch = 36;      // words a staged query row
template <int kQueries>
struct HugeChunk {
  static constexpr int kRowBytes = 128 * kHugeWordsStep * 4;   // 16 KB
  static constexpr int kBytes = kRowBytes + kQueries * kHugeQPitch * 4;
};

__device__ __forceinline__ void named_barrier(int id, int threads) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}

// Copy 4 words (a 16-byte piece) of a bitset row to shared memory: valid
// words past the row's end (valid < 4) and missing rows (src null) are
// zero-filled. src must be 16-byte aligned where vec16.
__device__ __forceinline__ void huge_piece(uint32_t dst, const int32_t* src,
                                           int valid, bool vec16,
                                           const int32_t* dummy) {
  if (src != nullptr && vec16 && valid >= 4) {
    cp_async16(dst, src);
    return;
  }
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const bool ok = src != nullptr && j < valid;
    cp_async4(dst + 4 * j, ok ? src + j : dummy, ok ? 4 : 0);
  }
}

// Each pair's shared-role bit for a warp's 16 queries (lane / 4 and lane /
// 4 + 8 of queries wq0 .. wq0 + 15 of the group's kQueries) against a
// 128-row tile: adm[h] bit 4 n + 2 i + j for query lane / 4 + 8 i and row
// 64 h + 8 n + 2 (lane % 4) + j. tid is the thread's index in the group,
// barrier (id, kThreads) the group's barrier; qrow(qi) the mask row of
// the group's query qi (null past the batch), tile_bits the tile's (128,
// W) words. Every thread of the group calls it.
template <int kThreads, int kQueries, typename QRow>
__device__ __forceinline__ void huge_tile_bits(uint32_t (&adm)[2],
                                               uint8_t* scratch,
                                               const int32_t* tile_bits,
                                               int w, bool vec16, int tid,
                                               int barrier_id, int wq0,
                                               QRow qrow) {
  constexpr int kPieces = kHugeWordsStep / 4;   // 16-byte pieces a row
  const uint32_t rows_s = smem_addr(scratch);
  const uint32_t qs_s = rows_s + HugeChunk<kQueries>::kRowBytes;
  const int32_t* planes = reinterpret_cast<const int32_t*>(scratch);
  const int32_t* qs = reinterpret_cast<const int32_t*>(
      scratch + HugeChunk<kQueries>::kRowBytes);
  const int lane = threadIdx.x % 32, t = lane % 4;
  adm[0] = adm[1] = 0;
#pragma unroll 1
  for (int m0 = 0; m0 < w; m0 += kHugeWordsStep) {
    named_barrier(barrier_id, kThreads);   // the last chunk's reads are done
#pragma unroll 2
    for (int e = tid; e < 128 * kPieces; e += kThreads) {
      const int r = e / kPieces, p = e % kPieces, m = m0 + 4 * p;
      huge_piece(rows_s + 16 * (p * 128 + r), tile_bits + (size_t)r * w + m,
                 w - m, vec16, tile_bits);
    }
#pragma unroll 2
    for (int e = tid; e < kQueries * kPieces; e += kThreads) {
      const int qi = e / kPieces, p = e % kPieces, m = m0 + 4 * p;
      const int32_t* row = qrow(qi);
      huge_piece(qs_s + 4 * (qi * kHugeQPitch + 4 * p),
                 row != nullptr ? row + m : nullptr, w - m, vec16, tile_bits);
    }
    asm volatile("cp.async.commit_group;\n" ::: "memory");
    asm volatile("cp.async.wait_group 0;\n" ::: "memory");
    named_barrier(barrier_id, kThreads);   // the chunk is in
    uint32_t qf[4][4];
#pragma unroll
    for (int k = 0; k < 4; ++k)
#pragma unroll
      for (int h = 0; h < 4; ++h)
        qf[k][h] = (uint32_t)qs[(wq0 + lane / 4 + 8 * (h & 1)) * kHugeQPitch +
                                8 * k + t + 4 * (h >> 1)];
#pragma unroll
    for (int h2 = 0; h2 < 2; ++h2) {
#pragma unroll 2
      for (int n = 0; n < 8; ++n) {
        const int r = 64 * h2 + 8 * n + lane / 4;
        int32_t c[4] = {0, 0, 0, 0};
#pragma unroll
        for (int k = 0; k < 4; ++k)
          bmma_and_popc(c[0], c[1], c[2], c[3], qf[k],
                        (uint32_t)planes[4 * (2 * k * 128 + r) + t],
                        (uint32_t)planes[4 * ((2 * k + 1) * 128 + r) + t]);
        adm[h2] |= (uint32_t)((c[0] != 0) | ((c[1] != 0) << 1) |
                              ((c[2] != 0) << 2) | ((c[3] != 0) << 3))
                   << (4 * n);
      }
    }
  }
}

// The tensor map of a (rows, d_pad) int8 matrix, read in 128-byte x
// box_rows boxes (box_rows <= 256) in the 128-byte swizzle.
inline cudaError_t box_map(CUtensorMap* map, const void* base, int rows,
                           int d_pad, int box_rows) {
  static PFN_cuTensorMapEncodeTiled_v12000 encode = nullptr;
  if (encode == nullptr) {
    void* fn = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &fn, 12000, cudaEnableDefault, &found);
#else
    cudaError_t err = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &fn,
                                              cudaEnableDefault, &found);
#endif
    if (err != cudaSuccess) return err;
    if (found != cudaDriverEntryPointSuccess || fn == nullptr)
      return cudaErrorSymbolNotFound;
    encode = reinterpret_cast<PFN_cuTensorMapEncodeTiled_v12000>(fn);
  }
  const cuuint64_t dims[2] = {(cuuint64_t)d_pad, (cuuint64_t)rows};
  const cuuint64_t strides[1] = {(cuuint64_t)d_pad};
  const cuuint32_t box[2] = {128, (cuuint32_t)box_rows};
  const cuuint32_t steps[2] = {1, 1};
  const CUresult res = encode(
      map, CU_TENSOR_MAP_DATA_TYPE_UINT8, 2, const_cast<void*>(base), dims,
      strides, box, steps, CU_TENSOR_MAP_INTERLEAVE_NONE,
      CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
      CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return res == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

}  // namespace
