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
// What bounds it on an H100: memory traffic. Each thread reads its column's
// sub values once per round, t times in all (16 x 32 MB per 2048-query batch
// at 1M rows), mostly from L2.
// Design: one thread per (subgroup, query); neighbouring threads read
// neighbouring queries of one row, so every load is coalesced and no state
// but (last value, running min, running meta) lives in registers.
//
// ---------------------------------------------------------------------------
// bitonic_pairs_kernel replaces the TPU kernel
// vectorsearch_rbac_tpu/ops/pallas_merge.py _make_bitonic_pairs_kernel
// (stage 2 of pallas_merge_topk).
//
// Contract: a full bitonic network sorts each query column's npc = nsub * t
// survivors by value, meta riding along, and keeps the first `keep` rows.
// The compare-exchange is the TPU network's own, not the textbook one:
//   le = a <= b; lo = le ? a : b; hi = le ? b : a
//   descending block (i & size) != 0: i <- hi, i + stride <- lo
// so equal values SWAP in a descending block. Copying that rule keeps the
// meta order of equal values identical to the TPU kernel's.
//
// What bounds it on an H100: barrier latency. log2(npc) (log2(npc) + 1) / 2
// stages (45 at npc = 512), each a __syncthreads over npc / 2 exchanges in
// shared memory; the column load reads one int32 per row, uncoalesced.
// Design: one block per query column, the column in shared memory, one
// thread per exchange.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int32_t kBig = 0x7FFFFFFF;
constexpr int kExtractThreads = 128;

__global__ void __launch_bounds__(kExtractThreads)
extract_pairs_kernel(const int32_t* __restrict__ mins,  // (n_groups, Q)
                     int32_t* __restrict__ out_y,       // (nsub * t, Q)
                     int32_t* __restrict__ out_m,       // (nsub * t, Q)
                     int nq, int sub, int t) {
  const int q = blockIdx.x * kExtractThreads + threadIdx.x;
  const int j = blockIdx.y;
  if (q >= nq) return;
  const int32_t* col = mins + (size_t)j * sub * nq + q;
  const uint32_t base = (uint32_t)j * (uint32_t)sub;
  int32_t last = 0;
  uint32_t meta_all = kBig;  // min meta over all rows: the drained-round meta
  for (int r = 0; r < t; ++r) {
    int32_t cur = kBig;
    uint32_t meta = kBig;
    for (int p = 0; p < sub; ++p) {
      const int32_t v = col[(size_t)p * nq];
      const uint32_t m = ((base + p) << 7) | ((uint32_t)v & 127u);
      if (r == 0) meta_all = min(meta_all, m);
      else if (v <= last) continue;  // extracted in an earlier round
      if (v < cur) {
        cur = v;
        meta = m;
      } else if (v == cur) {
        meta = min(meta, m);
      }
    }
    if (cur == kBig) meta = meta_all;
    const size_t o = ((size_t)j * t + r) * nq + q;
    out_y[o] = cur;
    out_m[o] = (int32_t)meta;
    last = cur;
  }
}

__global__ void bitonic_pairs_kernel(const int32_t* __restrict__ y,     // (npc, Q)
                                     const int32_t* __restrict__ meta,  // (npc, Q)
                                     int32_t* __restrict__ out_y,       // (keep, Q)
                                     int32_t* __restrict__ out_m,       // (keep, Q)
                                     int nq, int npc, int keep) {
  extern __shared__ int32_t smem[];
  int32_t* sy = smem;
  int32_t* sg = smem + npc;
  const int q = blockIdx.x;
  for (int i = threadIdx.x; i < npc; i += blockDim.x) {
    sy[i] = y[(size_t)i * nq + q];
    sg[i] = meta[(size_t)i * nq + q];
  }
  __syncthreads();
  for (int size = 2; size <= npc; size <<= 1) {
    for (int stride = size >> 1; stride >= 1; stride >>= 1) {
      for (int p = threadIdx.x; p < npc / 2; p += blockDim.x) {
        const int i = ((p & ~(stride - 1)) << 1) | (p & (stride - 1));
        const int k = i + stride;
        const int32_t a = sy[i], b = sy[k], ga = sg[i], gb = sg[k];
        const bool le = a <= b;
        const int32_t lo = le ? a : b, hi = le ? b : a;
        const int32_t glo = le ? ga : gb, ghi = le ? gb : ga;
        const bool desc = (i & size) != 0;
        sy[i] = desc ? hi : lo;
        sy[k] = desc ? lo : hi;
        sg[i] = desc ? ghi : glo;
        sg[k] = desc ? glo : ghi;
      }
      __syncthreads();
    }
  }
  for (int i = threadIdx.x; i < keep; i += blockDim.x) {
    out_y[(size_t)i * nq + q] = sy[i];
    out_m[(size_t)i * nq + q] = sg[i];
  }
}

}  // namespace

extern "C" int vsr_extract_pairs(const void* mins, void* out_y, void* out_m,
                                 int nq, int nsub, int sub, int t,
                                 void* stream) {
  if (nq < 1 || nsub < 1 || nsub > 65535 || sub < 1 || t < 1 ||
      (long long)nsub * sub * 128 > kBig)
    return (int)cudaErrorInvalidValue;
  const dim3 grid((nq + kExtractThreads - 1) / kExtractThreads, nsub);
  extract_pairs_kernel<<<grid, kExtractThreads, 0,
                         static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(mins), static_cast<int32_t*>(out_y),
      static_cast<int32_t*>(out_m), nq, sub, t);
  return (int)cudaGetLastError();
}

extern "C" int vsr_bitonic_pairs(const void* y, const void* meta, void* out_y,
                                 void* out_m, int nq, int npc, int keep,
                                 void* stream) {
  if (nq < 1 || npc < 2 || npc > 2048 || (npc & (npc - 1)) != 0 || keep < 1 ||
      keep > npc)
    return (int)cudaErrorInvalidValue;
  const int threads = npc / 2 < 32 ? 32 : npc / 2;
  const size_t smem = 2 * (size_t)npc * sizeof(int32_t);
  bitonic_pairs_kernel<<<nq, threads, smem,
                         static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(y), static_cast<const int32_t*>(meta),
      static_cast<int32_t*>(out_y), static_cast<int32_t*>(out_m), nq, npc,
      keep);
  return (int)cudaGetLastError();
}
