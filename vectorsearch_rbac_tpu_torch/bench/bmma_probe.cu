// Probe of the binary tensor-core product that the narrow scan's floor form
// (csrc/scan_int8.cu kFloor) counts shared roles with:
//   mma.sync.aligned.m16n8k256.row.col.s32.b1.b1.s32.and.popc
// 1. whether ptxas takes it for sm_90a as a native instruction (look for
//    BMMA in the SASS), 2. whether its fragments are laid out as the floor
//    assumes (A rows lane / 4 and lane / 4 + 8 holding words lane % 4 and
//    lane % 4 + 4; B column lane / 4 the same words; D the m16n8 layout),
//    checked against a host popcount, and 3. its issue rate beside int8
//    mma.sync m16n8k32 and beside the same counts on the CUDA cores.
//
//   nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 \
//       -o build/bmma_probe vectorsearch_rbac_tpu_torch/bench/bmma_probe.cu
//   build/bmma_probe
//   cuobjdump -sass build/bmma_probe | grep -c BMMA
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cuda_runtime.h>

__device__ __forceinline__ void bmma(int (&d)[4], const uint32_t (&a)[4],
                                     const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k256.row.col.s32.b1.b1.s32.and.popc "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

__device__ __forceinline__ void imma(int (&d)[4], const uint32_t (&a)[4],
                                     const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// A: 16 rows x 8 words; B: 8 columns x 8 words; D: 16 x 8, C preloaded
__global__ void layout_k(const uint32_t* A, const uint32_t* B, int* D) {
  const int lane = threadIdx.x, g = lane >> 2, t = lane & 3;
  uint32_t a[4] = {A[g * 8 + t], A[(g + 8) * 8 + t], A[g * 8 + t + 4],
                   A[(g + 8) * 8 + t + 4]};
  uint32_t b[2] = {B[g * 8 + t], B[g * 8 + t + 4]};
  int d[4] = {1000 * g + 2 * t, 1000 * g + 2 * t + 1,
              1000 * (g + 8) + 2 * t, 1000 * (g + 8) + 2 * t + 1};
  bmma(d, a, b);
  D[g * 8 + 2 * t] = d[0];
  D[g * 8 + 2 * t + 1] = d[1];
  D[(g + 8) * 8 + 2 * t] = d[2];
  D[(g + 8) * 8 + 2 * t + 1] = d[3];
}

template <bool kBin>
__global__ void rate_k(int* out, int iters, uint32_t seed) {
  uint32_t a[4], b[2];
  for (int i = 0; i < 4; ++i) a[i] = seed * (threadIdx.x + 7 * i + 1);
  for (int i = 0; i < 2; ++i) b[i] = seed ^ (threadIdx.x * 13 + i);
  int d[8][4] = {};
  for (int it = 0; it < iters; ++it) {
#pragma unroll
    for (int c = 0; c < 8; ++c) {
      if (kBin) bmma(d[c], a, b);
      else imma(d[c], a, b);
    }
  }
  int s = 0;
  for (int c = 0; c < 8; ++c) s += d[c][0] + d[c][1] + d[c][2] + d[c][3];
  out[blockIdx.x * blockDim.x + threadIdx.x] = s;
}

// the same popcount product on the CUDA cores: per thread its 4 outputs of
// an m16n8k256 tile, 8 words each (the words as registers, no shuffles:
// a lower bound of that route)
__global__ void cores_k(int* out, int iters, uint32_t seed) {
  uint32_t qa[2][8], rb[2][8];
  for (int i = 0; i < 8; ++i) {
    qa[0][i] = seed * (threadIdx.x + i + 1);
    qa[1][i] = seed * (threadIdx.x + i + 3);
    rb[0][i] = seed ^ (threadIdx.x * 5 + i);
    rb[1][i] = seed ^ (threadIdx.x * 9 + i);
  }
  int d[8][4] = {};
  for (int it = 0; it < iters; ++it) {
#pragma unroll
    for (int c = 0; c < 8; ++c)
#pragma unroll
      for (int o = 0; o < 4; ++o) {
        int s = d[c][o];
#pragma unroll
        for (int w = 0; w < 8; ++w)
          s += __popc(qa[o >> 1][w] & rb[o & 1][w ^ c]);
        d[c][o] = s;
      }
  }
  int s = 0;
  for (int c = 0; c < 8; ++c) s += d[c][0] + d[c][1] + d[c][2] + d[c][3];
  out[blockIdx.x * blockDim.x + threadIdx.x] = s;
}

int main() {
  cudaDeviceProp prop;
  cudaGetDeviceProperties(&prop, 0);
  printf("device: %s\n", prop.name);
  uint32_t hA[128], hB[64];
  srand(7);
  for (int i = 0; i < 128; ++i) hA[i] = ((uint32_t)rand() << 16) ^ rand();
  for (int i = 0; i < 64; ++i) hB[i] = ((uint32_t)rand() << 16) ^ rand();
  hA[3] = 0xFFFFFFFFu;
  hB[5] = 0xFFFFFFFFu;
  uint32_t *dA, *dB;
  int *dD, *dO;
  cudaMalloc(&dA, sizeof(hA));
  cudaMalloc(&dB, sizeof(hB));
  cudaMalloc(&dD, 128 * sizeof(int));
  cudaMemcpy(dA, hA, sizeof(hA), cudaMemcpyHostToDevice);
  cudaMemcpy(dB, hB, sizeof(hB), cudaMemcpyHostToDevice);
  layout_k<<<1, 32>>>(dA, dB, dD);
  cudaError_t err = cudaDeviceSynchronize();
  int hD[128];
  cudaMemcpy(hD, dD, sizeof(hD), cudaMemcpyDeviceToHost);
  int bad = 0;
  for (int m = 0; m < 16; ++m)
    for (int n = 0; n < 8; ++n) {
      int want = 1000 * m + n;
      for (int w = 0; w < 8; ++w)
        want += __builtin_popcount(hA[m * 8 + w] & hB[n * 8 + w]);
      if (hD[m * 8 + n] != want) ++bad;
    }
  printf("layout: err %s, %d of 128 wrong\n", cudaGetErrorString(err), bad);

  const int blocks = 132 * 8, threads = 128, iters = 4096;
  cudaMalloc(&dO, blocks * threads * sizeof(int));
  cudaEvent_t e0, e1;
  cudaEventCreate(&e0);
  cudaEventCreate(&e1);
  const double warps = blocks * threads / 32.0;
  for (int rep = 0; rep < 2; ++rep) {
    for (int kind = 0; kind < 3; ++kind) {
      cudaEventRecord(e0);
      if (kind == 0) rate_k<true><<<blocks, threads>>>(dO, iters, 3u + rep);
      else if (kind == 1) rate_k<false><<<blocks, threads>>>(dO, iters, 3u + rep);
      else cores_k<<<blocks, threads>>>(dO, iters, 3u + rep);
      cudaEventRecord(e1);
      cudaEventSynchronize(e1);
      float ms = 0;
      cudaEventElapsedTime(&ms, e0, e1);
      const double mmas = warps * iters * 8;
      // bit-ops: 2 * 16 * 8 * 256 (and, popc-add) a bmma; int8: 2*16*8*32
      const double ops = mmas * 2.0 * 16 * 8 * (kind == 1 ? 32 : 256);
      printf("%s: %.3f ms, %.4g warp-mma/s, %.4g ops/s (err %s)\n",
             kind == 0 ? "bmma m16n8k256 b1 and.popc"
                       : kind == 1 ? "imma m16n8k32 s8" : "cores popc (same outputs)",
             ms, mmas / (ms * 1e-3), ops / (ms * 1e-3),
             cudaGetErrorString(cudaGetLastError()));
    }
  }
  return 0;
}
