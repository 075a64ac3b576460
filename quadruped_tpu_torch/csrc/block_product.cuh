// One n x n matrix product per thread block, operands and result in shared
// memory, float32 FMA: the routine of the Newton-Schulz stage of
// fused_full_solve.cu and of the chained-product benchmark unrolled_dots.cu.
//
// Layout: both operands row-major with leading dimension ld = n + 1. The
// block's threads tile the n x n result; thread t < T * T (T = ceil(n / 8))
// owns the 8 x 8 entries at rows ti + T r and columns tj + T c (r, c < 8),
// with ti = t / T and tj = t % T. So at each k a warp reads consecutive words
// of a row of B (conflict-free) and a few rows of A, ld words apart, which
// the odd padding puts in distinct banks. Each thread keeps its 64 sums in
// registers: 64 FMA per 16 shared-memory loads. Threads t >= T * T hold
// zeros and own nothing.
//
// For bf16-in, f32-accumulate arithmetic a caller stores bf16-rounded values
// in the operands: a product of two bf16 values is exact in float32, so only
// the summation order differs from a bf16 tensor-core product.

#pragma once

#include <cuda_runtime.h>

namespace blockmm {

constexpr int kTile = 8;

__host__ __device__ inline int tiles(int n) { return (n + kTile - 1) / kTile; }

// Threads a block needs for an n x n product, whole warps.
__host__ __device__ inline int threads_for(int n) {
  const int owners = tiles(n) * tiles(n);
  return ((owners + 31) / 32) * 32;
}

__host__ __device__ inline int leading_dim(int n) { return n + 1; }

// Row and column of this thread's entry (r, c); false where it owns none.
__device__ __forceinline__ bool owned(int n, int r, int c, int* i, int* j) {
  const int t = tiles(n);
  const int ti = threadIdx.x / t;
  const int tj = threadIdx.x - ti * t;
  *i = ti + t * r;
  *j = tj + t * c;
  return ti < t && *i < n && *j < n;
}

// acc = A B for this thread's entries. Out-of-range rows and columns are
// clamped to n - 1 for reading and never owned, so no branch is taken inside
// the k loop. Reads only; the caller synchronises before overwriting A or B.
__device__ __forceinline__ void product(const float* __restrict__ a,
                                        const float* __restrict__ b, int n,
                                        int ld, float (&acc)[kTile][kTile]) {
  const int t = tiles(n);
  const int ti = threadIdx.x / t;
  const int tj = threadIdx.x - ti * t;
#pragma unroll
  for (int r = 0; r < kTile; ++r)
#pragma unroll
    for (int c = 0; c < kTile; ++c) acc[r][c] = 0.0f;
  if (ti >= t) return;
  int arow[kTile], bcol[kTile];
#pragma unroll
  for (int r = 0; r < kTile; ++r) arow[r] = min(ti + t * r, n - 1) * ld;
#pragma unroll
  for (int c = 0; c < kTile; ++c) bcol[c] = min(tj + t * c, n - 1);
#pragma unroll 2
  for (int k = 0; k < n; ++k) {
    float av[kTile], bv[kTile];
    const float* brow = b + k * ld;
#pragma unroll
    for (int r = 0; r < kTile; ++r) av[r] = a[arow[r] + k];
#pragma unroll
    for (int c = 0; c < kTile; ++c) bv[c] = brow[bcol[c]];
#pragma unroll
    for (int r = 0; r < kTile; ++r)
#pragma unroll
      for (int c = 0; c < kTile; ++c) acc[r][c] = fmaf(av[r], bv[c], acc[r][c]);
  }
}

// Copies a dense row-major n x n matrix from device memory into shared
// memory with leading dimension ld (coalesced reads).
template <typename T, typename Convert>
__device__ __forceinline__ void load(float* dst, const T* __restrict__ src,
                                     int n, int ld, Convert convert) {
  for (int idx = threadIdx.x; idx < n * n; idx += blockDim.x) {
    const int i = idx / n;
    dst[i * ld + (idx - i * n)] = convert(src[idx]);
  }
}

// Maximum of v over the block (blockDim.x a multiple of 32); every thread
// gets it. scratch holds 32 floats of shared memory.
__device__ __forceinline__ float block_max(float v, float* scratch) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, off));
  if ((threadIdx.x & 31) == 0) scratch[threadIdx.x >> 5] = v;
  __syncthreads();
  float r = scratch[0];
  for (int w = 1; w < static_cast<int>(blockDim.x >> 5); ++w)
    r = fmaxf(r, scratch[w]);
  __syncthreads();
  return r;
}

}  // namespace blockmm
