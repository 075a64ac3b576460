// Chained per-problem 128 x 128 products, max-normalised, for sm_90a: a
// matrix-product rate microbenchmark of the Newton-Schulz access pattern.
//
// Replaces benchmarks/exp_mxu_rate.py::pallas_unrolled_dots. It computes
// what that kernel computes, for each problem of the batch:
//   x = M;  repeat `iters` times:  y = M x (float32 accumulation),
//   y = y / max|y| over the problem,  x = y cast to the data type,
// for bf16 or float32 data, and writes x. The product is block_product.cuh,
// the routine of the Newton-Schulz stage of fused_full_solve.cu: bf16 values
// are exact in float32, so bf16 data gives bf16-in, f32-accumulate
// arithmetic up to summation order.
//
// What bounds it on this card: 2 * 128^3 FLOP per product, in float32 FMA on
// the CUDA cores (no tensor cores), fed from shared memory at 16 loads per
// 64 FMA. M and x take 2 * 128 * 129 floats (132 KB), one block per SM. Device
// memory is touched once per problem (M in, x out), not once per product.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "block_product.cuh"

namespace {

constexpr int kN = 128;
constexpr int kThreads = 256;  // blockmm::threads_for(128)

__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

// Rounds v to the data type and back: the cast y.astype(dtype).
__device__ __forceinline__ float cast(float v, float) { return v; }
__device__ __forceinline__ float cast(float v, __nv_bfloat16) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

__device__ __forceinline__ void put(float* dst, float v) { *dst = v; }
__device__ __forceinline__ void put(__nv_bfloat16* dst, float v) {
  *dst = __float2bfloat16_rn(v);
}

struct ToFloat {
  template <typename T>
  __device__ float operator()(T v) const { return to_float(v); }
};

template <typename T>
__global__ void __launch_bounds__(kThreads) unrolled_dots_kernel(
    const T* __restrict__ m, T* __restrict__ out, int iters) {
  extern __shared__ float smem[];
  constexpr int ld = kN + 1;
  float* s_m = smem;
  float* s_x = s_m + kN * ld;
  float* s_red = s_x + kN * ld;  // [32]
  const size_t b = blockIdx.x;
  const T* g_m = m + b * kN * kN;

  blockmm::load(s_m, g_m, kN, ld, ToFloat());
  blockmm::load(s_x, g_m, kN, ld, ToFloat());
  __syncthreads();

  float acc[blockmm::kTile][blockmm::kTile];
  int i, j;
  for (int it = 0; it < iters; ++it) {
    blockmm::product(s_m, s_x, kN, ld, acc);
    float local = 0.0f;
#pragma unroll
    for (int r = 0; r < blockmm::kTile; ++r)
#pragma unroll
      for (int c = 0; c < blockmm::kTile; ++c)
        if (blockmm::owned(kN, r, c, &i, &j))
          local = fmaxf(local, fabsf(acc[r][c]));
    // block_max synchronises, so every read of x is done after it.
    const float peak = blockmm::block_max(local, s_red);
#pragma unroll
    for (int r = 0; r < blockmm::kTile; ++r)
#pragma unroll
      for (int c = 0; c < blockmm::kTile; ++c)
        if (blockmm::owned(kN, r, c, &i, &j))
          s_x[i * ld + j] = cast(acc[r][c] / peak, T());
    __syncthreads();
  }

  for (int idx = threadIdx.x; idx < kN * kN; idx += kThreads) {
    const int r = idx / kN;
    put(out + b * kN * kN + idx, s_x[r * ld + (idx - r * kN)]);
  }
}

template <typename T>
int launch(const void* m, void* out, int batch, int iters, void* stream) {
  const size_t smem = (2 * kN * (kN + 1) + 32) * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      unrolled_dots_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  if (batch == 0) return 0;
  unrolled_dots_kernel<T><<<batch, kThreads, smem,
                            static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(m), static_cast<T*>(out), iters);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Launches the kernel on `stream` for [batch, 128, 128] data, bf16 when
// `bf16` is non-zero, else float32; returns the CUDA error code (0 = success).
extern "C" int unrolled_dots_launch(const void* m, void* out, int batch,
                                    int iters, int bf16, void* stream) {
  return bf16 ? launch<__nv_bfloat16>(m, out, batch, iters, stream)
              : launch<float>(m, out, batch, iters, stream);
}
