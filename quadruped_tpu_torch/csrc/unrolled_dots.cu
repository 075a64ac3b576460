// Chained per-problem 128 x 128 products, max-normalised, on the tensor
// cores of sm_90a: a matrix-product rate microbenchmark of the
// Newton-Schulz access pattern, in both data types.
//
// Replaces benchmarks/exp_mxu_rate.py::pallas_unrolled_dots. It computes
// what that kernel computes, for each problem of the batch:
//   x = M;  repeat `iters` times:  y = M x (float32 accumulation),
//   y = y / max|y| over the problem,  x = y cast to the data type,
// and writes x. One block of two warpgroups per problem; M and x stay in
// shared memory for the whole chain, y in the accumulator registers.
//
//   * bf16: the product is tc_product.cuh's, the routine of the
//     Newton-Schulz stage of fused_full_solve.cu: M and x bf16 tiles in its
//     128-byte-swizzled row-major layout (M the K-major A operand, x the
//     MN-major B operand through the transpose bit), bf16 x bf16 -> float32
//     wgmma: exact products summed in the tensor cores' float32
//     accumulator, in its own order and rounding (the plain version sums
//     them in IEEE float32; PERF.md gives both chains' distance from a
//     float64 one). y / max|y| is rounded to nearest-even bf16 straight
//     into x's tile. 65.1 KB of shared memory and at most 128 registers a
//     thread: two blocks an SM (ptxas refuses the m64n128 wgmma at the 80
//     registers that three would leave).
//   * float32: the product is tf32_product.cuh's three TF32 passes,
//     M_hi x_hi + M_hi x_lo + M_lo x_hi with hi = tf32(v), lo = tf32(v - hi)
//     (CUTLASS's 3xTF32), which holds float32 accuracy where one TF32 pass
//     would not. TF32 wgmma takes both operands K-major, so x is staged
//     transposed: M_hi and M_lo stay resident (128 KB); column j of y
//     depends only on column j of x, so x^T's hi and lo parts are staged
//     one 64-column half at a time (64 KB), each half's product taking
//     that half of the accumulators; the normalisation waits for the block
//     maximum over both halves. 193.1 KB, one block an SM.
//
// What bounds it on this card: 2 x 128^3 operations per product on the
// tensor cores, B x iters products; device memory is touched once per
// problem (M in, x out). bf16: 989 TFLOP/s dense, 0.043 ms at B = 1024, 10
// products. float32: three TF32 passes at 495 TFLOP/s, 0.26 ms (the
// CUDA cores' float32 rate, 67 TFLOP/s, would take 0.64 ms for one pass).
// What holds it above that (PERF.md): the products alone keep pace with the
// tensor cores, but between two products each step normalises (the block
// maximum and its barrier, an exact quotient and the cast or split of every
// entry, the stores and their barrier) with the tensor cores idle; the
// SM's two bf16 problems do so at the same time, and the float32 problem
// has its SM alone.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "tc_product.cuh"
#include "tf32_product.cuh"

namespace {

constexpr int kN = tc::kN;
constexpr int kWarps = tc::kThreads / 32;

// max |acc| over the block; every thread gets it. Its barrier also orders
// both warpgroups' finished products before the caller's next store; the
// caller passes another barrier before the next call reuses s_red. The
// maximum of non-negative floats is that of their bit patterns as unsigned
// integers: one warp reduction.
__device__ __forceinline__ float block_abs_max(const float (&acc)[tc::kAcc],
                                               float* s_red) {
  float part[8] = {};  // eight independent chains
#pragma unroll
  for (int i = 0; i < tc::kAcc; ++i)
    part[i & 7] = fmaxf(part[i & 7], fabsf(acc[i]));
  const float v =
      fmaxf(fmaxf(fmaxf(part[0], part[1]), fmaxf(part[2], part[3])),
            fmaxf(fmaxf(part[4], part[5]), fmaxf(part[6], part[7])));
  const unsigned bits = __reduce_max_sync(0xffffffffu, __float_as_uint(v));
  if ((threadIdx.x & 31) == 0) s_red[threadIdx.x >> 5] = __uint_as_float(bits);
  __syncthreads();
  float peak = s_red[0];
#pragma unroll
  for (int w = 1; w < kWarps; ++w) peak = fmaxf(peak, s_red[w]);
  return peak;
}

// y / peak rounded to nearest, the IEEE quotient the plain version takes,
// without a division per entry (an instruction sequence and a branch each):
// with inv = RN(1 / peak) and |v| <= peak, q = RN(v inv) is within an ulp
// of v / peak, the FMA gives its remainder v - q peak exactly, and
// RN(q + remainder inv) is RN(v / peak) (Markstein's correction;
// tests/test_torch_mxu_rate.py holds the sequence to IEEE division).
struct Normalise {
  float peak, inv;
  __device__ float operator()(float v, int, int) const {
    const float q = __fmul_rn(v, inv);
    return fmaf(fmaf(-q, peak, v), inv, q);
  }
};

__device__ __forceinline__ Normalise normalise_by(float peak) {
  return {peak, 1.0f / peak};
}

// The tiles start on a 1024-byte boundary (the swizzle pattern's period).
__device__ __forceinline__ char* aligned_tiles(unsigned char* smem_raw) {
  return reinterpret_cast<char*>(smem_raw) +
         ((1024 - (tc::smem_addr(smem_raw) & 1023)) & 1023);
}

__global__ void __launch_bounds__(tc::kThreads, 2) dots_bf16_kernel(
    const __nv_bfloat16* __restrict__ m, __nv_bfloat16* __restrict__ out,
    int iters) {
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  char* t_m = aligned_tiles(smem_raw);
  char* t_x = t_m + tc::kTileBytes;
  float* s_red = reinterpret_cast<float*>(t_x + tc::kTileBytes);
  const size_t b = blockIdx.x;
  // 16-byte chunks of 8 bf16 values, 16 a row.
  constexpr int kChunks = kN * kN / 8;
  const uint4* g_m = reinterpret_cast<const uint4*>(m + b * kN * kN);
#pragma unroll
  for (int j = 0; j < kChunks / tc::kThreads; ++j) {
    const int idx = threadIdx.x + j * tc::kThreads;
    const uint4 v = g_m[idx];
    const int off = tc::offset(idx >> 4, (idx & 15) << 3);
    *reinterpret_cast<uint4*>(t_m + off) = v;
    *reinterpret_cast<uint4*>(t_x + off) = v;
  }
  tc::operands_written();

  float acc[tc::kAcc] = {};
  for (int it = 0; it < iters; ++it) {
    tc::product_n128(acc, t_m, t_x, false);                // y = M x
    const float peak = block_abs_max(acc, s_red);          // x read by both
    tc::store<0, 2>(acc, t_x, false, normalise_by(peak));  // bf16(y / peak)
    tc::operands_written();
  }

  uint4* g_out = reinterpret_cast<uint4*>(out + b * kN * kN);
#pragma unroll
  for (int j = 0; j < kChunks / tc::kThreads; ++j) {
    const int idx = threadIdx.x + j * tc::kThreads;
    g_out[idx] = *reinterpret_cast<const uint4*>(
        t_x + tc::offset(idx >> 4, (idx & 15) << 3));
  }
}

__global__ void __launch_bounds__(tc::kThreads, 1) dots_f32_kernel(
    const float* __restrict__ m, float* __restrict__ out, int iters) {
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  char* a_hi = aligned_tiles(smem_raw);                  // M_hi
  char* a_lo = a_hi + tf32::operand_bytes<kN>();          // M_lo
  char* b_hi = a_lo + tf32::operand_bytes<kN>();          // a half of x^T: hi
  char* b_lo = b_hi + tf32::operand_bytes<kN / 2>();      // and lo
  float* s_red =
      reinterpret_cast<float*>(b_lo + tf32::operand_bytes<kN / 2>());
  const size_t b = blockIdx.x;
  const float* g_m = m + b * kN * kN;
  // x_0 = M, in the accumulators' layout (x = acc / peak throughout).
  float acc[tc::kAcc];
#pragma unroll
  for (int i = 0; i < tc::kAcc; i += 2) {
    const float2 v = *reinterpret_cast<const float2*>(
        g_m + tc::acc_row(i) * kN + tc::acc_col(i));
    acc[i] = v.x;
    acc[i + 1] = v.y;
  }
  tf32::load_split(a_hi, a_lo, g_m);
  float peak = 1.0f;
  for (int it = 0; it < iters; ++it) {
    tf32::store_split_transposed<0>(acc, b_hi, b_lo, normalise_by(peak));
    tc::operands_written();
    tf32::product_3pass_n64<0>(acc, a_hi, a_lo, b_hi, b_lo);
    __syncthreads();  // both warpgroups have read the first half
    tf32::store_split_transposed<1>(acc, b_hi, b_lo, normalise_by(peak));
    tc::operands_written();
    tf32::product_3pass_n64<1>(acc, a_hi, a_lo, b_hi, b_lo);
    peak = block_abs_max(acc, s_red);  // the second half read by both
  }

  float* g_out = out + b * kN * kN;
  const Normalise x = normalise_by(peak);
#pragma unroll
  for (int i = 0; i < tc::kAcc; i += 2)
    *reinterpret_cast<float2*>(g_out + tc::acc_row(i) * kN + tc::acc_col(i)) =
        make_float2(x(acc[i], 0, 0), x(acc[i + 1], 0, 0));
}

// Dynamic shared memory of one block: the operands, 1024 bytes to align
// them and 32 floats of reduction scratch.
constexpr size_t kScratchBytes = 1024 + 32 * sizeof(float);
constexpr size_t kSmemBf16 = 2 * tc::kTileBytes + kScratchBytes;
constexpr size_t kSmemF32 = 2 * tf32::operand_bytes<kN>() +
                            2 * tf32::operand_bytes<kN / 2>() + kScratchBytes;

template <typename T, typename Kernel>
int launch(Kernel kernel, size_t smem, const void* m, void* out, int batch,
           int iters, void* stream) {
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  if (batch == 0) return 0;
  kernel<<<batch, tc::kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(m), static_cast<T*>(out), iters);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Launches the kernel on `stream` for [batch, 128, 128] data (16-byte
// aligned), bf16 when `bf16` is non-zero, else float32; returns the CUDA
// error code (0 = success).
extern "C" int unrolled_dots_launch(const void* m, void* out, int batch,
                                    int iters, int bf16, void* stream) {
  return bf16 ? launch<__nv_bfloat16>(dots_bf16_kernel, kSmemBf16, m, out,
                                     batch, iters, stream)
              : launch<float>(dots_f32_kernel, kSmemF32, m, out, batch,
                              iters, stream);
}

// Dynamic shared memory of one block in bytes, bf16 when `bf16` is non-zero,
// else float32.
extern "C" long long unrolled_dots_smem_bytes(int bf16) {
  return static_cast<long long>(bf16 ? kSmemBf16 : kSmemF32);
}
