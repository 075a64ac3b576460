// Fully fused MPC cone-QP solve for sm_90a: the Newton-Schulz inverse of M
// on the tensor cores and every ADMM iteration, one thread block per
// problem, nothing of either stage in device memory between them.
//
// Replaces quadruped_tpu/solvers/pallas_admm.py::fused_full_solve (kernel
// _full_solve_kernel). It computes what that kernel computes:
//   X_0 = I (1 / ||M||_inf), the float32 reciprocal first;
//   ns_bf16 steps X <- X_b (2I - M_b X_b)_b (subscript b: rounded to bf16),
//     both products bf16 x bf16 -> float32 on the tensor cores (wgmma), the
//     TPU's bf16-in, f32-accumulate arithmetic up to summation order; the
//     result of a step is kept in float32 (accumulator registers), as the
//     Pallas kernel keeps it in its f32 scratch;
//   ns_f32 polish steps X <- X (2I - M X) with both products as the Pallas
//     kernel's _dot_f32_3pass: operands split into bf16 hi + lo, and
//     hi.hi + hi.lo + lo.hi summed in float32, three tensor-core passes;
//   then the ADMM loop of admm_loop.cuh on that X, contracting over X's
//     first index as fused_admm.cu and the Pallas loop do.
// The live n x n problem is padded to 128 with ZEROS (M and X_0 zero outside
// the live block): 2I - MX is then 2 on the pad diagonal and zero elsewhere
// in the pad, so X stays zero outside the live block through every step and
// the live block equals the unpadded iteration. ||M||_inf is taken over the
// live rows. (The Pallas wrapper pads with an identity tail, which makes its
// norm max(live, 1); equilibrated MPC matrices have norms above 1, where
// the two agree.)
//
// What bounds it on this card: the Newton-Schulz products, 2 x 2 x 128^3
// FLOP a step, 26 bf16 tensor-core products a problem at the production
// schedule (10 bf16 steps, one 3-pass polish step): 109 MFLOP, 0.9 PFLOP
// at B = 8192, 0.9 ms at the dense bf16 peak. Device memory is read for M
// (twice in the polish, for its hi and lo parts; the second read is from
// L2) and written for x and y: ~0.15 ms at B = 8192. The design:
//   * M_b, X_b and T = 2I - M_b X_b live in shared memory as bf16 in the
//     128-byte-swizzled layout of tc_product.cuh, 32 KB each; one row-major
//     layout serves wgmma as A (K-major) and as B (MN-major, transpose bit),
//     so no transposed copy is kept;
//   * two warpgroups a problem, each the 64 x 128 slice of a product in 64
//     float32 accumulator registers a thread, K = 128 in 8 wgmma k-steps;
//     the result stays in the accumulators and is rounded straight into the
//     bf16 operand of the next product;
//   * the polish reuses the three buffers: X_hi, X_lo and M's hi then lo
//     part for 2I - MX, then T's hi and lo parts one 64-column half at a
//     time in the M buffer, so X's f32 copy lives only in registers;
//   * 101.5 KB of shared memory and at most 128 registers a thread, so two
//     problems share an SM and one's epilogues overlap the other's products;
//   * the ADMM tail takes X from the accumulators through shared memory
//     into the registers of admm_loop.cuh's slice (see there).
// Measured on an H100 SXM (700 W) at B = 8192, n = 120 (chip_smoke.py
// phase 7 and PERF.md): the ten bf16 steps run at the tensor cores' dense
// rate on the padded 128^3 products; what is left above the bound is the
// 3-pass polish (its extra barriers and the reload of M), the latency-bound
// ADMM tail and the load of M.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "admm_loop.cuh"
#include "tc_product.cuh"

namespace {

constexpr int kS = 8;   // admm_loop.cuh shape for n <= 128 on 256 threads
constexpr int kR = 16;

// Writes M (row-major n x n float32 in device memory, zero-padded to 128) as
// bf16 into a tile: its hi part bf16(m), or with `lo_part` its lo part
// bf16(m - bf16(m)). Returns ||M||_inf over the live rows (every thread).
__device__ float load_m(char* tile, const float* __restrict__ g_m, int n,
                        bool lo_part, float* s_red) {
  constexpr int kWarps = tc::kThreads / 32;
  constexpr int kRows = 4;  // rows a warp has in flight
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  float row_max = 0.0f;
  for (int r0 = warp; r0 < tc::kN; r0 += kRows * kWarps) {
    float2 v[kRows][2];
#pragma unroll
    for (int i = 0; i < kRows; ++i)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int r = r0 + i * kWarps;
        const int c = 2 * lane + 64 * h;
        v[i][h] = (r < n && c < n)
                      ? *reinterpret_cast<const float2*>(g_m + r * n + c)
                      : make_float2(0.0f, 0.0f);
      }
#pragma unroll
    for (int i = 0; i < kRows; ++i) {
      const int r = r0 + i * kWarps;
      float sum = 0.0f;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int c = 2 * lane + 64 * h;
        sum += fabsf(v[i][h].x) + fabsf(v[i][h].y);
        __nv_bfloat162 part = __floats2bfloat162_rn(v[i][h].x, v[i][h].y);
        if (lo_part)
          part = __floats2bfloat162_rn(v[i][h].x - __low2float(part),
                                       v[i][h].y - __high2float(part));
        *reinterpret_cast<__nv_bfloat162*>(tile + tc::offset(r, c)) = part;
      }
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        sum += __shfl_xor_sync(0xffffffffu, sum, off);
      row_max = fmaxf(row_max, sum);
    }
  }
  if (lane == 0) s_red[warp] = row_max;
  __syncthreads();
  float norm = s_red[0];
  for (int w = 1; w < kWarps; ++w) norm = fmaxf(norm, s_red[w]);
  __syncthreads();
  return norm;
}

struct Same {
  __device__ float operator()(float v, int, int) const { return v; }
};
struct LoPart {
  __device__ float operator()(float v, int, int) const {
    return v - tc::bf16_round(v);
  }
};
struct TwoIMinus {
  __device__ float operator()(float v, int r, int c) const {
    return (r == c ? 2.0f : 0.0f) - v;
  }
};

// One 3-pass polish step X <- X (2I - M X) on acc (X in float32).
// On entry t_m holds M_hi; on exit acc holds the new X and t_m is clobbered.
__device__ __forceinline__ void polish_step(float (&acc)[tc::kAcc],
                                            char* t_m, char* t_x, char* t_t,
                                            const float* g_m, int n,
                                            float* s_red) {
  tc::store<0, 2>(acc, t_x, false, Same());    // X_hi
  tc::store<0, 2>(acc, t_t, false, LoPart());  // X_lo
  tc::operands_written();
  tc::product_n128(acc, t_m, t_x, false);      // M_hi X_hi
  tc::product_n128(acc, t_m, t_t, true);       // + M_hi X_lo
  __syncthreads();                             // M_hi read by both groups
  load_m(t_m, g_m, n, true, s_red);            // M_lo
  tc::operands_written();
  tc::product_n128(acc, t_m, t_x, true);       // + M_lo X_hi
  __syncthreads();
#pragma unroll
  for (int i = 0; i < tc::kAcc; ++i)
    acc[i] = TwoIMinus()(acc[i], tc::acc_row(i), tc::acc_col(i));
  // X_hi T_hi + X_hi T_lo + X_lo T_hi, one 64-column half of T at a time:
  // its hi and lo parts fill t_m, and the half's accumulators, free once
  // stored, take the half of the product.
  char* t_hi = t_m;
  char* t_lo = t_m + tc::kHalfBytes;
  tc::store<0, 1>(acc, t_hi, true, Same());
  tc::store<0, 1>(acc, t_lo, true, LoPart());
  tc::operands_written();
  tc::product_n64<0>(acc, t_x, t_hi, false);
  tc::product_n64<0>(acc, t_x, t_lo, true);
  tc::product_n64<0>(acc, t_t, t_hi, true);
  __syncthreads();
  tc::store<1, 2>(acc, t_hi, true, Same());
  tc::store<1, 2>(acc, t_lo, true, LoPart());
  tc::operands_written();
  tc::product_n64<1>(acc, t_x, t_hi, false);
  tc::product_n64<1>(acc, t_x, t_lo, true);
  tc::product_n64<1>(acc, t_t, t_hi, true);
  __syncthreads();
}

__global__ void __launch_bounds__(tc::kThreads, 2) fused_full_solve_kernel(
    const float* __restrict__ m_mat, const float* __restrict__ q,
    const float* __restrict__ mu, const float* __restrict__ lo,
    const float* __restrict__ hi, const float* __restrict__ rho,
    const float* __restrict__ x0, const float* __restrict__ y0,
    float* __restrict__ x_out, float* __restrict__ y_out,
    float* __restrict__ inv_out, int n, int ns_bf16, int ns_f32, int iters,
    float sigma, float alpha, int accel_restart) {
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  // Tiles start on a 1024-byte boundary (the swizzle pattern's period).
  char* tiles = reinterpret_cast<char*>(smem_raw) +
                ((1024 - (tc::smem_addr(smem_raw) & 1023)) & 1023);
  char* t_m = tiles;                        // M_b (= M_hi); polish: M_lo, T
  char* t_x = tiles + tc::kTileBytes;       // X_b; polish: X_hi
  char* t_t = tiles + 2 * tc::kTileBytes;   // T_b; polish: X_lo
  float* s_red = reinterpret_cast<float*>(tiles + 3 * tc::kTileBytes);
  const admm::Vectors v = admm::carve(s_red + 32);
  const size_t b = blockIdx.x;
  const float* g_m = m_mat + b * n * n;

  const float x_diag = 1.0f / load_m(t_m, g_m, n, false, s_red);
  float acc[tc::kAcc];
#pragma unroll
  for (int i = 0; i < tc::kAcc; ++i) {
    const int r = tc::acc_row(i);
    acc[i] = (r == tc::acc_col(i) && r < n) ? x_diag : 0.0f;
  }

  for (int s = 0; s < ns_bf16; ++s) {
    tc::store<0, 2>(acc, t_x, false, Same());       // X_b
    tc::operands_written();
    tc::product_n128(acc, t_m, t_x, false);         // M_b X_b
    tc::store<0, 2>(acc, t_t, false, TwoIMinus());  // (2I - M_b X_b)_b
    tc::operands_written();
    tc::product_n128(acc, t_x, t_t, false);         // X_b T_b
    __syncthreads();  // both groups' reads of X_b and T_b are done
  }
  for (int s = 0; s < ns_f32; ++s) {
    if (s > 0) {
      load_m(t_m, g_m, n, false, s_red);  // M_hi again (t_m held T)
    }
    polish_step(acc, t_m, t_x, t_t, g_m, n, s_red);
  }

  // X: to device memory if asked, and as float32 (row stride n) over the
  // first two tiles, from where the loop loads its register slice.
  float* s_x = reinterpret_cast<float*>(tiles);
#pragma unroll
  for (int i = 0; i < tc::kAcc; i += 2) {
    const int r = tc::acc_row(i);
    const int c = tc::acc_col(i);
    if (r < n && c < n) {
      const float2 pair = make_float2(acc[i], acc[i + 1]);
      *reinterpret_cast<float2*>(s_x + r * n + c) = pair;
      if (inv_out != nullptr)
        *reinterpret_cast<float2*>(inv_out + b * n * n + r * n + c) = pair;
    }
  }
  __syncthreads();
  admm::Slice<kS, kR> slice;
  admm::load_slice(slice, s_x, n, n);
  const float mub = mu[b];
  admm::Lane lane =
      admm::load(v, n, b, mub, q, lo, hi, rho, x0, y0, nullptr);
  admm::iterate(slice, v, lane, n, mub, iters, sigma, alpha, accel_restart);
  admm::store(lane, n, b, x_out, y_out);
}

// Dynamic shared memory of one block: three bf16 128 x 128 tiles, 1024
// bytes to align them, 32 floats of reduction scratch and the loop's
// vectors (solvers/fused_full_solve.py::SMEM_BYTES is the same).
constexpr size_t kSmemBytes =
    3 * tc::kTileBytes + 1024 + (32 + admm::kVectorFloats) * sizeof(float);

}  // namespace

// Launches the kernel on `stream`; returns the CUDA error code (0 = success).
// n = 12 G <= 128. inv_out may be null; otherwise it receives each
// problem's X ([B, n, n]).
extern "C" int fused_full_solve_launch(
    const void* m_mat, const void* q, const void* mu, const void* lo,
    const void* hi, const void* rho, const void* x0, const void* y0,
    void* x_out, void* y_out, void* inv_out, int batch, int n, int ns_bf16,
    int ns_f32, int iters, float sigma, float alpha, int accel_restart,
    void* stream) {
  if (n > tc::kN || n % 12 != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = kSmemBytes;
  cudaError_t err = cudaFuncSetAttribute(
      fused_full_solve_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  if (batch == 0) return 0;
  fused_full_solve_kernel<<<batch, tc::kThreads, smem,
                            static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(m_mat), static_cast<const float*>(q),
      static_cast<const float*>(mu), static_cast<const float*>(lo),
      static_cast<const float*>(hi), static_cast<const float*>(rho),
      static_cast<const float*>(x0), static_cast<const float*>(y0),
      static_cast<float*>(x_out), static_cast<float*>(y_out),
      static_cast<float*>(inv_out), n, ns_bf16, ns_f32, iters, sigma, alpha,
      accel_restart);
  return static_cast<int>(cudaGetLastError());
}
