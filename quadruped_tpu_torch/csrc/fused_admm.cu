// Fused ADMM loop for the batched MPC friction-cone QP, one thread block per
// problem, for sm_90a.
//
// Replaces quadruped_tpu/solvers/pallas_admm.py::fused_admm (kernel
// _admm_kernel, loop _admm_loop). It computes exactly what that kernel
// computes: all `iters` ADMM iterations of the equilibrated cone QP with
// M^{-1} held on chip. The iteration itself, its conventions (first-index
// contraction, 1/rho once, the per-triple cone pattern, live sizes) and both
// schemes (relaxed, Fast-ADMM) are the device functions of admm_loop.cuh,
// which fused_full_solve.cu runs too.
//
// What bounds it on this card: each iteration reads the n x n f32 M^{-1}
// from shared memory once (4 n^2 bytes, 57.6 KB at n = 120) and does 2 n^2
// FLOP; the rest is O(n + m). The working set (M^{-1} plus twelve vectors,
// 65.4 KB at n = 120) allows three blocks per SM, so at small batch the
// loop is latency-bound on the serial iteration chain, not bandwidth-bound.
// The design keeps every operand in shared memory for the whole solve, so
// device memory is touched once per problem (M^{-1} in, x and y out) instead
// of once per iteration as in the unfused loop, and splits each mat-vec row
// into four independent FMA chains to shorten the dependent chain.

#include <cuda_runtime.h>

#include "admm_loop.cuh"

namespace {

constexpr int kThreads = 128;

__global__ void __launch_bounds__(kThreads) fused_admm_kernel(
    const float* __restrict__ m_inv, const float* __restrict__ q,
    const float* __restrict__ mu, const float* __restrict__ lo,
    const float* __restrict__ hi, const float* __restrict__ rho,
    const float* __restrict__ x0, const float* __restrict__ y0,
    float* __restrict__ x_out, float* __restrict__ y_out, int n, int iters,
    float sigma, float alpha, int accel_restart) {
  extern __shared__ float smem[];
  const size_t b = blockIdx.x;
  float* s_minv = smem;  // [n * n]
  const admm::Vectors v = admm::carve(s_minv + n * n, n);

  const float mub = mu[b];
  const float* g_minv = m_inv + b * n * n;
  for (int i = threadIdx.x; i < n * n; i += kThreads) s_minv[i] = g_minv[i];
  admm::load(v, n, b, mub, q, lo, hi, rho, x0, y0);
  admm::iterate(s_minv, n, v, n, mub, iters, sigma, alpha, accel_restart);
  admm::store(v, n, b, x_out, y_out);
}

// Dynamic shared memory of one block: M^{-1}, four n-vectors, eight
// m-vectors (solvers/fused_admm.py::smem_bytes checks it before launch).
size_t smem_bytes(int n) {
  return (static_cast<size_t>(n) * n + admm::vector_floats(n)) *
         sizeof(float);
}

}  // namespace

// Launches the kernel on `stream`; returns the CUDA error code (0 = success).
extern "C" int fused_admm_launch(const void* m_inv, const void* q,
                                 const void* mu, const void* lo,
                                 const void* hi, const void* rho,
                                 const void* x0, const void* y0, void* x_out,
                                 void* y_out, int batch, int n, int iters,
                                 float sigma, float alpha, int accel_restart,
                                 void* stream) {
  const size_t smem = smem_bytes(n);
  cudaError_t err = cudaFuncSetAttribute(
      fused_admm_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  if (batch == 0) return 0;
  fused_admm_kernel<<<batch, kThreads, smem,
                      static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(m_inv), static_cast<const float*>(q),
      static_cast<const float*>(mu), static_cast<const float*>(lo),
      static_cast<const float*>(hi), static_cast<const float*>(rho),
      static_cast<const float*>(x0), static_cast<const float*>(y0),
      static_cast<float*>(x_out), static_cast<float*>(y_out), n, iters, sigma,
      alpha, accel_restart);
  return static_cast<int>(cudaGetLastError());
}
