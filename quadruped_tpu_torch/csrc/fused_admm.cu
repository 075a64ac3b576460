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
// What bounds it on this card: device memory is touched once per problem,
// 4 n^2 bytes of M^{-1} in (57.6 KB at n = 120; 0.15 ms for B = 8192 at
// 3.35 TB/s), then 24 (warm) or 400 (boot) iterations of ~2 n^2 FLOP each
// on data that stays on chip. The iterations form a serial chain (mat-vec,
// barrier, cone update, barrier), so at the batch sizes of the MPC the loop
// is latency-bound: its time is iterations x chain latency x problems per
// SM / problems resident per SM. The design shortens the chain: M^{-1} is
// read from device memory once into registers (admm_loop.cuh, `Slice`), so
// an iteration reads only rhs from shared memory, runs four independent
// FMA chains of R = n / 8 a thread and sums across 8 lanes by warp
// shuffles; the cone update runs on six lanes a triple with its state in
// registers; two barriers per iteration instead of three. Shared memory
// holds only rhs and x_t (2 KB), so residency is set by registers: 256
// threads (8 warps) a block for n <= 128 at ~107 registers, two blocks (16
// warps) per SM, where the previous design ran 3 blocks of 4 warps. The 64
// floats of M^{-1} a thread are what keeps a third block out. n = 192 runs
// 768 threads a block (S = 16 lanes a column), one block per SM.
//
// z0 may be null (z_0 = clip(A x_0, lo, hi), the Pallas kernel's start) or
// the [B, m] z of a loop that ran its first iterations elsewhere (the
// solver's bf16 head): the loop then continues from (x0, z0, y0). The two
// starts are separate instantiations (kZ0), so the null one compiles to
// the kernel without the pointer.

#include <cuda_runtime.h>

#include "admm_loop.cuh"

namespace {

template <int S, int R, int kMaxThreads, int kMinBlocks, bool kZ0>
__global__ void __launch_bounds__(kMaxThreads, kMinBlocks) fused_admm_kernel(
    const float* __restrict__ m_inv, const float* __restrict__ q,
    const float* __restrict__ mu, const float* __restrict__ lo,
    const float* __restrict__ hi, const float* __restrict__ rho,
    const float* __restrict__ x0, const float* __restrict__ y0,
    const float* __restrict__ z0, float* __restrict__ x_out,
    float* __restrict__ y_out, int n, int iters, float sigma, float alpha,
    int accel_restart) {
  extern __shared__ float smem[];
  const size_t b = blockIdx.x;
  const admm::Vectors v = admm::carve(smem);
  const float mub = mu[b];
  admm::Slice<S, R> slice;
  admm::load_slice<S, R, true>(slice, m_inv + b * n * n, n, n);
  admm::Lane lane =
      admm::load(v, n, b, mub, q, lo, hi, rho, x0, y0, kZ0 ? z0 : nullptr);
  admm::iterate(slice, v, lane, n, mub, iters, sigma, alpha, accel_restart);
  admm::store(lane, n, b, x_out, y_out);
}

template <int S, int R, int kMaxThreads, int kMinBlocks>
int launch(const void* m_inv, const void* q, const void* mu, const void* lo,
           const void* hi, const void* rho, const void* x0, const void* y0,
           const void* z0, void* x_out, void* y_out, int batch, int n,
           int iters, float sigma, float alpha, int accel_restart,
           cudaStream_t stream) {
  // S lanes for each group of four columns in whole warps, and six lanes
  // a force triple.
  int threads = ((S * ((n + 3) / 4) + 31) / 32) * 32;
  if (threads < admm::triple_threads(n)) threads = admm::triple_threads(n);
  if (threads > kMaxThreads) return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = admm::kVectorFloats * sizeof(float);
  if (batch == 0) return 0;
  auto kernel = z0 != nullptr
                    ? fused_admm_kernel<S, R, kMaxThreads, kMinBlocks, true>
                    : fused_admm_kernel<S, R, kMaxThreads, kMinBlocks, false>;
  kernel<<<batch, threads, smem, stream>>>(
      static_cast<const float*>(m_inv), static_cast<const float*>(q),
      static_cast<const float*>(mu), static_cast<const float*>(lo),
      static_cast<const float*>(hi), static_cast<const float*>(rho),
      static_cast<const float*>(x0), static_cast<const float*>(y0),
      static_cast<const float*>(z0), static_cast<float*>(x_out),
      static_cast<float*>(y_out), n, iters, sigma, alpha, accel_restart);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Launches the kernel on `stream`; returns the CUDA error code (0 = success).
// n must be a multiple of 3 and of 4 (n = 12 G) and at most 192; z0 may be
// null.
extern "C" int fused_admm_launch(const void* m_inv, const void* q,
                                 const void* mu, const void* lo,
                                 const void* hi, const void* rho,
                                 const void* x0, const void* y0,
                                 const void* z0, void* x_out, void* y_out,
                                 int batch, int n, int iters, float sigma,
                                 float alpha, int accel_restart,
                                 void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (n % 12 != 0) return static_cast<int>(cudaErrorInvalidValue);
  if (n <= 64)
    return launch<8, 8, 256, 2>(m_inv, q, mu, lo, hi, rho, x0, y0, z0,
                                x_out, y_out, batch, n, iters, sigma, alpha,
                                accel_restart, st);
  if (n <= 128)
    return launch<8, 16, 256, 2>(m_inv, q, mu, lo, hi, rho, x0, y0, z0,
                                 x_out, y_out, batch, n, iters, sigma, alpha,
                                 accel_restart, st);
  if (n <= 192)
    return launch<16, 12, 768, 1>(m_inv, q, mu, lo, hi, rho, x0, y0, z0,
                                  x_out, y_out, batch, n, iters, sigma,
                                  alpha, accel_restart, st);
  return static_cast<int>(cudaErrorInvalidValue);
}
