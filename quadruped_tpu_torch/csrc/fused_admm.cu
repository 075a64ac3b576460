// Fused ADMM loop for the batched MPC friction-cone QP, one thread block per
// problem, for sm_90a.
//
// Replaces quadruped_tpu/solvers/pallas_admm.py::fused_admm (kernel
// _admm_kernel, loop _admm_loop). It computes exactly what that kernel
// computes: all `iters` ADMM iterations of the equilibrated cone QP with
// M^{-1} held on chip,
//   x_t  = M^{-T} (sigma x - q + A^T (rho z_hat - y_hat))
//   z_t  = A x_t,  x <- alpha x_t + (1 - alpha) x
//   z_r  = alpha z_t + (1 - alpha) z_hat
//   z'   = clip(z_r + y_hat / rho, lo, hi),  y' = y_hat + rho (z_r - z')
// and, when accel_restart > 0, Nesterov momentum on (z, y) restarted every
// accel_restart iterations (Fast-ADMM, the production warm solve). With
// accel_restart == 0 the momentum factor beta is 0, z_hat = z and y_hat = y,
// which is the over-relaxed scheme of the 400-iteration boot solve.
//
// Conventions carried over from the TPU kernel:
//   * transpose: the mat-vec contracts over M^{-1}'s FIRST index,
//     x_t[i] = sum_j rhs[j] * Minv[j, i] (pallas_admm.py builds m_wide so
//     that its dot does this). Thread i reads smem[j * n + i]: neighbouring
//     threads read neighbouring words, free of bank conflicts;
//   * 1/rho is taken once per row before the loop and multiplied after;
//   * z_0 = clip(A x_0, lo, hi).
// A = A0 + mu A1 is applied as the per-triple 5x3 pattern (rows fx + mu fz,
// -fx + mu fz, fy + mu fz, -fy + mu fz, fz), never as a dense matrix, and mu
// is per problem. The live sizes n = 12 G and m = 20 G are runtime
// arguments: the TPU kernel's 128/224 lane padding is not carried over.
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

namespace {

constexpr int kThreads = 128;

__device__ __forceinline__ float clip(float v, float lo, float hi) {
  return fminf(fmaxf(v, lo), hi);
}

// Row r of A v for the per-triple friction pyramid.
__device__ __forceinline__ float cone_row(const float* v, int r, float mu) {
  const int t = r / 5;
  const int k = r - 5 * t;
  const float fx = v[3 * t], fy = v[3 * t + 1], fz = v[3 * t + 2];
  switch (k) {
    case 0: return fx + mu * fz;
    case 1: return -fx + mu * fz;
    case 2: return fy + mu * fz;
    case 3: return -fy + mu * fz;
    default: return fz;
  }
}

__global__ void __launch_bounds__(kThreads) fused_admm_kernel(
    const float* __restrict__ m_inv, const float* __restrict__ q,
    const float* __restrict__ mu, const float* __restrict__ lo,
    const float* __restrict__ hi, const float* __restrict__ rho,
    const float* __restrict__ x0, const float* __restrict__ y0,
    float* __restrict__ x_out, float* __restrict__ y_out, int n, int iters,
    float sigma, float alpha, int accel_restart) {
  extern __shared__ float smem[];
  const int m = (n / 3) * 5;
  const int tid = threadIdx.x;
  const size_t b = blockIdx.x;

  float* s_minv = smem;         // [n * n]
  float* s_x = s_minv + n * n;  // [n]
  float* s_q = s_x + n;         // [n]
  float* s_rhs = s_q + n;       // [n]
  float* s_xt = s_rhs + n;      // [n]
  float* s_z = s_xt + n;        // [m]
  float* s_y = s_z + m;
  float* s_zh = s_y + m;
  float* s_yh = s_zh + m;
  float* s_lo = s_yh + m;
  float* s_hi = s_lo + m;
  float* s_rho = s_hi + m;
  float* s_rinv = s_rho + m;

  const float mub = mu[b];
  const float* g_minv = m_inv + b * n * n;
  for (int i = tid; i < n * n; i += kThreads) s_minv[i] = g_minv[i];
  for (int i = tid; i < n; i += kThreads) {
    s_x[i] = x0[b * n + i];
    s_q[i] = q[b * n + i];
  }
  for (int r = tid; r < m; r += kThreads) {
    s_lo[r] = lo[b * m + r];
    s_hi[r] = hi[b * m + r];
    const float rr = rho[b * m + r];
    s_rho[r] = rr;
    s_rinv[r] = 1.0f / rr;
    s_y[r] = y0[b * m + r];
  }
  __syncthreads();
  for (int r = tid; r < m; r += kThreads) {
    const float z = clip(cone_row(s_x, r, mub), s_lo[r], s_hi[r]);
    s_z[r] = z;
    s_zh[r] = z;
    s_yh[r] = s_y[r];
  }
  __syncthreads();

  float tk = 1.0f;
  for (int k = 0; k < iters; ++k) {
    // rhs = sigma x - q + A^T (rho z_hat - y_hat), per variable.
    for (int i = tid; i < n; i += kThreads) {
      const int t = i / 3;
      const int c = i - 3 * t;
      const int r0 = 5 * t;
      float w[5];
#pragma unroll
      for (int j = 0; j < 5; ++j)
        w[j] = s_rho[r0 + j] * s_zh[r0 + j] - s_yh[r0 + j];
      const float atw = c == 0 ? w[0] - w[1]
                      : c == 1 ? w[2] - w[3]
                               : mub * (w[0] + w[1] + w[2] + w[3]) + w[4];
      s_rhs[i] = sigma * s_x[i] - s_q[i] + atw;
    }
    __syncthreads();

    // x_t[i] = sum_j rhs[j] Minv[j, i]; relaxation of x.
    for (int i = tid; i < n; i += kThreads) {
      float a0 = 0.f, a1 = 0.f, a2 = 0.f, a3 = 0.f;
      int j = 0;
      for (; j + 3 < n; j += 4) {
        a0 = fmaf(s_rhs[j], s_minv[j * n + i], a0);
        a1 = fmaf(s_rhs[j + 1], s_minv[(j + 1) * n + i], a1);
        a2 = fmaf(s_rhs[j + 2], s_minv[(j + 2) * n + i], a2);
        a3 = fmaf(s_rhs[j + 3], s_minv[(j + 3) * n + i], a3);
      }
      for (; j < n; ++j) a0 = fmaf(s_rhs[j], s_minv[j * n + i], a0);
      const float xt = (a0 + a1) + (a2 + a3);
      s_xt[i] = xt;
      s_x[i] = alpha * xt + (1.0f - alpha) * s_x[i];
    }
    __syncthreads();

    // Momentum schedule (uniform across the block).
    float beta = 0.0f;
    float tk_next = 1.0f;
    if (accel_restart > 0) {
      const bool restart = (k % accel_restart) == (accel_restart - 1);
      tk_next = restart ? 1.0f : 0.5f * (1.0f + sqrtf(1.0f + 4.0f * tk * tk));
      beta = restart ? 0.0f : (tk - 1.0f) / tk_next;
    }
    // z, y updates and extrapolation, per constraint row.
    for (int r = tid; r < m; r += kThreads) {
      const float zt = cone_row(s_xt, r, mub);
      const float zh = s_zh[r];
      const float yh = s_yh[r];
      const float zrel = alpha * zt + (1.0f - alpha) * zh;
      const float znew = clip(zrel + yh * s_rinv[r], s_lo[r], s_hi[r]);
      const float ynew = yh + s_rho[r] * (zrel - znew);
      s_zh[r] = znew + beta * (znew - s_z[r]);
      s_yh[r] = ynew + beta * (ynew - s_y[r]);
      s_z[r] = znew;
      s_y[r] = ynew;
    }
    tk = tk_next;
    __syncthreads();
  }

  for (int i = tid; i < n; i += kThreads) x_out[b * n + i] = s_x[i];
  for (int r = tid; r < m; r += kThreads) y_out[b * m + r] = s_y[r];
}

// Dynamic shared memory of one block: M^{-1}, four n-vectors, eight
// m-vectors (solvers/fused_admm.py::smem_bytes checks it before launch).
size_t smem_bytes(int n) {
  const size_t m = static_cast<size_t>(n / 3) * 5;
  return (static_cast<size_t>(n) * n + 4 * static_cast<size_t>(n) + 8 * m) *
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
