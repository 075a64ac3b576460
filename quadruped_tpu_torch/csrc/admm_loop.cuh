// ADMM iterations of the batched MPC friction-cone QP, one problem per thread
// block, as device functions shared by fused_admm.cu (the loop given M^{-1})
// and fused_full_solve.cu (Newton-Schulz inverse, then the loop).
//
// What `iterate` computes is the loop of
// quadruped_tpu/solvers/pallas_admm.py::_admm_loop: all `iters` iterations of
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
//     that its dot does this; a Newton-Schulz inverse is symmetric only to
//     roundoff). Thread i reads minv[j * ld + i]: neighbouring threads read
//     neighbouring words, free of bank conflicts;
//   * 1/rho is taken once per row before the loop and multiplied after;
//   * z_0 = clip(A x_0, lo, hi).
// A = A0 + mu A1 is applied as the per-triple 5x3 pattern (rows fx + mu fz,
// -fx + mu fz, fy + mu fz, -fy + mu fz, fz), never as a dense matrix, and mu
// is per problem. The live sizes n = 12 G and m = 20 G are runtime
// arguments: the TPU kernel's 128/224 lane padding is not carried over.
//
// Every loop strides by blockDim.x, so a kernel may launch any number of
// threads; each function ends with __syncthreads().

#pragma once

#include <cuda_runtime.h>

namespace admm {

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

__host__ __device__ inline int rows(int n) { return (n / 3) * 5; }

// The per-problem vectors in shared memory: four n-vectors, eight m-vectors.
struct Vectors {
  float *x, *q, *rhs, *xt, *z, *y, *zh, *yh, *lo, *hi, *rho, *rinv;
};

__host__ __device__ inline size_t vector_floats(int n) {
  return 4 * static_cast<size_t>(n) + 8 * static_cast<size_t>(rows(n));
}

__device__ inline Vectors carve(float* base, int n) {
  const int m = rows(n);
  Vectors v;
  v.x = base;
  v.q = v.x + n;
  v.rhs = v.q + n;
  v.xt = v.rhs + n;
  v.z = v.xt + n;
  v.y = v.z + m;
  v.zh = v.y + m;
  v.yh = v.zh + m;
  v.lo = v.yh + m;
  v.hi = v.lo + m;
  v.rho = v.hi + m;
  v.rinv = v.rho + m;
  return v;
}

// Loads problem b's vectors and forms z_0 = clip(A x_0), z_hat, y_hat.
__device__ inline void load(const Vectors& v, int n, size_t b, float mu,
                            const float* __restrict__ q,
                            const float* __restrict__ lo,
                            const float* __restrict__ hi,
                            const float* __restrict__ rho,
                            const float* __restrict__ x0,
                            const float* __restrict__ y0) {
  const int m = rows(n);
  const int tid = threadIdx.x;
  for (int i = tid; i < n; i += blockDim.x) {
    v.x[i] = x0[b * n + i];
    v.q[i] = q[b * n + i];
  }
  for (int r = tid; r < m; r += blockDim.x) {
    v.lo[r] = lo[b * m + r];
    v.hi[r] = hi[b * m + r];
    const float rr = rho[b * m + r];
    v.rho[r] = rr;
    v.rinv[r] = 1.0f / rr;
    v.y[r] = y0[b * m + r];
  }
  __syncthreads();
  for (int r = tid; r < m; r += blockDim.x) {
    const float z = clip(cone_row(v.x, r, mu), v.lo[r], v.hi[r]);
    v.z[r] = z;
    v.zh[r] = z;
    v.yh[r] = v.y[r];
  }
  __syncthreads();
}

// `iters` iterations with M^{-1} at minv (row stride ld >= n) in shared
// memory.
__device__ inline void iterate(const float* minv, int ld, const Vectors& v,
                               int n, float mu, int iters, float sigma,
                               float alpha, int accel_restart) {
  const int m = rows(n);
  const int tid = threadIdx.x;
  float tk = 1.0f;
  for (int k = 0; k < iters; ++k) {
    // rhs = sigma x - q + A^T (rho z_hat - y_hat), per variable.
    for (int i = tid; i < n; i += blockDim.x) {
      const int t = i / 3;
      const int c = i - 3 * t;
      const int r0 = 5 * t;
      float w[5];
#pragma unroll
      for (int j = 0; j < 5; ++j)
        w[j] = v.rho[r0 + j] * v.zh[r0 + j] - v.yh[r0 + j];
      const float atw = c == 0 ? w[0] - w[1]
                      : c == 1 ? w[2] - w[3]
                               : mu * (w[0] + w[1] + w[2] + w[3]) + w[4];
      v.rhs[i] = sigma * v.x[i] - v.q[i] + atw;
    }
    __syncthreads();

    // x_t[i] = sum_j rhs[j] Minv[j, i] in four FMA chains; relaxation of x.
    for (int i = tid; i < n; i += blockDim.x) {
      float a0 = 0.f, a1 = 0.f, a2 = 0.f, a3 = 0.f;
      int j = 0;
      for (; j + 3 < n; j += 4) {
        a0 = fmaf(v.rhs[j], minv[j * ld + i], a0);
        a1 = fmaf(v.rhs[j + 1], minv[(j + 1) * ld + i], a1);
        a2 = fmaf(v.rhs[j + 2], minv[(j + 2) * ld + i], a2);
        a3 = fmaf(v.rhs[j + 3], minv[(j + 3) * ld + i], a3);
      }
      for (; j < n; ++j) a0 = fmaf(v.rhs[j], minv[j * ld + i], a0);
      const float xt = (a0 + a1) + (a2 + a3);
      v.xt[i] = xt;
      v.x[i] = alpha * xt + (1.0f - alpha) * v.x[i];
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
    for (int r = tid; r < m; r += blockDim.x) {
      const float zt = cone_row(v.xt, r, mu);
      const float zh = v.zh[r];
      const float yh = v.yh[r];
      const float zrel = alpha * zt + (1.0f - alpha) * zh;
      const float znew = clip(zrel + yh * v.rinv[r], v.lo[r], v.hi[r]);
      const float ynew = yh + v.rho[r] * (zrel - znew);
      v.zh[r] = znew + beta * (znew - v.z[r]);
      v.yh[r] = ynew + beta * (ynew - v.y[r]);
      v.z[r] = znew;
      v.y[r] = ynew;
    }
    tk = tk_next;
    __syncthreads();
  }
}

__device__ inline void store(const Vectors& v, int n, size_t b,
                             float* __restrict__ x_out,
                             float* __restrict__ y_out) {
  const int m = rows(n);
  for (int i = threadIdx.x; i < n; i += blockDim.x) x_out[b * n + i] = v.x[i];
  for (int r = threadIdx.x; r < m; r += blockDim.x)
    y_out[b * m + r] = v.y[r];
  __syncthreads();
}

}  // namespace admm
