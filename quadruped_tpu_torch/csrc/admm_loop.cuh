// ADMM iterations of the batched MPC friction-cone QP, one problem per thread
// block, as device functions shared by fused_admm.cu (the loop given M^{-1})
// and fused_full_solve.cu (Newton-Schulz inverse, then the loop).
//
// What `iterate` computes is the loop of
// quadruped_tpu/solvers/pallas_admm.py::_admm_loop: all `iters` iterations of
//   x_t  = W (sigma x - q + A^T (rho z_hat - y_hat)),  W[c, j] = Slice(j, c)
//   z_t  = A x_t,  x <- alpha x_t + (1 - alpha) x
//   z_r  = alpha z_t + (1 - alpha) z_hat
//   z'   = clip(z_r + y_hat / rho, lo, hi),  y' = y_hat + rho (z_r - z')
// and, when accel_restart > 0, Nesterov momentum on (z, y) restarted every
// accel_restart iterations (Fast-ADMM, the production warm solve). With
// accel_restart == 0 the momentum factor beta is 0, z_hat = z and y_hat = y,
// which is the over-relaxed scheme of the 400-iteration boot solve. Both
// schemes run this one loop.
//
// Conventions carried over from the TPU kernel:
//   * orientation: the mat-vec contracts over the slice's FIRST index,
//     x_t[i] = sum_j rhs[j] * Slice(j, i), as pallas_admm.py's dot does
//     with its m_wide. fused_full_solve.cu loads its own inverse as it is
//     (x_t = X^T rhs, the Pallas full solve's loop); fused_admm.cu loads
//     M^{-1} transposed (`load_slice<.., true>`), so that its x_t is
//     M^{-1} rhs, the JAX `solve`'s mat-vec (a Newton-Schulz inverse is
//     symmetric only to ~1e-4, and the loop amplifies the gap);
//   * 1/rho is taken once per row before the loop and multiplied after;
//   * z_0 = clip(A x_0, lo, hi), or the z_0 the caller gives (the carried
//     iterate of a loop that ran its first iterations elsewhere: the z of
//     an iterate is clip(z_r + y / rho), not clip(A x)).
// A = A0 + mu A1 is applied as the per-triple 5x3 pattern (rows fx + mu fz,
// -fx + mu fz, fy + mu fz, -fy + mu fz, fz), never as a dense matrix, and mu
// is per problem. The live sizes n = 12 G and m = 20 G are runtime
// arguments: the TPU kernel's 128/224 lane padding is not carried over.
//
// What bounds the loop on this card, and the design. The mat-vec is the
// only O(n^2) work: 2 n^2 FLOP per iteration on an n x n matrix that does
// not change. Read from shared memory in every iteration it costs 4 n^2
// bytes of shared-memory traffic per iteration (57.6 KB at n = 120) and a
// long dependent FMA chain per thread. Here M^{-1} is loaded ONCE into
// registers (`Slice`): the block's threads form column groups of S lanes;
// column group g owns the four columns 4g .. 4g + 3 (one float4 per row,
// so the load from device memory is coalesced), and lane s of it the rows
// s, s + S, ..., s + S (R - 1). An iteration then reads only the n-vector
// rhs from shared memory (R broadcast loads a lane), runs four independent
// R-deep FMA chains, and sums the S partial sums of a column with log2(S)
// warp shuffles. The shape is a template parameter, one code path for
// every size: S = 8, R = 8 or 16 with 128 or 256 threads for n <= 64 or
// n <= 128 (64 floats of M^{-1} a thread at n = 120), S = 16, R = 12 with
// up to 768 threads for n <= 192 (H = 16 unblocked), where 256 threads'
// registers cannot hold the 36,864 floats.
//
// Per-triple work runs on six lanes of one warp for each triple, five
// triples a warp (`Lane`): lane k < 5 owns cone row 5t + k and keeps its z,
// y, z_hat, y_hat, bounds and rho in registers for the whole solve, lane
// k < 3 owns variable 3t + k (x, q). After the mat-vec a lane reads the
// triple's three x_t, updates its row or variable, and the rows' terms of
// A^T (rho z_hat - y_hat) reach the variable lanes by warp shuffles, so the
// rhs of the next iteration is built right after the z/y update with no
// barrier between them: two barriers per iteration (after the mat-vec,
// after the triple phase), against three before, and shared memory holds
// only rhs and x_t.

#pragma once

#include <cuda_runtime.h>

namespace admm {

// Padded length of the rhs and x_t vectors in shared memory: >= S R and
// >= 4 x column groups of every shape below.
constexpr int kVecPad = 256;

__device__ __forceinline__ float clip(float v, float lo, float hi) {
  return fminf(fmaxf(v, lo), hi);
}

// Row k of the friction pyramid of one force triple (fx, fy, fz).
__device__ __forceinline__ float cone_row(float fx, float fy, float fz,
                                          int k, float mu) {
  switch (k) {
    case 0: return fx + mu * fz;
    case 1: return -fx + mu * fz;
    case 2: return fy + mu * fz;
    case 3: return -fy + mu * fz;
    default: return fz;
  }
}

__host__ __device__ inline int rows(int n) { return (n / 3) * 5; }

// The two vectors the threads exchange through shared memory: rhs and x_t,
// kVecPad floats each, zero beyond n.
struct Vectors {
  float* rhs;
  float* xt;
};

constexpr int kVectorFloats = 2 * kVecPad;

__device__ inline Vectors carve(float* base) {
  return Vectors{base, base + kVecPad};
}

// Threads a block needs for the per-triple work: six lanes a triple, five
// triples a warp.
__host__ __device__ inline int triple_threads(int n) {
  return 32 * ((n / 3 + 4) / 5);
}

// What one lane keeps in registers through the loop. Lane k of the six of
// triple t owns cone row 5t + k (k < 5: z, y, z_hat, y_hat and the row's
// lo, hi, rho, 1/rho) and variable 3t + k (k < 3: x, q).
struct Lane {
  int t, k;
  bool row, var;
  float z, y, zh, yh, lo, hi, rho, rinv, x, q;
};

// This thread's part of M^{-1}: m[k][u] = Minv[s + S k, 4 g + u].
template <int S, int R>
struct Slice {
  float m[R][4];
};

// Loads the slice from a row-major n x n matrix at src (row stride ld, a
// multiple of 4, 16-byte aligned; device or shared memory), or with
// kTransposed from its transpose: m[k][u] = src[4 g + u, s + S k]. That
// load takes four scalar reads a row in place of one float4; the S lanes
// of a column group still read S consecutive floats. Entries outside the
// live n x n block are zero.
template <int S, int R, bool kTransposed = false>
__device__ __forceinline__ void load_slice(Slice<S, R>& sl,
                                           const float* __restrict__ src,
                                           int ld, int n) {
  const int s = threadIdx.x & (S - 1);
  const int c0 = 4 * (threadIdx.x / S);
#pragma unroll
  for (int k = 0; k < R; ++k) {
    const int j = s + S * k;
    float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
    if (j < n && c0 < n) {
      if (kTransposed) {
        const float* col = src + static_cast<size_t>(c0) * ld + j;
        v = make_float4(col[0], col[ld], col[2 * ld], col[3 * ld]);
      } else {
        v = *reinterpret_cast<const float4*>(
            src + static_cast<size_t>(j) * ld + c0);
      }
    }
    sl.m[k][0] = v.x;
    sl.m[k][1] = v.y;
    sl.m[k][2] = v.z;
    sl.m[k][3] = v.w;
  }
}

// This lane's triple and roles.
__device__ __forceinline__ Lane lane_of(int n) {
  Lane ln;
  const int l = threadIdx.x & 31;
  const int g = l / 6;
  ln.t = 5 * (threadIdx.x >> 5) + g;
  ln.k = l - 6 * g;
  const bool live = g < 5 && ln.t < n / 3;
  ln.row = live && ln.k < 5;
  ln.var = live && ln.k < 3;
  return ln;
}

// rhs of the lane's variable: sigma x - q + A^T (rho z_hat - y_hat), with
// the five rows' w = rho z_hat - y_hat gathered from the triple's lanes by
// shuffles. Every lane of the warp takes part.
__device__ __forceinline__ void write_rhs(const Vectors& v, const Lane& ln,
                                          float mu, float sigma) {
  const float w_own = ln.rho * ln.zh - ln.yh;
  const int first = 6 * min((threadIdx.x & 31) / 6, 4);
  float w[5];
#pragma unroll
  for (int j = 0; j < 5; ++j) w[j] = __shfl_sync(0xffffffffu, w_own, first + j);
  if (ln.var) {
    const float atw = ln.k == 0 ? w[0] - w[1]
                    : ln.k == 1 ? w[2] - w[3]
                                : mu * (w[0] + w[1] + w[2] + w[3]) + w[4];
    v.rhs[3 * ln.t + ln.k] = sigma * ln.x - ln.q + atw;
  }
}

// Zeroes rhs and x_t, loads problem b's entries of this lane and forms
// z_0 (z0[r] where z0 is not null, else clip(A x_0, lo, hi)), z_hat, y_hat.
// Returns the lane's state.
__device__ inline Lane load(const Vectors& v, int n, size_t b, float mu,
                            const float* __restrict__ q,
                            const float* __restrict__ lo,
                            const float* __restrict__ hi,
                            const float* __restrict__ rho,
                            const float* __restrict__ x0,
                            const float* __restrict__ y0,
                            const float* __restrict__ z0) {
  const int m = rows(n);
  for (int i = threadIdx.x; i < kVecPad; i += blockDim.x) {
    v.rhs[i] = 0.0f;
    v.xt[i] = 0.0f;
  }
  Lane ln = lane_of(n);
  ln.z = ln.y = ln.zh = ln.yh = ln.lo = ln.hi = ln.rinv = ln.x = ln.q = 0.0f;
  ln.rho = 1.0f;
  if (ln.row) {
    const size_t r = b * m + 5 * ln.t + ln.k;
    const float* xs = x0 + b * n + 3 * ln.t;
    ln.lo = lo[r];
    ln.hi = hi[r];
    ln.rho = rho[r];
    ln.rinv = 1.0f / ln.rho;
    ln.y = y0[r];
    ln.z = z0 != nullptr
               ? z0[r]
               : clip(cone_row(xs[0], xs[1], xs[2], ln.k, mu), ln.lo, ln.hi);
    ln.zh = ln.z;
    ln.yh = ln.y;
  }
  if (ln.var) {
    ln.x = x0[b * n + 3 * ln.t + ln.k];
    ln.q = q[b * n + 3 * ln.t + ln.k];
  }
  __syncthreads();
  return ln;
}

// `iters` iterations with this thread's slice of M^{-1} and its lane state
// in registers. The block has at least max(triple_threads(n),
// S ceil(n / 4)) threads.
template <int S, int R>
__device__ inline void iterate(const Slice<S, R>& sl, const Vectors& v,
                               Lane& ln, int n, float mu, int iters,
                               float sigma, float alpha, int accel_restart) {
  const int s = threadIdx.x & (S - 1);
  const int c0 = 4 * (threadIdx.x / S);
  float tk = 1.0f;
  write_rhs(v, ln, mu, sigma);
  __syncthreads();
  for (int k = 0; k < iters; ++k) {
    // x_t[c] = sum_j rhs[j] Minv[j, c]: R rows per lane, S lanes a column.
    float a[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
    for (int kk = 0; kk < R; ++kk) {
      const float r = v.rhs[s + S * kk];
#pragma unroll
      for (int u = 0; u < 4; ++u) a[u] = fmaf(r, sl.m[kk][u], a[u]);
    }
#pragma unroll
    for (int off = 1; off < S; off <<= 1)
#pragma unroll
      for (int u = 0; u < 4; ++u)
        a[u] += __shfl_xor_sync(0xffffffffu, a[u], off);
    if (s < 4 && c0 + s < n)
      v.xt[c0 + s] = s == 0 ? a[0] : s == 1 ? a[1] : s == 2 ? a[2] : a[3];
    __syncthreads();

    // Momentum schedule (uniform across the block).
    float beta = 0.0f;
    float tk_next = 1.0f;
    if (accel_restart > 0) {
      const bool restart = (k % accel_restart) == (accel_restart - 1);
      tk_next = restart ? 1.0f : 0.5f * (1.0f + sqrtf(1.0f + 4.0f * tk * tk));
      beta = restart ? 0.0f : (tk - 1.0f) / tk_next;
    }
    tk = tk_next;
    // Triple phase, a lane per row and per variable: relaxation of x, z
    // and y updates, extrapolation, and the next iteration's rhs.
    if (ln.row) {
      const float* xt3 = v.xt + 3 * ln.t;
      const float f0 = xt3[0], f1 = xt3[1], f2 = xt3[2];
      if (ln.var) {
        const float xt = ln.k == 0 ? f0 : ln.k == 1 ? f1 : f2;
        ln.x = alpha * xt + (1.0f - alpha) * ln.x;
      }
      const float zt = cone_row(f0, f1, f2, ln.k, mu);
      const float zrel = alpha * zt + (1.0f - alpha) * ln.zh;
      const float znew = clip(zrel + ln.yh * ln.rinv, ln.lo, ln.hi);
      const float ynew = ln.yh + ln.rho * (zrel - znew);
      ln.zh = znew + beta * (znew - ln.z);
      ln.yh = ynew + beta * (ynew - ln.y);
      ln.z = znew;
      ln.y = ynew;
    }
    write_rhs(v, ln, mu, sigma);
    __syncthreads();
  }
}

__device__ inline void store(const Lane& ln, int n, size_t b,
                             float* __restrict__ x_out,
                             float* __restrict__ y_out) {
  if (ln.var) x_out[b * n + 3 * ln.t + ln.k] = ln.x;
  if (ln.row) y_out[b * rows(n) + 5 * ln.t + ln.k] = ln.y;
}

}  // namespace admm
