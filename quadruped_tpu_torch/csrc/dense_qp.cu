// The whole of solvers/qp.py::admm_solve for a batch of small dense QPs, one
// warp per problem, for sm_90a.
//
//   min 1/2 x^T P x + q^T x   s.t.  l <= A x <= u,   n <= 20, m <= 32
//
// It replaces no TPU kernel: the JAX package's admm_solve is a lax.scan of
// plain operations that reaches no pallas_call. As plain torch it launched
// ~2,090 kernels a call on the WBC's QP (n = 18, m = 30, 50 iterations): ten
// Ruiz passes, the block-Schur inverse with its guard and two Newton steps,
// then three batched mat-vecs and a clip an iteration, each op a kernel
// over the batch that reads and writes device memory. Here each problem
// stays on chip from its load to its result.
//
// What it computes, in the plain version's order, all float32:
//  1. Ruiz equilibration (RUIZ_ITERS passes with the cost normalisation
//     gamma) when `scale`; bounds beyond +-1e7 kept as they are;
//  2. the per-row rho: default_rho of the (scaled) bounds, or the [m]
//     vector given; 1/rho once;
//  3. M = (P + sigma I) + A^T diag(rho) A;
//  4. M^{-1} by core/linalg.py::inv_spd(M, refine=2): Jacobi prescale, the
//     block-Schur recursion (split as linalg._split) down to the closed-form
//     1x1, 2x2 and 3x3, the residual guard (X0 = I / ||Ms||_inf where
//     max row sum |I - Ms X0| is not below 0.9, NaN included), two Newton
//     steps X <- X (2I - Ms X), unscaled; for n <= 3 the closed form alone;
//  5. the warm start (x0 / d, y0 c / e when scaled) or zeros;
//  6. `iters` relaxed ADMM iterations (alpha, the clip, rho_inv);
//  7. unscaling, z = clip(A x, l, u) on the caller's data when scaled, and
//     the residuals max |A x - clip(A x, l, u)|, max |P^T x + q + A^T y|.
//
// What bounds it on this card. Per WBC problem (n = 18, m = 30, 50
// iterations) ~2.8e5 float32 operations (the loop ~1.6e5, the inverse with
// guard and Newton ~7e4, Ruiz ~3e4, M ~2e4) against ~4.1 KB in and out: at
// B = 131072, 0.55 ms at 67 TFLOP/s against 0.16 ms at 3.35 TB/s, so the
// operations bound it. Every step of a problem depends on the one before,
// so the design keeps each chain short and the data in registers:
//  * A warp owns a problem; there is no atomic and no block-wide barrier, so
//    a problem's result is the same bits from run to run.
//  * Lane c holds column c of A (and of P during Ruiz) and row c of M^{-1};
//    lane r holds row r of A. An ADMM iteration is three mat-vecs: each
//    lane writes one float of the vector it owns to shared memory, and the
//    warp reads the vector back as float4 broadcasts, so a mat-vec costs
//    n/4 or m/4 shared loads and n or m FMAs a lane (four partial sums),
//    with three __syncwarp an iteration.
//  * Ruiz's column maxima are a lane's own registers; its row maxima are the
//    row copy's; dd and ee pass through shared memory; gamma's mean and max
//    are shuffle reductions, the same value in every lane.
//  * M, the Jacobi-scaled Ms and the Newton products are row-owned: lane i
//    computes row i of a product from its own row and the other matrix's
//    rows, both in shared memory, the latter read as float4 broadcasts. The Schur recursion runs in place on
//    one n x n matrix in shared memory (W kept transposed in the lower-left
//    block until the update needs it), its element products spread over the
//    lanes; the recursion's order of blocks is a plan the host computes
//    once per n and passes by value.
//  * Shared memory a warp: three kN x kN matrices (the inverse in place,
//    Ms, the Newton factor), A as kM x kN, four 32-float vectors (7.9 KB
//    at kN = 20, kM = 32); four warps a block. The products of the inverse
//    loop over k at run time, so the code stays small.
//  * One size, kN = 20 and kM = 32: the callers' problems are 18 x 30 (the
//    WBC), 12 x 20 (the force balance's polish) and 6 x 12 (the pose
//    planner); a wider problem is refused.
// ptxas (CUDA 12.8): 128 registers a thread, no spills; an SM holds four
// blocks (16 warps). On an H100 at
// B = 131072, n = 18, m = 30: 4.1 ms against the 0.55 ms bound (13%), and
// 105 ms for the plain version (PERF.md).
//
// Operands are float32 with contiguous trailing axes; each carries its own
// batch stride in floats (0 for a matrix shared by the batch, as the WBC's
// diagonal cost). Outputs x [B, n], z, y [B, m], prim, dual [B] are
// contiguous.

#include <cuda_runtime.h>

namespace {

constexpr int kLanes = 32;
constexpr int kWarpsPerBlock = 4;
constexpr int kRuizIters = 10;       // qp.RUIZ_ITERS
constexpr float kBigBound = 1e7f;    // qp.BIG_BOUND
constexpr float kEqRho = 100.0f;     // qp.default_rho: rho * EQ_RHO_SCALE
constexpr float kIneqRho = 0.1f;
constexpr unsigned kFull = 0xffffffffu;
constexpr int kN = 20;               // padded variables, n <= kN
constexpr int kM = 32;               // padded rows, a lane each
constexpr int kMaxOps = 32;          // ops of the Schur plan, 22 at n = 20

// One step of the block-Schur recursion: a closed-form leaf at (lo, n1), or
// the elimination before (kDown) and the update after (kUp) the inverse of
// the Schur complement of the node (lo, n1 + n2).
enum : unsigned char { kLeaf = 0, kDown = 1, kUp = 2 };

struct SchurPlan {
  int count;
  unsigned char op[kMaxOps][4];  // kind, lo, n1, n2
};

struct Args {
  const float* p;
  const float* q;
  const float* a;
  const float* l;
  const float* u;
  const float* rho;
  const float* x0;
  const float* y0;
  long long sp, sq, sa, sl, su, srho, sx0, sy0;
  float* x;
  float* z;
  float* y;
  float* prim;
  float* dual;
  int batch, n, m, iters, scale;
  float sigma, alpha;
};

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    v = fmaxf(v, __shfl_xor_sync(kFull, v, o));
  return v;
}

// Butterfly sum: float addition commutes, so every lane ends with the same
// bits.
__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(kFull, v, o);
  return v;
}

// qp.ruiz_equilibrate's safe_inv_sqrt: zero rows and columns keep scale 1.
__device__ __forceinline__ float safe_inv_sqrt(float v) {
  return v > 1e-12f ? 1.0f / sqrtf(fminf(fmaxf(v, 1e-12f), 1e12f)) : 1.0f;
}

__device__ __forceinline__ float4 ld4(const float* s) {
  return *reinterpret_cast<const float4*>(s);
}

__device__ __forceinline__ void st4(float* s, float a, float b, float c,
                                    float d) {
  *reinterpret_cast<float4*>(s) = make_float4(a, b, c, d);
}

// sum_k r[k] v[k] over the first `lim` entries (rounded up to 4; the
// padding of r and v is zero), v a shared vector read as float4
// broadcasts, four partial sums.
template <int K>
__device__ __forceinline__ float dot(const float (&r)[K], const float* v,
                                     int lim) {
  float a0 = 0.f, a1 = 0.f, a2 = 0.f, a3 = 0.f;
#pragma unroll
  for (int k = 0; k < K; k += 4) {
    if (k < lim) {
      const float4 t = ld4(v + k);
      a0 = fmaf(r[k], t.x, a0);
      a1 = fmaf(r[k + 1], t.y, a1);
      a2 = fmaf(r[k + 2], t.z, a2);
      a3 = fmaf(r[k + 3], t.w, a3);
    }
  }
  return (a0 + a1) + (a2 + a3);
}

// out = row times the K x K shared matrix `mat` (rows of stride K), row a
// shared row of K: out[j] = sum_{k < n} row[k] mat[k][j], in order of k.
// The loop over k is not unrolled (the inverse runs it once a problem; an
// unrolled product is most of the kernel's code).
template <int K>
__device__ __forceinline__ void row_times(float (&out)[K], const float* row,
                                          const float* mat, int n) {
#pragma unroll
  for (int j = 0; j < K; ++j) out[j] = 0.f;
#pragma unroll 1
  for (int k = 0; k < n; ++k) {
    const float rk = row[k];
#pragma unroll
    for (int j = 0; j < K; j += 4) {
      if (j < n) {
        const float4 t = ld4(mat + k * K + j);
        out[j] = fmaf(rk, t.x, out[j]);
        out[j + 1] = fmaf(rk, t.y, out[j + 1]);
        out[j + 2] = fmaf(rk, t.z, out[j + 2]);
        out[j + 3] = fmaf(rk, t.w, out[j + 3]);
      }
    }
  }
}

template <int K>
__device__ __forceinline__ void load_row(float (&r)[K], const float* s) {
#pragma unroll
  for (int j = 0; j < K; j += 4) {
    const float4 t = ld4(s + j);
    r[j] = t.x;
    r[j + 1] = t.y;
    r[j + 2] = t.z;
    r[j + 3] = t.w;
  }
}

// Row `r` from shared memory where `on`, else zeros.
template <int K>
__device__ __forceinline__ void load_row_if(float (&r)[K], const float* s,
                                            bool on) {
  if (on) {
    load_row(r, s);
  } else {
#pragma unroll
    for (int j = 0; j < K; ++j) r[j] = 0.f;
  }
}

template <int K>
__device__ __forceinline__ void store_row(float* s, const float (&r)[K]) {
#pragma unroll
  for (int j = 0; j < K; j += 4) st4(s + j, r[j], r[j + 1], r[j + 2], r[j + 3]);
}

// The closed-form inverse of the sz x sz block at (lo, lo) of x (stride
// ld), in place: 1 / m, the 2x2 adjugate, or se3.inv3x3 (entry (r, c) is
// the cofactor of (c, r) over the determinant a co_a + b co_d + c co_g).
__device__ void leaf_inverse(float* x, int ld, int lo, int sz, int lane) {
  float* m = x + lo * ld + lo;
  float out = 0.f;
  const int r = sz == 3 ? lane / 3 : lane / 2;
  const int c = sz == 3 ? lane % 3 : lane % 2;
  if (sz == 1) {
    if (lane == 0) out = 1.0f / m[0];
  } else if (sz == 2) {
    if (lane < 4) {
      const float a = m[0], b = m[1], cc = m[ld], d = m[ld + 1];
      const float det = a * d - b * cc;
      const float v = lane == 0 ? d : lane == 1 ? -b : lane == 2 ? -cc : a;
      out = v / det;
    }
  } else if (lane < 9) {
    const float a = m[0], b = m[1], cc = m[2];
    const float d = m[ld], e = m[ld + 1], f = m[ld + 2];
    const float g = m[2 * ld], h = m[2 * ld + 1], i = m[2 * ld + 2];
    const float det = (a * (e * i - f * h) + b * (f * g - d * i))
                      + cc * (d * h - e * g);
    const int c1 = (c + 1) % 3, c2 = (c + 2) % 3;
    const int r1 = (r + 1) % 3, r2 = (r + 2) % 3;
    const float co = m[c1 * ld + r1] * m[c2 * ld + r2]
                     - m[c1 * ld + r2] * m[c2 * ld + r1];
    out = co / det;
  }
  __syncwarp();
  if (lane < sz * sz) m[r * ld + c] = out;
  __syncwarp();
}

// Node (lo, n1 + n2) after its leading block holds A^{-1}: W = A^{-1} B
// into the lower-left block, transposed; then S = D - B^T W in place of D.
__device__ void schur_down(float* x, int ld, int lo, int n1, int n2,
                           int lane) {
  const int mid = lo + n1;
  for (int t = lane; t < n1 * n2; t += kLanes) {
    const int i = t / n2, j = t % n2;
    float acc = 0.f;
    for (int k = 0; k < n1; ++k)
      acc = fmaf(x[(lo + i) * ld + lo + k], x[(lo + k) * ld + mid + j], acc);
    x[(mid + j) * ld + lo + i] = acc;
  }
  __syncwarp();
  for (int t = lane; t < n2 * n2; t += kLanes) {
    const int i = t / n2, j = t % n2;
    float acc = 0.f;
    for (int k = 0; k < n1; ++k)
      acc = fmaf(x[(lo + k) * ld + mid + i], x[(mid + j) * ld + lo + k], acc);
    x[(mid + i) * ld + mid + j] -= acc;
  }
  __syncwarp();
}

// Node (lo, n1 + n2) after its trailing block holds S^{-1}: WS = W S^{-1}
// into the upper-right block; A^{-1} + WS W^T in place; then the
// off-diagonal blocks -WS and (-WS)^T.
__device__ void schur_up(float* x, int ld, int lo, int n1, int n2,
                         int lane) {
  const int mid = lo + n1;
  for (int t = lane; t < n1 * n2; t += kLanes) {
    const int i = t / n2, j = t % n2;
    float acc = 0.f;
    for (int k = 0; k < n2; ++k)
      acc = fmaf(x[(mid + k) * ld + lo + i], x[(mid + k) * ld + mid + j], acc);
    x[(lo + i) * ld + mid + j] = acc;
  }
  __syncwarp();
  for (int t = lane; t < n1 * n1; t += kLanes) {
    const int i = t / n1, j = t % n1;
    float acc = 0.f;
    for (int k = 0; k < n2; ++k)
      acc = fmaf(x[(lo + i) * ld + mid + k], x[(mid + k) * ld + lo + j], acc);
    x[(lo + i) * ld + lo + j] += acc;
  }
  __syncwarp();
  for (int t = lane; t < n1 * n2; t += kLanes) {
    const int i = t / n2, j = t % n2;
    const float v = -x[(lo + i) * ld + mid + j];
    x[(lo + i) * ld + mid + j] = v;
    x[(mid + j) * ld + lo + i] = v;
  }
  __syncwarp();
}

// Copies the rows x cols row-major block at `src` (row stride cols) into
// the shared matrix `dst` (row stride ld), the warp's lanes on consecutive
// floats.
__device__ __forceinline__ void stage(float* dst, int ld, const float* src,
                                      int rows, int cols, int lane) {
  for (int t = lane; t < rows * cols; t += kLanes)
    dst[(t / cols) * ld + t % cols] = src[t];
}

constexpr int kWarpFloats = 3 * kN * kN + kM * kN + 4 * kLanes;

__global__ void __launch_bounds__(kLanes* kWarpsPerBlock)
    dense_qp_kernel(const Args args, const SchurPlan plan) {
  extern __shared__ float4 smem4[];
  const int warp = threadIdx.x / kLanes;
  const int lane = threadIdx.x % kLanes;
  const long long b =
      static_cast<long long>(blockIdx.x) * kWarpsPerBlock + warp;
  if (b >= args.batch) return;  // whole warps only
  float* const xs = reinterpret_cast<float*>(smem4) + warp * kWarpFloats;
  float* const zs = xs + kN * kN;   // second kN x kN matrix
  float* const ys = zs + kN * kN;   // Ms (Jacobi-scaled M), kN x kN
  float* const as = ys + kN * kN;   // A, kM x kN
  float* const v0 = as + kM * kN;   // four vectors of 32
  float* const v1 = v0 + kLanes;
  float* const v2 = v1 + kLanes;
  float* const v3 = v2 + kLanes;
  const int n = args.n, m = args.m;
  const bool col = lane < n, row = lane < m;
  const float sigma = args.sigma, alpha = args.alpha;
  const float oma = 1.0f - alpha;

  const float* const pg = args.p + b * args.sp;
  const float* const ag = args.a + b * args.sa;
  const float lg = row ? args.l[b * args.sl + lane] : 0.f;
  const float ug = row ? args.u[b * args.su + lane] : 0.f;
  const float qg = col ? args.q[b * args.sq + lane] : 0.f;
  float qv = qg;

  // P into zs and A into as, zero padded.
  for (int t = lane * 4; t < kN * kN; t += 4 * kLanes) st4(zs + t, 0, 0, 0, 0);
  for (int t = lane * 4; t < kM * kN; t += 4 * kLanes) st4(as + t, 0, 0, 0, 0);
  __syncwarp();
  stage(zs, kN, pg, n, n, lane);
  stage(as, kN, ag, m, n, lane);
  __syncwarp();

  float pc[kN];  // column `lane` of P
  float ac[kM];  // column `lane` of A
  float ar[kN];  // row `lane` of A
#pragma unroll
  for (int i = 0; i < kN; ++i) pc[i] = lane < kN ? zs[i * kN + lane] : 0.f;
#pragma unroll
  for (int k = 0; k < kM; ++k) ac[k] = lane < kN ? as[k * kN + lane] : 0.f;
  load_row_if(ar, as + lane * kN, lane < kM);

  // 1. Ruiz equilibration.
  float d = 1.f, e = 1.f, cs = 1.f;
  float lv = lg, uv = ug;
  if (args.scale) {
#pragma unroll 1
    for (int it = 0; it < kRuizIters; ++it) {
      float cmax = 0.f, rmax = 0.f;
#pragma unroll
      for (int i = 0; i < kN; ++i) cmax = fmaxf(cmax, fabsf(pc[i]));
#pragma unroll
      for (int k = 0; k < kM; ++k) cmax = fmaxf(cmax, fabsf(ac[k]));
#pragma unroll
      for (int c = 0; c < kN; ++c) rmax = fmaxf(rmax, fabsf(ar[c]));
      const float dd = safe_inv_sqrt(cmax);
      const float ee = safe_inv_sqrt(rmax);
      v0[lane] = dd;
      v1[lane] = ee;
      __syncwarp();
#pragma unroll
      for (int i = 0; i < kN; i += 4) {
        const float4 t = ld4(v0 + i);
        pc[i] = (t.x * pc[i]) * dd;
        pc[i + 1] = (t.y * pc[i + 1]) * dd;
        pc[i + 2] = (t.z * pc[i + 2]) * dd;
        pc[i + 3] = (t.w * pc[i + 3]) * dd;
        ar[i] = (ee * ar[i]) * t.x;
        ar[i + 1] = (ee * ar[i + 1]) * t.y;
        ar[i + 2] = (ee * ar[i + 2]) * t.z;
        ar[i + 3] = (ee * ar[i + 3]) * t.w;
      }
#pragma unroll
      for (int k = 0; k < kM; k += 4) {
        const float4 t = ld4(v1 + k);
        ac[k] = (t.x * ac[k]) * dd;
        ac[k + 1] = (t.y * ac[k + 1]) * dd;
        ac[k + 2] = (t.z * ac[k + 2]) * dd;
        ac[k + 3] = (t.w * ac[k + 3]) * dd;
      }
      qv = qv * dd;
      d = d * dd;
      e = e * ee;
      // Cost normalisation: the mean column max of P' and the max of q'.
      float pmax = 0.f;
#pragma unroll
      for (int i = 0; i < kN; ++i) pmax = fmaxf(pmax, fabsf(pc[i]));
      const float mean = warp_sum(col ? pmax : 0.f) * (1.0f / n);
      const float qmax = warp_max(col ? fabsf(qv) : 0.f);
      const float gamma = 1.0f / fminf(fmaxf(fmaxf(mean, qmax), 1e-8f), 1e8f);
#pragma unroll
      for (int i = 0; i < kN; ++i) pc[i] = pc[i] * gamma;
      qv = qv * gamma;
      cs = cs * gamma;
      __syncwarp();
    }
    lv = lg <= -kBigBound ? lg : e * lg;
    uv = ug >= kBigBound ? ug : e * ug;
  }

  // 5 (operands). The warm start in the scaled variables.
  float x = 0.f, y = 0.f;
  if (args.x0 != nullptr && col) {
    x = args.x0[b * args.sx0 + lane];
    if (args.scale) x = x / d;
  }
  if (args.y0 != nullptr && row) {
    y = args.y0[b * args.sy0 + lane];
    if (args.scale) y = y * cs / e;
  }

  // 2. rho a row; padded rows keep rho = 1/rho = 0 and l = u = 0, so their
  // z and y stay 0.
  float rho = 0.f, rinv = 0.f;
  if (row) {
    rho = args.rho == nullptr ? ((uv - lv) < 1e-9f ? kEqRho : kIneqRho)
                              : args.rho[b * args.srho + lane];
    rinv = 1.0f / rho;
  } else {
    lv = 0.f;
    uv = 0.f;
  }

  // 3. M = (P + sigma I) + A^T diag(rho) A, row `lane`: the scaled A back
  // into `as` by rows, the scaled P into zs by columns (so lane i reads
  // row i of P), rho into v0.
  __syncwarp();
  if (lane < kM) store_row(as + lane * kN, ar);
#pragma unroll
  for (int i = 0; i < kN; ++i)
    if (lane < kN) zs[i * kN + lane] = pc[i];
  v0[lane] = rho;
  __syncwarp();
  float mrow[kN];
  {
    float prow[kN];
    load_row_if(prow, zs + lane * kN, lane < kN);
    float acc[kN];
#pragma unroll
    for (int j = 0; j < kN; ++j) acc[j] = 0.f;
#pragma unroll 1
    for (int k = 0; k < m; ++k) {
      const float aki = lane < kN ? as[k * kN + lane] : 0.f;
      const float rk = v0[k];
#pragma unroll
      for (int j = 0; j < kN; j += 4) {
        if (j < n) {
          const float4 t = ld4(as + k * kN + j);
          acc[j] = fmaf(aki, rk * t.x, acc[j]);
          acc[j + 1] = fmaf(aki, rk * t.y, acc[j + 1]);
          acc[j + 2] = fmaf(aki, rk * t.z, acc[j + 2]);
          acc[j + 3] = fmaf(aki, rk * t.w, acc[j + 3]);
        }
      }
    }
#pragma unroll
    for (int j = 0; j < kN; ++j)
      mrow[j] = col ? (prow[j] + (j == lane ? sigma : 0.f)) + acc[j] : 0.f;
  }
  __syncwarp();

  // 4. M^{-1}, row `lane` into mi.
  float mi[kN];
  if (n <= 3) {
    if (lane < kN) store_row(xs + lane * kN, mrow);
    __syncwarp();
    leaf_inverse(xs, kN, 0, n, lane);
    load_row_if(mi, xs + lane * kN, lane < kN);
  } else {
    float diag = 0.f;
#pragma unroll
    for (int j = 0; j < kN; ++j)
      if (j == lane) diag = mrow[j];
    const float s = col ? 1.0f / sqrtf(fabsf(diag) + 1e-30f) : 0.f;
    v1[lane] = s;
    __syncwarp();
    float ms[kN];  // row `lane` of Ms = diag(s) M diag(s)
#pragma unroll
    for (int j = 0; j < kN; j += 4) {
      const float4 t = ld4(v1 + j);
      ms[j] = (s * mrow[j]) * t.x;
      ms[j + 1] = (s * mrow[j + 1]) * t.y;
      ms[j + 2] = (s * mrow[j + 2]) * t.z;
      ms[j + 3] = (s * mrow[j + 3]) * t.w;
    }
    if (lane < kN) {
      store_row(xs + lane * kN, ms);
      store_row(ys + lane * kN, ms);
    }
    __syncwarp();
    for (int t = 0; t < plan.count; ++t) {
      const int kind = plan.op[t][0], lo = plan.op[t][1];
      const int n1 = plan.op[t][2], n2 = plan.op[t][3];
      if (kind == kLeaf)
        leaf_inverse(xs, kN, lo, n1, lane);
      else if (kind == kDown)
        schur_down(xs, kN, lo, n1, n2, lane);
      else
        schur_up(xs, kN, lo, n1, n2, lane);
    }
    // The residual guard.
    float prod[kN];
    row_times(prod, ys + lane * kN, xs, n);
    float resid = 0.f, norm = 0.f;
#pragma unroll
    for (int j = 0; j < kN; ++j) {
      if (j < n) {
        resid += fabsf((j == lane ? 1.f : 0.f) - prod[j]);
        norm += fabsf(ms[j]);
      }
    }
    const bool keep = __all_sync(kFull, !col || resid < 0.9f);
    const float norminf = warp_max(col ? norm : 0.f);
    if (!keep) {
      __syncwarp();
      if (lane < kN) {
#pragma unroll
        for (int j = 0; j < kN; ++j)
          prod[j] = (j == lane && col ? 1.f : 0.f) / norminf;
        store_row(xs + lane * kN, prod);
      }
      __syncwarp();
    }
    // Two Newton steps: X <- X (2I - Ms X).
#pragma unroll 1
    for (int r = 0; r < 2; ++r) {
      row_times(prod, ys + lane * kN, xs, n);
#pragma unroll
      for (int j = 0; j < kN; ++j)
        prod[j] = (j == lane && col ? 2.f : 0.f) - prod[j];
      if (lane < kN) store_row(zs + lane * kN, prod);
      __syncwarp();
      row_times(prod, xs + lane * kN, zs, n);
      __syncwarp();
      if (lane < kN) store_row(xs + lane * kN, prod);
      __syncwarp();
    }
    load_row_if(mi, xs + lane * kN, lane < kN);
#pragma unroll
    for (int j = 0; j < kN; j += 4) {
      const float4 t = ld4(v1 + j);
      mi[j] = (s * mi[j]) * t.x;
      mi[j + 1] = (s * mi[j + 1]) * t.y;
      mi[j + 2] = (s * mi[j + 2]) * t.z;
      mi[j + 3] = (s * mi[j + 3]) * t.w;
    }
  }

  // 6. ADMM. The scaled A again from `as` (written before M).
#pragma unroll
  for (int k = 0; k < kM; ++k) ac[k] = lane < kN ? as[k * kN + lane] : 0.f;
  load_row_if(ar, as + lane * kN, lane < kM);
  __syncwarp();
  v2[lane] = x;
  __syncwarp();
  float z = row ? fminf(fmaxf(dot(ar, v2, n), lv), uv) : 0.f;
  for (int it = 0; it < args.iters; ++it) {
    v0[lane] = rho * z - y;
    __syncwarp();
    const float rhs = (sigma * x - qv) + dot(ac, v0, m);
    v1[lane] = rhs;
    __syncwarp();
    const float xt = dot(mi, v1, n);
    v2[lane] = xt;
    __syncwarp();
    const float zt = dot(ar, v2, n);
    x = alpha * xt + oma * x;
    const float zr = alpha * zt + oma * z;
    const float zn = fminf(fmaxf(zr + rinv * y, lv), uv);
    y = y + rho * (zr - zn);
    z = zn;
  }

  // 7. Unscale; residuals on the caller's data.
  if (args.scale) {
    x = x * d;
    y = y * e / cs;
  }
  __syncwarp();
  for (int t = lane * 4; t < kN * kN; t += 4 * kLanes) st4(zs + t, 0, 0, 0, 0);
  for (int t = lane * 4; t < kM * kN; t += 4 * kLanes) st4(as + t, 0, 0, 0, 0);
  __syncwarp();
  stage(zs, kN, pg, n, n, lane);
  stage(as, kN, ag, m, n, lane);
  v2[lane] = x;
  v3[lane] = y;
  __syncwarp();
  load_row_if(ar, as + lane * kN, lane < kM);
  const float ax = dot(ar, v2, n);
  const float axc = fminf(fmaxf(ax, lg), ug);
  if (args.scale) z = row ? axc : 0.f;
#pragma unroll
  for (int i = 0; i < kN; ++i) pc[i] = lane < kN ? zs[i * kN + lane] : 0.f;
#pragma unroll
  for (int k = 0; k < kM; ++k) ac[k] = lane < kN ? as[k * kN + lane] : 0.f;
  const float dual_v = (dot(pc, v2, n) + qg) + dot(ac, v3, m);
  const float prim = warp_max(row ? fabsf(ax - axc) : 0.f);
  const float dual = warp_max(col ? fabsf(dual_v) : 0.f);
  if (col) args.x[b * n + lane] = x;
  if (row) {
    args.z[b * m + lane] = z;
    args.y[b * m + lane] = y;
  }
  if (lane == 0) {
    args.prim[b] = prim;
    args.dual[b] = dual;
  }
}

}  // namespace

namespace {

// linalg._split: the leading block of the Schur recursion, a multiple of 3
// where n is, so the leaves are the closed-form 3x3.
int split(int n) {
  if (n % 3 == 0) return 3 * ((n / 3) / 2 > 1 ? (n / 3) / 2 : 1);
  return n / 2;
}

void add_ops(SchurPlan& plan, int lo, int n) {
  auto push = [&](int kind, int n1, int n2) {
    unsigned char* op = plan.op[plan.count++];
    op[0] = static_cast<unsigned char>(kind);
    op[1] = static_cast<unsigned char>(lo);
    op[2] = static_cast<unsigned char>(n1);
    op[3] = static_cast<unsigned char>(n2);
  };
  if (n <= 3) {
    push(kLeaf, n, 0);
    return;
  }
  const int n1 = split(n);
  add_ops(plan, lo, n1);
  push(kDown, n1, n - n1);
  add_ops(plan, lo + n1, n - n1);
  push(kUp, n1, n - n1);
}

int launch(const Args& args, cudaStream_t stream) {
  SchurPlan plan{};
  if (args.n > 3) add_ops(plan, 0, args.n);
  const size_t smem = kWarpsPerBlock * kWarpFloats * sizeof(float);
  const unsigned blocks = static_cast<unsigned>(
      (static_cast<long long>(args.batch) + kWarpsPerBlock - 1)
      / kWarpsPerBlock);
  dense_qp_kernel<<<blocks, kLanes * kWarpsPerBlock, smem, stream>>>(args,
                                                                   plan);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Launches the kernel on `stream`; returns the CUDA error code (0 =
// success). 1 <= n <= 20, 1 <= m <= 32. `strides` holds the 8 batch
// strides, in floats, of p, q, a, l, u, rho, x0, y0. rho null: default_rho
// of the (scaled) bounds; x0 and y0 null: zeros.
extern "C" int dense_qp_launch(const void* p, const void* q, const void* a,
                               const void* l, const void* u, const void* rho,
                               const void* x0, const void* y0,
                               const long long* strides, void* x, void* z,
                               void* y, void* prim, void* dual, int batch,
                               int n, int m, int iters, int scale,
                               float sigma, float alpha, void* stream) {
  if (n < 1 || n > kN || m < 1 || m > kM || iters < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  if (batch == 0) return 0;
  Args args;
  args.p = static_cast<const float*>(p);
  args.q = static_cast<const float*>(q);
  args.a = static_cast<const float*>(a);
  args.l = static_cast<const float*>(l);
  args.u = static_cast<const float*>(u);
  args.rho = static_cast<const float*>(rho);
  args.x0 = static_cast<const float*>(x0);
  args.y0 = static_cast<const float*>(y0);
  args.sp = strides[0];
  args.sq = strides[1];
  args.sa = strides[2];
  args.sl = strides[3];
  args.su = strides[4];
  args.srho = strides[5];
  args.sx0 = strides[6];
  args.sy0 = strides[7];
  args.x = static_cast<float*>(x);
  args.z = static_cast<float*>(z);
  args.y = static_cast<float*>(y);
  args.prim = static_cast<float*>(prim);
  args.dual = static_cast<float*>(dual);
  args.batch = batch;
  args.n = n;
  args.m = m;
  args.iters = iters;
  args.scale = scale;
  args.sigma = sigma;
  args.alpha = alpha;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  return launch(args, st);
}
