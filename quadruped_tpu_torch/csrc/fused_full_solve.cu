// Fully fused MPC cone-QP solve for sm_90a: the Newton-Schulz inverse of M
// and every ADMM iteration, one thread block per problem, nothing of either
// stage in device memory between them.
//
// Replaces quadruped_tpu/solvers/pallas_admm.py::fused_full_solve (kernel
// _full_solve_kernel). It computes what that kernel computes:
//   X_0 = I (1 / ||M||_inf), the float32 reciprocal first;
//   ns_bf16 steps X <- X (2I - M X) on bf16-rounded operands: X is rounded
//     to bf16 at the start of each step, M once, 2I - M X is rounded before
//     the second product, and both products accumulate in float32 (a product
//     of two bf16 values is exact in float32, so this is the TPU's bf16-in,
//     f32-accumulate arithmetic up to summation order). The result of a step
//     is kept in float32, as the Pallas kernel keeps it in its f32 scratch;
//   ns_f32 polish steps of the same iteration in float32 FMA (the Pallas
//     kernel's 3-pass bf16 split emulates this on the TPU's matrix unit; it is
//     not carried over);
//   then the ADMM loop of admm_loop.cuh on that X, in place in shared memory,
//   contracting over X's first index as fused_admm.cu and the Pallas loop do.
// ||M||_inf is taken over the live n x n matrix: the Pallas wrapper pads M
// with an identity tail to 128 lanes, which makes its norm max(live, 1);
// equilibrated MPC matrices have norms above 1, where the two agree.
//
// What bounds it on this card: the Newton-Schulz stage, 2 n^3 FMA per step,
// 22 n^3 in all (38 MFMA at n = 120) against 2 n^2 per ADMM iteration. M, X
// and 2I - MX take 3 n (n + 1) floats of shared memory (174 KB at n = 120),
// so one block runs per SM and the products are bound by FMA issue and
// shared-memory loads (16 loads per 64 FMA, see block_product.cuh). Device
// memory is read once for M (twice when bf16 steps precede the polish: the
// polish reloads the unrounded M) and written once for x and y.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "admm_loop.cuh"
#include "block_product.cuh"

namespace {

// Enough for n = 132 (17 x 17 tiles of the product).
constexpr int kMaxThreads = 320;

__device__ __forceinline__ float bf16_round(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

struct Identity {
  __device__ float operator()(float v) const { return v; }
};

// s_x <- X (2I - M X) with M at s_m, T = 2I - M X through s_t; with
// `rounded`, X is rounded to bf16 first and T before the second product.
__device__ __forceinline__ void newton_schulz_step(const float* s_m,
                                                   float* s_x, float* s_t,
                                                   int n, int ld,
                                                   bool rounded) {
  float acc[blockmm::kTile][blockmm::kTile];
  int i, j;
  if (rounded) {
    for (int idx = threadIdx.x; idx < n * ld; idx += blockDim.x)
      s_x[idx] = bf16_round(s_x[idx]);
    __syncthreads();
  }
  blockmm::product(s_m, s_x, n, ld, acc);
#pragma unroll
  for (int r = 0; r < blockmm::kTile; ++r)
#pragma unroll
    for (int c = 0; c < blockmm::kTile; ++c)
      if (blockmm::owned(n, r, c, &i, &j)) {
        const float t = (i == j ? 2.0f : 0.0f) - acc[r][c];
        s_t[i * ld + j] = rounded ? bf16_round(t) : t;
      }
  __syncthreads();
  blockmm::product(s_x, s_t, n, ld, acc);
  __syncthreads();  // every read of X is done before it is overwritten
#pragma unroll
  for (int r = 0; r < blockmm::kTile; ++r)
#pragma unroll
    for (int c = 0; c < blockmm::kTile; ++c)
      if (blockmm::owned(n, r, c, &i, &j)) s_x[i * ld + j] = acc[r][c];
  __syncthreads();
}

__global__ void __launch_bounds__(kMaxThreads) fused_full_solve_kernel(
    const float* __restrict__ m_mat, const float* __restrict__ q,
    const float* __restrict__ mu, const float* __restrict__ lo,
    const float* __restrict__ hi, const float* __restrict__ rho,
    const float* __restrict__ x0, const float* __restrict__ y0,
    float* __restrict__ x_out, float* __restrict__ y_out,
    float* __restrict__ inv_out, int n, int ns_bf16, int ns_f32, int iters,
    float sigma, float alpha, int accel_restart) {
  extern __shared__ float smem[];
  const int ld = blockmm::leading_dim(n);
  const size_t b = blockIdx.x;
  float* s_m = smem;           // M, bf16-rounded during the bf16 steps
  float* s_x = s_m + n * ld;   // X, then the ADMM loop's M^{-1}
  float* s_t = s_x + n * ld;   // 2I - M X
  float* s_red = s_t + n * ld;  // [32] reduction scratch
  const admm::Vectors v = admm::carve(s_red + 32, n);
  const float* g_m = m_mat + b * n * n;

  blockmm::load(s_m, g_m, n, ld, Identity());
  __syncthreads();
  float row_max = 0.0f;
  for (int i = threadIdx.x; i < n; i += blockDim.x) {
    float s = 0.0f;
    for (int j = 0; j < n; ++j) s += fabsf(s_m[i * ld + j]);
    row_max = fmaxf(row_max, s);
  }
  const float x_diag = 1.0f / blockmm::block_max(row_max, s_red);
  for (int idx = threadIdx.x; idx < n * ld; idx += blockDim.x)
    s_x[idx] = (idx / ld == idx % ld) ? x_diag : 0.0f;
  if (ns_bf16 > 0)
    for (int idx = threadIdx.x; idx < n * ld; idx += blockDim.x)
      s_m[idx] = bf16_round(s_m[idx]);
  __syncthreads();

  for (int s = 0; s < ns_bf16; ++s)
    newton_schulz_step(s_m, s_x, s_t, n, ld, true);
  if (ns_bf16 > 0 && ns_f32 > 0) {
    blockmm::load(s_m, g_m, n, ld, Identity());
    __syncthreads();
  }
  for (int s = 0; s < ns_f32; ++s)
    newton_schulz_step(s_m, s_x, s_t, n, ld, false);

  if (inv_out != nullptr)
    for (int idx = threadIdx.x; idx < n * n; idx += blockDim.x) {
      const int i = idx / n;
      inv_out[b * n * n + idx] = s_x[i * ld + (idx - i * n)];
    }

  const float mub = mu[b];
  admm::load(v, n, b, mub, q, lo, hi, rho, x0, y0);
  admm::iterate(s_x, ld, v, n, mub, iters, sigma, alpha, accel_restart);
  admm::store(v, n, b, x_out, y_out);
}

// Dynamic shared memory of one block: M, X, 2I - MX (n x (n + 1) each), the
// reduction scratch, four n-vectors and eight m-vectors
// (solvers/fused_full_solve.py::smem_bytes checks it before launch).
size_t smem_bytes(int n) {
  const size_t mats = 3 * static_cast<size_t>(n) * blockmm::leading_dim(n);
  return (mats + 32 + admm::vector_floats(n)) * sizeof(float);
}

}  // namespace

// Launches the kernel on `stream`; returns the CUDA error code (0 = success).
// inv_out may be null; otherwise it receives each problem's X ([B, n, n]).
extern "C" int fused_full_solve_launch(
    const void* m_mat, const void* q, const void* mu, const void* lo,
    const void* hi, const void* rho, const void* x0, const void* y0,
    void* x_out, void* y_out, void* inv_out, int batch, int n, int ns_bf16,
    int ns_f32, int iters, float sigma, float alpha, int accel_restart,
    void* stream) {
  const int threads = blockmm::threads_for(n);
  if (threads > kMaxThreads) return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = smem_bytes(n);
  cudaError_t err = cudaFuncSetAttribute(
      fused_full_solve_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  if (batch == 0) return 0;
  fused_full_solve_kernel<<<batch, threads, smem,
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
