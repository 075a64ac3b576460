// The cold Newton-Schulz inverse of the MPC's cone QP for sm_90a: all of
// solvers/cone_qp.py::newton_schulz_inverse in one launch (two where the
// batch ends in a lone matrix, below), one thread block per problem, no
// intermediate of any step in device memory.
//
// Replaces no Pallas kernel: the JAX package's `newton_schulz_inverse` is
// plain XLA (jnp.matmul under jit), and the port ran it as ~85 torch
// launches a call, every cast and product a round trip through device
// memory. It computes what those torch ops compute, bit for bit on the
// card, given X_0 (the wrapper takes ||M||_inf and X_0 = bf16(I) /
// bf16(||M||_inf) with the same torch ops, whose reduction order the kernel
// would not reproduce):
//   ns_bf16 steps T = bf16(2I - M_b X_b), X_b = bf16(X_b T) (M_b = bf16(M));
//   ns_f32 polish steps X <- X (2I - M X) with M unrounded;
//   every product a float32 matmul as cuBLAS computes it with TF32 off:
//   for a batch each entry a chain of fused multiply-adds over k in order,
//   from zero; for a lone matrix (a batch of one, or the last chunk of one
//   where cuBLAS splits a batch of B = 1 mod 65535 into chunks of 65535)
//   split-K, chains over the k-slices of cone_qp.LONE_SPLIT[n] summed in
//   order, which the kernel's kSplit instantiation follows in a launch of
//   its own. The bf16 steps' products are exact in float32, so the order
//   of sums is the only rounding besides the bf16 casts; keeping it keeps
//   every cast where the plain path has it.
//   (Tensor cores sum a k16 block of products in their own order and
//   rounding: one cast in a few thousand then lands on the other side, the
//   closed loop's forces move by ~1e-2 m g, and the benchmark's checks,
//   which hold the program to the plain path's inverse within 1e-3 m g,
//   fail; PERF.md §6.) That order is cuBLAS's choice, not its contract:
//   the bits hold for the cuBLAS the tests ran with (tests/
//   test_torch_ns_inverse.py checks them), and another cuBLAS may choose
//   another order.
// The products run on the CUDA cores; each thread holds an 8 x 8 (128
// tile) or 4 x 8 (64 tile) block of the product, and rows and columns of
// the tile beyond n are computed and never stored.
//
// What bounds it on this card (n = 120, 10 bf16 steps, one polish step):
// 22 float32 products of 2 n^3 operations, 76 MFLOP a problem, 0.62 PFLOP
// at B = 8192, 9.3 ms at 67 TFLOP/s; the bytes (M read twice, X written
// once) take 0.28 ms. The design:
//   * M_b (then M), X and T live in shared memory as float32 n x ld
//     buffers (178,560 bytes at n = 120 with ld = 124, 43,200 at n = 60:
//     one problem an SM at the A1's n, five at the Aliengo's);
//   * every thread reads its A rows as float2 along k and its B row
//     segments as float4, rows interleaved across the warp so that a
//     warp's A reads fall in distinct banks for the row stride ld
//     (solvers/cone_qp.py::ns_layout picks it), and the bf16 casts and
//     2I - P are applied as a product's block is stored;
//   * the tile adapts to n, which the launch reads from the input: 256
//     threads for 64 < n <= 128, 128 threads for n <= 64.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

template <int kTile>
struct Shape;

// 128 tile: 8 warps as 4 x 2 warp tiles of 32 rows x 64 columns, a thread
// 8 rows x 2 float4 column groups; one block an SM at n = 120.
template <>
struct Shape<128> {
  static constexpr int kThreads = 256;
  static constexpr int kMinBlocks = 1;
  static constexpr int kRows = 8;       // rows a thread
  static constexpr int kVecs = 2;       // float4 column groups a thread
  static constexpr int kRowGroups = 4;  // lanes along a warp tile's rows
  static constexpr int kKPairs = 2;     // k pairs a product loop iteration
};

// 64 tile: 4 warps as 2 x 2 warp tiles of 32 x 32, a thread 4 rows x 2
// float4 column groups; five blocks an SM at n = 60.
template <>
struct Shape<64> {
  static constexpr int kThreads = 128;
  static constexpr int kMinBlocks = 4;
  static constexpr int kRows = 4;
  static constexpr int kVecs = 2;
  static constexpr int kRowGroups = 8;
  static constexpr int kKPairs = 2;
};

// Shared memory of a block: M, X and T, n x ld float32 each
// (cone_qp.ns_layout).
__host__ __device__ int smem_bytes(int n, int ld) { return 3 * n * ld * 4; }

__device__ __forceinline__ float bf16_round(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

struct Same {
  __device__ float operator()(float v, int, int) const { return v; }
};
struct Bf16 {
  __device__ float operator()(float v, int, int) const {
    return bf16_round(v);
  }
};
struct TwoIMinus {
  __device__ float operator()(float v, int r, int c) const {
    return (r == c ? 2.0f : 0.0f) - v;
  }
};
struct TwoIMinusBf16 {
  __device__ float operator()(float v, int r, int c) const {
    return bf16_round((r == c ? 2.0f : 0.0f) - v);
  }
};

// M (row stride n in device memory; n a multiple of 4) into a shared
// buffer of row stride ld, each entry through `f`.
template <int kThreads, typename F>
__device__ __forceinline__ void load_m(float* dst, const float* __restrict__ g,
                                       int n, int ld, F f) {
  const int quads = n * n / 4;
  for (int q = threadIdx.x; q < quads; q += kThreads) {
    const int e = 4 * q;
    const int r = e / n;
    const int c = e - r * n;
    const float4 v = __ldg(reinterpret_cast<const float4*>(g + e));
    *reinterpret_cast<float4*>(dst + r * ld + c) =
        make_float4(f(v.x, r, c), f(v.y, r, c + 1), f(v.z, r, c + 2),
                    f(v.w, r, c + 3));
  }
}

// This thread's block of a product: rows row(i) = 32 wr + rg + kRowGroups i,
// columns col(v) + 0..3 with col(v) = W wc + 4 cg + 4 (32 / kRowGroups) v
// (W: a warp tile's width).
template <int kTile>
struct Lane {
  using S = Shape<kTile>;
  static constexpr int kColGroups = 32 / S::kRowGroups;
  static constexpr int kWarpWidth = 4 * kColGroups * S::kVecs;
  static constexpr int kWarpCols = kTile / kWarpWidth;
  static_assert(S::kRowGroups * S::kRows == 32, "a warp tile is 32 rows");
  static_assert(kTile / 32 * kWarpCols * 32 == S::kThreads,
                "one warp a warp tile");
  int row0, col0;
  __device__ Lane() {
    const int warp = threadIdx.x >> 5;
    const int lane = threadIdx.x & 31;
    row0 = 32 * (warp / kWarpCols) + lane % S::kRowGroups;
    col0 = kWarpWidth * (warp % kWarpCols) + 4 * (lane / S::kRowGroups);
  }
  __device__ int row(int i) const { return row0 + S::kRowGroups * i; }
  __device__ int col(int v) const { return col0 + 4 * kColGroups * v; }
};

template <int kTile>
using Block = float[Shape<kTile>::kRows][4 * Shape<kTile>::kVecs];

// acc = A B over k = k_begin .. k_end-1, A and B n x n in shared memory
// (row stride ld): every entry a chain of fused multiply-adds in order of
// k, from zero (k_begin and k_end multiples of 4). Rows and columns beyond
// n read row or column 0 and are never stored.
template <int kTile>
__device__ __forceinline__ void chain(Block<kTile>& acc, const float* a,
                                      const float* b, int n, int ld,
                                      const Lane<kTile>& lane, int k_begin,
                                      int k_end) {
  using S = Shape<kTile>;
  int a_off[S::kRows];
  int b_off[S::kVecs];
#pragma unroll
  for (int i = 0; i < S::kRows; ++i)
    a_off[i] = (lane.row(i) < n ? lane.row(i) : 0) * ld;
#pragma unroll
  for (int v = 0; v < S::kVecs; ++v)
    b_off[v] = lane.col(v) < n ? lane.col(v) : 0;
#pragma unroll
  for (int i = 0; i < S::kRows; ++i)
#pragma unroll
    for (int j = 0; j < 4 * S::kVecs; ++j) acc[i][j] = 0.0f;
  // n is a multiple of 4, so of 2 kKPairs.
#pragma unroll 1
  for (int k0 = k_begin; k0 < k_end; k0 += 2 * S::kKPairs)
#pragma unroll
    for (int u = 0; u < S::kKPairs; ++u) {
      const int k = k0 + 2 * u;
      float2 av[S::kRows];
      float4 b0[S::kVecs], b1[S::kVecs];
#pragma unroll
      for (int i = 0; i < S::kRows; ++i)
        av[i] = *reinterpret_cast<const float2*>(a + a_off[i] + k);
#pragma unroll
      for (int v = 0; v < S::kVecs; ++v) {
        b0[v] = *reinterpret_cast<const float4*>(b + k * ld + b_off[v]);
        b1[v] = *reinterpret_cast<const float4*>(b + (k + 1) * ld +
                                                 b_off[v]);
      }
#pragma unroll
      for (int i = 0; i < S::kRows; ++i)
#pragma unroll
        for (int v = 0; v < S::kVecs; ++v) {
          float* d = &acc[i][4 * v];
          d[0] = fmaf(av[i].x, b0[v].x, d[0]);
          d[1] = fmaf(av[i].x, b0[v].y, d[1]);
          d[2] = fmaf(av[i].x, b0[v].z, d[2]);
          d[3] = fmaf(av[i].x, b0[v].w, d[3]);
          d[0] = fmaf(av[i].y, b1[v].x, d[0]);
          d[1] = fmaf(av[i].y, b1[v].y, d[1]);
          d[2] = fmaf(av[i].y, b1[v].z, d[2]);
          d[3] = fmaf(av[i].y, b1[v].w, d[3]);
        }
    }
}

// acc = A B: one chain over k, or (kSplit, a lone matrix's order; see
// the note above) chains over the k-slices [0, split), [split, 2 split),
// ... summed in order.
template <int kTile, bool kSplit>
__device__ __forceinline__ void product(Block<kTile>& acc, const float* a,
                                        const float* b, int n, int ld,
                                        const Lane<kTile>& lane, int split) {
  using S = Shape<kTile>;
  if constexpr (!kSplit) {
    chain<kTile>(acc, a, b, n, ld, lane, 0, n);
    return;
  }
  chain<kTile>(acc, a, b, n, ld, lane, 0, min(split, n));
  for (int k0 = split; k0 < n; k0 += split) {
    Block<kTile> part;
    chain<kTile>(part, a, b, n, ld, lane, k0, min(k0 + split, n));
#pragma unroll
    for (int i = 0; i < S::kRows; ++i)
#pragma unroll
      for (int j = 0; j < 4 * S::kVecs; ++j) acc[i][j] += part[i][j];
  }
}

// Stores f(acc) over the live block into a shared buffer (row stride ld).
template <int kTile, typename F>
__device__ __forceinline__ void store(const Block<kTile>& acc, float* dst,
                                      int n, int ld, const Lane<kTile>& lane,
                                      F f) {
  using S = Shape<kTile>;
#pragma unroll
  for (int i = 0; i < S::kRows; ++i) {
    const int r = lane.row(i);
#pragma unroll
    for (int v = 0; v < S::kVecs; ++v) {
      const int c = lane.col(v);
      if (r < n && c < n) {
        const float* s = &acc[i][4 * v];
        *reinterpret_cast<float4*>(dst + r * ld + c) =
            make_float4(f(s[0], r, c), f(s[1], r, c + 1), f(s[2], r, c + 2),
                        f(s[3], r, c + 3));
      }
    }
  }
}

template <int kTile, bool kSplit>
__global__ void __launch_bounds__(Shape<kTile>::kThreads,
                                  Shape<kTile>::kMinBlocks)
    newton_schulz_kernel(const float* __restrict__ m_all,
                         const float* __restrict__ x0_all,
                         float* __restrict__ x_all, int n, int ld,
                         int ns_bf16, int ns_f32, int split) {
  using S = Shape<kTile>;
  extern __shared__ __align__(16) float smem[];
  float* f_m = smem;           // M_b in the bf16 steps, then M
  float* f_x = f_m + n * ld;   // X
  float* f_t = f_x + n * ld;   // T
  const size_t nn = static_cast<size_t>(n) * n;
  const float* g_m = m_all + blockIdx.x * nn;
  float* g_x = x_all + blockIdx.x * nn;

  if (ns_bf16 > 0)
    load_m<S::kThreads>(f_m, g_m, n, ld, Bf16());
  else
    load_m<S::kThreads>(f_m, g_m, n, ld, Same());
  const float x0 = x0_all[blockIdx.x];
  for (int e = threadIdx.x; e < n * n; e += S::kThreads) {
    const int r = e / n;
    const int c = e - r * n;
    f_x[r * ld + c] = r == c ? x0 : 0.0f;
  }
  __syncthreads();

  const Lane<kTile> lane;
  Block<kTile> acc;
  for (int s = 0; s < ns_bf16; ++s) {
    product<kTile, kSplit>(acc, f_m, f_x, n, ld, lane, split);  // M_b X_b
    store<kTile>(acc, f_t, n, ld, lane, TwoIMinusBf16());  // T
    __syncthreads();
    product<kTile, kSplit>(acc, f_x, f_t, n, ld, lane, split);  // X_b T
    __syncthreads();
    store<kTile>(acc, f_x, n, ld, lane, Bf16());  // X_b
    __syncthreads();
  }
  if (ns_bf16 > 0 && ns_f32 > 0) {
    load_m<S::kThreads>(f_m, g_m, n, ld, Same());
    __syncthreads();
  }
  for (int s = 0; s < ns_f32; ++s) {
    product<kTile, kSplit>(acc, f_m, f_x, n, ld, lane, split);  // M X
    store<kTile>(acc, f_t, n, ld, lane, TwoIMinus());  // T
    __syncthreads();
    product<kTile, kSplit>(acc, f_x, f_t, n, ld, lane, split);  // X T
    __syncthreads();
    store<kTile>(acc, f_x, n, ld, lane, Same());
    __syncthreads();
  }
  for (int q = threadIdx.x; q < n * n / 4; q += S::kThreads) {
    const int e = 4 * q;
    const int r = e / n;
    *reinterpret_cast<float4*>(g_x + e) =
        *reinterpret_cast<const float4*>(f_x + r * ld + (e - r * n));
  }
}

template <int kTile, bool kSplit>
int configure(int smem) {
  cudaError_t err = cudaFuncSetAttribute(
      newton_schulz_kernel<kTile, kSplit>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaFuncSetAttribute(
      newton_schulz_kernel<kTile, kSplit>,
      cudaFuncAttributePreferredSharedMemoryCarveout,
      cudaSharedmemCarveoutMaxShared));
}

// The batch's problems in one launch, but for a last problem in k-slices
// (lone_split > 0), which takes a launch of its own.
template <int kTile>
int launch(const float* m, const float* x0, float* x, int batch, int n,
           int ld, int smem, int ns_bf16, int ns_f32, int lone_split,
           cudaStream_t stream) {
  if (smem < smem_bytes(n, ld)) return static_cast<int>(cudaErrorInvalidValue);
  int err = configure<kTile, false>(smem);
  if (err == 0) err = configure<kTile, true>(smem);
  if (err != 0) return err;
  const int lone = batch > 0 && lone_split > 0;
  if (batch > lone)
    newton_schulz_kernel<kTile, false><<<batch - lone, Shape<kTile>::kThreads,
                                         smem, stream>>>(
        m, x0, x, n, ld, ns_bf16, ns_f32, 0);
  if (lone) {
    const size_t last = static_cast<size_t>(batch - 1) * n * n;
    newton_schulz_kernel<kTile, true><<<1, Shape<kTile>::kThreads, smem,
                                        stream>>>(
        m + last, x0 + batch - 1, x + last, n, ld, ns_bf16, ns_f32,
        lone_split);
  }
  return static_cast<int>(cudaGetLastError());
}

bool layout_ok(int tile, int n, int ld) {
  return n > 0 && n % 12 == 0 && n <= tile && (tile == 64 || tile == 128) &&
         (tile == 128) == (n > 64) && ld >= n && ld % 4 == 0;
}

}  // namespace

// Launches the kernel on `stream`, the last problem's products in k-slices
// of lone_split (a multiple of 4) where it is above 0; returns the CUDA
// error code (0 = success). m and x: [batch, n, n] float32, 16-byte
// aligned; x0: [batch] float32, X_0's diagonal; n = 12 G <= 128; tile, ld
// and smem from solvers/cone_qp.py::ns_layout.
extern "C" int newton_schulz_launch(const void* m, const void* x0, void* x,
                                    int batch, int n, int tile, int ld,
                                    int smem, int ns_bf16, int ns_f32,
                                    int lone_split, void* stream) {
  if (!layout_ok(tile, n, ld) || ns_bf16 < 0 || ns_f32 < 0 ||
      lone_split < 0 || lone_split % 4)
    return static_cast<int>(cudaErrorInvalidValue);
  const auto* mm = static_cast<const float*>(m);
  const auto* xx0 = static_cast<const float*>(x0);
  auto* xx = static_cast<float*>(x);
  auto st = static_cast<cudaStream_t>(stream);
  return tile == 64
             ? launch<64>(mm, xx0, xx, batch, n, ld, smem, ns_bf16, ns_f32,
                          lone_split, st)
             : launch<128>(mm, xx0, xx, batch, n, ld, smem, ns_bf16, ns_f32,
                           lone_split, st);
}
