// Tensor-core products of 128 x 128 float32 matrices held in shared memory
// as three TF32 passes (CUTLASS's 3xTF32), float32 accumulators in
// registers, for sm_90a (wgmma .tf32): the float32 counterpart of
// tc_product.cuh, the routine of the float32 chain of unrolled_dots.cu.
//
// Arithmetic. Each operand value v is split into hi = tf32(v) and
// lo = tf32(v - hi), both rounded to nearest with ties away from zero
// (cvt.rna; the tensor cores would otherwise drop the low 13 bits, and lo
// with them). A product is A_hi B_hi + A_hi B_lo + A_lo B_hi, the three
// passes summed in one float32 accumulator. A TF32 product of two TF32
// values is exact in float32; what the split leaves out (A_lo B_lo and the
// rounding of lo) is ~2^-21 of |A||B| per term, where one pass would leave
// ~2^-11.
//
// Layout. TF32 wgmma has no transpose bit: A and B are both K-major. An
// operand of R rows (M rows for A, N rows for B) x 128 K values is stored as
// four K-quarters of R rows x 32 float32 values (quarter q holds K 32q ..
// 32q + 31, R x 128 bytes, on a 1024-byte boundary). Row r of a quarter is
// one 128-byte line whose eight 16-byte chunks are permuted by the 128-byte
// swizzle (chunk c stored at c ^ (r % 8)). wgmma reads it with 8-row groups
// 1024 bytes apart (SBO), K advanced by 32 bytes (8 values) per k-step
// inside a quarter and by R x 128 bytes across quarters. A row-major matrix
// is an A operand as it is; a B operand is the transpose of the right-hand
// factor (its row n is column n of the factor).
//
// Fragments and the order of operations around a product are those of
// tc_product.cuh: the float32 accumulator layout of m64nNk8 is that of
// m64nNk16.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#include "tc_product.cuh"

namespace tf32 {

constexpr int kQuarterLine = 128;  // bytes of one row of a K-quarter

// Bytes of an operand of kRows rows x 128 K values.
template <int kRows>
__host__ __device__ constexpr int operand_bytes() {
  return 4 * kRows * kQuarterLine;
}

// Byte offset of element (r, k) of an operand of kRows rows.
template <int kRows>
__device__ __forceinline__ int offset(int r, int k) {
  return (k >> 5) * (kRows * kQuarterLine) + r * kQuarterLine +
         ((((k & 31) >> 2) ^ (r & 7)) << 4) + ((k & 3) << 2);
}

// v rounded to TF32 (10 mantissa bits), to nearest with ties away from
// zero; the low 13 bits are cleared, so the result is a float32 value too.
__device__ __forceinline__ float round_rna(float v) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(r) : "f"(v));
  return __uint_as_float(r & 0xFFFFE000u);
}

// The split of v: returns hi = tf32(v) and sets lo = tf32(v - hi).
__device__ __forceinline__ float split(float v, float& lo) {
  const float hi = round_rna(v);
  lo = round_rna(v - hi);
  return hi;
}

// d[kOff .. kOff + 31] (+)= A B for one k step of 8, N = 64, both K-major.
template <int kOff>
__device__ __forceinline__ void mma_n64(float (&d)[tc::kAcc], uint64_t desc_a,
                                        uint64_t desc_b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p, 1, 1;\n}\n"
      : "+f"(d[kOff + 0]), "+f"(d[kOff + 1]), "+f"(d[kOff + 2]), "+f"(d[kOff + 3]),
        "+f"(d[kOff + 4]), "+f"(d[kOff + 5]), "+f"(d[kOff + 6]), "+f"(d[kOff + 7]),
        "+f"(d[kOff + 8]), "+f"(d[kOff + 9]), "+f"(d[kOff + 10]), "+f"(d[kOff + 11]),
        "+f"(d[kOff + 12]), "+f"(d[kOff + 13]), "+f"(d[kOff + 14]), "+f"(d[kOff + 15]),
        "+f"(d[kOff + 16]), "+f"(d[kOff + 17]), "+f"(d[kOff + 18]), "+f"(d[kOff + 19]),
        "+f"(d[kOff + 20]), "+f"(d[kOff + 21]), "+f"(d[kOff + 22]), "+f"(d[kOff + 23]),
        "+f"(d[kOff + 24]), "+f"(d[kOff + 25]), "+f"(d[kOff + 26]), "+f"(d[kOff + 27]),
        "+f"(d[kOff + 28]), "+f"(d[kOff + 29]), "+f"(d[kOff + 30]), "+f"(d[kOff + 31])
      : "l"(desc_a), "l"(desc_b), "r"(scale_d));
}

// One pass over K = 128 (16 k-steps): this warpgroup's 64 rows of A (a
// 128-row operand) times B (a 64-row operand) into acc[32 kHalf ..].
template <int kHalf>
__device__ __forceinline__ void pass_n64(float (&acc)[tc::kAcc],
                                         const char* a, const char* b,
                                         bool accumulate) {
  const uint32_t a0 =
      tc::smem_addr(a) + (threadIdx.x >> 7) * 64 * kQuarterLine;
  const uint32_t b0 = tc::smem_addr(b);
#pragma unroll
  for (int s = 0; s < 16; ++s) {
    const uint64_t da = tc::descriptor(
        a0 + (s >> 2) * (128 * kQuarterLine) + (s & 3) * 32, 16, 1024);
    const uint64_t db = tc::descriptor(
        b0 + (s >> 2) * (64 * kQuarterLine) + (s & 3) * 32, 16, 1024);
    mma_n64<32 * kHalf>(acc, da, db, (accumulate || s > 0) ? 1 : 0);
  }
}

// acc[32 kHalf .. 32 kHalf + 31] = A_hi B_hi + A_hi B_lo + A_lo B_hi: columns
// 64 kHalf .. 64 kHalf + 63 of the product, B the 64-row operand of those
// columns. Waits for its wgmma group before it returns.
template <int kHalf>
__device__ __forceinline__ void product_3pass_n64(float (&acc)[tc::kAcc],
                                                  const char* a_hi,
                                                  const char* a_lo,
                                                  const char* b_hi,
                                                  const char* b_lo) {
  tc::mma_fence();
  pass_n64<kHalf>(acc, a_hi, b_hi, false);
  pass_n64<kHalf>(acc, a_hi, b_lo, true);
  pass_n64<kHalf>(acc, a_lo, b_hi, true);
  tc::mma_commit_and_wait();
}

// Loads a row-major 128 x 128 float32 matrix from device memory (16-byte
// aligned) as the hi and lo parts of an A operand, 16-byte loads and stores.
__device__ __forceinline__ void load_split(char* a_hi, char* a_lo,
                                           const float* __restrict__ g) {
  constexpr int kLoads = tc::kN * tc::kN / 4 / tc::kThreads;  // 16 a thread
  float4 in[kLoads];  // every load in flight before the first store
#pragma unroll
  for (int j = 0; j < kLoads; ++j)
    in[j] = reinterpret_cast<const float4*>(g)[threadIdx.x + j * tc::kThreads];
#pragma unroll
  for (int j = 0; j < kLoads; ++j) {
    const int idx = threadIdx.x + j * tc::kThreads;
    const int r = idx >> 5;  // 32 chunks a row
    const int k = (idx & 31) << 2;
    const float4 v = in[j];
    float4 hi, lo;
    hi.x = split(v.x, lo.x);
    hi.y = split(v.y, lo.y);
    hi.z = split(v.z, lo.z);
    hi.w = split(v.w, lo.w);
    *reinterpret_cast<float4*>(a_hi + offset<128>(r, k)) = hi;
    *reinterpret_cast<float4*>(a_lo + offset<128>(r, k)) = lo;
  }
}

// Stores f(acc[i], row, col) for the accumulators of result columns
// [64 kHalf, 64 kHalf + 64) as the hi and lo parts of a 64-row B operand:
// the transpose, row n = column 64 kHalf + n, K = the accumulator's row.
template <int kHalf, typename F>
__device__ __forceinline__ void store_split_transposed(
    const float (&acc)[tc::kAcc], char* b_hi, char* b_lo, F f) {
#pragma unroll
  for (int i = 32 * kHalf; i < 32 * kHalf + 32; ++i) {
    const int r = tc::acc_row(i);
    const int c = tc::acc_col(i);
    float lo;
    const float hi = split(f(acc[i], r, c), lo);
    const int off = offset<64>(c - 64 * kHalf, r);
    *reinterpret_cast<float*>(b_hi + off) = hi;
    *reinterpret_cast<float*>(b_lo + off) = lo;
  }
}

}  // namespace tf32
