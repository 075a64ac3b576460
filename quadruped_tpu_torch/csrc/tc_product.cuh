// Tensor-core products of 128 x 128 bf16 matrices held in shared memory,
// float32 accumulators in registers, for sm_90a (wgmma): the routine of the
// Newton-Schulz stage of fused_full_solve.cu.
//
// Layout. A matrix is stored row-major as bf16 in two column halves of
// 128 rows x 64 columns (16 KB each; half h holds columns 64h..64h+63).
// Row r of a half is one 128-byte line whose eight 16-byte chunks are
// permuted by the 128-byte swizzle (chunk c stored at c ^ (r % 8)), and
// each half starts on a 1024-byte boundary. wgmma reads this one layout
// both as a K-major A operand and, with its transpose bit, as an MN-major
// B operand, so C = A B of two row-major matrices needs no transposed copy:
//   A (K-major): 8-row groups 1024 bytes apart (SBO), K advanced by 32
//     bytes per 16-wide step inside a half and by 16 KB across halves;
//   B (MN-major): 64-column blocks 16 KB apart (LBO), 8-row K groups
//     1024 bytes apart (SBO), K advanced by 16 rows = 2048 bytes per step.
//
// Fragments. A block runs two warpgroups; warpgroup g (threads 128g ..
// 128g + 127) computes rows 64g .. 64g + 63 of C. Thread 128g + 32w + l
// holds accumulator i of the m64nNk16 shape at row 64g + 16w + l/4 +
// 8 ((i >> 1) & 1) and column 8 (i / 4) + 2 (l % 4) + (i & 1).
//
// Order of operations around a product (shared-memory writes by threads
// are made visible to the tensor cores' async proxy, then every thread
// meets at a barrier; a product waits for its own wgmma group before its
// accumulators are read):
//   stores -> operands_written() -> product_*() -> ... -> __syncthreads()
//   before any operand of that product is overwritten.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace tc {

constexpr int kN = 128;                 // padded matrix size
constexpr int kHalfBytes = kN * 128;    // one 128 x 64 bf16 column half
constexpr int kTileBytes = 2 * kHalfBytes;
constexpr int kThreads = 256;           // two warpgroups
constexpr int kAcc = 64;                // accumulators of m64n128k16

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// Byte offset of element (r, c) of a row-major 128 x 128 tile.
__device__ __forceinline__ int offset(int r, int c) {
  return (c >> 6) * kHalfBytes + r * 128 +
         ((((c & 63) >> 3) ^ (r & 7)) << 4) + ((c & 7) << 1);
}

__device__ __forceinline__ uint64_t descriptor(uint32_t addr, uint32_t lbo,
                                               uint32_t sbo) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>(lbo >> 4) << 16) |
         (static_cast<uint64_t>(sbo >> 4) << 32) | (1ull << 62);  // 128B
}

// Thread stores to shared memory -> visible to wgmma, then a block barrier.
__device__ __forceinline__ void operands_written() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  __syncthreads();
}

__device__ __forceinline__ void mma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void mma_commit_and_wait() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}

// d (+)= A B for one k step, N = 128: A K-major, B MN-major.
__device__ __forceinline__ void mma_n128(float (&d)[kAcc], uint64_t desc_a,
                                         uint64_t desc_b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63"
      "}, %64, %65, p, 1, 1, 0, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(desc_a), "l"(desc_b), "r"(scale_d));
}

// d[kOff .. kOff + 31] (+)= A B for one k step, N = 64.
template <int kOff>
__device__ __forceinline__ void mma_n64(float (&d)[kAcc], uint64_t desc_a,
                                        uint64_t desc_b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p, 1, 1, 0, 1;\n}\n"
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

// This warpgroup's 64 x 128 slice of A B over K = 128; A and B are tiles
// in the layout above. `accumulate` false: acc = A B, else acc += A B.
__device__ __forceinline__ void product_n128(float (&acc)[kAcc],
                                             const char* a, const char* b,
                                             bool accumulate) {
  const uint32_t a0 = smem_addr(a) + (threadIdx.x >> 7) * 64 * 128;
  const uint32_t b0 = smem_addr(b);
  mma_fence();
#pragma unroll
  for (int s = 0; s < 8; ++s) {
    const uint64_t da =
        descriptor(a0 + (s >> 2) * kHalfBytes + (s & 3) * 32, 16, 1024);
    const uint64_t db = descriptor(b0 + s * 2048, kHalfBytes, 1024);
    mma_n128(acc, da, db, (accumulate || s > 0) ? 1 : 0);
  }
  mma_commit_and_wait();
}

// The same with B one 128 x 64 half (its own 16 KB block): columns
// 64 kHalf .. 64 kHalf + 63 of the result, in acc[32 kHalf ..].
template <int kHalf>
__device__ __forceinline__ void product_n64(float (&acc)[kAcc],
                                            const char* a, const char* b,
                                            bool accumulate) {
  const uint32_t a0 = smem_addr(a) + (threadIdx.x >> 7) * 64 * 128;
  const uint32_t b0 = smem_addr(b);
  mma_fence();
#pragma unroll
  for (int s = 0; s < 8; ++s) {
    const uint64_t da =
        descriptor(a0 + (s >> 2) * kHalfBytes + (s & 3) * 32, 16, 1024);
    const uint64_t db = descriptor(b0 + s * 2048, kHalfBytes, 1024);
    mma_n64<32 * kHalf>(acc, da, db, (accumulate || s > 0) ? 1 : 0);
  }
  mma_commit_and_wait();
}

// Row and column of this thread's accumulator i.
__device__ __forceinline__ int acc_row(int i) {
  const int t = threadIdx.x;
  return (t >> 7) * 64 + ((t >> 5) & 3) * 16 + ((t & 31) >> 2) +
         8 * ((i >> 1) & 1);
}
__device__ __forceinline__ int acc_col(int i) {
  return 8 * (i >> 2) + 2 * (threadIdx.x & 3) + (i & 1);
}

__device__ __forceinline__ float bf16_round(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

// Stores f(acc[i], row, col) as bf16 into a tile at `dst`, for the
// accumulators of columns [64 kFirst, 64 kLast) (offsets inside one half
// when `one_half`, so a half can be written as its own 128 x 64 block).
template <int kFirst, int kLast, typename F>
__device__ __forceinline__ void store(const float (&acc)[kAcc], char* dst,
                                      bool one_half, F f) {
#pragma unroll
  for (int i = 32 * kFirst; i < 32 * kLast; i += 2) {
    const int r = acc_row(i);
    const int c = acc_col(i);
    const __nv_bfloat162 v = __floats2bfloat162_rn(f(acc[i], r, c),
                                                   f(acc[i + 1], r, c + 1));
    const int off = one_half ? offset(r, c & 63) : offset(r, c);
    *reinterpret_cast<__nv_bfloat162*>(dst + off) = v;
  }
}

}  // namespace tc
