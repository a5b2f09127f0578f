// Building blocks of the mma.sync attention kernels (K1's forward and
// backward mma paths): 64-row bf16 tiles in shared memory, rows padded by 16
// bytes so ldmatrix does not conflict, copied by 4 warps with cp.async; exp2
// on the special-function unit; two floats packed as a bf16 pair, which is
// how an m16n8k16 accumulator becomes the A operand of the next product.
//
// Fragments (mma.sync.m16n8k16, g = lane / 4, c = lane % 4): the f32
// accumulator of a 16x8 tile holds (row g, cols 2c, 2c+1) in d[0..1] and
// (row g+8, the same cols) in d[2..3]; the A operand of a 16x16 k-step is
// four such pairs, (g, 2c) (g+8, 2c) (g, 8+2c) (g+8, 8+2c).  So two adjacent
// accumulator tiles, packed pairwise, are one A fragment: a product's result
// feeds the next product without a trip through shared memory.
#pragma once

#include "common.cuh"
#include "hopper.cuh"

namespace {

constexpr int MMA_ROWS = 64;      // rows of a tile
constexpr int MMA_THREADS = 128;  // 4 warps, 16 rows of a tile each

template <int DH>
__host__ __device__ constexpr int mma_stride() { return DH + 8; }  // bf16 per padded row: +16 bytes

// 2^x (ex2.approx: 2 ulp, +0 at -inf)
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 b = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&b);
}

// 4 bytes global -> shared, asynchronously; zero-filled when !valid
__device__ __forceinline__ void cp_async4(void* smem, const void* gmem, bool valid) {
  const unsigned dst = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;" ::"r"(dst), "l"(gmem),
               "r"(valid ? 4 : 0)
               : "memory");
}

// rows [s0, s0 + 64) of one head, dh wide, into a padded tile; rows >= limit
// are zero-filled by the copy itself
template <int DH>
__device__ __forceinline__ void load_tile(__nv_bfloat16* dst, const __nv_bfloat16* base,
                                          long long stride_s, int s0, int limit, int tid) {
  constexpr int CHUNKS = DH / 8;  // 16-byte chunks per row
#pragma unroll
  for (int it = 0; it < MMA_ROWS * CHUNKS / MMA_THREADS; ++it) {
    const int i = tid + it * MMA_THREADS;
    const int r = i / CHUNKS, c = i % CHUNKS;
    const bool ok = s0 + r < limit;
    const __nv_bfloat16* src = ok ? base + (long long)(s0 + r) * stride_s + c * 8 : base;
    cp_async16(dst + r * mma_stride<DH>() + c * 8, src, ok);
  }
}

}  // namespace
