// K3: weight-only int8 GEMM, out = (x @ w_q) * scales, for Hopper (sm_90a).
//
// Replaces the TPU kernel src/repro/kernels/int8_matmul.py:int8_matmul
// (body _kernel): x (M, D) f32/bf16, w_q (D, N) int8, scales (N,) f32 per
// output channel, out (M, N) in x's dtype, accumulated in float32.
//
// What bounds it on the H100: at decode M is the batch (4), so the kernel
// reads D*N weight bytes for 2*M*D*N operations -- far below the card's
// ~295 operations per byte, so it is bound by the bytes of the weights.  At
// prefill M = B*S (2048) and the same call is bound by operations.
//
// Design: one block of 256 threads computes a BM x 128 tile of out, looping
// over D in 32-deep steps; each step copies a 32 x 128 int8 weight tile to
// shared memory with one 16-byte load per thread, converts it to float32 in
// registers (every int8 value is exact there), and accumulates with float32
// FMAs, so float32 inputs are computed in true float32 (no TF32).  The
// per-channel scale is
// applied once, in the epilogue.  BM is 128 (8 rows per thread) for large M
// and 16 (1 row per thread) for skinny M, so decode does not pay for 128
// rows.  When the (M, N) tiles are too few to fill the 132 SMs (decode), the
// wrapper splits D across blocks: each split writes float32 partial sums and
// a second kernel adds the splits in a fixed order and applies the scales,
// so the result does not depend on scheduling.
//
// Left for later work: tensor cores (wgmma on bf16 after an in-register
// int8 -> bf16 convert), TMA loads and a multi-stage pipeline.
#include "common.cuh"

namespace {

constexpr int BN = 128;
constexpr int BK = 32;
constexpr int THREADS = 256;

template <typename T, int TM>
__global__ void __launch_bounds__(THREADS)
int8_gemm_kernel(const T* __restrict__ x, const int8_t* __restrict__ w,
                 const float* __restrict__ scales, T* __restrict__ out,
                 float* __restrict__ partial, int M, int N, int D,
                 long long sxm, int k_per_split) {
  constexpr int BM = 16 * TM;
  __shared__ __align__(16) float Xs[BK][BM];
  __shared__ __align__(16) int8_t Wq[BK][BN];

  const int tid = threadIdx.x;
  const int tx = tid % 16;  // column group: columns tx*4..+4 and 64+tx*4..+4
  const int ty = tid / 16;  // row group: rows ty*TM..+TM
  const int m0 = blockIdx.y * BM;
  const int n0 = blockIdx.x * BN;
  const int k_begin = blockIdx.z * k_per_split;
  const int k_end = min(D, k_begin + k_per_split);
  const bool vec_w = (N % 16) == 0;

  float acc[TM][8];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;

  for (int k0 = k_begin; k0 < k_end; k0 += BK) {
    // weight tile: 32 rows x 128 int8, one 16-byte load and store per
    // thread; it stays int8 in shared memory and is converted in registers
    {
      const int r = tid / 8;
      const int c = (tid % 8) * 16;
      const int gk = k0 + r;
      const int gn = n0 + c;
      if (vec_w && gk < k_end && gn + 16 <= N) {
        *reinterpret_cast<int4*>(&Wq[r][c]) =
            *reinterpret_cast<const int4*>(w + (long long)gk * N + gn);
      } else {
#pragma unroll
        for (int i = 0; i < 16; ++i)
          Wq[r][c + i] = (gk < k_end && gn + i < N) ? w[(long long)gk * N + gn + i] : 0;
      }
    }
    // activation tile, stored transposed: Xs[k][m]; consecutive threads take
    // consecutive rows so the shared-memory stores do not conflict
#pragma unroll
    for (int i = 0; i < (BM * BK) / THREADS; ++i) {
      const int idx = tid + i * THREADS;
      const int m = idx % BM;
      const int kk = idx / BM;
      const int gm = m0 + m;
      const int gk = k0 + kk;
      Xs[kk][m] = (gm < M && gk < k_end) ? to_f32(x[(long long)gm * sxm + gk]) : 0.f;
    }
    __syncthreads();

#pragma unroll 8
    for (int kk = 0; kk < BK; ++kk) {
      float a[TM];
      if constexpr (TM % 4 == 0) {
#pragma unroll
        for (int i = 0; i < TM; i += 4) {
          float4 v = *reinterpret_cast<const float4*>(&Xs[kk][ty * TM + i]);
          a[i] = v.x; a[i + 1] = v.y; a[i + 2] = v.z; a[i + 3] = v.w;
        }
      } else {
#pragma unroll
        for (int i = 0; i < TM; ++i) a[i] = Xs[kk][ty * TM + i];
      }
      const char4 q0 = *reinterpret_cast<const char4*>(&Wq[kk][tx * 4]);
      const char4 q1 = *reinterpret_cast<const char4*>(&Wq[kk][64 + tx * 4]);
      const float b[8] = {(float)q0.x, (float)q0.y, (float)q0.z, (float)q0.w,
                          (float)q1.x, (float)q1.y, (float)q1.z, (float)q1.w};
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int gm = m0 + ty * TM + i;
    if (gm >= M) continue;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int gn = n0 + (j < 4 ? tx * 4 + j : 64 + tx * 4 + (j - 4));
      if (gn >= N) continue;
      if (partial != nullptr) {
        partial[((long long)blockIdx.z * M + gm) * N + gn] = acc[i][j];
      } else {
        out[(long long)gm * N + gn] = from_f32<T>(acc[i][j] * scales[gn]);
      }
    }
  }
}

// Sum the D-splits in a fixed order, apply the per-channel scale, cast.
template <typename T>
__global__ void int8_gemm_reduce(const float* __restrict__ partial,
                                 const float* __restrict__ scales,
                                 T* __restrict__ out, int M, int N, int splits) {
  const long long idx = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  const long long total = (long long)M * N;
  if (idx >= total) return;
  float s = 0.f;
  for (int z = 0; z < splits; ++z) s += partial[z * total + idx];
  out[idx] = from_f32<T>(s * scales[idx % N]);
}

template <typename T, int TM>
void launch(const void* x, const void* w, const void* scales, void* out,
            void* partial, int M, int N, int D, long long sxm, int splits,
            int k_per_split, cudaStream_t stream) {
  constexpr int BM = 16 * TM;
  dim3 grid((N + BN - 1) / BN, (M + BM - 1) / BM, splits);
  int8_gemm_kernel<T, TM><<<grid, THREADS, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const int8_t*>(w),
      static_cast<const float*>(scales), static_cast<T*>(out),
      splits > 1 ? static_cast<float*>(partial) : nullptr, M, N, D, sxm,
      k_per_split);
  if (splits > 1) {
    const long long total = (long long)M * N;
    const int threads = 256;
    int8_gemm_reduce<T><<<(unsigned)((total + threads - 1) / threads), threads, 0, stream>>>(
        static_cast<const float*>(partial), static_cast<const float*>(scales),
        static_cast<T*>(out), M, N, splits);
  }
}

}  // namespace

// x: (M, D) with row stride sxm and unit column stride; w: (D, N) int8
// contiguous; scales: (N,) f32; out: (M, N) contiguous; partial: (splits, M,
// N) f32 scratch, used when splits > 1.  rows_per_thread is 1 or 8.
extern "C" int int8_matmul_fwd(const void* x, const void* w, const void* scales,
                               void* out, void* partial, int dtype, int M,
                               int N, int D, long long sxm, int splits,
                               int k_per_split, int rows_per_thread,
                               void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == REPRO_F32) {
    if (rows_per_thread == 8)
      launch<float, 8>(x, w, scales, out, partial, M, N, D, sxm, splits, k_per_split, s);
    else
      launch<float, 1>(x, w, scales, out, partial, M, N, D, sxm, splits, k_per_split, s);
  } else {
    if (rows_per_thread == 8)
      launch<__nv_bfloat16, 8>(x, w, scales, out, partial, M, N, D, sxm, splits, k_per_split, s);
    else
      launch<__nv_bfloat16, 1>(x, w, scales, out, partial, M, N, D, sxm, splits, k_per_split, s);
  }
  return static_cast<int>(cudaGetLastError());
}
