// K4: grouped (expert) GEMM, out[e] = x[e] @ w[e], for Hopper (sm_90a).
//
// Replaces the TPU kernel src/repro/kernels/moe_gmm.py:moe_gmm (body
// _kernel): x (E, C, D) and w (E, D, F) in f32 or bf16, accumulated in
// float32, out (E, C, F) in x's dtype.  Rows at or past group_sizes[e] (the
// tokens routed to expert e, at most the capacity C) count as zero, as the
// TPU kernel masks them before its product.
//
// What bounds it on the H100: at decode (mixtral, 4 tokens, top-2, C = 8) it
// reads each live expert's whole weight, 4096 x 14336 bf16 = 117 MB, for a
// few rows: bound by the bytes of the weights.  At prefill (C = 640) every
// weight byte serves up to 640 rows, well above the ~295 operations per byte
// where the tensor cores become the limit: bound by operations.
//
// Design: one block per (c-tile, f-tile, expert), looping over D inside the
// block.  group_sizes is read from device memory, never from the host, so a
// CUDA graph can capture the launch.  A c-tile that lies wholly at or past
// group_sizes[e] writes zeros and reads no weight bytes: at decode most of
// the 8 experts get one or two of the 8 routed rows and several get none,
// and skipping a dead expert's weight is the kernel's main saving over a
// dense batched product.  The c-tile is the fastest grid axis, so the tiles
// of one expert that share a weight slab run side by side and read it from
// L2.  x and w are read by stride (unit stride on the last axis), so the
// model's (E, C, D) view of its dispatch buffer goes in without a copy.
//   bf16: 4 warps on a BM x 128 tile (BM = 64, or 16 when C <= 32), tensor
//         cores through WMMA (mma.sync, 16x16x16 bf16 -> f32), a 3-stage
//         cp.async pipeline of 32-deep k-steps; masked rows and ragged edges
//         are zero-filled by the copy itself.
//   f32:  true float32 (FMAs, no TF32), 256 threads on a BM x 128 tile, as
//         the int8 GEMM (K3), so the f32 parity tests hold at 1e-4.
//
// Left for later work: wgmma and TMA (a warp-specialised producer), split-D
// for the decode-time down projection (256 blocks on 132 SMs), and fusing
// gate, up and silu into one launch.
#include "common.cuh"

#include <mma.h>

namespace {

using namespace nvcuda;

constexpr int BN = 128;     // output columns of one block
constexpr int BK = 32;      // depth of one k-step (bf16 path)
constexpr int STAGES = 3;   // cp.async pipeline depth (bf16 path)
constexpr int PAD = 8;      // bf16 elements of padding per shared-memory row

struct Geom {
  int C, D, F;
  long long sxe, sxc;  // x element strides of (expert, row); d is 1
  long long swe, swd;  // w element strides of (expert, d); f is 1
};

// Live rows of expert e: group_sizes[e] clamped to [0, C]; all C without sizes.
__device__ __forceinline__ int live_rows(const int* gs, int e, int C) {
  return gs == nullptr ? C : min(max(gs[e], 0), C);
}

template <typename T>
__device__ void zero_tile(T* oe, int m0, int n0, int BM, const Geom& g) {
  for (int i = threadIdx.x; i < BM * BN; i += blockDim.x) {
    const int r = m0 + i / BN, c = n0 + i % BN;
    if (r < g.C && c < g.F) oe[(long long)r * g.F + c] = from_f32<T>(0.f);
  }
}

// 16-byte asynchronous copy global -> shared; copies zeros when !valid.
__device__ __forceinline__ void cp_async16(void* smem, const void* gmem, bool valid) {
  const unsigned dst = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  const int n = valid ? 16 : 0;
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(gmem), "r"(n));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

template <int BM, int WARPS_M>
__global__ void __launch_bounds__(128)
gmm_bf16_kernel(const __nv_bfloat16* __restrict__ x, const __nv_bfloat16* __restrict__ w,
                const int* __restrict__ group_sizes, __nv_bfloat16* __restrict__ out,
                Geom g) {
  constexpr int THREADS = 128;
  constexpr int WARPS_N = 4 / WARPS_M;
  constexpr int WTM = BM / WARPS_M;  // rows of one warp's tile
  constexpr int WTN = BN / WARPS_N;  // columns of one warp's tile
  constexpr int FM = WTM / 16, FN = WTN / 16;
  constexpr int LDA = BK + PAD;
  constexpr int LDB = BN + PAD;
  constexpr int LDC = BN + 4;
  constexpr int A_STAGE = BM * LDA;
  constexpr int B_STAGE = BK * LDB;
  constexpr int PIPE_BYTES = STAGES * (A_STAGE + B_STAGE) * 2;
  constexpr int EPI_BYTES = BM * LDC * 4;
  constexpr int SMEM = PIPE_BYTES > EPI_BYTES ? PIPE_BYTES : EPI_BYTES;
  __shared__ __align__(128) unsigned char smem[SMEM];
  __nv_bfloat16* As = reinterpret_cast<__nv_bfloat16*>(smem);
  __nv_bfloat16* Bs = As + STAGES * A_STAGE;
  float* Cs = reinterpret_cast<float*>(smem);  // epilogue, after the pipeline drains

  const int e = blockIdx.z;
  const int m0 = blockIdx.x * BM;
  const int n0 = blockIdx.y * BN;
  const int live = live_rows(group_sizes, e, g.C);
  __nv_bfloat16* oe = out + (long long)e * g.C * g.F;
  if (m0 >= live) {  // no live row in this tile: zeros, no weight bytes read
    zero_tile(oe, m0, n0, BM, g);
    return;
  }
  const int tid = threadIdx.x;
  const __nv_bfloat16* xe = x + (long long)e * g.sxe;
  const __nv_bfloat16* we = w + (long long)e * g.swe;
  const int nk = (g.D + BK - 1) / BK;

  auto load_stage = [&](int stage, int kt) {
    const int k0 = kt * BK;
    __nv_bfloat16* a = As + stage * A_STAGE;
    __nv_bfloat16* b = Bs + stage * B_STAGE;
    for (int i = tid; i < BM * BK / 8; i += THREADS) {
      const int r = i / (BK / 8), c = (i % (BK / 8)) * 8;
      const bool ok = m0 + r < live && k0 + c < g.D;
      cp_async16(a + r * LDA + c, ok ? xe + (long long)(m0 + r) * g.sxc + k0 + c : xe, ok);
    }
    for (int i = tid; i < BK * BN / 8; i += THREADS) {
      const int r = i / (BN / 8), c = (i % (BN / 8)) * 8;
      const bool ok = k0 + r < g.D && n0 + c < g.F;
      cp_async16(b + r * LDB + c, ok ? we + (long long)(k0 + r) * g.swd + n0 + c : we, ok);
    }
  };

  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[FM][FN];
#pragma unroll
  for (int i = 0; i < FM; ++i)
#pragma unroll
    for (int j = 0; j < FN; ++j) wmma::fill_fragment(acc[i][j], 0.f);
  const int warp = tid / 32;
  const int wm = warp / WARPS_N, wn = warp % WARPS_N;

#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < nk) load_stage(s, s);
    cp_async_commit();
  }
  for (int kt = 0; kt < nk; ++kt) {
    cp_async_wait<STAGES - 2>();  // k-step kt has landed
    __syncthreads();              // ... for every thread; step kt-1 is consumed
    const int next = kt + STAGES - 1;
    if (next < nk) load_stage(next % STAGES, next);
    cp_async_commit();
    const __nv_bfloat16* a = As + (kt % STAGES) * A_STAGE;
    const __nv_bfloat16* b = Bs + (kt % STAGES) * B_STAGE;
#pragma unroll
    for (int kk = 0; kk < BK; kk += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, wmma::row_major> fa[FM];
      wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, wmma::row_major> fb[FN];
#pragma unroll
      for (int i = 0; i < FM; ++i)
        wmma::load_matrix_sync(fa[i], a + (wm * WTM + i * 16) * LDA + kk, LDA);
#pragma unroll
      for (int j = 0; j < FN; ++j)
        wmma::load_matrix_sync(fb[j], b + kk * LDB + wn * WTN + j * 16, LDB);
#pragma unroll
      for (int i = 0; i < FM; ++i)
#pragma unroll
        for (int j = 0; j < FN; ++j) wmma::mma_sync(acc[i][j], fa[i], fb[j], acc[i][j]);
    }
  }
  cp_async_wait<0>();
  __syncthreads();  // the pipeline buffers become the epilogue's
#pragma unroll
  for (int i = 0; i < FM; ++i)
#pragma unroll
    for (int j = 0; j < FN; ++j)
      wmma::store_matrix_sync(Cs + (wm * WTM + i * 16) * LDC + wn * WTN + j * 16, acc[i][j],
                              LDC, wmma::mem_row_major);
  __syncthreads();
  for (int i = tid; i < BM * BN; i += THREADS) {
    const int r = i / BN, c = i % BN;
    if (m0 + r < g.C && n0 + c < g.F)
      oe[(long long)(m0 + r) * g.F + n0 + c] = __float2bfloat16_rn(Cs[r * LDC + c]);
  }
}

template <int TM>
__global__ void __launch_bounds__(256)
gmm_f32_kernel(const float* __restrict__ x, const float* __restrict__ w,
               const int* __restrict__ group_sizes, float* __restrict__ out, Geom g) {
  constexpr int THREADS = 256;
  constexpr int BM = 16 * TM;
  constexpr int BKF = 16;
  __shared__ __align__(16) float Xs[BKF][BM];
  __shared__ __align__(16) float Ws[BKF][BN];

  const int e = blockIdx.z;
  const int m0 = blockIdx.x * BM;
  const int n0 = blockIdx.y * BN;
  const int live = live_rows(group_sizes, e, g.C);
  float* oe = out + (long long)e * g.C * g.F;
  if (m0 >= live) {
    zero_tile(oe, m0, n0, BM, g);
    return;
  }
  const int tid = threadIdx.x;
  const int tx = tid % 16;  // columns tx*4..+4 and 64+tx*4..+4
  const int ty = tid / 16;  // rows ty*TM..+TM
  const float* xe = x + (long long)e * g.sxe;
  const float* we = w + (long long)e * g.swe;

  float acc[TM][8];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;

  for (int k0 = 0; k0 < g.D; k0 += BKF) {
    for (int i = tid; i < BKF * BN; i += THREADS) {
      const int r = i / BN, c = i % BN;
      Ws[r][c] = (k0 + r < g.D && n0 + c < g.F) ? we[(long long)(k0 + r) * g.swd + n0 + c] : 0.f;
    }
    for (int i = tid; i < BM * BKF; i += THREADS) {
      const int m = i % BM, kk = i / BM;
      Xs[kk][m] = (m0 + m < live && k0 + kk < g.D) ? xe[(long long)(m0 + m) * g.sxc + k0 + kk]
                                                   : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < BKF; ++kk) {
      float a[TM];
#pragma unroll
      for (int i = 0; i < TM; ++i) a[i] = Xs[kk][ty * TM + i];
      const float4 b0 = *reinterpret_cast<const float4*>(&Ws[kk][tx * 4]);
      const float4 b1 = *reinterpret_cast<const float4*>(&Ws[kk][64 + tx * 4]);
      const float b[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
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
    if (gm >= g.C) continue;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int gn = n0 + (j < 4 ? tx * 4 + j : 64 + tx * 4 + (j - 4));
      if (gn < g.F) oe[(long long)gm * g.F + gn] = acc[i][j];
    }
  }
}

}  // namespace

// x: (E, C, D) with strides (sxe, sxc, 1); w: (E, D, F) with strides (swe,
// swd, 1); group_sizes: (E,) int32 on the device, or null for all C rows;
// out: (E, C, F) contiguous.  bf16 needs 16-byte aligned rows: x, w 16-byte
// aligned and sxe, sxc, swe, swd, D, F multiples of 8 (the wrapper checks).
extern "C" int moe_gmm_fwd(const void* x, const void* w, const void* group_sizes, void* out,
                           int dtype, int E, int C, int D, int F, long long sxe,
                           long long sxc, long long swe, long long swd, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const Geom g{C, D, F, sxe, sxc, swe, swd};
  const int* gs = static_cast<const int*>(group_sizes);
  const unsigned f_tiles = (F + BN - 1) / BN;
  const bool tall = C > 32;
  if (dtype == REPRO_BF16) {
    const auto* xb = static_cast<const __nv_bfloat16*>(x);
    const auto* wb = static_cast<const __nv_bfloat16*>(w);
    auto* ob = static_cast<__nv_bfloat16*>(out);
    if (tall)
      gmm_bf16_kernel<64, 2><<<dim3((C + 63) / 64, f_tiles, E), 128, 0, s>>>(xb, wb, gs, ob, g);
    else
      gmm_bf16_kernel<16, 1><<<dim3((C + 15) / 16, f_tiles, E), 128, 0, s>>>(xb, wb, gs, ob, g);
  } else {
    const auto* xf = static_cast<const float*>(x);
    const auto* wf = static_cast<const float*>(w);
    auto* of = static_cast<float*>(out);
    if (tall)
      gmm_f32_kernel<4><<<dim3((C + 63) / 64, f_tiles, E), 256, 0, s>>>(xf, wf, gs, of, g);
    else
      gmm_f32_kernel<1><<<dim3((C + 15) / 16, f_tiles, E), 256, 0, s>>>(xf, wf, gs, of, g);
  }
  return static_cast<int>(cudaGetLastError());
}
