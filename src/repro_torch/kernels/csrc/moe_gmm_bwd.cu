// K4 backward: the gradients of the grouped (expert) GEMM out[e] = x[e] @ w[e],
// rows at or past group_sizes[e] counting as zero, for Hopper (sm_90a).
//
// The TPU kernel (src/repro/kernels/moe_gmm.py:moe_gmm) has no backward of
// its own: the JAX package differentiates the model's three expert einsums
// (src/repro/models/moe.py:93-95) by autodiff.  This kernel takes the place
// of that VJP on the card, in K4's layout: x (E, C, D), w (E, D, F), dy
// (E, C, F), bf16 or f32, accumulated in float32:
//   dx[e] = dy[e] w[e]^T        (E, C, D), rows >= group_sizes[e] zero
//   dw[e] = x~[e]^T dy[e]       (E, D, F), x~ = x with those rows zeroed,
// each written in its input's dtype; only the gradients the caller asks for
// are computed.  group_sizes is read on the device (no host sync: a CUDA
// graph can capture every path), and x, w and dy are read by stride (unit
// stride on the last axis).
//
// What bounds it on the H100: at mixtral-8x7b's training shape (B 2 x S 512,
// top-2, E 8, C 320: at most 2048 live rows) dx of gate/up does 240.5 GFLOP
// (0.243 ms of bf16 tensor cores) while reading w's 939.5 MB (0.28 ms), and
// dw writes 939.5 MB: each is bound by bytes at ~0.30 ms.  Both must
// therefore read w, and write dw, once and in place: no transposed copy of
// w (1.9 GB of traffic for one expert stack) and no f32 scratch of dw.
//
// Paths (kernels/moe_gmm_bwd.py:plan picks one for each gradient by dtype):
//   dx wgmma  (bf16): K4 forward's persistent TMA + wgmma body
//             (gmm_wgmma.cuh) with w^T as a K-major b operand: F, the
//             contraction, is w's contiguous axis, so one TMA box of 256 w
//             rows x 64 deep a stage feeds wgmma.m64n256k16 with no transpose
//             flag and no copy.  At C below one 128-row tile TMA zero-fills
//             the rows past C and the epilogue writes only rows below C.
//   dw mma    (bf16): one block of 8 warps per 128 x 128 output tile and
//             expert, a 3-stage cp.async ring of 32-deep k-steps,
//             mma.sync.m16n8k16 (warp tile 64 x 32).  dw contracts over the
//             ragged C axis: both operands (x and dy) lie C-major, read
//             through ldmatrix.trans, the k-loop stops at the expert's last
//             live row and the copy zero-fills rows at or past
//             group_sizes[e] in the last k-tile, so an expert with no live
//             row writes zeros.  Each output tile belongs to one block and k
//             runs in order: no atomics, two calls give the same bits.
//   fma       (f32): true float32 FMAs on 64 x 64 tiles, for the 2e-4 parity
//             of the f32 smoke models.
// Left for later work: a wgmma form of dw (its operands are both MN-major:
// the transposed wgmma descriptors of the forward's b), and fusing silu's
// backward into the gate/up dx.
#include "common.cuh"
#include "gmm_wgmma.cuh"
#include "hopper.cuh"

namespace {

constexpr int T_BM = 128;          // output rows of one mma block
constexpr int T_BN = 128;          // output columns
constexpr int T_BK = 32;           // depth of one k-step
constexpr int T_STAGES = 3;
constexpr int T_THREADS = 256;     // 8 warps: 2 (rows) x 4 (columns), 64 x 32 each
constexpr int T_PAD = 8;           // bf16 of padding a row: ldmatrix rows on distinct banks

// One C-major operand of dw, read by stride: element (row r, depth c) of
// expert e at p[e * se + c * so + r].
struct Operand {
  const __nv_bfloat16* p;
  long long se, so;
};

constexpr int LDA = T_BM + T_PAD;  // [k][m] stage rows of A
constexpr int LDB = T_BN + T_PAD;  // [k][n] stage rows of B
constexpr int A_ELEMS = T_BK * LDA;
constexpr int STAGE_ELEMS = A_ELEMS + T_BK * LDB;
constexpr int T_SMEM = T_STAGES * STAGE_ELEMS * 2;

// dw[e] (M x N, bf16, contiguous) = A[e] (M x K) B[e] (K x N) with A = x~^T
// and B = dy, both MN-major (C-major), the depth (c) limited to the live rows.
__global__ void __launch_bounds__(T_THREADS)
gmmbwd_mma(Operand a, Operand b, const int* __restrict__ group_sizes,
           __nv_bfloat16* __restrict__ out, int C, int M, int N) {
  extern __shared__ __align__(16) unsigned char t_smem[];
  __nv_bfloat16* sm = reinterpret_cast<__nv_bfloat16*>(t_smem);
  const int e = blockIdx.z;
  const int m0 = blockIdx.x * T_BM, n0 = blockIdx.y * T_BN;
  const int live = live_rows(group_sizes, e, C);
  const int nk = (live + T_BK - 1) / T_BK;
  const __nv_bfloat16* ae = a.p + e * a.se;
  const __nv_bfloat16* be = b.p + e * b.se;
  const int tid = threadIdx.x;

  auto load_stage = [&](int stage, int kt) {  // [k][row]: 16 16-byte chunks a k row
    const int k0 = kt * T_BK;
    __nv_bfloat16* as = sm + stage * STAGE_ELEMS;
    __nv_bfloat16* bs = as + A_ELEMS;
    for (int i = tid; i < T_BK * ((T_BM + T_BN) / 8); i += T_THREADS) {
      const bool is_a = i < T_BK * (T_BM / 8);
      const int j = is_a ? i : i - T_BK * (T_BM / 8);
      const int r = j / (T_BM / 8), c = (j % (T_BM / 8)) * 8;
      const int col = (is_a ? m0 : n0) + c;
      const bool ok = k0 + r < live && col < (is_a ? M : N);
      const Operand& o = is_a ? a : b;
      const __nv_bfloat16* base = is_a ? ae : be;
      cp_async16((is_a ? as + r * LDA : bs + r * LDB) + c,
                 ok ? base + (long long)(k0 + r) * o.so + col : base, ok);
    }
  };

  float acc[4][4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int v = 0; v < 4; ++v) acc[i][j][v] = 0.f;
  const int warp = tid >> 5, lane = tid & 31;
  const int wm = warp >> 2, wn = warp & 3;        // rows wm*64, columns wn*32
  const int q = lane >> 3, r8 = lane & 7;          // the 8x8 matrix this lane addresses

#pragma unroll
  for (int s = 0; s < T_STAGES - 1; ++s) {
    if (s < nk) load_stage(s, s);
    cp_async_commit();
  }
  for (int kt = 0; kt < nk; ++kt) {
    cp_async_wait<T_STAGES - 2>();  // k-step kt has landed
    __syncthreads();                // ... for every thread; step kt-1 is consumed
    const int next = kt + T_STAGES - 1;
    if (next < nk) load_stage(next % T_STAGES, next);
    cp_async_commit();
    const __nv_bfloat16* as = sm + (kt % T_STAGES) * STAGE_ELEMS;
    const __nv_bfloat16* bs = as + A_ELEMS;
#pragma unroll
    for (int kk = 0; kk < T_BK; kk += 16) {
      uint32_t af[4][4], bf[2][4];
#pragma unroll
      for (int mi = 0; mi < 4; ++mi) {
        const int m = wm * 64 + mi * 16;  // [k][m], transposed on the way
        ldsm_x4_trans(smem_u32(as + (kk + (q >> 1) * 8 + r8) * LDA + m + (q & 1) * 8), af[mi]);
      }
#pragma unroll
      for (int p = 0; p < 2; ++p) {  // two n8 tiles: b0, b1 of the first, then the second
        const int n = wn * 32 + p * 16;  // [k][n]
        ldsm_x4_trans(smem_u32(bs + (kk + (q & 1) * 8 + r8) * LDB + n + (q >> 1) * 8), bf[p]);
      }
#pragma unroll
      for (int mi = 0; mi < 4; ++mi)
#pragma unroll
        for (int nj = 0; nj < 4; ++nj)
          mma_bf16(acc[mi][nj], af[mi], bf[nj >> 1][2 * (nj & 1)], bf[nj >> 1][2 * (nj & 1) + 1]);
    }
  }
  cp_async_wait<0>();

  // accumulator fragment: row g (+8) of the m16 tile, columns 2c, 2c+1 of the n8 tile
  __nv_bfloat16* oe = out + (long long)e * M * N;
#pragma unroll
  for (int mi = 0; mi < 4; ++mi)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row = m0 + wm * 64 + mi * 16 + (lane >> 2) + h * 8;
      if (row >= M) continue;
#pragma unroll
      for (int nj = 0; nj < 4; ++nj) {
        const int col = n0 + wn * 32 + nj * 8 + 2 * (lane & 3);
        if (col < N)  // N % 8 == 0: col + 1 < N as well
          *reinterpret_cast<__nv_bfloat162*>(oe + (long long)row * N + col) =
              __floats2bfloat162_rn(acc[mi][nj][2 * h], acc[mi][nj][2 * h + 1]);
      }
    }
}

// The float32 kernel: 64 x 64 output tiles, 16-deep k-steps, 256 threads of
// 4 x 4 outputs each.  KMAJ (dx): A = dy (rows c, depth f) and B = w^T (rows
// d, depth f), both K-major, the rows of A at or past live zero; !KMAJ (dw):
// A = x~^T and B = dy, both C-major, the depth (c) limited to live.  An
// operand reads element (outer, inner) of expert e at p[e * se + outer * so
// + inner]: (row, depth) when K-major, (depth, row) when C-major.
struct OperandF {
  const float* p;
  long long se, so;
};

template <bool KMAJ>
__global__ void __launch_bounds__(256)
gmmbwd_fma(OperandF a, OperandF b, const int* __restrict__ group_sizes,
           float* __restrict__ out, int C, int M, int N, int K) {
  constexpr int BT = 64, BKF = 16;
  __shared__ __align__(16) float As[BKF][BT];
  __shared__ __align__(16) float Bs[BKF][BT];
  const int e = blockIdx.z;
  const int m0 = blockIdx.x * BT, n0 = blockIdx.y * BT;
  const int live = live_rows(group_sizes, e, C);
  const int m_lim = KMAJ ? live : M;
  const int k_lim = KMAJ ? K : live;
  const int k_end = (KMAJ && m0 >= live) ? 0 : k_lim;
  const float* ae = a.p + e * a.se;
  const float* be = b.p + e * b.se;
  const int tid = threadIdx.x;
  const int tx = tid % 16, ty = tid / 16;   // columns tx*4.., rows ty*4..
  float acc[4][4] = {};
  for (int k0 = 0; k0 < k_end; k0 += BKF) {
    for (int i = tid; i < BKF * BT; i += 256) {
      // K-major: depth fastest across threads; MN-major: rows fastest
      const int kk = KMAJ ? i % BKF : i / BT, rr = KMAJ ? i / BKF : i % BT;
      const int k = k0 + kk;
      const int am = m0 + rr, bn = n0 + rr;
      As[kk][rr] = (am < m_lim && k < k_lim)
                       ? ae[KMAJ ? (long long)am * a.so + k : (long long)k * a.so + am] : 0.f;
      Bs[kk][rr] = (bn < N && k < k_lim)
                       ? be[KMAJ ? (long long)bn * b.so + k : (long long)k * b.so + bn] : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < BKF; ++kk) {
      const float4 av = *reinterpret_cast<const float4*>(&As[kk][ty * 4]);
      const float4 bv = *reinterpret_cast<const float4*>(&Bs[kk][tx * 4]);
      const float ar[4] = {av.x, av.y, av.z, av.w}, br[4] = {bv.x, bv.y, bv.z, bv.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(ar[i], br[j], acc[i][j]);
    }
    __syncthreads();
  }
  float* oe = out + (long long)e * M * N;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = m0 + ty * 4 + i;
    if (row >= M) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int col = n0 + tx * 4 + j;
      if (col < N) oe[(long long)row * N + col] = acc[i][j];
    }
  }
}

__global__ void __launch_bounds__(W_THREADS, 1)
gmmbwd_dx_wgmma(const __grid_constant__ CUtensorMap tmap_dy,
                const __grid_constant__ CUtensorMap tmap_w, const int* __restrict__ group_sizes,
                __nv_bfloat16* __restrict__ dx, int E, int C, int D, int F) {
  extern __shared__ __align__(1024) uint8_t w_smem_raw[];
  gmm_wgmma_body<true>(&tmap_dy, &tmap_w, group_sizes, dx, E, C, F, D, w_smem_raw);
}

template <typename Kernel>
int set_smem(Kernel kernel, int bytes, bool& configured) {
  if (configured) return 0;
  const cudaError_t e =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (e != cudaSuccess) return static_cast<int>(e);
  configured = true;
  return 0;
}

int launch_dx_wgmma(const void* dy, const void* w, const int* gs, void* dx, int E, int C, int D,
                    int F, long long sde, long long sdc, long long swe, long long swd, int grid,
                    cudaStream_t stream) {
  EncodeTiledFn encode = encode_tiled();
  if (encode == nullptr) return static_cast<int>(cudaErrorNotSupported);
  if (E > W_MAX_E || grid < 1 || D % 8 || F % 8 || sde % 8 || sdc % 8 || swe % 8 || swd % 8 ||
      reinterpret_cast<uintptr_t>(dy) % 16 || reinterpret_cast<uintptr_t>(w) % 16)
    return static_cast<int>(cudaErrorInvalidValue);
  CUtensorMap tdy, tw;
  // dy (E, C, F) K-major in 64 x 128 boxes; w (E, D, F) as w^T, K-major, in 64 x 256 boxes
  if (encode_bf16_3d(encode, &tdy, dy, F, C, E, sdc, sde, W_BK, W_BM) != CUDA_SUCCESS ||
      encode_bf16_3d(encode, &tw, w, F, D, E, swd, swe, W_BK, W_BN) != CUDA_SUCCESS)
    return static_cast<int>(cudaErrorInvalidValue);
  static bool configured = false;
  if (int err = set_smem(gmmbwd_dx_wgmma, W_SMEM, configured)) return err;
  gmmbwd_dx_wgmma<<<grid, W_THREADS, W_SMEM, stream>>>(
      tdy, tw, gs, static_cast<__nv_bfloat16*>(dx), E, C, D, F);
  return static_cast<int>(cudaGetLastError());
}

int launch_dw_mma(Operand a, Operand b, const int* gs, void* out, int E, int C, int M, int N,
                  cudaStream_t stream) {
  static bool configured = false;
  if (int err = set_smem(gmmbwd_mma, T_SMEM, configured)) return err;
  const dim3 grid((M + T_BM - 1) / T_BM, (N + T_BN - 1) / T_BN, E);
  gmmbwd_mma<<<grid, T_THREADS, T_SMEM, stream>>>(a, b, gs, static_cast<__nv_bfloat16*>(out),
                                                 C, M, N);
  return static_cast<int>(cudaGetLastError());
}

template <bool KMAJ>
int launch_fma(OperandF a, OperandF b, const int* gs, void* out, int E, int C, int M, int N,
               int K, cudaStream_t stream) {
  const dim3 grid((M + 63) / 64, (N + 63) / 64, E);
  gmmbwd_fma<KMAJ><<<grid, 256, 0, stream>>>(a, b, gs, static_cast<float*>(out), C, M, N, K);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Paths, as kernels/moe_gmm_bwd.py numbers them.
#define GBWD_PATH_FMA 0
#define GBWD_PATH_MMA 1
#define GBWD_PATH_WGMMA 2

// x: (E, C, D) with strides (sxe, sxc, 1); w: (E, D, F) with strides (swe,
// swd, 1); dy: (E, C, F) with strides (sde, sdc, 1); group_sizes: (E,) int32
// on the device, or null for all C rows; dx (E, C, D) and dw (E, D, F)
// contiguous, either null when not asked for.  dx_path: fma / wgmma (grid:
// its persistent blocks); dw_path: fma / mma.  bf16 needs D, F and
// every row stride a multiple of 8 and 16-byte aligned x, w, dy (the wrapper
// checks).
extern "C" int moe_gmm_bwd(const void* x, const void* w, const void* group_sizes,
                           const void* dy, void* dx, void* dw, int dtype, int E, int C, int D,
                           int F, long long sxe, long long sxc, long long swe, long long swd,
                           long long sde, long long sdc, int dx_path, int dw_path, int grid,
                           void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int* gs = static_cast<const int*>(group_sizes);
  const bool bf16 = dtype == REPRO_BF16;
  if (!bf16 && dtype != REPRO_F32) return static_cast<int>(cudaErrorInvalidValue);
  if (dx != nullptr) {
    int err;
    if (dx_path == GBWD_PATH_WGMMA && bf16) {
      err = launch_dx_wgmma(dy, w, gs, dx, E, C, D, F, sde, sdc, swe, swd, grid, s);
    } else if (dx_path == GBWD_PATH_FMA && !bf16) {
      err = launch_fma<true>({static_cast<const float*>(dy), sde, sdc},
                             {static_cast<const float*>(w), swe, swd}, gs, dx, E, C, C, D, F, s);
    } else {
      return static_cast<int>(cudaErrorInvalidValue);
    }
    if (err) return err;
  }
  if (dw != nullptr) {
    // dw (D x F) = x~^T (rows d, depth c: x is C-major) dy (depth c, columns f)
    if (dw_path == GBWD_PATH_MMA && bf16)
      return launch_dw_mma({static_cast<const __nv_bfloat16*>(x), sxe, sxc},
                           {static_cast<const __nv_bfloat16*>(dy), sde, sdc}, gs, dw, E, C, D,
                           F, s);
    if (dw_path == GBWD_PATH_FMA && !bf16)
      return launch_fma<false>({static_cast<const float*>(x), sxe, sxc},
                               {static_cast<const float*>(dy), sde, sdc}, gs, dw, E, C, D, F, C,
                               s);
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return 0;
}
