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
// group_sizes is read from device memory, never from the host, so a CUDA
// graph can capture every path.  x and w are read by stride (unit stride on
// the last axis), so the model's (E, C, D) view of its dispatch buffer goes
// in without a copy.  Four paths; kernels/moe_gmm.py:plan picks one by
// dtype and shape:
//   wgmma (bf16, C > 32, TMA-addressable strides): prefill (the body is
//         gmm_wgmma.cuh's, shared with the backward's dx).  A persistent
//         grid (one block per SM) walks the live tiles of out, 128 x 256
//         each: one producer warp keeps a 4-stage ring of TMA copies in
//         flight (an x tile 128 rows x 64 deep, K-major; a w tile 64 deep x
//         256 wide as four 64 x 64 boxes, MN-major as w lies in memory, both
//         128-byte swizzled), and two consumer warpgroups each run
//         wgmma.m64n256k16 on 64 of the rows, reading w through the
//         instruction's transpose flag, so unlike K3 no conversion pass is
//         needed.  The tile list comes from group_sizes on the device: each
//         block sums ceil(live_e / 128) in shared memory at its start, so no
//         tile at or past group_sizes[e] reads a byte of weights.  Tiles run
//         expert by expert, column slab by column slab, row tile fastest, so
//         the blocks that share a weight slab run side by side and read it
//         from L2.  Masking moves to the epilogue: an output row depends only
//         on its own x row, so writing zeros for rows >= group_sizes[e] (and
//         for the rows of wholly dead tiles, which the consumers clear first)
//         is exactly the TPU kernel's masking of x rows, and TMA loads whole
//         tiles (rows past C, columns past F and depth past D come in as
//         zeros).
//   mma   (bf16, C <= 32: decode): bound by the bytes of the live experts'
//         weights, which serve at most 32 rows.  Split-D: each work item is
//         (live expert, D split, 128-column tile), listed on the device from
//         group_sizes by one warp's ballots at the block's start, so a dead
//         expert (arctic: 120 of 128) costs no block and no byte of weight.
//         The split count comes from static shapes only (E, C, D, F and the
//         SM count: kernels/moe_gmm.py:plan), so one captured graph serves
//         every step; the grid covers the items of min(E, C) live experts
//         and loops when more are live.  A producer warp streams each item's
//         weight slab through a 4-stage ring of 22 KB stages with 1-D bulk
//         copies (one per 256-byte weight row, and the live x rows) that
//         complete on mbarriers; two blocks per SM keep ~128 KB of weights
//         in flight on each SM.  Four consumer warps compute the transposed
//         product on mma.sync.m16n8k16: 16 weight columns as the A operand,
//         read with ldmatrix.trans from the F-contiguous rows, and the x
//         rows as n8 B operands (up to four), so no tensor-core row is
//         padding beyond the last n8 tile.  Ragged depth (D % 16 == 8) is
//         masked in registers.  A single split writes bf16 directly;
//         several write float32 partials to a scratch the wrapper
//         allocates, and the last split of each (expert, tile) to finish,
//         found through a counter that resets itself (so graph replays stay
//         right), sums them in split order: two calls give the same bits.
//         Rows at or past group_sizes[e] get zeros from the item's last
//         writer, dead experts' rows from all blocks, before their items.
//   wmma  (bf16, C > 32 with operands TMA cannot address, or more than 1024
//         experts): one block per (c-tile, f-tile, expert), 64 x 128 tiles
//         on 4 warps through WMMA (16x16x16 bf16 -> f32), a 3-stage
//         cp.async pipeline of 32-deep k-steps; masked rows and ragged edges
//         are zero-filled by the copy itself, and a c-tile wholly at or past
//         group_sizes[e] writes zeros and reads no weight bytes.
//   fma   (f32): true float32 (FMAs, no TF32), 256 threads on a BM x 128
//         tile, as the int8 GEMM (K3), so the f32 parity tests hold at 1e-4.
//
// Left for later work: overlapping the wgmma epilogue with the next tile's
// products (two consumer groups in turn), and fusing gate, up and silu into
// one launch.
#include "common.cuh"
#include "gmm_wgmma.cuh"
#include "hopper.cuh"

#include <mma.h>

namespace {

using namespace nvcuda;

constexpr int BN = 128;     // output columns of one block
constexpr int BK = 32;      // depth of one k-step (wmma path)
constexpr int STAGES = 3;   // cp.async pipeline depth (wmma path)
constexpr int PAD = 8;      // bf16 elements of padding per shared-memory row

struct Geom {
  int C, D, F;
  long long sxe, sxc;  // x element strides of (expert, row); d is 1
  long long swe, swd;  // w element strides of (expert, d); f is 1
};

template <typename T>
__device__ void zero_tile(T* oe, int m0, int n0, int BM, const Geom& g) {
  for (int i = threadIdx.x; i < BM * BN; i += blockDim.x) {
    const int r = m0 + i / BN, c = n0 + i % BN;
    if (r < g.C && c < g.F) oe[(long long)r * g.F + c] = from_f32<T>(0.f);
  }
}

__global__ void __launch_bounds__(128)
gmm_bf16_kernel(const __nv_bfloat16* __restrict__ x, const __nv_bfloat16* __restrict__ w,
                const int* __restrict__ group_sizes, __nv_bfloat16* __restrict__ out,
                Geom g) {
  constexpr int THREADS = 128;
  constexpr int BM = 64;
  constexpr int WARPS_M = 2;
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

// -------------------------------------------------------------- wgmma path

// the body is gmm_wgmma.cuh's, shared with the backward's dx: here b is w
// (E, D, F), MN-major, on the whole-tile schedule
__global__ void __launch_bounds__(W_THREADS, 1)
gmm_wgmma_kernel(const __grid_constant__ CUtensorMap tmap_x,
                 const __grid_constant__ CUtensorMap tmap_w,
                 const int* __restrict__ group_sizes, __nv_bfloat16* __restrict__ out, int E,
                 int C, int D, int F) {
  extern __shared__ __align__(1024) uint8_t w_smem_raw[];
  gmm_wgmma_body<false, false>(&tmap_x, &tmap_w, nullptr, group_sizes, out, nullptr, nullptr, E,
                               C, D, F, w_smem_raw);
}

// w (E, D, F) as a 3-D tensor map, innermost axis first, in boxes 64 wide
// and 64 deep (the wgmma and mma paths' stage depth); bf16, 128-byte
// swizzle, zeros outside the tensor.
CUresult encode_w(EncodeTiledFn encode, CUtensorMap* tw, const void* w, int E, const Geom& g) {
  static_assert(W_BK == 64, "w boxes are 64 deep");
  return encode_bf16_3d(encode, tw, w, g.F, g.D, E, g.swd, g.swe, 64, W_BK);
}

// x (E, C, D) and w (E, D, F) as 3-D tensor maps, innermost axis first;
// bf16, 128-byte swizzle, zeros outside the tensor.
int launch_wgmma(const void* x, const void* w, const int* gs, void* out, int E, const Geom& g,
                 int grid, cudaStream_t stream) {
  EncodeTiledFn encode = encode_tiled();
  if (encode == nullptr) return static_cast<int>(cudaErrorNotSupported);
  if (E > W_MAX_E || grid < 1 || g.D % 8 || g.F % 8 || g.sxc % 8 || g.sxe % 8 || g.swd % 8 ||
      g.swe % 8 || reinterpret_cast<uintptr_t>(x) % 16 || reinterpret_cast<uintptr_t>(w) % 16)
    return static_cast<int>(cudaErrorInvalidValue);
  CUtensorMap tx, tw;
  if (encode_bf16_3d(encode, &tx, x, g.D, g.C, E, g.sxc, g.sxe, W_BK, W_BM) != CUDA_SUCCESS)
    return static_cast<int>(cudaErrorInvalidValue);
  if (encode_w(encode, &tw, w, E, g) != CUDA_SUCCESS) return static_cast<int>(cudaErrorInvalidValue);
  static bool configured = false;
  if (!configured) {
    const cudaError_t e = cudaFuncSetAttribute(
        gmm_wgmma_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, W_SMEM);
    if (e != cudaSuccess) return static_cast<int>(e);
    configured = true;
  }
  gmm_wgmma_kernel<<<grid, W_THREADS, W_SMEM, stream>>>(
      tx, tw, gs, static_cast<__nv_bfloat16*>(out), E, g.C, g.D, g.F);
  return static_cast<int>(cudaGetLastError());
}

// ----------------------------------------------------- mma path (decode)

constexpr int D_BN = 128;                  // output columns (w columns) of one work item
constexpr int D_BK = 64;                   // depth of one ring stage
constexpr int D_STAGES = 4;
constexpr int D_MAX_C = 32;                // x rows: up to four n8 tiles of the mma
constexpr int D_CONSUMERS = 128;           // 4 warps, 32 columns each
constexpr int D_THREADS = D_CONSUMERS + 32;  // + one producer warp
constexpr int D_BOX_BYTES = D_BK * 64 * 2;   // one TMA box of w: 64 deep x 64 wide
constexpr int D_W_BYTES = D_BN / 64 * D_BOX_BYTES;
constexpr int D_X_LD = D_BK * 2 + 16;      // bytes per staged x row: + 16 so the 8 rows
                                           // of an ldmatrix fall on distinct banks
constexpr int D_STAGE_BYTES = (D_W_BYTES + D_MAX_C * D_X_LD + 1023) / 1024 * 1024;  // 21 KB
constexpr int D_MAX_E = 1024;
constexpr int D_MAX_COUNTERS = 1 << 16;    // (expert, column tile) pairs of a split call
constexpr int D_SMEM = D_STAGES * D_STAGE_BYTES + 2 * D_STAGES * 8 + D_MAX_E * 4 +
                       1024;  // + alignment slack

// Splits that have finished each (expert, column tile) of the running call.
// Zero when the library loads; the last split of a tile sets it back to zero,
// so every call (and every replay of a captured one) finds it zero.  Calls on
// one device run in stream order, so they never share a counter.
__device__ unsigned int g_splits_done[D_MAX_COUNTERS];

__device__ __forceinline__ void consumers_sync() {
  asm volatile("bar.sync 1, %0;" ::"n"(D_CONSUMERS) : "memory");
}

struct Item {
  int e, split, n0;
};

// Work item t: the live experts in order (order[0 .. n_live)), then the D
// splits, then the column tiles, fastest.
__device__ __forceinline__ Item item_at(const int* order, int n_tiles, int splits, int t) {
  const int per_expert = n_tiles * splits;
  const int rem = t % per_expert;
  return {order[t / per_expert], rem / n_tiles, (rem % n_tiles) * D_BN};
}

__global__ void __launch_bounds__(D_THREADS, 2)
gmm_decode_kernel(const __grid_constant__ CUtensorMap tmap_w,
                  const __nv_bfloat16* __restrict__ x, const int* __restrict__ group_sizes,
                  __nv_bfloat16* __restrict__ out, float* __restrict__ part, Geom g, int E,
                  int splits, int kps) {
  extern __shared__ __align__(1024) uint8_t d_smem_raw[];
  // the swizzled w boxes need 1024-byte alignment in the shared window
  const uint32_t raw = smem_u32(d_smem_raw);
  uint8_t* ring = d_smem_raw + (((raw + 1023u) & ~1023u) - raw);
  // [stage]: w as two 64-wide boxes [64 deep][64], then x [32 rows][64 + 8 deep]
  uint64_t* full = reinterpret_cast<uint64_t*>(ring + D_STAGES * D_STAGE_BYTES);
  uint64_t* empty = full + D_STAGES;
  int* order = reinterpret_cast<int*>(empty + D_STAGES);  // live experts, then dead ones
  __shared__ int n_live_s, last_s;

  const int tid = threadIdx.x;
  const int n_tiles = (g.F + D_BN - 1) / D_BN;
  if (tid < 32) {  // the live experts in order, by one warp's ballots
    int n_live = 0, n_dead = 0;
    for (int e0 = 0; e0 < E; e0 += 32) {
      const int e = e0 + tid;
      const bool live = e < E && live_rows(group_sizes, e, g.C) > 0;
      const bool dead = e < E && !live;
      const unsigned lm = __ballot_sync(0xffffffffu, live);
      const unsigned dm = __ballot_sync(0xffffffffu, dead);
      const unsigned below = (1u << tid) - 1u;
      if (live) order[n_live + __popc(lm & below)] = e;
      if (dead) order[E - 1 - n_dead - __popc(dm & below)] = e;
      n_live += __popc(lm);
      n_dead += __popc(dm);
    }
    if (tid == 0) n_live_s = n_live;
  }
  if (tid == 32) {
#pragma unroll
    for (int s = 0; s < D_STAGES; ++s) {
      mbar_init(smem_u32(&full[s]), 1);
      mbar_init(smem_u32(&empty[s]), D_CONSUMERS / 32);  // one arrival per consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();
  const int n_live = n_live_s;
  const int total = n_live * n_tiles * splits;

  if (tid >= D_CONSUMERS) {  // producer warp: w's TMA boxes and x's live rows into the ring
    const int lane = tid - D_CONSUMERS;
    int it = 0;  // ring position, continued from item to item
    for (int t = blockIdx.x; t < total; t += gridDim.x) {
      const Item im = item_at(order, n_tiles, splits, t);
      const int live = live_rows(group_sizes, im.e, g.C);
      const int boxes = g.F - im.n0 > 64 ? 2 : 1;  // a box wholly past F is not loaded
      const int d0 = im.split * kps, d1 = min(g.D, d0 + kps);
      const __nv_bfloat16* xe = x + (long long)im.e * g.sxe;
      for (int k0 = d0; k0 < d1; k0 += D_BK, ++it) {
        const int st = it % D_STAGES;
        const int kv = min(D_BK, d1 - k0);  // a multiple of 8: D is
        uint8_t* stage = ring + st * D_STAGE_BYTES;
        const uint32_t fb = smem_u32(&full[st]);
        if (lane == 0) {
          mbar_wait(smem_u32(&empty[st]), ((it / D_STAGES) & 1) ^ 1);
          // TMA counts a box's full bytes, zeros past D and F included
          mbar_expect_tx(fb, boxes * D_BOX_BYTES + live * kv * 2);
          for (int i = 0; i < boxes; ++i)
            tma_load_3d(smem_u32(stage + i * D_BOX_BYTES), &tmap_w, fb, im.n0 + i * 64, k0,
                        im.e);
        }
        __syncwarp();
        for (int c = lane; c < live; c += 32)  // only the live rows of x
          bulk_load(smem_u32(stage + D_W_BYTES + c * D_X_LD), xe + (long long)c * g.sxc + k0,
                    kv * 2, fb);
      }
    }
    return;
  }

  // zeros for every dead expert's rows, shared over the grid; the producer's
  // first copies land meanwhile
  const long long per16 = (long long)g.C * g.F / 8;  // 16-byte stores of one expert
  const long long n16 = (E - n_live) * per16;
  for (long long i = (long long)blockIdx.x * D_CONSUMERS + tid; i < n16;
       i += (long long)gridDim.x * D_CONSUMERS)
    reinterpret_cast<uint4*>(out + (long long)order[n_live + i / per16] * g.C * g.F)[i % per16] =
        make_uint4(0u, 0u, 0u, 0u);

  const int warp = tid >> 5, lane = tid & 31;
  const int q = lane >> 3, r8 = lane & 7;  // the 8x8 matrix this lane addresses, and its row
  // A = w^T (16 columns x 16 deep) from the depth-major w rows, transposed by
  // ldmatrix: matrix q holds depth (q >> 1) * 8.. and columns (q & 1) * 8..
  // of the m-th 16 of the warp's 32; in a box, the 16-byte piece p of depth
  // row r lies at piece p ^ (r % 8) of its 128 bytes (the 128-byte swizzle)
  uint32_t a_off[2];
#pragma unroll
  for (int m = 0; m < 2; ++m) {
    const int col = warp * 32 + m * 16 + (q & 1) * 8;
    a_off[m] = (col >> 6) * D_BOX_BYTES + ((q >> 1) * 8 + r8) * 128 +
               ((((col & 63) >> 3) ^ r8) << 4);
  }
  // B = x^T (16 deep x 8 rows): matrix q holds depth q * 8.., two 16-deep steps
  const uint32_t b_off = D_W_BYTES + r8 * D_X_LD + q * 16;
  int it = 0;
  for (int t = blockIdx.x; t < total; t += gridDim.x) {
    const Item im = item_at(order, n_tiles, splits, t);
    const int live = live_rows(group_sizes, im.e, g.C);
    const int nt = (live + 7) / 8;  // n8 tiles with a live row
    const int d0 = im.split * kps, d1 = min(g.D, d0 + kps);
    float acc[2][4][4];
#pragma unroll
    for (int m = 0; m < 2; ++m)
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int v = 0; v < 4; ++v) acc[m][j][v] = 0.f;
    for (int k0 = d0; k0 < d1; k0 += D_BK, ++it) {
      const int st = it % D_STAGES;
      const int kv = min(D_BK, d1 - k0);
      mbar_wait(smem_u32(&full[st]), (it / D_STAGES) & 1);
      const uint32_t base = smem_u32(ring + st * D_STAGE_BYTES);
#pragma unroll
      for (int kk = 0; kk < D_BK; kk += 32) {
        if (kk >= kv) break;
        uint32_t b[4][4];
#pragma unroll
        for (int j = 0; j < 4; ++j)
          if (j < nt) ldsm_x4(base + b_off + j * 8 * D_X_LD + kk * 2, b[j]);
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int k16 = kk + 16 * h;
          if (k16 >= kv) break;
          const bool half = k16 + 8 >= kv;  // only depth k16 .. k16 + 8 is staged
#pragma unroll
          for (int m = 0; m < 2; ++m) {
            uint32_t a[4];
            ldsm_x4_trans(base + a_off[m] + k16 * 128, a);
            if (half) a[2] = a[3] = 0u;
#pragma unroll
            for (int j = 0; j < 4; ++j)
              if (j < nt) mma_bf16(acc[m][j], a, b[j][2 * h], half ? 0u : b[j][2 * h + 1]);
          }
        }
      }
      __syncwarp();
      if (lane == 0) mbar_arrive(smem_u32(&empty[st]));
    }

    // accumulator fragment: w column (lane / 4) (+ 8) of the warp's 16, x row
    // 2 * (lane % 4) (+ 1) of the n8 tile; the tile's columns past F and rows
    // at or past live are not written
    const int bnv = min(D_BN, g.F - im.n0);
    __nv_bfloat16* oe = out + (long long)im.e * g.C * g.F + im.n0;
    float* pe = splits > 1 ? part + ((long long)im.split * E + im.e) * g.C * g.F + im.n0 : nullptr;
#pragma unroll
    for (int m = 0; m < 2; ++m)
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int v = 0; v < 4; ++v) {
          const int col = warp * 32 + m * 16 + (lane >> 2) + (v >> 1) * 8;
          const int row = j * 8 + 2 * (lane & 3) + (v & 1);
          if (j < nt && row < live && col < bnv) {
            if (splits == 1) oe[(long long)row * g.F + col] = __float2bfloat16_rn(acc[m][j][v]);
            else pe[(long long)row * g.F + col] = acc[m][j][v];
          }
        }
    if (splits == 1) {
      for (int i = tid; i < (g.C - live) * bnv; i += D_CONSUMERS)
        oe[(long long)(live + i / bnv) * g.F + i % bnv] = __float2bfloat16_rn(0.f);
      continue;
    }
    // the last split of this (expert, column tile) to finish sums all of them,
    // in split order, so two calls give the same bits
    __threadfence();
    consumers_sync();
    unsigned int* done = &g_splits_done[im.e * n_tiles + im.n0 / D_BN];
    if (tid == 0) last_s = atomicAdd(done, 1u) == (unsigned)splits - 1u;
    consumers_sync();
    if (!last_s) continue;
    __threadfence();
    const float* pt = part + (long long)im.e * g.C * g.F + im.n0;
    const long long split_stride = (long long)E * g.C * g.F;
    for (int i = tid; i < g.C * bnv; i += D_CONSUMERS) {
      const int row = i / bnv, col = i % bnv;
      float sum = 0.f;
      if (row < live)
        for (int s = 0; s < splits; ++s)
          sum += __ldcg(pt + s * split_stride + (long long)row * g.F + col);
      oe[(long long)row * g.F + col] = __float2bfloat16_rn(sum);
    }
    if (tid == 0) atomicExch(done, 0u);
  }
}

int launch_decode(const void* x, const void* w, const int* gs, void* out, void* part, int E,
                  const Geom& g, int grid, int splits, int kps, cudaStream_t stream) {
  const int n_tiles = (g.F + D_BN - 1) / D_BN;
  if (E > D_MAX_E || g.C > D_MAX_C || grid < 1 || splits < 1 || kps % D_BK ||
      (long long)(splits - 1) * kps >= g.D || (long long)splits * kps < g.D ||
      (splits > 1 && (part == nullptr || (long long)E * n_tiles > D_MAX_COUNTERS)) ||
      g.D % 8 || g.F % 8 || g.sxc % 8 || g.sxe % 8 || g.swd % 8 || g.swe % 8 ||
      reinterpret_cast<uintptr_t>(x) % 16 || reinterpret_cast<uintptr_t>(w) % 16 ||
      reinterpret_cast<uintptr_t>(out) % 16)
    return static_cast<int>(cudaErrorInvalidValue);
  EncodeTiledFn encode = encode_tiled();
  if (encode == nullptr) return static_cast<int>(cudaErrorNotSupported);
  CUtensorMap tw;
  if (encode_w(encode, &tw, w, E, g) != CUDA_SUCCESS) return static_cast<int>(cudaErrorInvalidValue);
  static bool configured = false;
  if (!configured) {
    const cudaError_t e = cudaFuncSetAttribute(
        gmm_decode_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, D_SMEM);
    if (e != cudaSuccess) return static_cast<int>(e);
    configured = true;
  }
  gmm_decode_kernel<<<grid, D_THREADS, D_SMEM, stream>>>(
      tw, static_cast<const __nv_bfloat16*>(x), gs, static_cast<__nv_bfloat16*>(out),
      static_cast<float*>(part), g, E, splits, kps);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Paths, as kernels/moe_gmm.py numbers them.
#define GMM_PATH_FMA 0
#define GMM_PATH_MMA 1
#define GMM_PATH_WGMMA 2
#define GMM_PATH_WMMA 3

// x: (E, C, D) with strides (sxe, sxc, 1); w: (E, D, F) with strides (swe,
// swd, 1); group_sizes: (E,) int32 on the device, or null for all C rows;
// out: (E, C, F) contiguous.  bf16 needs 16-byte aligned rows: x, w 16-byte
// aligned and sxe, sxc, swe, swd, D, F multiples of 8 (the wrapper checks).
// grid: the wgmma and mma paths' blocks.  mma only: splits D splits of kps
// (a multiple of 64) each, and part, (splits, E, C, F) float32 scratch for
// their partial sums when splits > 1.
extern "C" int moe_gmm_fwd(const void* x, const void* w, const void* group_sizes, void* out,
                           void* part, int dtype, int E, int C, int D, int F, long long sxe,
                           long long sxc, long long swe, long long swd, int path, int grid,
                           int splits, int kps, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const Geom g{C, D, F, sxe, sxc, swe, swd};
  const int* gs = static_cast<const int*>(group_sizes);
  const unsigned f_tiles = (F + BN - 1) / BN;
  if (path == GMM_PATH_WGMMA || path == GMM_PATH_MMA || path == GMM_PATH_WMMA) {
    if (dtype != REPRO_BF16) return static_cast<int>(cudaErrorInvalidValue);
    if (path == GMM_PATH_WGMMA) return launch_wgmma(x, w, gs, out, E, g, grid, s);
    if (path == GMM_PATH_MMA) return launch_decode(x, w, gs, out, part, E, g, grid, splits, kps, s);
    gmm_bf16_kernel<<<dim3((C + 63) / 64, f_tiles, E), 128, 0, s>>>(
        static_cast<const __nv_bfloat16*>(x), static_cast<const __nv_bfloat16*>(w), gs,
        static_cast<__nv_bfloat16*>(out), g);
    return static_cast<int>(cudaGetLastError());
  }
  if (path != GMM_PATH_FMA || dtype != REPRO_F32) return static_cast<int>(cudaErrorInvalidValue);
  const auto* xf = static_cast<const float*>(x);
  const auto* wf = static_cast<const float*>(w);
  auto* of = static_cast<float*>(out);
  if (C > 32)
    gmm_f32_kernel<4><<<dim3((C + 63) / 64, f_tiles, E), 256, 0, s>>>(xf, wf, gs, of, g);
  else
    gmm_f32_kernel<1><<<dim3((C + 15) / 16, f_tiles, E), 256, 0, s>>>(xf, wf, gs, of, g);
  return static_cast<int>(cudaGetLastError());
}
