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
//             the rows past C and the store clips them.  dx takes the body's
//             stream-K schedule: at mixtral's gate/up 320 live tiles of 224
//             k-steps are 2.42 waves on 132 SMs, so whole tiles would leave
//             76 SMs idle for the third wave's length; here the two full
//             waves run whole and each of the 56 tiles left is cut at the
//             same k-steps in two, 560 k-steps a block in all instead of
//             672 (down: 576 -> 544), their f32 pieces summed by each tile's
//             first block in block order through a workspace the wrapper
//             allocates (a slot and a flag a block, the flags cleared at the
//             launch).  Its epilogue stores the bf16 tile by TMA from a
//             swizzled buffer, half a tile at a time, while the next tile's
//             products run; a 4-stage ring beside it (at most SK_MAX_E
//             experts in the shared tile list).
//   dw wgmma  (bf16): gmmbwd_dw_wgmma below.  dw is bound by its write (at
//             mixtral's gate/up 939.5 MB against a contraction of only the
//             ~256 live rows), so the design keeps that write streaming:
//             a persistent grid (one block an SM) walks dw's 128 x 256 tiles
//             expert by expert, the shorter of the two tile axes fastest
//             (the blocks side by side share x's and dy's live rows in L2);
//             a producer warp keeps a 3-stage ring of 48 KB TMA stages in
//             flight across tile boundaries, so the next tile's operands land
//             while this tile's epilogue runs; two consumer warpgroups run
//             wgmma.m64n256k16 on 64 rows each.  Both operands are MN-major
//             and read in place: A = x~^T from x (E, C, D) boxes of 64 d x
//             64 c (the transpose flag for A), B = dy from (E, C, F) boxes
//             of 64 f x 64 c (the flag for B), all 128-byte swizzled.  The
//             contraction is ragged: the k-loop stops at the expert's last
//             live row, and since TMA zero-fills only past C, each consumer
//             zeroes the c-lines at or past group_sizes[e] of its own x box
//             in the last k-tile (whole 128-byte rows, which the swizzle
//             leaves in place), then fences the async proxy before wgmma
//             reads it.  An expert with no live row reads nothing and writes
//             zeros.  The epilogue converts the accumulators to bf16 into a
//             swizzled 64 KB buffer and one thread of each warpgroup issues
//             TMA stores of it; the store drains while the next tile's
//             products run, and the buffer is rewritten only after the
//             store has read it.  Each output tile belongs to one block and
//             k runs in order: no atomics, two calls give the same bits.
//             Measured and not kept (PERF.md): clusters of two blocks
//             sharing each dy stage by TMA multicast (slower), and one tile
//             order for every shape (row tiles fastest: slower at down).
//   fma       (f32): true float32 FMAs on 64 x 64 tiles, for the 2e-4 parity
//             of the f32 smoke models.
// Left for later work: fusing silu's backward into the gate/up dx.
#include <climits>

#include "common.cuh"
#include "gmm_wgmma.cuh"
#include "hopper.cuh"

namespace {

constexpr int DW_BM = 128;                       // rows of dw (d) per tile: 2 warpgroups x 64
constexpr int DW_BN = 256;                       // columns of dw (f) per tile
constexpr int DW_BK = 64;                        // live rows (c) of one stage
constexpr int DW_STAGES = 3;
constexpr int DW_BOX = 64 * 64 * 2;              // one 64 x 64 bf16 box, 8 KB
constexpr int DW_A_BYTES = DW_BM * DW_BK * 2;    // two x boxes a stage
constexpr int DW_B_BYTES = DW_BN * DW_BK * 2;    // four dy boxes a stage
constexpr int DW_OUT_BYTES = DW_BM * DW_BN * 2;  // the epilogue's tile: 4 boxes a warpgroup
constexpr int DW_SMEM = DW_STAGES * (DW_A_BYTES + DW_B_BYTES) + DW_OUT_BYTES +
                        2 * DW_STAGES * 8 + 1024;  // + alignment slack: 214,064 bytes

struct DwTile {
  int e, m0, n0;
};

// tile t of the expert-major order, the shorter of dw's two tile axes
// fastest: the blocks running side by side then cover whole rows (or
// columns) of tiles and share the slabs of the longer axis from L2 (at
// mixtral's gate/up, D 4096 x F 14336: row tiles fastest; at down, D 14336
// x F 4096: column tiles fastest)
__device__ __forceinline__ DwTile dw_tile(int t, int m_tiles, int n_tiles) {
  const int per_e = m_tiles * n_tiles;
  const int local = t % per_e;
  if (m_tiles <= n_tiles) return {t / per_e, (local % m_tiles) * DW_BM, (local / m_tiles) * DW_BN};
  return {t / per_e, (local / n_tiles) * DW_BM, (local % n_tiles) * DW_BN};
}

// dw[e] (D x F) = x~[e]^T dy[e] over the live rows: tmap_x is x as (D, C, E)
// and tmap_dy is dy as (F, C, E), both in 64 x 64 boxes; tmap_dw is dw as
// (F, D, E) in 64 x 64 boxes.
__global__ void __launch_bounds__(W_THREADS, 1)
gmmbwd_dw_wgmma(const __grid_constant__ CUtensorMap tmap_x,
                const __grid_constant__ CUtensorMap tmap_dy,
                const __grid_constant__ CUtensorMap tmap_dw,
                const int* __restrict__ group_sizes, int E, int C, int D, int F) {
  extern __shared__ __align__(1024) uint8_t dw_smem_raw[];
  const uint32_t raw = smem_u32(dw_smem_raw);
  uint8_t* smem = dw_smem_raw + (((raw + 1023u) & ~1023u) - raw);
  uint8_t* as = smem;                                // [stage][2 boxes: 64 c x 64 d]
  uint8_t* bs = as + DW_STAGES * DW_A_BYTES;         // [stage][4 boxes: 64 c x 64 f]
  uint8_t* os = bs + DW_STAGES * DW_B_BYTES;         // [warpgroup][4 boxes: 64 d x 64 f]
  uint64_t* full = reinterpret_cast<uint64_t*>(os + DW_OUT_BYTES);
  uint64_t* empty = full + DW_STAGES;

  const int tid = threadIdx.x;
  const int m_tiles = (D + DW_BM - 1) / DW_BM, n_tiles = (F + DW_BN - 1) / DW_BN;
  const int total = E * m_tiles * n_tiles;
  if (tid == 0) {
#pragma unroll
    for (int s = 0; s < DW_STAGES; ++s) {
      mbar_init(smem_u32(&full[s]), 1);
      mbar_init(smem_u32(&empty[s]), 2);  // one arrival per consumer warpgroup
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  if (tid >= W_CONSUMERS) {  // producer warp: one thread issues the copies
    if (tid == W_CONSUMERS) {
      int it = 0;  // ring position, continued from tile to tile
      for (int t = blockIdx.x; t < total; t += gridDim.x) {
        const DwTile tl = dw_tile(t, m_tiles, n_tiles);
        const int nk = (live_rows(group_sizes, tl.e, C) + DW_BK - 1) / DW_BK;
        for (int kt = 0; kt < nk; ++kt, ++it) {
          const int s = it % DW_STAGES;
          mbar_wait(smem_u32(&empty[s]), ((it / DW_STAGES) & 1) ^ 1);
          const uint32_t fb = smem_u32(&full[s]);
          mbar_expect_tx(fb, DW_A_BYTES + DW_B_BYTES);
#pragma unroll
          for (int i = 0; i < DW_BM / 64; ++i)
            tma_load_3d(smem_u32(as + s * DW_A_BYTES + i * DW_BOX), &tmap_x, fb, tl.m0 + i * 64,
                        kt * DW_BK, tl.e);
#pragma unroll
          for (int i = 0; i < DW_BN / 64; ++i)
            tma_load_3d(smem_u32(bs + s * DW_B_BYTES + i * DW_BOX), &tmap_dy, fb,
                        tl.n0 + i * 64, kt * DW_BK, tl.e);
        }
      }
    }
    return;
  }

  // consumer warpgroup: rows wg*64 .. +64 of the tile; read through a shuffle
  // so ptxas knows it is the same in every lane of a warp (else it
  // serializes the wgmmas)
  const int wg = __shfl_sync(0xffffffffu, tid >> 7, 0);
  const int wtid = tid & 127, lane = tid & 31;
  uint8_t* ob = os + wg * (DW_OUT_BYTES / 2);
  float acc[128];
  int it = 0;
  for (int t = blockIdx.x; t < total; t += gridDim.x) {
    const DwTile tl = dw_tile(t, m_tiles, n_tiles);
    const int live = live_rows(group_sizes, tl.e, C);
    const int nk = (live + DW_BK - 1) / DW_BK;
    for (int kt = 0; kt < nk; ++kt, ++it) {
      const int s = it % DW_STAGES;
      mbar_wait(smem_u32(&full[s]), (it / DW_STAGES) & 1);
      uint8_t* a_box = as + s * DW_A_BYTES + wg * DW_BOX;
      const int lines = live - kt * DW_BK;  // live c-lines of this k-tile
      if (lines < DW_BK) {
        // the last k-tile: zero c-lines [lines, 64) of this warpgroup's x box
        // (TMA zero-filled only past C), 8 16-byte stores a 128-byte line, as
        // predicated stores of a fixed count (a loop whose trip count differs
        // between threads here makes ptxas serialize the wgmmas)
        uint4* box = reinterpret_cast<uint4*>(a_box);
#pragma unroll
        for (int j = 0; j < DW_BK * 8 / 128; ++j) {
          const int idx = j * 128 + wtid;
          if (idx >= lines * 8) box[idx] = make_uint4(0u, 0u, 0u, 0u);
        }
        fence_proxy_async();  // visible to wgmma, which reads through the async proxy
        named_barrier(1 + wg, 128);
      }
      wgmma_fence();
      const uint64_t da = gmma_desc_mn(smem_u32(a_box), DW_BOX);
      const uint64_t db = gmma_desc_mn(smem_u32(bs + s * DW_B_BYTES), DW_BOX);
#pragma unroll
      for (int j = 0; j < DW_BK / 16; ++j)  // 16 c-lines = 2048 bytes of either box
        wgmma_m64n256k16<1, 1>(acc, da + (2048 >> 4) * j, db + (2048 >> 4) * j,
                               kt > 0 || j > 0);
      wgmma_commit();
      wgmma_wait<1>();  // the product of step it-1 is done: release its stage
      if (kt > 0 && wtid == 0) mbar_arrive(smem_u32(&empty[(it - 1) % DW_STAGES]));
    }
    if (nk > 0) {
      wgmma_wait<0>();
      if (wtid == 0) mbar_arrive(smem_u32(&empty[(it - 1) % DW_STAGES]));
      fence_acc<128>(acc);
    }
    // no live row: dw[e] is zero (selected below, so that no instruction but
    // wgmma defines the accumulators)
    const bool keep = nk > 0;

    // epilogue: the previous tile's stores must have read the buffer first
    if (wtid == 0) bulk_wait_group_read<0>();
    named_barrier(1 + wg, 128);
    // accumulator fragment: row r = (warp%4)*16 + lane/4 (+8) of the warpgroup's
    // 64, columns 8c + 2*(lane%4) (+1)
    const int r = ((tid >> 5) & 3) * 16 + (lane >> 2);
#pragma unroll
    for (int c = 0; c < DW_BN / 8; ++c)
      stage_bf16(ob, c, r, lane, acc[4 * c], acc[4 * c + 1], acc[4 * c + 2], acc[4 * c + 3], keep,
                 keep);
    fence_proxy_async();  // the buffer's writes visible to the TMA store
    named_barrier(1 + wg, 128);
    if (wtid == 0) {  // rows past D and columns past F are clipped by the store
#pragma unroll
      for (int i = 0; i < DW_BN / 64; ++i)
        tma_store_3d(&tmap_dw, smem_u32(ob + i * DW_BOX), tl.n0 + i * 64, tl.m0 + wg * 64, tl.e);
      bulk_commit_group();
    }
  }
  if (wtid == 0) bulk_wait_group<0>();
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

// dx (E, C, D) = dy w^T on the body's stream-K schedule: tmap_dy is dy as
// (F, C, E) in 64 x 128 boxes, tmap_w is w as w^T, (F, D, E) in 64 x 256
// boxes, tmap_dx is dx as (D, C, E) in 64 x 64 boxes; `partials` and `flags`
// the workspace of gridDim.x slots.
__global__ void __launch_bounds__(W_THREADS, 1)
gmmbwd_dx_wgmma(const __grid_constant__ CUtensorMap tmap_dy,
                const __grid_constant__ CUtensorMap tmap_w,
                const __grid_constant__ CUtensorMap tmap_dx, const int* __restrict__ group_sizes,
                __nv_bfloat16* __restrict__ dx, float* __restrict__ partials,
                unsigned* __restrict__ flags, int E, int C, int D, int F) {
  extern __shared__ __align__(1024) uint8_t w_smem_raw[];
  gmm_wgmma_body<true, true>(&tmap_dy, &tmap_w, &tmap_dx, group_sizes, dx, partials, flags, E, C,
                             F, D, w_smem_raw);
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

// persistent blocks: one an SM, or one a tile when the tiles are fewer
int persistent_grid(int sms, long long tiles) {
  return static_cast<int>(tiles < sms ? (tiles > 0 ? tiles : 1) : sms);
}

// grid: the wrapper's (moe_gmm_bwd.py:dx_grid); workspace: grid slots of
// SK_PART_FLOATS floats, then grid flags
int launch_dx_wgmma(const void* dy, const void* w, const int* gs, void* dx, void* workspace,
                    int E, int C, int D, int F, long long sde, long long sdc, long long swe,
                    long long swd, int grid, cudaStream_t stream) {
  EncodeTiledFn encode = encode_tiled();
  if (encode == nullptr) return static_cast<int>(cudaErrorNotSupported);
  // the schedule's int arithmetic: a tile's k-steps x G below 2^31
  if (E > SK_MAX_E || grid < 1 || (long long)((F + W_BK - 1) / W_BK) * grid > INT_MAX ||
      workspace == nullptr || D % 8 || F % 8 || sde % 8 || sdc % 8 || swe % 8 || swd % 8 ||
      reinterpret_cast<uintptr_t>(dy) % 16 || reinterpret_cast<uintptr_t>(w) % 16 ||
      reinterpret_cast<uintptr_t>(dx) % 16 || reinterpret_cast<uintptr_t>(workspace) % 16)
    return static_cast<int>(cudaErrorInvalidValue);
  CUtensorMap tdy, tw, tdx;
  // dy (E, C, F) K-major in 64 x 128 boxes; w (E, D, F) as w^T, K-major, in
  // 64 x 256 boxes; dx (E, C, D) contiguous in 64 x 64 boxes
  if (encode_bf16_3d(encode, &tdy, dy, F, C, E, sdc, sde, W_BK, W_BM) != CUDA_SUCCESS ||
      encode_bf16_3d(encode, &tw, w, F, D, E, swd, swe, W_BK, W_BN) != CUDA_SUCCESS ||
      encode_bf16_3d(encode, &tdx, dx, D, C, E, D, (long long)C * D, 64, 64) != CUDA_SUCCESS)
    return static_cast<int>(cudaErrorInvalidValue);
  static bool configured = false;
  if (int err = set_smem(gmmbwd_dx_wgmma, SK_SMEM, configured)) return err;
  float* partials = static_cast<float*>(workspace);
  unsigned* flags = reinterpret_cast<unsigned*>(partials + (long long)grid * SK_PART_FLOATS);
  // the flags start at zero in every call (and every replay of a captured one)
  if (cudaError_t e = cudaMemsetAsync(flags, 0, grid * sizeof(unsigned), stream))
    return static_cast<int>(e);
  gmmbwd_dx_wgmma<<<grid, W_THREADS, SK_SMEM, stream>>>(
      tdy, tw, tdx, gs, static_cast<__nv_bfloat16*>(dx), partials, flags, E, C, D, F);
  return static_cast<int>(cudaGetLastError());
}

int launch_dw_wgmma(const void* x, const void* dy, const int* gs, void* dw, int E, int C, int D,
                    int F, long long sxe, long long sxc, long long sde, long long sdc, int sms,
                    cudaStream_t stream) {
  EncodeTiledFn encode = encode_tiled();
  if (encode == nullptr) return static_cast<int>(cudaErrorNotSupported);
  if (sms < 1 || D % 8 || F % 8 || sxe % 8 || sxc % 8 || sde % 8 || sdc % 8 ||
      reinterpret_cast<uintptr_t>(x) % 16 || reinterpret_cast<uintptr_t>(dy) % 16 ||
      reinterpret_cast<uintptr_t>(dw) % 16)
    return static_cast<int>(cudaErrorInvalidValue);
  CUtensorMap tx, tdy, tdw;
  // x (E, C, D) and dy (E, C, F) MN-major, dw (E, D, F) contiguous: 64 x 64 boxes
  if (encode_bf16_3d(encode, &tx, x, D, C, E, sxc, sxe, 64, 64) != CUDA_SUCCESS ||
      encode_bf16_3d(encode, &tdy, dy, F, C, E, sdc, sde, 64, 64) != CUDA_SUCCESS ||
      encode_bf16_3d(encode, &tdw, dw, F, D, E, F, (long long)D * F, 64, 64) != CUDA_SUCCESS)
    return static_cast<int>(cudaErrorInvalidValue);
  static bool configured = false;
  if (int err = set_smem(gmmbwd_dw_wgmma, DW_SMEM, configured)) return err;
  const int grid = persistent_grid(
      sms, (long long)E * ((D + DW_BM - 1) / DW_BM) * ((F + DW_BN - 1) / DW_BN));
  gmmbwd_dw_wgmma<<<grid, W_THREADS, DW_SMEM, stream>>>(tx, tdy, tdw, gs, E, C, D, F);
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
#define GBWD_PATH_WGMMA 1

// x: (E, C, D) with strides (sxe, sxc, 1); w: (E, D, F) with strides (swe,
// swd, 1); dy: (E, C, F) with strides (sde, sdc, 1); group_sizes: (E,) int32
// on the device, or null for all C rows; dx (E, C, D) and dw (E, D, F)
// contiguous, either null when not asked for.  dx_path, dw_path: fma (f32)
// or wgmma (bf16); dw's wgmma on a persistent grid of at most `sms` blocks,
// dx's on `dx_grid` blocks with `workspace` (dx_grid slots of
// SK_PART_FLOATS floats and dx_grid flags; null on fma).  bf16 needs D, F
// and every row and expert stride a multiple of 8 and 16-byte aligned x,
// w, dy (the wrapper checks).
extern "C" int moe_gmm_bwd(const void* x, const void* w, const void* group_sizes,
                           const void* dy, void* dx, void* dw, void* workspace, int dtype, int E,
                           int C, int D, int F, long long sxe, long long sxc, long long swe,
                           long long swd, long long sde, long long sdc, int dx_path, int dw_path,
                           int sms, int dx_grid, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int* gs = static_cast<const int*>(group_sizes);
  const bool bf16 = dtype == REPRO_BF16;
  if (!bf16 && dtype != REPRO_F32) return static_cast<int>(cudaErrorInvalidValue);
  if (dx != nullptr) {
    int err;
    if (dx_path == GBWD_PATH_WGMMA && bf16) {
      err = launch_dx_wgmma(dy, w, gs, dx, workspace, E, C, D, F, sde, sdc, swe, swd, dx_grid, s);
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
    if (dw_path == GBWD_PATH_WGMMA && bf16)
      return launch_dw_wgmma(x, dy, gs, dw, E, C, D, F, sxe, sxc, sde, sdc, sms, s);
    if (dw_path == GBWD_PATH_FMA && !bf16)
      return launch_fma<false>({static_cast<const float*>(x), sxe, sxc},
                               {static_cast<const float*>(dy), sde, sdc}, gs, dw, E, C, D, F, C,
                               s);
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return 0;
}
