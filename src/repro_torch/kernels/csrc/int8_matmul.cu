// K3: weight-only int8 GEMM, out = (x @ w_q) * scales, for Hopper (sm_90a).
//
// Replaces the TPU kernel src/repro/kernels/int8_matmul.py:int8_matmul
// (body _kernel): x (M, D) f32/bf16, w_q (D, N) int8, scales (N,) f32 per
// output channel, out (M, N) in x's dtype, accumulated in float32.  Every
// int8 value (|q| <= 127) is exact in bf16 and a bf16 x bf16 product is exact
// in float32, so the tensor-core path differs from the TPU kernel only in
// the order of its float32 sums.
//
// What bounds it on the H100: at decode M is the batch (4), so the kernel
// reads D*N weight bytes for 2*M*D*N operations -- far below the card's ~295
// operations per byte: bound by the bytes of the weights.  At prefill M = B*S
// (2048) every weight byte serves 2048 rows: bound by operations, which only
// the tensor cores deliver (989 TFLOP/s bf16 against 67 on the CUDA cores).
//
// Three paths; the wrapper (kernels/int8_matmul.py:plan) picks one by dtype
// and shape and says which:
//   wgmma  (bf16, M > 8, N % 16 == 0, x rows 16-byte aligned): one block of
//          2 consumer warpgroups + 1 producer warp per 128 x 128 tile of out.
//          The producer keeps a ring of TMA copies in flight (x tile 128 x 64
//          bf16, 128-byte swizzled; w tile 64 x 128 int8, half the bytes of a
//          bf16 weight tile), each stage signalled on an mbarrier.  The
//          consumers convert the int8 tile to bf16 in shared memory,
//          transposed to the K-major 128-byte-swizzled layout wgmma reads
//          (design (a): both operands in shared memory), then run
//          wgmma.m64n128k16.f32.bf16.bf16, each warpgroup 64 rows, keeping
//          one product group in flight while the next tile converts.  Every
//          converted element feeds 128 multiply-adds.  The epilogue scales
//          each column in float32, casts to bf16 and stores.  TMA zero-fills
//          the ragged edges of M, N and D.  What holds it back is shared
//          memory: per 64-deep step a block reads the int8 tile, writes the
//          bf16 tile and each warpgroup reads x and the bf16 tile, ~72 KB for
//          2 MFLOP.  Grids of two or more tiles per SM run two blocks per SM
//          (3 stages, 2 converted tiles), so one block's conversion and
//          epilogue overlap the other's products; smaller grids one (4 and 3).
//   stream (bf16, M <= 8, N % 16 == 0): decode.  Bound by the weight bytes,
//          so no tensor cores: each thread owns 16 columns and keeps 8
//          independent 16-byte weight loads in flight (8 rows of w), straight
//          to registers, no barrier per step; x's (M, D-slice) sits in shared
//          memory as float32 and M x 16 float32 accumulators live in
//          registers.  With M <= 2 the next 8 rows load while this 8 compute.
//          8 warps split a block's rows, and D is split across blocks to fill
//          the 132 SMs; the warps' sums, then the splits' sums (a second
//          kernel), are added in a fixed order, so the result does not depend
//          on scheduling.  No host sync and no allocation: a CUDA graph
//          captures it (SI2's decode step).
//   fma    (f32 always; bf16 shapes the two above do not take, e.g. N = 136,
//          whose w row stride TMA cannot address): float32 FMAs on the CUDA
//          cores, so f32 inputs compute in true float32 (no TF32) for the
//          1e-3 parity tests.  One block of 256 threads per BM x 128 tile
//          (BM = 128, or 16 for skinny M), 32-deep k-steps through shared
//          memory, split-D with a fixed-order reduction for skinny M.
#include "common.cuh"
#include "hopper.cuh"

namespace {

// ---------------------------------------------------------------- fma path

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
#pragma unroll 8
  for (int z = 0; z < splits; ++z) s += partial[z * total + idx];
  out[idx] = from_f32<T>(s * scales[idx % N]);
}

template <typename T>
void launch_reduce(const void* partial, const void* scales, void* out, int M, int N,
                   int splits, cudaStream_t stream) {
  const long long total = (long long)M * N;
  const int threads = 256;
  int8_gemm_reduce<T><<<(unsigned)((total + threads - 1) / threads), threads, 0, stream>>>(
      static_cast<const float*>(partial), static_cast<const float*>(scales),
      static_cast<T*>(out), M, N, splits);
}

template <typename T, int TM>
int launch_fma(const void* x, const void* w, const void* scales, void* out,
               void* partial, int M, int N, int D, long long sxm, int splits,
               int k_per_split, cudaStream_t stream) {
  constexpr int BM = 16 * TM;
  dim3 grid((N + BN - 1) / BN, (M + BM - 1) / BM, splits);
  int8_gemm_kernel<T, TM><<<grid, THREADS, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const int8_t*>(w),
      static_cast<const float*>(scales), static_cast<T*>(out),
      splits > 1 ? static_cast<float*>(partial) : nullptr, M, N, D, sxm,
      k_per_split);
  if (splits > 1) launch_reduce<T>(partial, scales, out, M, N, splits, stream);
  return static_cast<int>(cudaGetLastError());
}

// ------------------------------------------------------------- stream path

constexpr int S_WARPS = 8;
constexpr int S_THREADS = 32 * S_WARPS;
constexpr int S_UNROLL = 8;                    // weight rows in flight per thread
constexpr int S_COLS = 16;                     // columns per thread (one 16-byte load)
constexpr int S_STRIP = 32 * S_COLS;           // 512 columns per block
constexpr int S_ROWS = S_WARPS * S_UNROLL;     // 64: k_per_split is a multiple of it
constexpr int S_MAX_ROWS = S_WARPS * S_STRIP;  // 4096: the x slice fits the sum buffer

// 4 int8 (one word) -> 4 exact floats: (q ^ 0x80) in the low mantissa byte of
// 2^23 gives 2^23 + 128 + q; one subtraction leaves q.
__device__ __forceinline__ void i8x4_to_f32(uint32_t v, float* f) {
  const uint32_t u = v ^ 0x80808080u;
  f[0] = __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7440)) - 8388736.f;
  f[1] = __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7441)) - 8388736.f;
  f[2] = __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7442)) - 8388736.f;
  f[3] = __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7443)) - 8388736.f;
}

template <int MT>
constexpr int stream_smem_bytes() {
  return S_WARPS * MT * S_STRIP * static_cast<int>(sizeof(float));
}

// One block: columns [bx*512, +512) of rows [by*k_per_split, +k_per_split).
template <int MT>
__global__ void __launch_bounds__(S_THREADS)
int8_stream_kernel(const __nv_bfloat16* __restrict__ x, const int8_t* __restrict__ w,
                   const float* __restrict__ scales, __nv_bfloat16* __restrict__ out,
                   float* __restrict__ partial, int M, int N, int D, long long sxm,
                   int k_per_split) {
  extern __shared__ __align__(16) float s_smem[];
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int k_begin = blockIdx.y * k_per_split;
  const int rows = min(D - k_begin, k_per_split);
  const int rows_pad = (rows + S_ROWS - 1) / S_ROWS * S_ROWS;
  const int n = blockIdx.x * S_STRIP + lane * S_COLS;
  const bool live = n < N;  // N % 16 == 0: a live thread owns all 16 columns
  float* xs = s_smem;       // x's slice, filled below

  float acc[MT][S_COLS];
#pragma unroll
  for (int m = 0; m < MT; ++m)
#pragma unroll
    for (int c = 0; c < S_COLS; ++c) acc[m][c] = 0.f;

  const int8_t* wcol = w + (long long)k_begin * N + n;
  // one group: S_UNROLL independent 16-byte loads (rows past the split: zero, no access)
  auto load_group = [&](int4* q, int g) {
#pragma unroll
    for (int u = 0; u < S_UNROLL; ++u)
      q[u] = (live && g + u < rows)
                 ? __ldg(reinterpret_cast<const int4*>(wcol + (long long)(g + u) * N))
                 : make_int4(0, 0, 0, 0);
  };
  auto fma_group = [&](const int4* q, int g) {
#pragma unroll
    for (int u = 0; u < S_UNROLL; ++u) {
      float xv[MT];
      const float* xr = xs + (g + u) * MT;
      if constexpr (MT % 4 == 0) {
#pragma unroll
        for (int m = 0; m < MT; m += 4) {
          const float4 t = *reinterpret_cast<const float4*>(xr + m);
          xv[m] = t.x; xv[m + 1] = t.y; xv[m + 2] = t.z; xv[m + 3] = t.w;
        }
      } else {
#pragma unroll
        for (int m = 0; m < MT; ++m) xv[m] = xr[m];
      }
      const uint32_t words[4] = {static_cast<uint32_t>(q[u].x), static_cast<uint32_t>(q[u].y),
                                 static_cast<uint32_t>(q[u].z), static_cast<uint32_t>(q[u].w)};
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        float f[4];
        i8x4_to_f32(words[j], f);
#pragma unroll
        for (int m = 0; m < MT; ++m)
#pragma unroll
          for (int c = 0; c < 4; ++c) acc[m][4 * j + c] = fmaf(xv[m], f[c], acc[m][4 * j + c]);
      }
    }
  };
  // warp w takes the groups of S_UNROLL rows starting at w*S_UNROLL, + S_ROWS, ...
  // With M <= 2 the FMAs are few and the loads' latency shows, so the next
  // group loads while this one computes (and the first one across the x
  // slice's barrier); with more rows the FMAs hide it, and the second group
  // of registers would cost a block per SM.
  constexpr bool pipeline = MT <= 2;
  int4 qa[S_UNROLL];
  if constexpr (pipeline) load_group(qa, warp * S_UNROLL);

  // x[:M, k_begin:k_begin+rows) as float32, laid out [k][MT]; rows m >= M
  // and k >= rows are zero, so the loop below needs no bounds on x
  for (int i = tid; i < rows_pad * MT; i += S_THREADS) {
    const int kk = i / MT, m = i % MT;
    xs[i] = (m < M && kk < rows) ? __bfloat162float(x[(long long)m * sxm + k_begin + kk]) : 0.f;
  }
  __syncthreads();

  if constexpr (pipeline) {
    int4 qb[S_UNROLL];
    for (int g = warp * S_UNROLL; g < rows; g += 2 * S_ROWS) {
      load_group(qb, g + S_ROWS);
      fma_group(qa, g);
      load_group(qa, g + 2 * S_ROWS);
      if (g + S_ROWS < rows) fma_group(qb, g + S_ROWS);
    }
  } else {
    for (int g = warp * S_UNROLL; g < rows; g += S_ROWS) {
      load_group(qa, g);
      fma_group(qa, g);
    }
  }

  // the 8 warps' sums of the same columns, added in warp order
  __syncthreads();  // xs is no longer read: its space takes the sums
  float* red = s_smem;  // [warp][m][512]
#pragma unroll
  for (int m = 0; m < MT; ++m)
#pragma unroll
    for (int c = 0; c < S_COLS; c += 4)
      *reinterpret_cast<float4*>(red + (warp * MT + m) * S_STRIP + lane * S_COLS + c) =
          make_float4(acc[m][c], acc[m][c + 1], acc[m][c + 2], acc[m][c + 3]);
  __syncthreads();
  for (int i = tid; i < MT * S_STRIP; i += S_THREADS) {
    const int m = i / S_STRIP, col = i % S_STRIP;
    const int gn = blockIdx.x * S_STRIP + col;
    if (m >= M || gn >= N) continue;
    float s = 0.f;
#pragma unroll
    for (int wi = 0; wi < S_WARPS; ++wi) s += red[(wi * MT + m) * S_STRIP + col];
    if (partial != nullptr)
      partial[((long long)blockIdx.y * M + m) * N + gn] = s;
    else
      out[(long long)m * N + gn] = __float2bfloat16_rn(s * scales[gn]);
  }
}

template <int MT>
int launch_stream(const void* x, const void* w, const void* scales, void* out,
                  void* partial, int M, int N, int D, long long sxm, int splits,
                  int k_per_split, cudaStream_t stream) {
  if (k_per_split % S_ROWS != 0 || k_per_split > S_MAX_ROWS || N % 16 != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  constexpr int smem = stream_smem_bytes<MT>();
  static bool configured = false;  // one attribute call per instantiation
  if (!configured) {
    cudaError_t e = cudaFuncSetAttribute(int8_stream_kernel<MT>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return static_cast<int>(e);
    configured = true;
  }
  dim3 grid((N + S_STRIP - 1) / S_STRIP, splits);
  int8_stream_kernel<MT><<<grid, S_THREADS, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(x), static_cast<const int8_t*>(w),
      static_cast<const float*>(scales), static_cast<__nv_bfloat16*>(out),
      splits > 1 ? static_cast<float*>(partial) : nullptr, M, N, D, sxm, k_per_split);
  if (splits > 1) launch_reduce<__nv_bfloat16>(partial, scales, out, M, N, splits, stream);
  return static_cast<int>(cudaGetLastError());
}

// -------------------------------------------------------------- wgmma path

constexpr int G_BM = 128;                         // rows of out per block (2 warpgroups x 64)
constexpr int G_BN = 128;                         // columns of out per block
constexpr int G_BK = 64;                          // depth of one stage: 128 bytes of bf16
constexpr int G_CONSUMERS = 256;
constexpr int G_THREADS = G_CONSUMERS + 32;       // + one producer warp
constexpr int G_X_BYTES = G_BM * G_BK * 2;        // 16 KB
constexpr int G_W_BYTES = G_BK * G_BN;            // 8 KB of int8
constexpr int G_WB_BYTES = G_BN * G_BK * 2;       // 16 KB
// Two shapes of the same kernel, by blocks per SM (BPS):
//   BPS 1: a 4-stage TMA ring and 3 converted tiles (145 KB), for grids of
//          fewer than two tiles per SM;
//   BPS 2: 3 stages and 2 converted tiles (105 KB) and at most 112 registers
//          a thread, so two blocks share an SM and one block's prologue,
//          conversion and epilogue overlap the other's products.
template <int BPS> struct GCfg;
template <> struct GCfg<1> { static constexpr int STAGES = 4, WB = 3; };
template <> struct GCfg<2> { static constexpr int STAGES = 3, WB = 2; };
template <int BPS>
constexpr int g_smem_bytes() {
  return GCfg<BPS>::STAGES * (G_X_BYTES + G_W_BYTES) + GCfg<BPS>::WB * G_WB_BYTES +
         2 * GCfg<BPS>::STAGES * 8 + 1024;  // + alignment slack
}

// one m64n128k16 product: acc = A (64 x 16, smem) * B (16 x 128, smem)
// + (accumulate ? acc : 0)
__device__ __forceinline__ void wgmma_m64n128k16(float* d, uint64_t da, uint64_t db,
                                                 int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
      "}, %64, %65, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(accumulate));
}

// The stage's int8 tile [64 k][128 n] -> bf16 [128 n][64 k], K-major with the
// 128-byte swizzle (16-byte chunk c of row n at chunk c ^ (n % 8)), which is
// what TMA would have written and what the B descriptor reads.  Consumer
// thread ct converts 8 k x 4 n: k rows 8*(ct/32).., columns 4*(ct%32)..
// Reads: a warp reads 32 consecutive words of each k row (no bank conflict).
// Writes: each thread writes its 4 rows in an order rotated by (ct/2) % 4,
// so the 8 lanes of each store phase hit 8 distinct chunks (no conflict).
__device__ __forceinline__ void convert_w_tile(const uint8_t* __restrict__ src,
                                               uint8_t* __restrict__ dst, int ct) {
  const int kg = ct >> 5;
  const int ng = ct & 31;
  uint32_t wv[8];
#pragma unroll
  for (int k = 0; k < 8; ++k)
    wv[k] = *reinterpret_cast<const uint32_t*>(src + (kg * 8 + k) * G_BN + ng * 4) ^ 0x80808080u;
  uint4 o[4];
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    uint32_t packed[4];
#pragma unroll
    for (int p = 0; p < 4; ++p) {
      const float lo = __uint_as_float(__byte_perm(wv[2 * p], 0x4B000000u, 0x7440 | j)) - 8388736.f;
      const float hi = __uint_as_float(__byte_perm(wv[2 * p + 1], 0x4B000000u, 0x7440 | j)) - 8388736.f;
      const __nv_bfloat162 b = __floats2bfloat162_rn(lo, hi);
      packed[p] = *reinterpret_cast<const uint32_t*>(&b);
    }
    o[j] = make_uint4(packed[0], packed[1], packed[2], packed[3]);
  }
  const int r = (ng >> 1) & 3;
  if (r & 1) {
    const uint4 t = o[0];
    o[0] = o[1]; o[1] = o[2]; o[2] = o[3]; o[3] = t;
  }
  if (r & 2) {
    uint4 t = o[0]; o[0] = o[2]; o[2] = t;
    t = o[1]; o[1] = o[3]; o[3] = t;
  }
#pragma unroll
  for (int t = 0; t < 4; ++t) {
    const int n = ng * 4 + ((t + r) & 3);
    const int chunk = kg ^ (n & 7);
    *reinterpret_cast<uint4*>(dst + n * 128 + chunk * 16) = o[t];
  }
}

template <int BPS>
__global__ void __launch_bounds__(G_THREADS, BPS)
int8_wgmma_kernel(const __grid_constant__ CUtensorMap tmap_x,
                  const __grid_constant__ CUtensorMap tmap_w,
                  const float* __restrict__ scales, __nv_bfloat16* __restrict__ out,
                  int M, int N, int D) {
  constexpr int G_STAGES = GCfg<BPS>::STAGES;  // TMA ring
  constexpr int G_WB = GCfg<BPS>::WB;          // converted (bf16) weight tiles
  extern __shared__ __align__(1024) uint8_t g_smem_raw[];
  // the swizzled tiles need 1024-byte alignment in the shared window
  const uint32_t raw = smem_u32(g_smem_raw);
  uint8_t* smem = g_smem_raw + (((raw + 1023u) & ~1023u) - raw);
  uint8_t* xs = smem;                                  // [stage][128 m][64 k] bf16, swizzled
  uint8_t* ws = xs + G_STAGES * G_X_BYTES;             // [stage][64 k][128 n] int8
  uint8_t* wb = ws + G_STAGES * G_W_BYTES;             // [WB][128 n][64 k] bf16, swizzled
  uint64_t* full = reinterpret_cast<uint64_t*>(wb + G_WB * G_WB_BYTES);
  uint64_t* empty = full + G_STAGES;

  const int tid = threadIdx.x;
  const int m0 = blockIdx.y * G_BM;
  const int n0 = blockIdx.x * G_BN;
  const int ktiles = (D + G_BK - 1) / G_BK;

  if (tid == 0) {
#pragma unroll
    for (int s = 0; s < G_STAGES; ++s) {
      mbar_init(smem_u32(&full[s]), 1);
      mbar_init(smem_u32(&empty[s]), 2);  // one arrival per consumer warpgroup
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  if (tid >= G_CONSUMERS) {  // producer warp: one thread issues the copies
    if (tid == G_CONSUMERS) {
      for (int kt = 0; kt < ktiles; ++kt) {
        const int s = kt % G_STAGES;
        mbar_wait(smem_u32(&empty[s]), ((kt / G_STAGES) & 1) ^ 1);
        const uint32_t fb = smem_u32(&full[s]);
        mbar_expect_tx(fb, G_X_BYTES + G_W_BYTES);
        tma_load_2d(smem_u32(xs + s * G_X_BYTES), &tmap_x, fb, kt * G_BK, m0);
        tma_load_2d(smem_u32(ws + s * G_W_BYTES), &tmap_w, fb, n0, kt * G_BK);
      }
    }
    return;
  }

  const int wg = tid >> 7;  // consumer warpgroup: rows wg*64 .. +64 of the tile
  float acc[64];  // no initial value: the first product does not accumulate

  for (int kt = 0; kt < ktiles; ++kt) {
    const int s = kt % G_STAGES;
    mbar_wait(smem_u32(&full[s]), (kt / G_STAGES) & 1);
    uint8_t* wbuf = wb + (kt % G_WB) * G_WB_BYTES;
    // wbuf was last read by tile kt-G_WB.  With 3 buffers both warpgroups
    // finished it before the barrier of tile kt-1; with 2, they must first
    // both be past their wait of tile kt-1
    if constexpr (G_WB < 3) asm volatile("bar.sync 2, %0;" ::"n"(G_CONSUMERS) : "memory");
    convert_w_tile(ws + s * G_W_BYTES, wbuf, tid);
    asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
    asm volatile("bar.sync 1, %0;" ::"n"(G_CONSUMERS) : "memory");

    wgmma_fence();
    const uint64_t da = gmma_desc(smem_u32(xs + s * G_X_BYTES + wg * 64 * 128));
    const uint64_t db = gmma_desc(smem_u32(wbuf));
#pragma unroll
    for (int j = 0; j < G_BK / 16; ++j)  // 16 k = 32 bytes = 2 descriptor units
      wgmma_m64n128k16(acc, da + 2 * j, db + 2 * j, kt > 0 || j > 0);
    wgmma_commit();
    wgmma_wait<1>();  // the product of tile kt-1 is done: release its stage
    if (kt > 0 && (tid & 127) == 0) mbar_arrive(smem_u32(&empty[(kt - 1) % G_STAGES]));
  }
  wgmma_wait<0>();
  fence_acc<64>(acc);

  // accumulator fragment: row (warp%4)*16 + lane/4 (+8), column 8c + 2*(lane%4) (+1)
  const int lane = tid & 31;
  const int row0 = m0 + wg * 64 + ((tid >> 5) & 3) * 16 + (lane >> 2);
#pragma unroll
  for (int c = 0; c < G_BN / 8; ++c) {
    const int col = n0 + c * 8 + (lane & 3) * 2;
    if (col >= N) continue;  // N % 16 == 0: col + 1 < N as well
    const float2 sc = *reinterpret_cast<const float2*>(scales + col);
    if (row0 < M)
      *reinterpret_cast<__nv_bfloat162*>(out + (long long)row0 * N + col) =
          __floats2bfloat162_rn(acc[4 * c] * sc.x, acc[4 * c + 1] * sc.y);
    if (row0 + 8 < M)
      *reinterpret_cast<__nv_bfloat162*>(out + (long long)(row0 + 8) * N + col) =
          __floats2bfloat162_rn(acc[4 * c + 2] * sc.x, acc[4 * c + 3] * sc.y);
  }
}

template <int BPS>
int launch_wgmma(const void* x, const void* w, const void* scales, void* out, int M, int N,
                 int D, long long sxm, cudaStream_t stream) {
  EncodeTiledFn encode = encode_tiled();
  if (encode == nullptr) return static_cast<int>(cudaErrorNotSupported);
  if (N % 16 != 0 || sxm % 8 != 0 || reinterpret_cast<uintptr_t>(x) % 16 != 0 ||
      reinterpret_cast<uintptr_t>(w) % 16 != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  CUtensorMap tx, tw;
  const cuuint32_t ones[2] = {1, 1};
  const cuuint64_t x_dim[2] = {static_cast<cuuint64_t>(D), static_cast<cuuint64_t>(M)};
  const cuuint64_t x_stride[1] = {static_cast<cuuint64_t>(sxm) * 2};
  const cuuint32_t x_box[2] = {G_BK, G_BM};
  if (encode(&tx, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, const_cast<void*>(x), x_dim, x_stride,
             x_box, ones, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
             CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) != CUDA_SUCCESS)
    return static_cast<int>(cudaErrorInvalidValue);
  const cuuint64_t w_dim[2] = {static_cast<cuuint64_t>(N), static_cast<cuuint64_t>(D)};
  const cuuint64_t w_stride[1] = {static_cast<cuuint64_t>(N)};
  const cuuint32_t w_box[2] = {G_BN, G_BK};
  if (encode(&tw, CU_TENSOR_MAP_DATA_TYPE_UINT8, 2, const_cast<void*>(w), w_dim, w_stride,
             w_box, ones, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_NONE,
             CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) != CUDA_SUCCESS)
    return static_cast<int>(cudaErrorInvalidValue);
  static bool configured = false;
  if (!configured) {
    cudaError_t e = cudaFuncSetAttribute(int8_wgmma_kernel<BPS>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         g_smem_bytes<BPS>());
    if (e != cudaSuccess) return static_cast<int>(e);
    configured = true;
  }
  dim3 grid((N + G_BN - 1) / G_BN, (M + G_BM - 1) / G_BM);
  int8_wgmma_kernel<BPS><<<grid, G_THREADS, g_smem_bytes<BPS>(), stream>>>(
      tx, tw, static_cast<const float*>(scales), static_cast<__nv_bfloat16*>(out), M, N, D);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Paths, as kernels/int8_matmul.py numbers them.
#define INT8_PATH_FMA 0
#define INT8_PATH_STREAM 1
#define INT8_PATH_WGMMA 2

// x: (M, D) with row stride sxm and unit column stride; w: (D, N) int8
// contiguous; scales: (N,) f32; out: (M, N) contiguous; partial: (splits, M,
// N) f32 scratch, used when splits > 1.  tile: rows per thread (1 or 8) on
// the fma path, the padded row count MT (1, 2, 4 or 8) on the stream path,
// blocks per SM (1 or 2) on the wgmma path.
extern "C" int int8_matmul_fwd(const void* x, const void* w, const void* scales,
                               void* out, void* partial, int dtype, int M,
                               int N, int D, long long sxm, int path, int splits,
                               int k_per_split, int tile, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (path == INT8_PATH_WGMMA) {
    if (dtype != REPRO_BF16) return static_cast<int>(cudaErrorInvalidValue);
    if (tile == 2) return launch_wgmma<2>(x, w, scales, out, M, N, D, sxm, s);
    return launch_wgmma<1>(x, w, scales, out, M, N, D, sxm, s);
  }
  if (path == INT8_PATH_STREAM) {
    if (dtype != REPRO_BF16) return static_cast<int>(cudaErrorInvalidValue);
    switch (tile) {
      case 1: return launch_stream<1>(x, w, scales, out, partial, M, N, D, sxm, splits, k_per_split, s);
      case 2: return launch_stream<2>(x, w, scales, out, partial, M, N, D, sxm, splits, k_per_split, s);
      case 4: return launch_stream<4>(x, w, scales, out, partial, M, N, D, sxm, splits, k_per_split, s);
      case 8: return launch_stream<8>(x, w, scales, out, partial, M, N, D, sxm, splits, k_per_split, s);
      default: return static_cast<int>(cudaErrorInvalidValue);
    }
  }
  if (path != INT8_PATH_FMA) return static_cast<int>(cudaErrorInvalidValue);
  if (dtype == REPRO_F32) {
    if (tile == 8)
      return launch_fma<float, 8>(x, w, scales, out, partial, M, N, D, sxm, splits, k_per_split, s);
    return launch_fma<float, 1>(x, w, scales, out, partial, M, N, D, sxm, splits, k_per_split, s);
  }
  if (tile == 8)
    return launch_fma<__nv_bfloat16, 8>(x, w, scales, out, partial, M, N, D, sxm, splits, k_per_split, s);
  return launch_fma<__nv_bfloat16, 1>(x, w, scales, out, partial, M, N, D, sxm, splits, k_per_split, s);
}
