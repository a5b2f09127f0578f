// K1 backward: the gradients of causal / sliding-window GQA prefill attention
// from its output and row log-sum-exp, for Hopper (sm_90a).
//
// Replaces the backward of the JAX package's attention, the custom VJP's
// src/repro/models/attention.py:_attention_bwd_rule, on the card: the TPU
// kernel (src/repro/kernels/flash_attention.py:flash_attention) has no
// backward of its own, and the port's training path runs K1 forward, so
// this kernel takes the place of the rule's block-wise flash backward.
// q, o, do (B, H, Sq, dh), k/v (B, K, T, dh) in f32 or bf16, read by stride
// (the model's (B, S, heads, dh) activations in place); lse and delta
// (B, H, Sq) f32 contiguous.  Query head h reads kv head h / (H / K).  The
// arithmetic of the rule, in float32:
//   delta = rowsum(do * o);  p = exp(scale q.k - lse), 0 where masked;
//   dv = p^T do;  ds = p (do.v - delta) scale;  dq = ds k;  dk = ds^T q,
// dk and dv summed over the G query heads of each kv head.  dq, dk, dv are
// written in the inputs' dtype.
//
// What bounds it on the H100: five products of 2*Sq*T*dh operations per
// (b, q head), halved by a causal mask -- at minitron-4b's B2 H24 S512 dh128
// about 8 GFLOP over 30 MB: bound by operations, on the tensor cores.  Both
// paths recompute s and dp in each of their two main kernels (7 products
// instead of 5), the price of writing no (Sq, T) tensor and taking no
// atomics: two calls give the same bits.
//
// Two paths; the wrapper (kernels/flash_attention_bwd.py:plan) picks one by
// dtype and layout and says which:
//   mma  (bf16, every (b, s, head) stride a multiple of 8 elements and
//        16-byte aligned bases: the model's layouts): FlashAttention-2's
//        backward on mma.sync.m16n8k16 (bf16 in, f32 accumulate) with K1
//        forward's tiles, copies and fragments (mma.cuh).  Bound by the
//        tensor cores' issue rate and by ldmatrix's shared-memory reads (each
//        warp reads its B operands whole for 16 rows of A), and under a
//        causal mask by the work of the first kv tiles.  Up to four
//        launches; after delta, the dk/dv kernel runs on the caller's stream
//        and the dq pass beside it on a second stream (forked and joined by
//        events, so a CUDA graph captures both): its blocks fill the SMs the
//        dk/dv kernel's causal tail leaves idle.
//        attn_bwd_delta       delta = rowsum(do * o) in f32, 16 lanes a row,
//                             into the (B, H, Sq) scratch, so delta does not
//                             depend on how the dq pass is split.
//        attn_bwd_mma_dq      one block of 4 warps per (64-row q tile, q head,
//                             batch, kv split), 16 q rows a warp.  Q and dO
//                             fragments stay in registers; K/V tiles arrive
//                             through a double-buffered cp.async ring.  S = Q K^T
//                             and dP = dO V^T on mma; P = exp2(S scale log2e -
//                             lse log2e) and dS = P (dP - delta) scale on the
//                             accumulator fragments; dS rounded to bf16 is the A
//                             operand of dQ += dS K (K through ldmatrix.trans),
//                             as the forward's P V.  The heaviest (last) causal
//                             q tiles launch first.
//        attn_bwd_dq_reduce   only where the plan splits the kv range (too
//                             few q tiles to fill the card, e.g. whisper's
//                             cross attention, Sq 64 against T 1500): each
//                             split wrote an f32 partial dq; the partials are
//                             summed in split order and dq written in bf16.
//        attn_bwd_mma_dkdv    one block of 8 warps per (64-row kv tile, kv head,
//                             batch): two groups of 4 warps, 16 kv rows a warp,
//                             each group walking every other one of the (query
//                             head of the kv head's G, live q tile) pairs with
//                             a ring of its own for Q, dO, lse and delta; group
//                             1's sums are added to group 0's through shared
//                             memory in that fixed order.  A one-group block
//                             left an SM 4 warps where the kv tiles are few
//                             (minitron-4b's training shape: 128 blocks for
//                             132 SMs, the first walking 24 q tiles).  It computes
//                             the transposed tiles S^T = K Q^T and dP^T = V dO^T,
//                             whose accumulators are already the A fragments of
//                             dV += P^T dO and dK += dS^T Q (dO and Q through
//                             ldmatrix.trans): P^T and dS^T never touch shared
//                             memory.  K/V fragments are reloaded from shared
//                             memory at each k-step rather than held, so that
//                             the two 16 x dh f32 accumulators fit in registers
//                             at dh 128.  The heaviest (first) causal kv tiles
//                             launch first.
//        Tiles are bf16 with rows padded by 16 bytes; the dq kernel holds 6
//        (102 KB at dh 128, 66 KB at dh 80: two blocks an SM), the dk/dv kernel
//        10 (172 KB at dh 128, 110 KB at dh 80: one block of 8 warps).  Tiles
//        wholly outside the causal diagonal or the window are skipped; only
//        diagonal, window-edge and T- or Sq-edge tiles are masked.
//        Numerics: the rule rounds q scale, do and ds to bf16 for a bf16 model
//        and keeps p and ds in f32 for dv and dk; this path scales S in f32,
//        and also rounds P^T and dS^T to bf16 for the dV and dK products: at
//        most 2^-9 relative error per term, the forward's P V argument, inside
//        the 2e-2 bf16 tolerance.  lse arrives in natural-log units and is
//        multiplied by log2e once.  A row that sees no key (lse -1e30) or lies
//        past Sq gets lse log2e = +inf, so exp2 of any score minus it is 0:
//        p = 0 by a select per row, never an exp of a huge product.
//   fma  (f32 always, so the 2e-4 parity tests see true float32; bf16 in a
//        layout the copies cannot take): two kernels that run the products as
//        float32 FMAs on the CUDA cores (67 TFLOP/s peak) from shared memory,
//        bound by the CUDA cores' FMA and shared-memory load rate.
//        attn_bwd_dq_kernel    one block of 256 threads per (64-row q tile, q
//                              head, batch).  Its prologue computes delta for
//                              the tile's rows from do and o and writes it out;
//                              then it walks the kv tiles the masks leave live
//                              (the window's first tile to the causal
//                              diagonal), recomputing s and dp, and accumulates
//                              dq in registers (four threads a row, dh/4
//                              columns each).
//        attn_bwd_dkdv_kernel  one block per (64-row kv tile, kv head, batch),
//                              launched after the dq kernel on the same stream
//                              (it reads delta).  It holds k and v of its tile
//                              and walks the G query heads of its group and the
//                              q tiles that can see a key of the tile,
//                              recomputing p and ds, and accumulates dk and dv
//                              in registers.
//        Tiles are float32 in shared memory with rows padded by one float (no
//        bank conflicts in the 16x16-thread score products); at dh 128 the
//        dk/dv kernel holds 162 KB, the dq kernel 146 KB: one block per SM.  A
//        q row at or past Sq, a key at or past T and every masked pair give
//        p = 0 by a select (never a product with exp of -inf), so a row with
//        every key masked gets zeros.
#include "mma.cuh"

namespace {

// ---------------------------------------------------------------- fma path

constexpr int BQ = 64;        // q rows of a tile
constexpr int BKV = 64;       // kv rows of a tile
constexpr int THREADS = 256;  // 16 x 16 for the score products; 4 a row for the rest
constexpr int PS = BKV + 1;   // padded row of a (BQ, BKV) score tile

struct Strides {  // element strides of (b, s, h) for one tensor; d is 1
  long long b, s, h;
};

template <int DH>
__host__ __device__ constexpr int rs() { return DH + 1; }  // padded f32 row of a tile

// rows [s0, s0 + 64) of one head into a padded float32 tile; rows >= limit are 0
template <typename T, int DH>
__device__ __forceinline__ void load_rows(float* dst, const T* base, long long stride_s,
                                          int s0, int limit, int tid) {
  for (int i = tid; i < 64 * DH; i += THREADS) {
    const int r = i / DH, d = i % DH;
    const int s = s0 + r;
    dst[r * rs<DH>() + d] = s < limit ? to_f32(base[(long long)s * stride_s + d]) : 0.f;
  }
}

__device__ __forceinline__ bool visible(int i, int j, int Sq, int T_len, int causal,
                                        int window) {
  bool ok = i < Sq && j < T_len;
  if (causal) ok = ok && j <= i;
  if (window >= 0) ok = ok && j > i - window;
  return ok;
}

// For the tile pair (q rows q0.., keys k0..): s = q.k and dp = do.v, each
// thread 4 x 4 of them (rows ty + 16a, keys tx + 16b), then p and ds into
// shared memory (p only where Ps is given).
template <int DH>
__device__ __forceinline__ void score_tiles(const float* Qs, const float* dOs, const float* Ks,
                                            const float* Vs, const float* lse_s,
                                            const float* delta_s, float* Ps, float* dSs, int q0,
                                            int k0, int Sq, int T_len, int causal, int window,
                                            float scale, int tid) {
  const int tx = tid % 16, ty = tid / 16;
  float s[4][4], dp[4][4];
#pragma unroll
  for (int a = 0; a < 4; ++a)
#pragma unroll
    for (int b = 0; b < 4; ++b) s[a][b] = dp[a][b] = 0.f;
#pragma unroll 4
  for (int d = 0; d < DH; ++d) {
    float qa[4], oa[4], kb[4], vb[4];
#pragma unroll
    for (int a = 0; a < 4; ++a) {
      qa[a] = Qs[(ty + 16 * a) * rs<DH>() + d];
      oa[a] = dOs[(ty + 16 * a) * rs<DH>() + d];
      kb[a] = Ks[(tx + 16 * a) * rs<DH>() + d];
      vb[a] = Vs[(tx + 16 * a) * rs<DH>() + d];
    }
#pragma unroll
    for (int a = 0; a < 4; ++a)
#pragma unroll
      for (int b = 0; b < 4; ++b) {
        s[a][b] = fmaf(qa[a], kb[b], s[a][b]);
        dp[a][b] = fmaf(oa[a], vb[b], dp[a][b]);
      }
  }
#pragma unroll
  for (int a = 0; a < 4; ++a) {
    const int i = ty + 16 * a;
#pragma unroll
    for (int b = 0; b < 4; ++b) {
      const int j = tx + 16 * b;
      const bool ok = visible(q0 + i, k0 + j, Sq, T_len, causal, window);
      const float p = ok ? expf(s[a][b] * scale - lse_s[i]) : 0.f;
      if (Ps != nullptr) Ps[i * PS + j] = p;
      dSs[i * PS + j] = p * (dp[a][b] - delta_s[i]) * scale;
    }
  }
}

template <int DH>
constexpr int dq_smem_floats() {
  return 2 * BQ * rs<DH>() + 2 * BKV * rs<DH>() + BQ * PS + 2 * BQ;
}
template <int DH>
constexpr int dkdv_smem_floats() {
  return 2 * BQ * rs<DH>() + 2 * BKV * rs<DH>() + 2 * BQ * PS + 2 * BQ;
}

template <typename T, int DH>
__global__ void __launch_bounds__(THREADS)
attn_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                   const T* __restrict__ o, const T* __restrict__ dout,
                   const float* __restrict__ lse, float* __restrict__ delta,
                   T* __restrict__ dq, int H, int K, int Sq, int T_len, Strides sq,
                   Strides sk, Strides sv, Strides so, Strides sdo, Strides sdq, int causal,
                   int window, float scale) {
  extern __shared__ float smem[];
  float* Qs = smem;                    // [BQ][DH+1]
  float* dOs = Qs + BQ * rs<DH>();     // [BQ][DH+1]
  float* Ks = dOs + BQ * rs<DH>();     // [BKV][DH+1]
  float* Vs = Ks + BKV * rs<DH>();     // [BKV][DH+1]
  float* dSs = Vs + BKV * rs<DH>();    // [BQ][BKV+1]
  float* lse_s = dSs + BQ * PS;        // [BQ]
  float* delta_s = lse_s + BQ;         // [BQ]

  const int tid = threadIdx.x;
  const int r = tid / 4;  // this thread's q row in the tile
  const int c = tid % 4;  // its column phase: columns c, c + 4, ...
  const int q0 = blockIdx.x * BQ;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int kh = h / (H / K);
  const long long row0 = ((long long)b * H + h) * Sq;  // lse / delta row of (b, h, 0)

  load_rows<T, DH>(Qs, q + b * sq.b + h * sq.h, sq.s, q0, Sq, tid);
  load_rows<T, DH>(dOs, dout + b * sdo.b + h * sdo.h, sdo.s, q0, Sq, tid);
  __syncthreads();

  // delta = rowsum(do * o), four threads a row
  const int qp = q0 + r;
  float part = 0.f;
  if (qp < Sq) {
    const T* orow = o + b * so.b + (long long)qp * so.s + h * so.h;
    for (int d = c; d < DH; d += 4) part = fmaf(dOs[r * rs<DH>() + d], to_f32(orow[d]), part);
  }
  part += __shfl_xor_sync(0xffffffffu, part, 1);
  part += __shfl_xor_sync(0xffffffffu, part, 2);
  if (c == 0) {
    delta_s[r] = part;
    lse_s[r] = qp < Sq ? lse[row0 + qp] : 0.f;
    if (qp < Sq) delta[row0 + qp] = part;
  }

  constexpr int NT = DH / 4;
  float acc[NT];
#pragma unroll
  for (int t = 0; t < NT; ++t) acc[t] = 0.f;

  // the kv tiles this q tile can see: the window's first key to the diagonal
  const int kv_end = causal ? min(T_len, q0 + BQ) : T_len;
  int kv_begin = window >= 0 ? max(0, q0 - window + 1) : 0;
  kv_begin = (kv_begin / BKV) * BKV;
  const T* kb = k + b * sk.b + kh * sk.h;
  const T* vb = v + b * sv.b + kh * sv.h;
  for (int k0 = kv_begin; k0 < kv_end; k0 += BKV) {
    __syncthreads();  // the previous tile's Ks, Vs and dSs are read
    load_rows<T, DH>(Ks, kb, sk.s, k0, T_len, tid);
    load_rows<T, DH>(Vs, vb, sv.s, k0, T_len, tid);
    __syncthreads();
    score_tiles<DH>(Qs, dOs, Ks, Vs, lse_s, delta_s, nullptr, dSs, q0, k0, Sq, T_len, causal,
                    window, scale, tid);
    __syncthreads();
    const float* dsrow = dSs + r * PS;
#pragma unroll 4
    for (int j = 0; j < BKV; ++j) {
      const float ds = dsrow[j];
      const float* krow = Ks + j * rs<DH>() + c;
#pragma unroll
      for (int t = 0; t < NT; ++t) acc[t] = fmaf(ds, krow[4 * t], acc[t]);
    }
  }
  if (qp < Sq) {
    T* out = dq + b * sdq.b + (long long)qp * sdq.s + h * sdq.h;
#pragma unroll
    for (int t = 0; t < NT; ++t) out[c + 4 * t] = from_f32<T>(acc[t]);
  }
}

template <typename T, int DH>
__global__ void __launch_bounds__(THREADS)
attn_bwd_dkdv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                     const T* __restrict__ v, const T* __restrict__ dout,
                     const float* __restrict__ lse, const float* __restrict__ delta,
                     T* __restrict__ dk, T* __restrict__ dv, int H, int K, int Sq, int T_len,
                     Strides sq, Strides sk, Strides sv, Strides sdo, Strides sdk,
                     Strides sdv, int causal, int window, float scale) {
  extern __shared__ float smem[];
  float* Ks = smem;                    // [BKV][DH+1]
  float* Vs = Ks + BKV * rs<DH>();     // [BKV][DH+1]
  float* Qs = Vs + BKV * rs<DH>();     // [BQ][DH+1]
  float* dOs = Qs + BQ * rs<DH>();     // [BQ][DH+1]
  float* Ps = dOs + BQ * rs<DH>();     // [BQ][BKV+1]
  float* dSs = Ps + BQ * PS;           // [BQ][BKV+1]
  float* lse_s = dSs + BQ * PS;        // [BQ]
  float* delta_s = lse_s + BQ;         // [BQ]

  const int tid = threadIdx.x;
  const int r = tid / 4;  // this thread's key row in the tile
  const int c = tid % 4;  // its column phase
  const int k0 = blockIdx.x * BKV;
  const int kh = blockIdx.y;
  const int b = blockIdx.z;
  const int G = H / K;

  load_rows<T, DH>(Ks, k + b * sk.b + kh * sk.h, sk.s, k0, T_len, tid);
  load_rows<T, DH>(Vs, v + b * sv.b + kh * sv.h, sv.s, k0, T_len, tid);

  constexpr int NT = DH / 4;
  float dk_acc[NT], dv_acc[NT];
#pragma unroll
  for (int t = 0; t < NT; ++t) dk_acc[t] = dv_acc[t] = 0.f;

  // the q rows that can see a key of this tile: from the diagonal (causal)
  // to the last key's window
  const int k_last = min(T_len, k0 + BKV) - 1;
  const int q_begin = causal ? (k0 / BQ) * BQ : 0;
  const int q_end = window >= 0 ? min(Sq, k_last + window) : Sq;
  for (int g = 0; g < G; ++g) {
    const int h = kh * G + g;
    const long long row0 = ((long long)b * H + h) * Sq;
    for (int q0 = q_begin; q0 < q_end; q0 += BQ) {
      __syncthreads();  // the previous q tile's Qs, dOs, Ps and dSs are read
      load_rows<T, DH>(Qs, q + b * sq.b + h * sq.h, sq.s, q0, Sq, tid);
      load_rows<T, DH>(dOs, dout + b * sdo.b + h * sdo.h, sdo.s, q0, Sq, tid);
      if (tid < BQ) {
        const bool in = q0 + tid < Sq;
        lse_s[tid] = in ? lse[row0 + q0 + tid] : 0.f;
        delta_s[tid] = in ? delta[row0 + q0 + tid] : 0.f;
      }
      __syncthreads();
      score_tiles<DH>(Qs, dOs, Ks, Vs, lse_s, delta_s, Ps, dSs, q0, k0, Sq, T_len, causal,
                      window, scale, tid);
      __syncthreads();
#pragma unroll 4
      for (int i = 0; i < BQ; ++i) {
        const float p = Ps[i * PS + r];
        const float ds = dSs[i * PS + r];
        const float* dorow = dOs + i * rs<DH>() + c;
        const float* qrow = Qs + i * rs<DH>() + c;
#pragma unroll
        for (int t = 0; t < NT; ++t) {
          dv_acc[t] = fmaf(p, dorow[4 * t], dv_acc[t]);
          dk_acc[t] = fmaf(ds, qrow[4 * t], dk_acc[t]);
        }
      }
    }
  }
  const int kp = k0 + r;
  if (kp < T_len) {
    T* dkrow = dk + b * sdk.b + (long long)kp * sdk.s + kh * sdk.h;
    T* dvrow = dv + b * sdv.b + (long long)kp * sdv.s + kh * sdv.h;
#pragma unroll
    for (int t = 0; t < NT; ++t) {
      dkrow[c + 4 * t] = from_f32<T>(dk_acc[t]);
      dvrow[c + 4 * t] = from_f32<T>(dv_acc[t]);
    }
  }
}

struct Args {
  const void *q, *k, *v, *o, *dout;
  const float* lse;
  float* delta;
  void *dq, *dk, *dv;
  int B, H, K, Sq, T_len;
  Strides sq, sk, sv, so, sdo, sdq, sdk, sdv;
  int causal, window;
  float scale;
};

template <typename F>
int allow_smem(F* kernel, int bytes) {
  return static_cast<int>(
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes));
}

template <typename T, int DH>
int launch_fma(const Args& a, cudaStream_t stream) {
  constexpr int dq_smem = dq_smem_floats<DH>() * sizeof(float);
  constexpr int dkdv_smem = dkdv_smem_floats<DH>() * sizeof(float);
  static bool configured = false;  // one attribute call per instantiation
  if (!configured) {
    int e = allow_smem(attn_bwd_dq_kernel<T, DH>, dq_smem);
    if (e == 0) e = allow_smem(attn_bwd_dkdv_kernel<T, DH>, dkdv_smem);
    if (e != 0) return e;
    configured = true;
  }
  const T *q = static_cast<const T*>(a.q), *k = static_cast<const T*>(a.k),
          *v = static_cast<const T*>(a.v);
  attn_bwd_dq_kernel<T, DH><<<dim3((a.Sq + BQ - 1) / BQ, a.H, a.B), THREADS, dq_smem, stream>>>(
      q, k, v, static_cast<const T*>(a.o), static_cast<const T*>(a.dout), a.lse, a.delta,
      static_cast<T*>(a.dq), a.H, a.K, a.Sq, a.T_len, a.sq, a.sk, a.sv, a.so, a.sdo, a.sdq,
      a.causal, a.window, a.scale);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  attn_bwd_dkdv_kernel<T, DH>
      <<<dim3((a.T_len + BKV - 1) / BKV, a.K, a.B), THREADS, dkdv_smem, stream>>>(
          q, k, v, static_cast<const T*>(a.dout), a.lse, a.delta, static_cast<T*>(a.dk),
          static_cast<T*>(a.dv), a.H, a.K, a.Sq, a.T_len, a.sq, a.sk, a.sv, a.sdo, a.sdk,
          a.sdv, a.causal, a.window, a.scale);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int dispatch_dh(int dh, const Args& a, cudaStream_t s) {
  switch (dh) {
    case 32: return launch_fma<T, 32>(a, s);
    case 64: return launch_fma<T, 64>(a, s);
    case 80: return launch_fma<T, 80>(a, s);
    case 128: return launch_fma<T, 128>(a, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// ---------------------------------------------------------------- mma path

constexpr int MQ = MMA_ROWS;    // q rows of a tile, 16 per warp
constexpr int MKV = MMA_ROWS;   // kv rows of a tile, 16 per warp in the dk/dv kernel
constexpr int M_THREADS = MMA_THREADS;
constexpr float LOG2E = 1.4426950408889634f;
constexpr int DELTA_ROWS = 16;  // rows of attn_bwd_delta's 256-thread block, 16 lanes each

typedef __nv_bfloat16 bf16;

template <int DH>
__host__ __device__ constexpr int mma_tile_elems() { return MQ * mma_stride<DH>(); }
constexpr int DKDV_GROUPS = 2;  // warp groups of the dk/dv kernel, each over its own q tiles
constexpr int DKDV_THREADS = DKDV_GROUPS * M_THREADS;
// dq: Q, dO, K x2, V x2; dk/dv: K, V, and per group Q x2, dO x2 and the lse
// and delta of its two q tiles
template <int DH>
__host__ __device__ constexpr int mma_dq_smem() { return 6 * mma_tile_elems<DH>() * 2; }
template <int DH>
__host__ __device__ constexpr int mma_dkdv_smem() {
  return (2 + 4 * DKDV_GROUPS) * mma_tile_elems<DH>() * 2 + DKDV_GROUPS * 4 * MQ * 4;
}

// lse of a q row (natural log) in log2 units; +inf where the row sees no key
// (lse -1e30), so that exp2(x - it) is 0 for every score x
__device__ __forceinline__ float lse_log2(float lse) {
  return lse < 0.5f * REPRO_NEG_INF ? INFINITY : lse * LOG2E;
}

__global__ void __launch_bounds__(256)
attn_bwd_delta(const bf16* __restrict__ o, const bf16* __restrict__ dout,
               float* __restrict__ delta, int H, int Sq, int dh, Strides so, Strides sdo,
               long long rows) {
  const long long r = (long long)blockIdx.x * DELTA_ROWS + threadIdx.x / 16;
  const int c = threadIdx.x % 16;  // this lane's 8 columns
  float part = 0.f;
  if (r < rows && c * 8 < dh) {
    const int i = static_cast<int>(r % Sq);
    const long long bh = r / Sq;
    const int h = static_cast<int>(bh % H), b = static_cast<int>(bh / H);
    float x[8], y[8];
    unpack16(o + b * so.b + (long long)i * so.s + h * so.h + c * 8, x);
    unpack16(dout + b * sdo.b + (long long)i * sdo.s + h * sdo.h + c * 8, y);
#pragma unroll
    for (int e = 0; e < 8; ++e) part = fmaf(x[e], y[e], part);
  }
#pragma unroll
  for (int m = 8; m > 0; m >>= 1) part += __shfl_xor_sync(0xffffffffu, part, m);
  if (r < rows && c == 0) delta[r] = part;
}

template <int DH>
__global__ void __launch_bounds__(M_THREADS)
attn_bwd_mma_dq(const bf16* __restrict__ q, const bf16* __restrict__ k,
                const bf16* __restrict__ v, const bf16* __restrict__ dout,
                const float* __restrict__ lse, const float* __restrict__ delta,
                bf16* __restrict__ dq, float* __restrict__ dq_part, int H, int K, int Sq,
                int T_len, Strides sq, Strides sk, Strides sv, Strides sdo, Strides sdq,
                int causal, int window, float scale, int splits, int chunk) {
  constexpr int STRIDE = mma_stride<DH>();
  constexpr int TILE = mma_tile_elems<DH>();
  constexpr int NT = MKV / 8;   // 8-column tiles of S
  constexpr int OT = DH / 8;    // 8-column tiles of dQ
  constexpr int KS = DH / 16;   // k-steps over dh
  extern __shared__ __align__(16) bf16 qsm[];
  bf16* Qs = qsm;
  bf16* dOs = qsm + TILE;
  bf16* Ks = qsm + 2 * TILE;  // [2][MKV][STRIDE]
  bf16* Vs = qsm + 4 * TILE;  // [2][MKV][STRIDE]

  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int h = blockIdx.x;
  const int b = blockIdx.y;
  const int split = blockIdx.z % splits;
  const int q0 = (gridDim.z / splits - 1 - blockIdx.z / splits) * MQ;  // last q tiles first
  const int kh = h / (H / K);
  const bf16* kb = k + b * sk.b + kh * sk.h;
  const bf16* vb = v + b * sv.b + kh * sv.h;
  const long long row0 = ((long long)b * H + h) * Sq;  // lse / delta row of (b, h, 0)

  // the kv tiles this q tile can see (the window's first key to the
  // diagonal), cut to this split's range
  int kv_end = causal ? min(T_len, q0 + MQ) : T_len;
  int kv_begin = window >= 0 ? max(0, q0 - window + 1) : 0;
  kv_begin = max((kv_begin / MKV) * MKV, split * chunk);
  kv_end = min(kv_end, (split + 1) * chunk);
  const int n_tiles = kv_end > kv_begin ? (kv_end - kv_begin + MKV - 1) / MKV : 0;

  load_tile<DH>(Qs, q + b * sq.b + h * sq.h, sq.s, q0, Sq, tid);
  load_tile<DH>(dOs, dout + b * sdo.b + h * sdo.h, sdo.s, q0, Sq, tid);
  cp_async_commit();
  if (n_tiles > 0) {
    load_tile<DH>(Ks, kb, sk.s, kv_begin, T_len, tid);
    load_tile<DH>(Vs, vb, sv.s, kv_begin, T_len, tid);
  }
  cp_async_commit();

  const int row_lo = q0 + warp * 16 + (lane >> 2);
  const int i8 = lane >> 3;  // which 8x8 matrix this lane addresses in ldmatrix.x4
  float lse2[2], dlt[2];     // rows row_lo and row_lo + 8
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int qp = row_lo + 8 * r;
    lse2[r] = qp < Sq ? lse_log2(lse[row0 + qp]) : INFINITY;
    dlt[r] = qp < Sq ? delta[row0 + qp] : 0.f;
  }
  const float scale_log2 = scale * LOG2E;

  uint32_t qf[KS][4], df[KS][4];
  float acc[OT][4];
#pragma unroll
  for (int t = 0; t < OT; ++t)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[t][e] = 0.f;

  for (int j = 0; j < n_tiles; ++j) {
    const int k0 = kv_begin + j * MKV;
    const int buf = j & 1;
    if (j + 1 < n_tiles) {  // the next tile loads while this one computes
      load_tile<DH>(Ks + (buf ^ 1) * TILE, kb, sk.s, k0 + MKV, T_len, tid);
      load_tile<DH>(Vs + (buf ^ 1) * TILE, vb, sv.s, k0 + MKV, T_len, tid);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    if (j == 0) {  // Q's and dO's fragments, kept in registers for every kv tile
#pragma unroll
      for (int ks = 0; ks < KS; ++ks) {
        const int off = (warp * 16 + (i8 & 1) * 8 + (lane & 7)) * STRIDE + ks * 16 + (i8 >> 1) * 8;
        ldsm_x4(smem_u32(Qs + off), qf[ks]);
        ldsm_x4(smem_u32(dOs + off), df[ks]);
      }
    }
    const bf16* Kt = Ks + buf * TILE;
    const bf16* Vt = Vs + buf * TILE;

    // S = Q K^T and dP = dO V^T: this warp's 16 rows x 64 keys
    float s[NT][4], dp[NT][4];
#pragma unroll
    for (int t = 0; t < NT; ++t)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[t][e] = dp[t][e] = 0.f;
#pragma unroll
    for (int ks = 0; ks < KS; ++ks) {
#pragma unroll
      for (int np = 0; np < NT / 2; ++np) {
        const int off = (np * 16 + (i8 >> 1) * 8 + (lane & 7)) * STRIDE + ks * 16 + (i8 & 1) * 8;
        uint32_t f[4];
        ldsm_x4(smem_u32(Kt + off), f);
        mma_bf16(s[2 * np], qf[ks], f[0], f[1]);
        mma_bf16(s[2 * np + 1], qf[ks], f[2], f[3]);
        ldsm_x4(smem_u32(Vt + off), f);
        mma_bf16(dp[2 * np], df[ks], f[0], f[1]);
        mma_bf16(dp[2 * np + 1], df[ks], f[2], f[3]);
      }
    }

    // dS = P (dP - delta) scale, into s; masks only on tiles that cross the
    // diagonal, the window's edge or T
    const bool edge = (k0 + MKV > T_len) || (causal && k0 + MKV - 1 > q0) ||
                      (window >= 0 && k0 <= q0 + MQ - 1 - window);
#pragma unroll
    for (int t = 0; t < NT; ++t)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float x = s[t][e] * scale_log2;
        if (edge) {
          const int kp = k0 + t * 8 + (lane & 3) * 2 + (e & 1);
          const int qp = row_lo + (e >> 1) * 8;
          bool ok = kp < T_len;
          if (causal) ok = ok && kp <= qp;
          if (window >= 0) ok = ok && kp > qp - window;
          x = ok ? x : -INFINITY;
        }
        const float p = ex2(x - lse2[e >> 1]);
        s[t][e] = p * (dp[t][e] - dlt[e >> 1]) * scale;
      }

    // dQ += dS K, dS straight from the fragment as the bf16 A operand
#pragma unroll
    for (int kk = 0; kk < MKV / 16; ++kk) {
      uint32_t a[4];
      a[0] = pack_bf16(s[2 * kk][0], s[2 * kk][1]);
      a[1] = pack_bf16(s[2 * kk][2], s[2 * kk][3]);
      a[2] = pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]);
      a[3] = pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3]);
#pragma unroll
      for (int dp2 = 0; dp2 < DH / 16; ++dp2) {
        uint32_t f[4];
        ldsm_x4_trans(smem_u32(Kt + (kk * 16 + (i8 & 1) * 8 + (lane & 7)) * STRIDE + dp2 * 16 +
                               (i8 >> 1) * 8),
                      f);
        mma_bf16(acc[2 * dp2], a, f[0], f[1]);
        mma_bf16(acc[2 * dp2 + 1], a, f[2], f[3]);
      }
    }
    __syncthreads();  // this tile's buffers are read; the next load may take them
  }
  cp_async_wait<0>();  // nothing in flight at exit (no kv tile: Q's and dO's copies)

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int qp = row_lo + 8 * r;
    if (qp >= Sq) continue;
    if (splits == 1) {
      bf16* row = dq + b * sdq.b + (long long)qp * sdq.s + h * sdq.h;
#pragma unroll
      for (int t = 0; t < OT; ++t)
        *reinterpret_cast<__nv_bfloat162*>(row + t * 8 + (lane & 3) * 2) =
            __floats2bfloat162_rn(acc[t][2 * r], acc[t][2 * r + 1]);
    } else {  // this split's part, (splits, B, H, Sq, dh) f32
      float* row = dq_part + (((long long)split * gridDim.y * H) * Sq + row0 + qp) * DH;
#pragma unroll
      for (int t = 0; t < OT; ++t)
        *reinterpret_cast<float2*>(row + t * 8 + (lane & 3) * 2) =
            make_float2(acc[t][2 * r], acc[t][2 * r + 1]);
    }
  }
}

// dq = the sum of the splits' partial dq in split order, one thread per 8 columns of a row
template <int DH>
__global__ void __launch_bounds__(256)
attn_bwd_dq_reduce(const float* __restrict__ part, bf16* __restrict__ dq, int splits, int H,
                   int Sq, Strides sdq, long long rows) {
  constexpr int CHUNKS = DH / 8;
  const long long i = (long long)blockIdx.x * 256 + threadIdx.x;
  const long long r = i / CHUNKS;
  if (r >= rows) return;
  const int c = static_cast<int>(i % CHUNKS);
  float sum[8];
#pragma unroll
  for (int e = 0; e < 8; ++e) sum[e] = 0.f;
  for (int s = 0; s < splits; ++s) {
    const float4* p = reinterpret_cast<const float4*>(part + (s * rows + r) * DH + c * 8);
    const float4 x = p[0], y = p[1];
    sum[0] += x.x; sum[1] += x.y; sum[2] += x.z; sum[3] += x.w;
    sum[4] += y.x; sum[5] += y.y; sum[6] += y.z; sum[7] += y.w;
  }
  const int qp = static_cast<int>(r % Sq);
  const long long bh = r / Sq;
  const int h = static_cast<int>(bh % H), b = static_cast<int>(bh / H);
  uint4 out;
  uint32_t* w = reinterpret_cast<uint32_t*>(&out);
#pragma unroll
  for (int e = 0; e < 4; ++e) w[e] = pack_bf16(sum[2 * e], sum[2 * e + 1]);
  *reinterpret_cast<uint4*>(dq + b * sdq.b + (long long)qp * sdq.s + h * sdq.h + c * 8) = out;
}

// named barrier of one warp group (ids 1, 2; 0 is __syncthreads)
__device__ __forceinline__ void group_sync(int group) {
  asm volatile("bar.sync %0, %1;" ::"r"(1 + group), "r"(M_THREADS) : "memory");
}

template <int DH>
__global__ void __launch_bounds__(DKDV_THREADS)
attn_bwd_mma_dkdv(const bf16* __restrict__ q, const bf16* __restrict__ k,
                  const bf16* __restrict__ v, const bf16* __restrict__ dout,
                  const float* __restrict__ lse, const float* __restrict__ delta,
                  bf16* __restrict__ dk, bf16* __restrict__ dv, int H, int K, int Sq, int T_len,
                  Strides sq, Strides sk, Strides sv, Strides sdo, Strides sdk, Strides sdv,
                  int causal, int window, float scale) {
  constexpr int STRIDE = mma_stride<DH>();
  constexpr int TILE = mma_tile_elems<DH>();
  constexpr int NT = MQ / 8;    // 8-column tiles of S^T (q rows)
  constexpr int OT = DH / 8;    // 8-column tiles of dK and dV
  constexpr int KS = DH / 16;   // k-steps over dh
  static_assert(DKDV_GROUPS == 2, "the sums of two groups are added below");
  extern __shared__ __align__(16) bf16 kvsm[];
  const int tid = threadIdx.x;
  const int grp = tid / M_THREADS;   // warp group: takes every DKDV_GROUPS-th q tile
  const int gtid = tid % M_THREADS;  // thread within the group
  const int warp = gtid >> 5;        // warp within the group: kv rows 16 warp ..
  const int lane = tid & 31;
  bf16* Ks = kvsm;
  bf16* Vs = kvsm + TILE;
  bf16* Qs = kvsm + (2 + 4 * grp) * TILE;   // [2][MQ][STRIDE], this group's ring
  bf16* dOs = Qs + 2 * TILE;                // [2][MQ][STRIDE]
  float* lse_s = reinterpret_cast<float*>(kvsm + 10 * TILE) + grp * 4 * MQ;  // [2][MQ]
  float* dlt_s = lse_s + 2 * MQ;                                              // [2][MQ]

  const int kh = blockIdx.x;
  const int b = blockIdx.y;
  const int k0 = blockIdx.z * MKV;  // first (heaviest causal) kv tiles first
  const int G = H / K;

  // the q rows that can see a key of this tile: from the diagonal (causal)
  // to the last key's window
  const int k_last = min(T_len, k0 + MKV) - 1;
  const int q_begin = causal ? (k0 / MQ) * MQ : 0;
  const int q_end = window >= 0 ? min(Sq, k_last + window) : Sq;
  const int nq = q_end > q_begin ? (q_end - q_begin + MQ - 1) / MQ : 0;
  const int n_iters = G * nq;  // (q head, q tile) pairs; this group's: grp, grp + 2, ..

  // Q, dO, lse and delta of iteration `it` (q head kh * G + it / nq, q tile
  // it % nq) into ring slot `buf` of this group
  auto issue = [&](int it, int buf) {
    const int h = kh * G + it / nq;
    const int q0 = q_begin + (it % nq) * MQ;
    load_tile<DH>(Qs + buf * TILE, q + b * sq.b + h * sq.h, sq.s, q0, Sq, gtid);
    load_tile<DH>(dOs + buf * TILE, dout + b * sdo.b + h * sdo.h, sdo.s, q0, Sq, gtid);
    const int i = gtid % MQ;
    const bool ok = q0 + i < Sq;
    const long long at = ((long long)b * H + h) * Sq + (ok ? q0 + i : 0);
    if (gtid < MQ)
      cp_async4(lse_s + buf * MQ + i, lse + at, ok);
    else
      cp_async4(dlt_s + buf * MQ + i, delta + at, ok);
  };
  if (n_iters > 0) {  // K (group 0) and V (group 1), and each group's first q tile
    if (grp == 0)
      load_tile<DH>(Ks, k + b * sk.b + kh * sk.h, sk.s, k0, T_len, gtid);
    else
      load_tile<DH>(Vs, v + b * sv.b + kh * sv.h, sv.s, k0, T_len, gtid);
    if (grp < n_iters) issue(grp, 0);
  }
  cp_async_commit();
  cp_async_wait<0>();
  __syncthreads();  // K and V are seen by both groups

  float dk_acc[OT][4], dv_acc[OT][4];
#pragma unroll
  for (int t = 0; t < OT; ++t)
#pragma unroll
    for (int e = 0; e < 4; ++e) dk_acc[t][e] = dv_acc[t][e] = 0.f;
  const int krow = k0 + warp * 16 + (lane >> 2);  // this thread's kv rows: krow, krow + 8
  const int i8 = lane >> 3;
  const int a_off = (warp * 16 + (i8 & 1) * 8 + (lane & 7)) * STRIDE + (i8 >> 1) * 8;
  const float scale_log2 = scale * LOG2E;

  for (int it = grp, m = 0; it < n_iters; it += DKDV_GROUPS, ++m) {
    const int buf = m & 1;
    if (it + DKDV_GROUPS < n_iters) {  // the group's next q tile loads while this one computes
      issue(it + DKDV_GROUPS, buf ^ 1);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    group_sync(grp);
    const int q0 = q_begin + (it % nq) * MQ;
    const bf16* Qt = Qs + buf * TILE;
    const bf16* dOt = dOs + buf * TILE;

    // S^T = K Q^T and dP^T = V dO^T: this warp's 16 kv rows x 64 q rows
    float st[NT][4], dpt[NT][4];
#pragma unroll
    for (int t = 0; t < NT; ++t)
#pragma unroll
      for (int e = 0; e < 4; ++e) st[t][e] = dpt[t][e] = 0.f;
#pragma unroll
    for (int ks = 0; ks < KS; ++ks) {
      uint32_t ka[4], va[4];
      ldsm_x4(smem_u32(Ks + a_off + ks * 16), ka);
      ldsm_x4(smem_u32(Vs + a_off + ks * 16), va);
#pragma unroll
      for (int np = 0; np < NT / 2; ++np) {
        const int off = (np * 16 + (i8 >> 1) * 8 + (lane & 7)) * STRIDE + ks * 16 + (i8 & 1) * 8;
        uint32_t f[4];
        ldsm_x4(smem_u32(Qt + off), f);
        mma_bf16(st[2 * np], ka, f[0], f[1]);
        mma_bf16(st[2 * np + 1], ka, f[2], f[3]);
        ldsm_x4(smem_u32(dOt + off), f);
        mma_bf16(dpt[2 * np], va, f[0], f[1]);
        mma_bf16(dpt[2 * np + 1], va, f[2], f[3]);
      }
    }

    // P^T into st, dS^T = P^T (dP^T - delta) scale into dpt; lse and delta
    // are per column (q row); masks only on edge tiles
    const bool edge = (k0 + MKV > T_len) || (q0 + MQ > Sq) || (causal && k0 + MKV - 1 > q0) ||
                      (window >= 0 && k0 <= q0 + MQ - 1 - window);
    const float* lse_t = lse_s + buf * MQ;
    const float* dlt_t = dlt_s + buf * MQ;
#pragma unroll
    for (int t = 0; t < NT; ++t) {
      const int col = t * 8 + (lane & 3) * 2;
      const float2 l = *reinterpret_cast<const float2*>(lse_t + col);
      const float2 d = *reinterpret_cast<const float2*>(dlt_t + col);
      const float l2[2] = {lse_log2(l.x), lse_log2(l.y)};
      const float dd[2] = {d.x, d.y};
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float x = st[t][e] * scale_log2;
        if (edge) {
          const int kp = krow + (e >> 1) * 8;
          const int qp = q0 + col + (e & 1);
          bool ok = kp < T_len && qp < Sq;
          if (causal) ok = ok && kp <= qp;
          if (window >= 0) ok = ok && kp > qp - window;
          x = ok ? x : -INFINITY;
        }
        const float p = ex2(x - l2[e & 1]);
        st[t][e] = p;
        dpt[t][e] = p * (dpt[t][e] - dd[e & 1]) * scale;
      }
    }

    // dV += P^T dO and dK += dS^T Q, P^T and dS^T straight from the
    // fragments as bf16 A operands
#pragma unroll
    for (int kk = 0; kk < MQ / 16; ++kk) {
      uint32_t pa[4], da[4];
      pa[0] = pack_bf16(st[2 * kk][0], st[2 * kk][1]);
      pa[1] = pack_bf16(st[2 * kk][2], st[2 * kk][3]);
      pa[2] = pack_bf16(st[2 * kk + 1][0], st[2 * kk + 1][1]);
      pa[3] = pack_bf16(st[2 * kk + 1][2], st[2 * kk + 1][3]);
      da[0] = pack_bf16(dpt[2 * kk][0], dpt[2 * kk][1]);
      da[1] = pack_bf16(dpt[2 * kk][2], dpt[2 * kk][3]);
      da[2] = pack_bf16(dpt[2 * kk + 1][0], dpt[2 * kk + 1][1]);
      da[3] = pack_bf16(dpt[2 * kk + 1][2], dpt[2 * kk + 1][3]);
#pragma unroll
      for (int dp2 = 0; dp2 < DH / 16; ++dp2) {
        const int off = (kk * 16 + (i8 & 1) * 8 + (lane & 7)) * STRIDE + dp2 * 16 + (i8 >> 1) * 8;
        uint32_t f[4];
        ldsm_x4_trans(smem_u32(dOt + off), f);
        mma_bf16(dv_acc[2 * dp2], pa, f[0], f[1]);
        mma_bf16(dv_acc[2 * dp2 + 1], pa, f[2], f[3]);
        ldsm_x4_trans(smem_u32(Qt + off), f);
        mma_bf16(dk_acc[2 * dp2], da, f[0], f[1]);
        mma_bf16(dk_acc[2 * dp2 + 1], da, f[2], f[3]);
      }
    }
    group_sync(grp);  // this q tile's slot is read; the next load may take it
  }
  cp_async_wait<0>();

  // group 1's sums go through shared memory (the rings' space, register
  // slot-major so the stores do not conflict) and group 0 adds them, in that
  // order: the same bits every call
  float* red = reinterpret_cast<float*>(kvsm + 2 * TILE);  // [2 OT 4][M_THREADS]
  __syncthreads();
  if (grp == 1) {
#pragma unroll
    for (int t = 0; t < OT; ++t)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        red[((t * 4 + e) * 2) * M_THREADS + gtid] = dk_acc[t][e];
        red[((t * 4 + e) * 2 + 1) * M_THREADS + gtid] = dv_acc[t][e];
      }
  }
  __syncthreads();
  if (grp == 1) return;
#pragma unroll
  for (int t = 0; t < OT; ++t)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      dk_acc[t][e] += red[((t * 4 + e) * 2) * M_THREADS + gtid];
      dv_acc[t][e] += red[((t * 4 + e) * 2 + 1) * M_THREADS + gtid];
    }
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int kp = krow + 8 * r;
    if (kp >= T_len) continue;
    bf16* dkrow = dk + b * sdk.b + (long long)kp * sdk.s + kh * sdk.h;
    bf16* dvrow = dv + b * sdv.b + (long long)kp * sdv.s + kh * sdv.h;
#pragma unroll
    for (int t = 0; t < OT; ++t) {
      const int col = t * 8 + (lane & 3) * 2;
      *reinterpret_cast<__nv_bfloat162*>(dkrow + col) =
          __floats2bfloat162_rn(dk_acc[t][2 * r], dk_acc[t][2 * r + 1]);
      *reinterpret_cast<__nv_bfloat162*>(dvrow + col) =
          __floats2bfloat162_rn(dv_acc[t][2 * r], dv_acc[t][2 * r + 1]);
    }
  }
}

// A second stream and a fork and a join event for the current device,
// made at its first call (outside any graph capture: the first call of a
// captured backward is an eager one): the dq pass runs on it beside the
// dk/dv kernel.  Recording the fork on a capturing stream and waiting on it
// from this one makes this one part of the capture; the join brings it back.
struct Side {
  cudaStream_t stream;
  cudaEvent_t fork, join;
};
constexpr int MAX_DEVICES = 64;

int side_stream(Side** out) {
  static Side sides[MAX_DEVICES];
  static bool made[MAX_DEVICES];
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return static_cast<int>(e);
  if (dev < 0 || dev >= MAX_DEVICES) return static_cast<int>(cudaErrorInvalidDevice);
  Side& sd = sides[dev];
  if (!made[dev]) {
    e = cudaStreamCreateWithFlags(&sd.stream, cudaStreamNonBlocking);
    if (e == cudaSuccess) e = cudaEventCreateWithFlags(&sd.fork, cudaEventDisableTiming);
    if (e == cudaSuccess) e = cudaEventCreateWithFlags(&sd.join, cudaEventDisableTiming);
    if (e != cudaSuccess) return static_cast<int>(e);
    made[dev] = true;
  }
  *out = &sd;
  return 0;
}

template <int DH>
int launch_mma(const Args& a, int splits, int chunk, float* dq_part, cudaStream_t stream) {
  constexpr int dq_smem = mma_dq_smem<DH>();
  constexpr int dkdv_smem = mma_dkdv_smem<DH>();
  static bool configured = false;  // one attribute call per instantiation
  if (!configured) {
    int e = allow_smem(attn_bwd_mma_dq<DH>, dq_smem);
    if (e == 0) e = allow_smem(attn_bwd_mma_dkdv<DH>, dkdv_smem);
    if (e != 0) return e;
    configured = true;
  }
  if (splits < 1 || (splits > 1 && dq_part == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  Side* side = nullptr;
  int err = side_stream(&side);
  if (err != 0) return err;
  const bf16 *q = static_cast<const bf16*>(a.q), *k = static_cast<const bf16*>(a.k),
             *v = static_cast<const bf16*>(a.v), *dout = static_cast<const bf16*>(a.dout);
  const long long rows = (long long)a.B * a.H * a.Sq;
  attn_bwd_delta<<<static_cast<unsigned>((rows + DELTA_ROWS - 1) / DELTA_ROWS), 256, 0, stream>>>(
      static_cast<const bf16*>(a.o), dout, a.delta, a.H, a.Sq, DH, a.so, a.sdo, rows);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  e = cudaEventRecord(side->fork, stream);
  if (e == cudaSuccess) e = cudaStreamWaitEvent(side->stream, side->fork, 0);
  if (e != cudaSuccess) return static_cast<int>(e);
  // the dk/dv kernel first, so that its heaviest blocks take the SMs first;
  // the dq blocks fill what its causal tail leaves idle
  attn_bwd_mma_dkdv<DH>
      <<<dim3(a.K, a.B, (a.T_len + MKV - 1) / MKV), DKDV_THREADS, dkdv_smem, stream>>>(
          q, k, v, dout, a.lse, a.delta, static_cast<bf16*>(a.dk), static_cast<bf16*>(a.dv),
          a.H, a.K, a.Sq, a.T_len, a.sq, a.sk, a.sv, a.sdo, a.sdk, a.sdv, a.causal, a.window,
          a.scale);
  e = cudaGetLastError();
  const int q_tiles = (a.Sq + MQ - 1) / MQ;
  if (e == cudaSuccess) {
    attn_bwd_mma_dq<DH><<<dim3(a.H, a.B, q_tiles * splits), M_THREADS, dq_smem, side->stream>>>(
        q, k, v, dout, a.lse, a.delta, static_cast<bf16*>(a.dq), dq_part, a.H, a.K, a.Sq,
        a.T_len, a.sq, a.sk, a.sv, a.sdo, a.sdq, a.causal, a.window, a.scale, splits, chunk);
    e = cudaGetLastError();
  }
  if (e == cudaSuccess && splits > 1) {
    const long long threads = rows * (DH / 8);
    attn_bwd_dq_reduce<DH>
        <<<static_cast<unsigned>((threads + 255) / 256), 256, 0, side->stream>>>(
            dq_part, static_cast<bf16*>(a.dq), splits, a.H, a.Sq, a.sdq, rows);
    e = cudaGetLastError();
  }
  // join whatever happened: the side stream never runs on past the call
  cudaError_t j = cudaEventRecord(side->join, side->stream);
  if (j == cudaSuccess) j = cudaStreamWaitEvent(stream, side->join, 0);
  return static_cast<int>(e != cudaSuccess ? e : j);
}

}  // namespace

// Paths, as kernels/flash_attention_bwd.py numbers them.
#define BWD_PATH_FMA 0
#define BWD_PATH_MMA 1

// Strides are in elements, for the (b, s, head) axes of each tensor; the
// last axis is contiguous.  lse (read) and delta (written: scratch the dk/dv
// kernel reads) are (B, H, Sq) float32 contiguous.  window < 0 means none.
// The mma path splits the dq pass's kv range into dq_splits ranges of
// dq_chunk keys (a multiple of 64); with more than one, dq_partial is
// (dq_splits, B, H, Sq, dh) float32 scratch.  The fma path takes neither.
extern "C" int flash_attention_bwd(
    const void* q, const void* k, const void* v, const void* o, const void* dout,
    const void* lse, void* delta, void* dq, void* dk, void* dv, int dtype, int path, int B,
    int H, int K, int Sq, int T_len, int dh,
    long long sqb, long long sqs, long long sqh, long long skb, long long sks, long long skh,
    long long svb, long long svs, long long svh, long long sob, long long sos, long long soh,
    long long sdob, long long sdos, long long sdoh, long long sdqb, long long sdqs,
    long long sdqh, long long sdkb, long long sdks, long long sdkh, long long sdvb,
    long long sdvs, long long sdvh, int causal, int window, float scale, int dq_splits,
    int dq_chunk, void* dq_partial, void* stream) {
  const Args a{q, k, v, o, dout, static_cast<const float*>(lse), static_cast<float*>(delta),
               dq, dk, dv, B, H, K, Sq, T_len,
               {sqb, sqs, sqh}, {skb, sks, skh}, {svb, svs, svh}, {sob, sos, soh},
               {sdob, sdos, sdoh}, {sdqb, sdqs, sdqh}, {sdkb, sdks, sdkh}, {sdvb, sdvs, sdvh},
               causal, window, scale};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (path == BWD_PATH_MMA) {
    if (dtype != REPRO_BF16) return static_cast<int>(cudaErrorInvalidValue);
    float* part = static_cast<float*>(dq_partial);
    switch (dh) {
      case 32: return launch_mma<32>(a, dq_splits, dq_chunk, part, s);
      case 64: return launch_mma<64>(a, dq_splits, dq_chunk, part, s);
      case 80: return launch_mma<80>(a, dq_splits, dq_chunk, part, s);
      case 128: return launch_mma<128>(a, dq_splits, dq_chunk, part, s);
      default: return static_cast<int>(cudaErrorInvalidValue);
    }
  }
  if (path != BWD_PATH_FMA) return static_cast<int>(cudaErrorInvalidValue);
  if (dtype == REPRO_F32) return dispatch_dh<float>(dh, a, s);
  if (dtype == REPRO_BF16) return dispatch_dh<__nv_bfloat16>(dh, a, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
