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
// about 8 GFLOP over 30 MB: bound by operations (tensor cores) in principle.
// This first form runs the products as float32 FMAs on the CUDA cores (67
// TFLOP/s peak) from shared memory, recomputing s and dp in both kernels (7
// products), so it is bound by the CUDA cores' FMA and shared-memory load
// rate.  An mma.sync / wgmma form is queued (ROADMAP Queue 2).
//
// Design: two kernels, no atomics (two calls give the same bits).
//   attn_bwd_dq_kernel    one block of 256 threads per (64-row q tile, q
//                         head, batch).  Its prologue computes delta for the
//                         tile's rows from do and o and writes it out; then
//                         it walks the kv tiles the masks leave live (the
//                         window's first tile to the causal diagonal),
//                         recomputing s and dp, and accumulates dq in
//                         registers (four threads a row, dh/4 columns each).
//   attn_bwd_dkdv_kernel  one block per (64-row kv tile, kv head, batch),
//                         launched after the dq kernel on the same stream
//                         (it reads delta).  It holds k and v of its tile and
//                         walks the G query heads of its group and the q
//                         tiles that can see a key of the tile, recomputing
//                         p and ds, and accumulates dk and dv in registers.
// Tiles are float32 in shared memory with rows padded by one float (no bank
// conflicts in the 16x16-thread score products); at dh 128 the dk/dv kernel
// holds 162 KB, the dq kernel 146 KB: one block per SM.  A q row at or past
// Sq, a key at or past T and every masked pair give p = 0 by a select (never
// a product with exp of -inf), so a row with every key masked gets zeros.
#include "common.cuh"

namespace {

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
int launch(const Args& a, cudaStream_t stream) {
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
    case 32: return launch<T, 32>(a, s);
    case 64: return launch<T, 64>(a, s);
    case 80: return launch<T, 80>(a, s);
    case 128: return launch<T, 128>(a, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// Strides are in elements, for the (b, s, head) axes of each tensor; the
// last axis is contiguous.  lse (read) and delta (written: scratch the dk/dv
// kernel reads) are (B, H, Sq) float32 contiguous.  window < 0 means none.
extern "C" int flash_attention_bwd(
    const void* q, const void* k, const void* v, const void* o, const void* dout,
    const void* lse, void* delta, void* dq, void* dk, void* dv, int dtype, int B, int H,
    int K, int Sq, int T_len, int dh,
    long long sqb, long long sqs, long long sqh, long long skb, long long sks, long long skh,
    long long svb, long long svs, long long svh, long long sob, long long sos, long long soh,
    long long sdob, long long sdos, long long sdoh, long long sdqb, long long sdqs,
    long long sdqh, long long sdkb, long long sdks, long long sdkh, long long sdvb,
    long long sdvs, long long sdvh, int causal, int window, float scale, void* stream) {
  const Args a{q, k, v, o, dout, static_cast<const float*>(lse), static_cast<float*>(delta),
               dq, dk, dv, B, H, K, Sq, T_len,
               {sqb, sqs, sqh}, {skb, sks, skh}, {svb, svs, svh}, {sob, sos, soh},
               {sdob, sdos, sdoh}, {sdqb, sdqs, sdqh}, {sdkb, sdks, sdkh}, {sdvb, sdvs, sdvh},
               causal, window, scale};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == REPRO_F32) return dispatch_dh<float>(dh, a, s);
  if (dtype == REPRO_BF16) return dispatch_dh<__nv_bfloat16>(dh, a, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
