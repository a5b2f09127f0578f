// K1: causal / sliding-window GQA prefill attention with an online softmax,
// for Hopper (sm_90a).
//
// Replaces the TPU kernel src/repro/kernels/flash_attention.py:flash_attention
// (body _kernel).  q (B, H, Sq, dh), k/v (B, K, T, dh) in f32 or bf16, read by
// stride, so the model's (B, S, H, dh) / (B, T, K, dh) activations are read
// in place with no transpose copy.  Query head h reads kv head h / (H / K).
// Masks: k < T, k <= q (causal), k > q - window.  q is scaled by dh^-0.5 in
// float32; running max m, sum l and the accumulator stay in float32; out =
// acc / max(l, 1e-20) in q's dtype.
//
// What bounds it on the H100: 4*Sq*T*dh/2 operations (causal) over
// (Sq*H + 2*T*K)*dh elements -- at S=512, dh=128 about 60 operations per
// byte of q/k/v, below the bf16 tensor-core ridge (~295) but far above what
// the float32 FMA units sustain, so this simple kernel is bound by
// operations on the CUDA cores.
//
// Design: one block of 256 threads per (64-row q tile, q head, batch).  Four
// threads share a q row: each computes 16 of the 64 scores of a kv tile as
// full dot products from shared memory, the row's max and sum are combined
// with two warp shuffles, and each thread keeps dh/4 output columns of the
// row in registers.  The block walks kv tiles from the window's first tile to
// the causal diagonal and no further.  Shared rows are padded by one float so
// the row-strided reads do not conflict.
//
// Left for later work: wgmma on bf16 tiles, TMA loads, a pipeline over kv
// tiles, and warp specialisation (FlashAttention-3 shape).
#include "common.cuh"

namespace {

constexpr int BQ = 64;
constexpr int BKV = 64;
constexpr int THREADS = 256;

struct Strides {  // element strides of (b, s, h) for one tensor; d is 1
  long long b, s, h;
};

template <int DH>
constexpr int smem_floats() {
  return BQ * (DH + 1) + BKV * (DH + 1) + BKV * DH + BQ * (BKV + 1);
}

template <typename T, int DH>
__global__ void __launch_bounds__(THREADS)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, T* __restrict__ o, int H, int K,
                 int Sq, int T_len, Strides sq, Strides sk, Strides sv,
                 Strides so, int causal, int window, float scale) {
  extern __shared__ float smem[];
  float* Qs = smem;                        // [BQ][DH+1]
  float* Ks = Qs + BQ * (DH + 1);          // [BKV][DH+1]
  float* Vs = Ks + BKV * (DH + 1);         // [BKV][DH]
  float* Ps = Vs + BKV * DH;               // [BQ][BKV+1]

  const int tid = threadIdx.x;
  const int r = tid / 4;   // q row within the tile
  const int c = tid % 4;   // which quarter of the row this thread serves
  const int q0 = blockIdx.x * BQ;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int kh = h / (H / K);

  const T* qb = q + b * sq.b + h * sq.h;
  const T* kb = k + b * sk.b + kh * sk.h;
  const T* vb = v + b * sv.b + kh * sv.h;

  for (int i = tid; i < BQ * DH; i += THREADS) {
    const int rr = i / DH, d = i % DH;
    const int s = q0 + rr;
    Qs[rr * (DH + 1) + d] = s < Sq ? to_f32(qb[s * sq.s + d]) * scale : 0.f;
  }

  constexpr int NT = DH / 4;
  float acc[NT];
#pragma unroll
  for (int t = 0; t < NT; ++t) acc[t] = 0.f;
  float m = REPRO_NEG_INF, l = 0.f;
  const int q_pos = q0 + r;

  // kv range this tile can see: from the window's first key to the diagonal
  int kv_end = causal ? min(T_len, q0 + BQ) : T_len;
  int kv_begin = window >= 0 ? max(0, q0 - window + 1) : 0;
  kv_begin = (kv_begin / BKV) * BKV;

  for (int k0 = kv_begin; k0 < kv_end; k0 += BKV) {
    __syncthreads();  // previous tile's Ks/Vs/Ps are no longer read
    for (int i = tid; i < BKV * DH; i += THREADS) {
      const int j = i / DH, d = i % DH;
      const int s = k0 + j;
      const bool in = s < T_len;
      Ks[j * (DH + 1) + d] = in ? to_f32(kb[s * sk.s + d]) : 0.f;
      Vs[j * DH + d] = in ? to_f32(vb[s * sv.s + d]) : 0.f;
    }
    __syncthreads();

    float sc[BKV / 4];
#pragma unroll
    for (int i = 0; i < BKV / 4; ++i) sc[i] = 0.f;
    const float* qrow = Qs + r * (DH + 1);
#pragma unroll 4
    for (int d = 0; d < DH; ++d) {
      const float qd = qrow[d];
#pragma unroll
      for (int i = 0; i < BKV / 4; ++i) sc[i] = fmaf(qd, Ks[(c + 4 * i) * (DH + 1) + d], sc[i]);
    }

    float tile_max = REPRO_NEG_INF;
#pragma unroll
    for (int i = 0; i < BKV / 4; ++i) {
      const int kp = k0 + c + 4 * i;
      bool ok = kp < T_len;
      if (causal) ok = ok && kp <= q_pos;
      if (window >= 0) ok = ok && kp > q_pos - window;
      sc[i] = ok ? sc[i] : REPRO_NEG_INF;
      tile_max = fmaxf(tile_max, sc[i]);
    }
    tile_max = fmaxf(tile_max, __shfl_xor_sync(0xffffffffu, tile_max, 1));
    tile_max = fmaxf(tile_max, __shfl_xor_sync(0xffffffffu, tile_max, 2));
    const float m_new = fmaxf(m, tile_max);
    const float alpha = expf(m - m_new);
    float psum = 0.f;
#pragma unroll
    for (int i = 0; i < BKV / 4; ++i) {
      const float p = sc[i] > 0.5f * REPRO_NEG_INF ? expf(sc[i] - m_new) : 0.f;
      psum += p;
      Ps[r * (BKV + 1) + c + 4 * i] = p;
    }
    psum += __shfl_xor_sync(0xffffffffu, psum, 1);
    psum += __shfl_xor_sync(0xffffffffu, psum, 2);
    l = l * alpha + psum;
    m = m_new;
    __syncwarp();  // the row's four threads (one warp) exchange P

#pragma unroll
    for (int t = 0; t < NT; ++t) acc[t] *= alpha;
    const float* prow = Ps + r * (BKV + 1);
#pragma unroll 4
    for (int j = 0; j < BKV; ++j) {
      const float p = prow[j];
      const float* vrow = Vs + j * DH + c;
#pragma unroll
      for (int t = 0; t < NT; ++t) acc[t] = fmaf(p, vrow[4 * t], acc[t]);
    }
  }

  if (q_pos < Sq) {
    const float inv = 1.f / fmaxf(l, 1e-20f);
    T* orow = o + b * so.b + q_pos * so.s + h * so.h;
#pragma unroll
    for (int t = 0; t < NT; ++t) orow[c + 4 * t] = from_f32<T>(acc[t] * inv);
  }
}

template <typename T, int DH>
int launch(const void* q, const void* k, const void* v, void* o, int B, int H,
           int K, int Sq, int T_len, Strides sq, Strides sk, Strides sv,
           Strides so, int causal, int window, float scale, cudaStream_t stream) {
  const size_t smem = smem_floats<DH>() * sizeof(float);
  static bool configured = false;  // one attribute call per instantiation
  if (!configured) {
    cudaError_t e = cudaFuncSetAttribute(flash_fwd_kernel<T, DH>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
    configured = true;
  }
  dim3 grid((Sq + BQ - 1) / BQ, H, B);
  flash_fwd_kernel<T, DH><<<grid, THREADS, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<T*>(o), H, K, Sq, T_len, sq, sk, sv, so, causal, window, scale);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int dispatch_dh(int dh, const void* q, const void* k, const void* v, void* o,
                int B, int H, int K, int Sq, int T_len, Strides sq, Strides sk,
                Strides sv, Strides so, int causal, int window, float scale,
                cudaStream_t s) {
  switch (dh) {
    case 32: return launch<T, 32>(q, k, v, o, B, H, K, Sq, T_len, sq, sk, sv, so, causal, window, scale, s);
    case 64: return launch<T, 64>(q, k, v, o, B, H, K, Sq, T_len, sq, sk, sv, so, causal, window, scale, s);
    case 128: return launch<T, 128>(q, k, v, o, B, H, K, Sq, T_len, sq, sk, sv, so, causal, window, scale, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// Strides are in elements, for the (b, s, head) axes of each tensor; the
// last axis is contiguous.  window < 0 means no window.
extern "C" int flash_attention_fwd(
    const void* q, const void* k, const void* v, void* o, int dtype, int B,
    int H, int K, int Sq, int T_len, int dh,
    long long sqb, long long sqs, long long sqh,
    long long skb, long long sks, long long skh,
    long long svb, long long svs, long long svh,
    long long sob, long long sos, long long soh,
    int causal, int window, float scale, void* stream) {
  const Strides sq{sqb, sqs, sqh}, sk{skb, sks, skh}, sv{svb, svs, svh}, so{sob, sos, soh};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == REPRO_F32)
    return dispatch_dh<float>(dh, q, k, v, o, B, H, K, Sq, T_len, sq, sk, sv, so, causal, window, scale, s);
  return dispatch_dh<__nv_bfloat16>(dh, q, k, v, o, B, H, K, Sq, T_len, sq, sk, sv, so, causal, window, scale, s);
}
