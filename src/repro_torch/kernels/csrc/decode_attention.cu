// K2: decode attention -- one query token per sequence against the KV cache,
// for Hopper (sm_90a).
//
// Replaces the TPU kernel src/repro/kernels/decode_attention.py:decode_attention
// (body _kernel).  q (B, K, G, dh); caches indexed (B, K, S, dh) but read by
// stride, so the model's (B, S, K, dh) cache is read in place: a transposed
// copy would move the whole cache on every layer of every step.  Entries
// k < lengths[b] are attended, and with a window only k > lengths[b]-1-window.
// lengths is read from device memory, never from the host, so a CUDA graph
// can capture the launch.  Float32 running max, sum and accumulator; out =
// acc / max(l, 1e-20) in q's dtype.
//
// What bounds it on the H100: the cache bytes.  Each cache entry is read
// once for 4*G*dh operations per kv head, a few operations per byte, far
// below the ~295 operations per byte where compute would take over.
//
// Design: one block of four warps per (kv head, batch row) serves the G
// query rows of the group, so each cache entry is read once for all of them.
// Each warp takes 32-entry chunks of the cache in turn: for the scores every
// lane reads one entry's key row with 16-byte loads; for the values the lanes
// split the head dimension, so a value row is one coalesced read.  Every warp
// keeps its own (m, l, acc) and the four are merged through shared memory at
// the end.  The loop reads only the entries below lengths[b] (and inside the
// window).
//
// Known limit: B*K blocks (32 at B=4, K=8) on 132 SMs leave most of the card
// idle at small batch; splitting the cache across blocks (split-KV, with a
// second pass that merges the partial softmax states) is later work.
#include "common.cuh"

namespace {

constexpr int WARPS = 4;
constexpr int MAXG = 8;
constexpr int CHUNK = 32;

struct Strides {  // element strides of (b, head, row) for one tensor; d is 1
  long long b, h, r;
};

template <typename T, int DH>
__global__ void __launch_bounds__(WARPS * 32)
decode_kernel(const T* __restrict__ q, const T* __restrict__ kc,
              const T* __restrict__ vc, const int* __restrict__ lengths,
              T* __restrict__ o, int G, Strides sq, Strides sk, Strides sv,
              Strides so, int window, float scale) {
  constexpr int VPL = DH / 32;  // value columns per lane
  __shared__ __align__(16) float Qs[MAXG][DH];
  __shared__ float Ps[WARPS][MAXG][CHUNK];
  __shared__ float Ms[WARPS][MAXG];
  __shared__ float Ls[WARPS][MAXG];
  __shared__ float As[WARPS][MAXG][DH];

  const int kh = blockIdx.x;
  const int b = blockIdx.y;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;

  for (int i = threadIdx.x; i < G * DH; i += WARPS * 32) {
    const int g = i / DH, d = i % DH;
    Qs[g][d] = to_f32(q[b * sq.b + kh * sq.h + g * sq.r + d]) * scale;
  }
  __syncthreads();

  const int len = lengths[b];
  const int begin = window >= 0 ? max(0, len - window) : 0;
  const T* kbase = kc + b * sk.b + kh * sk.h;
  const T* vbase = vc + b * sv.b + kh * sv.h;

  float m[MAXG], l[MAXG], acc[MAXG][VPL];
#pragma unroll
  for (int g = 0; g < MAXG; ++g) {
    m[g] = REPRO_NEG_INF;
    l[g] = 0.f;
#pragma unroll
    for (int t = 0; t < VPL; ++t) acc[g][t] = 0.f;
  }

  for (int base = begin + warp * CHUNK; base < len; base += WARPS * CHUNK) {
    const int key = base + lane;
    const bool valid = key < len;
    float s[MAXG];
#pragma unroll
    for (int g = 0; g < MAXG; ++g) s[g] = 0.f;
    if (valid) {
      const T* krow = kbase + key * sk.r;
      constexpr int PER16 = 16 / sizeof(T);
#pragma unroll 4
      for (int d0 = 0; d0 < DH; d0 += PER16) {
        float kv[PER16];
        unpack16(krow + d0, kv);
#pragma unroll
        for (int g = 0; g < MAXG; ++g) {
          if (g < G) {
#pragma unroll
            for (int e = 0; e < PER16; ++e) s[g] = fmaf(Qs[g][d0 + e], kv[e], s[g]);
          }
        }
      }
    }
    const int n_valid = min(CHUNK, len - base);
#pragma unroll
    for (int g = 0; g < MAXG; ++g) {
      if (g >= G) break;
      const float sg = valid ? s[g] : REPRO_NEG_INF;
      const float m_new = fmaxf(m[g], warp_max(sg));
      const float p = valid ? expf(sg - m_new) : 0.f;
      const float alpha = expf(m[g] - m_new);
      l[g] = l[g] * alpha + warp_sum(p);
      m[g] = m_new;
      Ps[warp][g][lane] = p;
#pragma unroll
      for (int t = 0; t < VPL; ++t) acc[g][t] *= alpha;
    }
    __syncwarp();
    for (int j = 0; j < n_valid; ++j) {
      const T* vrow = vbase + (base + j) * sv.r + lane * VPL;
      float vv[VPL];
#pragma unroll
      for (int t = 0; t < VPL; ++t) vv[t] = to_f32(vrow[t]);
#pragma unroll
      for (int g = 0; g < MAXG; ++g) {
        if (g < G) {
          const float p = Ps[warp][g][j];
#pragma unroll
          for (int t = 0; t < VPL; ++t) acc[g][t] = fmaf(p, vv[t], acc[g][t]);
        }
      }
    }
    __syncwarp();  // Ps is rewritten by the next chunk
  }

  // merge the four warps' softmax states
#pragma unroll
  for (int g = 0; g < MAXG; ++g) {
    if (g >= G) break;
    if (lane == 0) {
      Ms[warp][g] = m[g];
      Ls[warp][g] = l[g];
    }
#pragma unroll
    for (int t = 0; t < VPL; ++t) As[warp][g][lane * VPL + t] = acc[g][t];
  }
  __syncthreads();
  for (int i = threadIdx.x; i < G * DH; i += WARPS * 32) {
    const int g = i / DH, d = i % DH;
    float mx = REPRO_NEG_INF;
#pragma unroll
    for (int w = 0; w < WARPS; ++w) mx = fmaxf(mx, Ms[w][g]);
    float lsum = 0.f, a = 0.f;
#pragma unroll
    for (int w = 0; w < WARPS; ++w) {
      const float f = expf(Ms[w][g] - mx);
      lsum += Ls[w][g] * f;
      a += As[w][g][d] * f;
    }
    o[b * so.b + kh * so.h + g * so.r + d] = from_f32<T>(a / fmaxf(lsum, 1e-20f));
  }
}

template <typename T, int DH>
int launch(const void* q, const void* kc, const void* vc, const int* lengths,
           void* o, int B, int K, int G, Strides sq, Strides sk, Strides sv,
           Strides so, int window, float scale, cudaStream_t stream) {
  dim3 grid(K, B);
  decode_kernel<T, DH><<<grid, WARPS * 32, 0, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(kc), static_cast<const T*>(vc),
      lengths, static_cast<T*>(o), G, sq, sk, sv, so, window, scale);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int dispatch_dh(int dh, const void* q, const void* kc, const void* vc,
                const int* lengths, void* o, int B, int K, int G, Strides sq,
                Strides sk, Strides sv, Strides so, int window, float scale,
                cudaStream_t s) {
  switch (dh) {
    case 32: return launch<T, 32>(q, kc, vc, lengths, o, B, K, G, sq, sk, sv, so, window, scale, s);
    case 64: return launch<T, 64>(q, kc, vc, lengths, o, B, K, G, sq, sk, sv, so, window, scale, s);
    case 128: return launch<T, 128>(q, kc, vc, lengths, o, B, K, G, sq, sk, sv, so, window, scale, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// Strides are in elements for the (b, kv head, row) axes: the row axis is the
// query group for q and out and the cache position for the caches; the last
// axis is contiguous.  window < 0 means no window.  G <= 8.
extern "C" int decode_attention_fwd(
    const void* q, const void* kc, const void* vc, const void* lengths, void* o,
    int dtype, int B, int K, int G, int dh,
    long long sqb, long long sqh, long long sqr,
    long long skb, long long skh, long long skr,
    long long svb, long long svh, long long svr,
    long long sob, long long soh, long long sor,
    int window, float scale, void* stream) {
  const Strides sq{sqb, sqh, sqr}, sk{skb, skh, skr}, sv{svb, svh, svr}, so{sob, soh, sor};
  const int* len = static_cast<const int*>(lengths);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == REPRO_F32)
    return dispatch_dh<float>(dh, q, kc, vc, len, o, B, K, G, sq, sk, sv, so, window, scale, s);
  return dispatch_dh<__nv_bfloat16>(dh, q, kc, vc, len, o, B, K, G, sq, sk, sv, so, window, scale, s);
}
