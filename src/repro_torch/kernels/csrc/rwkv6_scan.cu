// K5: the RWKV6 WKV recurrence, for Hopper (sm_90a).
//
// Replaces the TPU kernel src/repro/kernels/rwkv6_scan.py:rwkv6_scan (body
// _kernel).  Per (batch b, head h), with a dh x dh float32 state S[i][j]
// (i: key dim, j: value dim) that starts at s0:
//     out_t[j] = sum_i r_t[i] * (u[i] * k_t[i] * v_t[j] + S[i][j])
//     S[i][j] <- w_t[i] * S[i][j] + k_t[i] * v_t[j]
// r/k/v/w in f32 or bf16, u and the state in f32, out in r's dtype, the final
// state in f32.
//
// What bounds it on the H100: neither bytes nor operations, but the chain of
// T dependent steps.  Each step needs ~5*dh^2 operations on dh^2 state values
// (2*dh^2 for r @ S, 3*dh^2 for the state update) while reading only 4*dh
// inputs, so the state has to stay on chip; at rwkv6-3b (dh = 64, T = 512)
// the bytes and the float32 operations each bound one layer's call at a few
// tens of microseconds.
//
// Design: one block per (head, batch row) holds the state in registers, one
// thread per value column j holding S[:, j] (dh floats), so a step needs no
// exchange between threads: every thread reads the same r/k/w/u values from
// shared memory (broadcast) and its own v_t[j].  The TPU kernel's sequential
// chunk grid axis becomes the time loop inside the block: chunks of 32 steps
// of r/k/v/w are staged through shared memory as float32.  The inputs are
// read by stride, so the model's (B, T, H, dh) views of its (B, T, D)
// projections go in without a transpose copy; out is written by stride (the
// wrapper gives it (B, T, H, dh) memory) and the final state to a
// caller-given tensor, which may be the initial state itself (the decode
// cache, updated in place: each thread reads its state column before it
// writes it back).  The sum over i runs in four partial sums to shorten the
// dependent chain.
//
// Known limit: B*H blocks of dh threads -- 160 blocks of 64 threads at
// rwkv6-3b, B = 4 -- is about one wave on 132 SMs with two warps each, so the
// card is mostly idle.  Splitting the value columns of a head across blocks
// (each block owns S[:, j0:j1]) is a later PR's work.
#include "common.cuh"

namespace {

constexpr int CHUNK = 32;  // time steps staged per pass through shared memory

struct Seq {  // element strides of (batch, head, time); d is 1
  long long b, h, t;
};

__device__ __forceinline__ void wkv_step(float& s, float r, float k, float w, float u, float v,
                                         float& acc) {
  const float kv = k * v;
  acc = fmaf(r, fmaf(u, kv, s), acc);
  s = fmaf(w, s, kv);
}

template <typename T, int DH>
__global__ void __launch_bounds__(DH)
wkv_kernel(const T* __restrict__ r, const T* __restrict__ k, const T* __restrict__ v,
           const T* __restrict__ w, const float* __restrict__ u, const float* s0,
           T* __restrict__ out, float* s_final, int T_len, Seq sr, Seq sk, Seq sv, Seq sw,
           Seq so, long long s0_b, long long s0_h, long long sf_b, long long sf_h) {
  __shared__ __align__(16) float Rs[CHUNK][DH];
  __shared__ __align__(16) float Ks[CHUNK][DH];
  __shared__ __align__(16) float Ws[CHUNK][DH];
  __shared__ float Vs[CHUNK][DH];
  __shared__ __align__(16) float Us[DH];

  const int j = threadIdx.x;
  const int h = blockIdx.x;
  const int b = blockIdx.y;
  Us[j] = u[h * DH + j];

  float S[DH];
  const float* sp = s0 + b * s0_b + h * s0_h;
#pragma unroll
  for (int i = 0; i < DH; ++i) S[i] = sp[i * DH + j];

  const T* rb = r + b * sr.b + h * sr.h;
  const T* kb = k + b * sk.b + h * sk.h;
  const T* vb = v + b * sv.b + h * sv.h;
  const T* wb = w + b * sw.b + h * sw.h;
  T* ob = out + b * so.b + h * so.h;

  for (int t0 = 0; t0 < T_len; t0 += CHUNK) {
    const int n = min(CHUNK, T_len - t0);
    __syncthreads();  // the previous chunk is consumed (and Us is visible)
    for (int tt = 0; tt < n; ++tt) {
      const long long t = t0 + tt;
      Rs[tt][j] = to_f32(rb[t * sr.t + j]);
      Ks[tt][j] = to_f32(kb[t * sk.t + j]);
      Vs[tt][j] = to_f32(vb[t * sv.t + j]);
      Ws[tt][j] = to_f32(wb[t * sw.t + j]);
    }
    __syncthreads();
    for (int tt = 0; tt < n; ++tt) {
      const float vj = Vs[tt][j];
      float a0 = 0.f, a1 = 0.f, a2 = 0.f, a3 = 0.f;
#pragma unroll
      for (int i = 0; i < DH; i += 4) {
        const float4 r4 = *reinterpret_cast<const float4*>(&Rs[tt][i]);
        const float4 k4 = *reinterpret_cast<const float4*>(&Ks[tt][i]);
        const float4 w4 = *reinterpret_cast<const float4*>(&Ws[tt][i]);
        const float4 u4 = *reinterpret_cast<const float4*>(&Us[i]);
        wkv_step(S[i], r4.x, k4.x, w4.x, u4.x, vj, a0);
        wkv_step(S[i + 1], r4.y, k4.y, w4.y, u4.y, vj, a1);
        wkv_step(S[i + 2], r4.z, k4.z, w4.z, u4.z, vj, a2);
        wkv_step(S[i + 3], r4.w, k4.w, w4.w, u4.w, vj, a3);
      }
      ob[(t0 + tt) * so.t + j] = from_f32<T>((a0 + a1) + (a2 + a3));
    }
  }

  float* fp = s_final + b * sf_b + h * sf_h;
#pragma unroll
  for (int i = 0; i < DH; ++i) fp[i * DH + j] = S[i];
}

template <typename T, int DH>
void launch(const void* r, const void* k, const void* v, const void* w, const void* u,
            const void* s0, void* out, void* s_final, int B, int H, int T_len, const Seq* seq,
            const long long* st, cudaStream_t stream) {
  wkv_kernel<T, DH><<<dim3(H, B), DH, 0, stream>>>(
      static_cast<const T*>(r), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<const T*>(w), static_cast<const float*>(u), static_cast<const float*>(s0),
      static_cast<T*>(out), static_cast<float*>(s_final), T_len, seq[0], seq[1], seq[2],
      seq[3], seq[4], st[0], st[1], st[2], st[3]);
}

template <typename T>
int dispatch_dh(int dh, const void* r, const void* k, const void* v, const void* w,
                const void* u, const void* s0, void* out, void* s_final, int B, int H,
                int T_len, const Seq* seq, const long long* st, cudaStream_t stream) {
  switch (dh) {
    case 16: launch<T, 16>(r, k, v, w, u, s0, out, s_final, B, H, T_len, seq, st, stream); break;
    case 32: launch<T, 32>(r, k, v, w, u, s0, out, s_final, B, H, T_len, seq, st, stream); break;
    case 64: launch<T, 64>(r, k, v, w, u, s0, out, s_final, B, H, T_len, seq, st, stream); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// r/k/v/w: (B, H, T, dh) read with element strides (b, h, t) each and unit d
// stride; u: (H, dh) f32 contiguous; s0 and s_final: (B, H, dh, dh) f32 with
// strides (b, h) and a contiguous dh x dh block; out: written with strides
// (b, h, t).  s_final may be s0 itself.  dh is 16, 32 or 64.
extern "C" int rwkv6_scan_fwd(const void* r, const void* k, const void* v, const void* w,
                              const void* u, const void* s0, void* out, void* s_final,
                              int dtype, int B, int H, int T_len, int dh, long long rb,
                              long long rh, long long rt, long long kb, long long kh,
                              long long kt, long long vb, long long vh, long long vt,
                              long long wb, long long wh, long long wt, long long ob,
                              long long oh, long long ot, long long s0b, long long s0h,
                              long long sfb, long long sfh, void* stream) {
  const Seq seq[5] = {{rb, rh, rt}, {kb, kh, kt}, {vb, vh, vt}, {wb, wh, wt}, {ob, oh, ot}};
  const long long st[4] = {s0b, s0h, sfb, sfh};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == REPRO_BF16)
    return dispatch_dh<__nv_bfloat16>(dh, r, k, v, w, u, s0, out, s_final, B, H, T_len, seq,
                                      st, s);
  return dispatch_dh<float>(dh, r, k, v, w, u, s0, out, s_final, B, H, T_len, seq, st, s);
}
