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
// What bounds it on the H100: at rwkv6-3b (dh = 64, T = 512) the bytes and
// the float32 operations each bound one layer's call at a few tens of
// microseconds.  Each step needs ~5*dh^2 operations on dh^2 state values
// (2*dh^2 for r @ S, 3*dh^2 for the state update) while reading only 4*dh
// inputs, so the state has to stay on chip, and the T steps form a chain:
// the card must be filled with independent columns, and each column's
// step kept short.
//
// Design: each block owns one slice of value columns of one (batch row,
// head), S[:, j0 : j0 + JB], so there are B * H * (dh / JB) blocks (320 of 4
// warps at rwkv6-3b's B = 4, JB = 32, against 160 of 2 warps before).
// Column slices never exchange data: out_t[j] and S[:, j] need only v_t[j]
// and the shared r_t, k_t, w_t, u.  Inside a block the key dimension is
// split into row groups of R = 16 rows: thread (group g, column j)
// holds S[Rg .. Rg + R, j] in registers, so the dependent chain of a step is
// R values in four partial sums, not dh.  The threads of a warp are columns
// of one row group (of two or four when JB < 32), so their 16-byte reads of
// r/k/w in shared memory share one address and broadcast.  Those reads,
// three 16-byte reads per four state values a step, and the staging of r/k/w
// once per column slice, are what the measurements point to as its limit.  Each group
// writes its share of out_t[j] to shared memory, and after each chunk the
// shares are summed in group order.  JB comes from the static shapes
// (kernels/rwkv6_scan.py:plan), never from the data.  The TPU kernel's
// sequential chunk grid axis becomes the time loop: chunks of 16 steps of
// r/k/w (all dh) and v (the block's columns) are staged with 16-byte
// cp.async into one of two buffers while the other chunk computes, and a
// whole chunk's steps are unrolled.  Measured and not kept (PERF.md): the key
// rows spread over the lanes of a warp and summed with shuffles (four
// addresses per read), 8-row groups (twice the warps), reading the next
// step's inputs into registers ahead of time, and 2 or 4 columns a thread
// (fewer shared-memory reads, fewer warps).  The inputs are read by stride, so the
// model's (B, T, H, dh) views of its (B, T, D) projections go in without a
// transpose copy; out is written by stride (the wrapper gives it (B, T, H,
// dh) memory) and the final state to a caller-given tensor, which may be the
// initial state itself (the decode cache, updated in place: each block reads
// its own columns of the state before it writes them back, and no other
// block touches them).  Under autograd the wrapper also asks for the
// state entering every 16-step chunk (ckpt), which the backward recomputes
// each chunk's states from: each thread writes its state rows as the chunk
// starts, 42 MB a layer at rwkv6-3b's training shape.
#include "common.cuh"
#include "hopper.cuh"

namespace {

constexpr int CHUNK = 16;  // time steps staged per buffer

struct Seq {  // element strides of (batch, head, time); d is 1
  long long b, h, t;
};

__device__ __forceinline__ void wkv_step(float& s, float r, float k, float w, float u, float v,
                                         float& acc) {
  const float kv = k * v;
  acc = fmaf(r, fmaf(u, kv, s), acc);
  s = fmaf(w, s, kv);
}

__device__ __forceinline__ float4 load4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}
__device__ __forceinline__ float4 load4(const __nv_bfloat16* p) {
  const uint2 raw = *reinterpret_cast<const uint2*>(p);
  const float2 lo = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&raw.x));
  const float2 hi = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&raw.y));
  return make_float4(lo.x, lo.y, hi.x, hi.y);
}

template <typename T, int DH>
__global__ void __launch_bounds__(256)
wkv_kernel(const T* __restrict__ r, const T* __restrict__ k, const T* __restrict__ v,
           const T* __restrict__ w, const float* __restrict__ u, const float* s0,
           T* __restrict__ out, float* s_final, float* __restrict__ ckpt, int T_len, int jb,
           Seq sr, Seq sk, Seq sv, Seq sw, Seq so, long long s0_b, long long s0_h,
           long long sf_b, long long sf_h) {
  constexpr int R = 16;                       // key rows of one thread's column share
  constexpr int G = DH / R;                   // row groups: key rows Rg .. Rg + R
  constexpr int E16 = 16 / sizeof(T);         // elements per 16-byte copy
  constexpr int ROW16 = DH / E16;             // 16-byte copies per r/k/w row
  // [2 buffers][CHUNK steps] of r, k, w (dh wide) and v (the block's jb
  // columns), then [G][CHUNK][jb] float32 shares of out (wkv_smem_bytes)
  extern __shared__ __align__(16) unsigned char wkv_smem[];
  T* Rs = reinterpret_cast<T*>(wkv_smem);
  const T* Ks = Rs + 2 * CHUNK * DH;
  const T* Ws = Ks + 2 * CHUNK * DH;
  T* Vs = Rs + 6 * CHUNK * DH;
  float* Ps = reinterpret_cast<float*>(Vs + 2 * CHUNK * jb);

  const int tid = threadIdx.x;
  const int col = tid % jb, grp = tid / jb;
  const int j0 = blockIdx.x * jb, j = j0 + col;
  const int h = blockIdx.y, b = blockIdx.z;

  const T* rb = r + b * sr.b + h * sr.h;
  const T* kb = k + b * sk.b + h * sk.h;
  const T* vb = v + b * sv.b + h * sv.h + j0;
  const T* wb = w + b * sw.b + h * sw.h;
  T* ob = out + b * so.b + h * so.h;

  // chunk [t0, t0 + n) into buffer buf, one commit group
  auto stage = [&](int buf, int t0, int n) {
    const int v16 = jb / E16;
    const int per_t = 3 * ROW16 + v16;
    for (int i = tid; i < n * per_t; i += blockDim.x) {
      const int tt = i / per_t, p = i % per_t;
      const long long t = t0 + tt;
      if (p < 3 * ROW16) {  // r, k or w (Rs, Ks, Ws lie one after the other), all dh
        const int a = p / ROW16, e = p % ROW16 * E16;
        const T* row = a == 0 ? rb + t * sr.t : a == 1 ? kb + t * sk.t : wb + t * sw.t;
        cp_async16(Rs + ((2 * a + buf) * CHUNK + tt) * DH + e, row + e, true);
      } else {  // v, the block's columns
        const int e = (p - 3 * ROW16) * E16;
        cp_async16(Vs + (buf * CHUNK + tt) * jb + e, vb + t * sv.t + e, true);
      }
    }
    cp_async_commit();
  };
  const int n_chunks = (T_len + CHUNK - 1) / CHUNK;
  if (n_chunks > 0) stage(0, 0, min(CHUNK, T_len));

  // this thread's R state rows of column j, and u at those rows
  float S[R], U[R];
  const float* sp = s0 + b * s0_b + h * s0_h;
#pragma unroll
  for (int i = 0; i < R; ++i) {
    S[i] = sp[(R * grp + i) * DH + j];
    U[i] = u[h * DH + R * grp + i];
  }

  for (int ch = 0; ch < n_chunks; ++ch) {
    const int buf = ch & 1, t0 = ch * CHUNK, n = min(CHUNK, T_len - t0);
    if (ckpt != nullptr) {  // the state entering this chunk, for the backward
      float* cp = ckpt + (((long long)b * gridDim.y + h) * n_chunks + ch) * DH * DH;
#pragma unroll
      for (int i = 0; i < R; ++i) cp[(R * grp + i) * DH + j] = S[i];
    }
    if (ch + 1 < n_chunks) {  // the next chunk lands while this one computes
      stage(buf ^ 1, t0 + CHUNK, min(CHUNK, T_len - t0 - CHUNK));
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    // one time step: the row group's share of out_t[j]; a whole chunk is
    // unrolled, so only the state update (4 cycles a step) is serial
    auto step = [&](int tt) {
      const float vj = to_f32(Vs[(buf * CHUNK + tt) * jb + col]);
      float a[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
      for (int m = 0; m < R / 4; ++m) {
        // the same address across the warp's columns: one broadcast wavefront
        const int at = (buf * CHUNK + tt) * DH + R * grp + 4 * m;
        const float4 r4 = load4(Rs + at);
        const float4 k4 = load4(Ks + at);
        const float4 w4 = load4(Ws + at);
        wkv_step(S[4 * m], r4.x, k4.x, w4.x, U[4 * m], vj, a[0]);
        wkv_step(S[4 * m + 1], r4.y, k4.y, w4.y, U[4 * m + 1], vj, a[1]);
        wkv_step(S[4 * m + 2], r4.z, k4.z, w4.z, U[4 * m + 2], vj, a[2]);
        wkv_step(S[4 * m + 3], r4.w, k4.w, w4.w, U[4 * m + 3], vj, a[3]);
      }
      Ps[(grp * CHUNK + tt) * jb + col] = (a[0] + a[1]) + (a[2] + a[3]);
    };
    if (n == CHUNK) {
#pragma unroll
      for (int tt = 0; tt < CHUNK; ++tt) step(tt);
    } else {
      for (int tt = 0; tt < n; ++tt) step(tt);
    }
    __syncthreads();
    // out over the row groups, in group order
    for (int i = tid; i < n * jb; i += blockDim.x) {
      const int tt = i / jb, c = i % jb;
      float acc = Ps[tt * jb + c];
#pragma unroll
      for (int gg = 1; gg < G; ++gg) acc += Ps[(gg * CHUNK + tt) * jb + c];
      ob[(t0 + tt) * so.t + j0 + c] = from_f32<T>(acc);
    }
    __syncthreads();  // buffer buf and Ps are consumed before the next chunk reuses them
  }

  float* fp = s_final + b * sf_b + h * sf_h;
#pragma unroll
  for (int i = 0; i < R; ++i) fp[(R * grp + i) * DH + j] = S[i];
}

template <typename T, int DH>
constexpr int wkv_smem_bytes(int jb) {
  return (2 * CHUNK * (3 * DH + jb)) * static_cast<int>(sizeof(T)) + DH / 16 * CHUNK * jb * 4;
}

template <typename T, int DH>
void launch(const void* r, const void* k, const void* v, const void* w, const void* u,
            const void* s0, void* out, void* s_final, void* ckpt, int B, int H, int T_len,
            int jb, const Seq* seq, const long long* st, cudaStream_t stream) {
  wkv_kernel<T, DH><<<dim3(DH / jb, H, B), jb * (DH / 16), wkv_smem_bytes<T, DH>(jb), stream>>>(
      static_cast<const T*>(r), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<const T*>(w), static_cast<const float*>(u), static_cast<const float*>(s0),
      static_cast<T*>(out), static_cast<float*>(s_final), static_cast<float*>(ckpt), T_len,
      jb, seq[0], seq[1], seq[2],
      seq[3], seq[4], st[0], st[1], st[2], st[3]);
}

template <typename T>
int dispatch_dh(int dh, int jb, const void* r, const void* k, const void* v, const void* w,
                const void* u, const void* s0, void* out, void* s_final, void* ckpt, int B,
                int H, int T_len, const Seq* seq, const long long* st, cudaStream_t stream) {
  // jb: a power of two from 8 to dh, so each block's v columns are whole 16-byte copies
  if (jb < 8 || jb > dh || (jb & (jb - 1))) return static_cast<int>(cudaErrorInvalidValue);
  switch (dh) {
    case 16: launch<T, 16>(r, k, v, w, u, s0, out, s_final, ckpt, B, H, T_len, jb, seq, st, stream); break;
    case 32: launch<T, 32>(r, k, v, w, u, s0, out, s_final, ckpt, B, H, T_len, jb, seq, st, stream); break;
    case 64: launch<T, 64>(r, k, v, w, u, s0, out, s_final, ckpt, B, H, T_len, jb, seq, st, stream); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// r/k/v/w: (B, H, T, dh) read with element strides (b, h, t) each and unit d
// stride, 16-byte aligned rows (the wrapper checks); u: (H, dh) f32
// contiguous; s0 and s_final: (B, H, dh, dh) f32 with strides (b, h) and a
// contiguous dh x dh block; out: written with strides (b, h, t).  s_final
// may be s0 itself.  ckpt, when not null: (B, H, ceil(T / 16), dh, dh) f32
// contiguous, the state entering every 16-step chunk (what the backward,
// csrc/rwkv6_scan_bwd.cu, recomputes each chunk from); the serving calls
// pass null.  dh is 16, 32 or 64; jb, the value columns of one block,
// a power of two from 8 to dh.
extern "C" int rwkv6_scan_fwd(const void* r, const void* k, const void* v, const void* w,
                              const void* u, const void* s0, void* out, void* s_final,
                              int dtype, int B, int H, int T_len, int dh, int jb, long long rb,
                              long long rh, long long rt, long long kb, long long kh,
                              long long kt, long long vb, long long vh, long long vt,
                              long long wb, long long wh, long long wt, long long ob,
                              long long oh, long long ot, long long s0b, long long s0h,
                              long long sfb, long long sfh, void* ckpt, void* stream) {
  const Seq seq[5] = {{rb, rh, rt}, {kb, kh, kt}, {vb, vh, vt}, {wb, wh, wt}, {ob, oh, ot}};
  const long long st[4] = {s0b, s0h, sfb, sfh};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == REPRO_BF16)
    return dispatch_dh<__nv_bfloat16>(dh, jb, r, k, v, w, u, s0, out, s_final, ckpt, B, H,
                                      T_len, seq, st, s);
  return dispatch_dh<float>(dh, jb, r, k, v, w, u, s0, out, s_final, ckpt, B, H, T_len, seq,
                            st, s);
}
