// K1: causal / sliding-window GQA prefill attention with an online softmax,
// for Hopper (sm_90a).
//
// Replaces the TPU kernel src/repro/kernels/flash_attention.py:flash_attention
// (body _kernel).  q (B, H, Sq, dh), k/v (B, K, T, dh) in f32 or bf16, read by
// stride, so the model's (B, S, H, dh) / (B, T, K, dh) activations are read
// in place with no transpose copy.  Query head h reads kv head h / (H / K).
// Masks: k < T, k <= q (causal), k > q - window.  Scores are scaled by
// dh^-0.5 in float32; running max m, sum l and the accumulator stay in
// float32; out = acc / max(l, 1e-20) in q's dtype.
//
// What bounds it on the H100: 4*Sq*T*dh/2 operations (causal) over
// (Sq*H + 2*T*K)*dh elements -- at S=512, dh=128 about 60 operations per
// byte of q/k/v, below the bf16 tensor-core ridge (~295): bound by bytes in
// principle, but only if the products run on the tensor cores; on the CUDA
// cores (67 TFLOP/s float32) the same work is bound by operations.
//
// Two paths; the wrapper (kernels/flash_attention.py:plan) picks one by
// dtype and layout and says which:
//   mma  (bf16, every (b, s, head) stride a multiple of 8 elements and
//        16-byte aligned bases: the model's layouts): FlashAttention-2 on the
//        tensor cores.  One block of 4 warps per (64-row q tile, q head,
//        batch), 16 q rows per warp.  Q, K and V tiles stay bf16 in shared
//        memory (rows padded by 16 bytes so ldmatrix does not conflict), 87 KB
//        at dh 128, so two blocks share an SM; at dh 80 (zamba2: 5 k-steps of
//        16, 176-byte rows, still conflict-free) 55 KB.  K/V tiles arrive through a
//        double-buffered cp.async ring: tile j+1 loads while tile j computes.
//        S = Q K^T runs as mma.sync.m16n8k16 bf16 -> f32 with ldmatrix
//        fragments (Q's fragments stay in registers for the whole block); the
//        dh^-0.5 scale is applied to S in float32 and the online softmax runs
//        on the accumulator fragment in registers.  P is rounded to bf16 in
//        registers and used directly as the A operand of P V: the m16n8k16
//        accumulator layout of two adjacent 8-column tiles is the A fragment
//        layout, so P never touches shared memory.  The TPU kernel multiplies
//        P V in float32; rounding P to bf16 adds at most 2^-9 relative error
//        per term, inside the 2e-2 bf16 tolerance (l sums the unrounded P).
//        kv tiles wholly past the causal diagonal or before the window are
//        skipped; only diagonal, window-edge and T-edge tiles are masked.
//        The heaviest (last) causal q tiles launch first to shorten the tail.
//   fma  (f32 always, so the 2e-4 parity tests see true float32; bf16 in a
//        layout the copies cannot take): one block of 256 threads per (64-row
//        q tile, q head, batch), four threads per q row, scores as float32
//        dot products from shared memory (rows padded by one float), the
//        row's max and sum combined with warp shuffles, dh/4 output columns
//        of the row per thread.  The block walks kv tiles from the window's
//        first tile to the causal diagonal and no further.
#include "mma.cuh"

namespace {

// ---------------------------------------------------------------- fma path

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
                 const T* __restrict__ v, T* __restrict__ o, float* __restrict__ lse,
                 int H, int K, int Sq, int T_len, Strides sq, Strides sk, Strides sv,
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
    // the natural-log row log-sum-exp the backward reads; a row with every
    // key masked keeps m = -1e30, as the JAX package's
    if (lse != nullptr && c == 0)
      lse[((long long)b * H + h) * Sq + q_pos] = m + logf(fmaxf(l, 1e-20f));
  }
}

template <typename T, int DH>
int launch(const void* q, const void* k, const void* v, void* o, float* lse, int B,
           int H, int K, int Sq, int T_len, Strides sq, Strides sk, Strides sv,
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
      static_cast<T*>(o), lse, H, K, Sq, T_len, sq, sk, sv, so, causal, window, scale);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int dispatch_dh(int dh, const void* q, const void* k, const void* v, void* o, float* lse,
                int B, int H, int K, int Sq, int T_len, Strides sq, Strides sk,
                Strides sv, Strides so, int causal, int window, float scale,
                cudaStream_t s) {
  switch (dh) {
    case 32: return launch<T, 32>(q, k, v, o, lse, B, H, K, Sq, T_len, sq, sk, sv, so, causal, window, scale, s);
    case 64: return launch<T, 64>(q, k, v, o, lse, B, H, K, Sq, T_len, sq, sk, sv, so, causal, window, scale, s);
    case 80: return launch<T, 80>(q, k, v, o, lse, B, H, K, Sq, T_len, sq, sk, sv, so, causal, window, scale, s);
    case 128: return launch<T, 128>(q, k, v, o, lse, B, H, K, Sq, T_len, sq, sk, sv, so, causal, window, scale, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// ---------------------------------------------------------------- mma path

constexpr int MQ = MMA_ROWS;    // q rows per block, 16 per warp
constexpr int MKV = MMA_ROWS;   // kv rows per tile
constexpr int M_THREADS = MMA_THREADS;

template <int DH>
__host__ __device__ constexpr int mma_smem_bytes() { return 5 * MQ * mma_stride<DH>() * 2; }  // Q, K x2, V x2

template <int DH>
__global__ void __launch_bounds__(M_THREADS)
flash_mma_kernel(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
                 const __nv_bfloat16* __restrict__ v, __nv_bfloat16* __restrict__ o,
                 float* __restrict__ lse, int H, int K, int Sq, int T_len, Strides sq,
                 Strides sk, Strides sv, Strides so, int causal, int window, float scale_log2) {
  constexpr int STRIDE = mma_stride<DH>();
  constexpr int TILE = MQ * STRIDE;
  constexpr int NT = MKV / 8;   // 8-column tiles of S
  constexpr int OT = DH / 8;    // 8-column tiles of O
  constexpr int KS = DH / 16;   // k-steps of Q K^T
  extern __shared__ __align__(16) __nv_bfloat16 fsm[];
  __nv_bfloat16* Qs = fsm;
  __nv_bfloat16* Ks = fsm + TILE;      // [2][MKV][STRIDE]
  __nv_bfloat16* Vs = fsm + 3 * TILE;  // [2][MKV][STRIDE]

  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int h = blockIdx.x;
  const int b = blockIdx.y;
  const int q0 = (gridDim.z - 1 - blockIdx.z) * MQ;  // last (heaviest) q tiles first
  const int kh = h / (H / K);
  const __nv_bfloat16* qb = q + b * sq.b + h * sq.h;
  const __nv_bfloat16* kb = k + b * sk.b + kh * sk.h;
  const __nv_bfloat16* vb = v + b * sv.b + kh * sv.h;

  // kv range this tile can see: from the window's first key to the diagonal
  const int kv_end = causal ? min(T_len, q0 + MQ) : T_len;
  int kv_begin = window >= 0 ? max(0, q0 - window + 1) : 0;
  kv_begin = (kv_begin / MKV) * MKV;
  const int n_tiles = kv_end > kv_begin ? (kv_end - kv_begin + MKV - 1) / MKV : 0;

  load_tile<DH>(Qs, qb, sq.s, q0, Sq, tid);
  cp_async_commit();
  if (n_tiles > 0) {
    load_tile<DH>(Ks, kb, sk.s, kv_begin, T_len, tid);
    load_tile<DH>(Vs, vb, sv.s, kv_begin, T_len, tid);
  }
  cp_async_commit();

  uint32_t qf[KS][4];
  float acc[OT][4];
#pragma unroll
  for (int t = 0; t < OT; ++t)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[t][e] = 0.f;
  float m_run[2] = {-INFINITY, -INFINITY};  // per row, in log2 units of the scaled score
  float l_run[2] = {0.f, 0.f};              // this thread's part of the row sum
  const int row_lo = q0 + warp * 16 + (lane >> 2);
  const int i8 = lane >> 3;  // which 8x8 matrix this lane addresses in ldmatrix.x4

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
    if (j == 0) {  // Q's fragments, kept in registers for every kv tile
#pragma unroll
      for (int ks = 0; ks < KS; ++ks)
        ldsm_x4(smem_u32(Qs + (warp * 16 + (i8 & 1) * 8 + (lane & 7)) * STRIDE + ks * 16 +
                         (i8 >> 1) * 8),
                qf[ks]);
    }
    const __nv_bfloat16* Kt = Ks + buf * TILE;
    const __nv_bfloat16* Vt = Vs + buf * TILE;

    // S = Q K^T: this warp's 16 rows x 64 keys
    float s[NT][4];
#pragma unroll
    for (int t = 0; t < NT; ++t)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[t][e] = 0.f;
#pragma unroll
    for (int ks = 0; ks < KS; ++ks) {
#pragma unroll
      for (int np = 0; np < NT / 2; ++np) {
        uint32_t kf[4];
        ldsm_x4(smem_u32(Kt + (np * 16 + (i8 >> 1) * 8 + (lane & 7)) * STRIDE + ks * 16 +
                         (i8 & 1) * 8),
                kf);
        mma_bf16(s[2 * np], qf[ks], kf[0], kf[1]);
        mma_bf16(s[2 * np + 1], qf[ks], kf[2], kf[3]);
      }
    }

    // masks, only on tiles that cross the diagonal, the window's edge or T
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
        s[t][e] = x;
      }

    // online softmax on the fragment: rows row_lo (e = 0, 1) and row_lo + 8
    // (e = 2, 3); the four threads of a quad share a row
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      float mx = -INFINITY;
#pragma unroll
      for (int t = 0; t < NT; ++t) mx = fmaxf(mx, fmaxf(s[t][2 * r], s[t][2 * r + 1]));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      const float m_new = fmaxf(m_run[r], mx);
      const float m_use = m_new == -INFINITY ? 0.f : m_new;  // a row with nothing seen yet
      const float alpha = ex2(m_run[r] - m_use);
      float psum = 0.f;
#pragma unroll
      for (int t = 0; t < NT; ++t) {
        s[t][2 * r] = ex2(s[t][2 * r] - m_use);
        s[t][2 * r + 1] = ex2(s[t][2 * r + 1] - m_use);
        psum += s[t][2 * r] + s[t][2 * r + 1];
      }
      l_run[r] = l_run[r] * alpha + psum;
      m_run[r] = m_new;
#pragma unroll
      for (int t = 0; t < OT; ++t) {
        acc[t][2 * r] *= alpha;
        acc[t][2 * r + 1] *= alpha;
      }
    }

    // O += P V, P straight from the S fragment as the bf16 A operand
#pragma unroll
    for (int kk = 0; kk < MKV / 16; ++kk) {
      uint32_t pa[4];
      pa[0] = pack_bf16(s[2 * kk][0], s[2 * kk][1]);
      pa[1] = pack_bf16(s[2 * kk][2], s[2 * kk][3]);
      pa[2] = pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]);
      pa[3] = pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3]);
#pragma unroll
      for (int dp = 0; dp < DH / 16; ++dp) {
        uint32_t vf[4];
        ldsm_x4_trans(smem_u32(Vt + (kk * 16 + (i8 & 1) * 8 + (lane & 7)) * STRIDE + dp * 16 +
                               (i8 >> 1) * 8),
                      vf);
        mma_bf16(acc[2 * dp], pa, vf[0], vf[1]);
        mma_bf16(acc[2 * dp + 1], pa, vf[2], vf[3]);
      }
    }
    __syncthreads();  // this tile's buffers are read; the next load may take them
  }
  cp_async_wait<0>();  // nothing in flight at exit (no kv tile: Q's copy)

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    float l = l_run[r];
    l += __shfl_xor_sync(0xffffffffu, l, 1);
    l += __shfl_xor_sync(0xffffffffu, l, 2);
    const float inv = 1.f / fmaxf(l, 1e-20f);
    const int qp = row_lo + r * 8;
    if (qp >= Sq) continue;
    // m_run is in log2 units of the scaled score: the natural-log lse is
    // (m + log2 l) ln 2.  A row with every key masked (l = 0, m = -inf)
    // gets the JAX package's -1e30, not -inf
    if (lse != nullptr && (lane & 3) == 0)
      lse[((long long)b * H + h) * Sq + qp] =
          l > 0.f ? (m_run[r] + log2f(l)) * 0.6931471805599453f : REPRO_NEG_INF;
    __nv_bfloat16* orow = o + b * so.b + (long long)qp * so.s + h * so.h;
#pragma unroll
    for (int t = 0; t < OT; ++t)
      *reinterpret_cast<__nv_bfloat162*>(orow + t * 8 + (lane & 3) * 2) =
          __floats2bfloat162_rn(acc[t][2 * r] * inv, acc[t][2 * r + 1] * inv);
  }
}

template <int DH>
int launch_mma(const void* q, const void* k, const void* v, void* o, float* lse, int B, int H,
               int K, int Sq, int T_len, Strides sq, Strides sk, Strides sv, Strides so,
               int causal, int window, float scale, cudaStream_t stream) {
  constexpr int smem = mma_smem_bytes<DH>();
  static bool configured = false;  // one attribute call per instantiation
  if (!configured) {
    cudaError_t e = cudaFuncSetAttribute(flash_mma_kernel<DH>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return static_cast<int>(e);
    configured = true;
  }
  dim3 grid(H, B, (Sq + MQ - 1) / MQ);
  flash_mma_kernel<DH><<<grid, M_THREADS, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<__nv_bfloat16*>(o), lse, H, K, Sq,
      T_len, sq, sk, sv, so, causal, window, scale * 1.4426950408889634f);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Paths, as kernels/flash_attention.py numbers them.
#define FLASH_PATH_FMA 0
#define FLASH_PATH_MMA 1

// Strides are in elements, for the (b, s, head) axes of each tensor; the
// last axis is contiguous.  window < 0 means no window.  lse, when not null,
// receives the row log-sum-exp, (B, H, Sq) float32 contiguous; null leaves
// the serving call as it was.
extern "C" int flash_attention_fwd(
    const void* q, const void* k, const void* v, void* o, int dtype, int path, int B,
    int H, int K, int Sq, int T_len, int dh,
    long long sqb, long long sqs, long long sqh,
    long long skb, long long sks, long long skh,
    long long svb, long long svs, long long svh,
    long long sob, long long sos, long long soh,
    int causal, int window, float scale, void* lse_out, void* stream) {
  float* lse = static_cast<float*>(lse_out);
  const Strides sq{sqb, sqs, sqh}, sk{skb, sks, skh}, sv{svb, svs, svh}, so{sob, sos, soh};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (path == FLASH_PATH_MMA) {
    if (dtype != REPRO_BF16) return static_cast<int>(cudaErrorInvalidValue);
    switch (dh) {
      case 32: return launch_mma<32>(q, k, v, o, lse, B, H, K, Sq, T_len, sq, sk, sv, so, causal, window, scale, s);
      case 64: return launch_mma<64>(q, k, v, o, lse, B, H, K, Sq, T_len, sq, sk, sv, so, causal, window, scale, s);
      case 80: return launch_mma<80>(q, k, v, o, lse, B, H, K, Sq, T_len, sq, sk, sv, so, causal, window, scale, s);
      case 128: return launch_mma<128>(q, k, v, o, lse, B, H, K, Sq, T_len, sq, sk, sv, so, causal, window, scale, s);
      default: return static_cast<int>(cudaErrorInvalidValue);
    }
  }
  if (path != FLASH_PATH_FMA) return static_cast<int>(cudaErrorInvalidValue);
  if (dtype == REPRO_F32)
    return dispatch_dh<float>(dh, q, k, v, o, lse, B, H, K, Sq, T_len, sq, sk, sv, so, causal, window, scale, s);
  return dispatch_dh<__nv_bfloat16>(dh, q, k, v, o, lse, B, H, K, Sq, T_len, sq, sk, sv, so, causal, window, scale, s);
}
