// K2: decode attention -- one query token per sequence against the KV cache,
// for Hopper (sm_90a), split across the cache (flash-decoding).
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
// once for 4*G*dh operations per kv head, about 3 operations per byte at
// G = 3, far below the ~295 operations per byte where compute would take
// over.  So the design puts as many bytes in flight as the card can hold.
//
// Design (kernels/decode_attention.py:plan sizes the split):
//   split kernel  grid (split, kv head, batch row), 4 warps a block.  The
//                 cache axis [0, S) is cut into `splits` chunks of `chunk`
//                 entries (a multiple of the 32-entry tile), from the static
//                 shapes alone (B, K, S and the SM count), never from
//                 lengths: one captured graph serves every replay while
//                 lengths grow.  At B = 4, K = 8, S = 1024 that is 32 splits
//                 of one tile, 1024 blocks.  A split wholly at or past
//                 lengths[b], or before the window, writes an empty state
//                 (l = 0) and exits.  Inside a split, 32-entry key and value
//                 tiles are staged through shared memory by 16-byte cp.async
//                 copies (16 threads per 256-byte bf16 row, coalesced),
//                 double-buffered when a split has more than one tile, so
//                 the next tile lands while this one is scored; a one-tile
//                 split takes one stage, so twice the blocks fit on an SM.
//                 Rows are padded by 16 bytes, so a warp reading 8 key rows
//                 at once hits 8 distinct bank groups.  Warp w serves query
//                 rows g = w and w + 4 of the group: for the scores lane j
//                 dots key row j with q (8 independent partial sums); the
//                 online softmax runs across the lanes; for P.V the lanes
//                 split the head dimension and p_j comes by shuffle.  The
//                 CUDA cores suffice: the bytes, not the arithmetic, are the
//                 limit, and what a split waits on is latency, so splits are
//                 short and many.  Each writes its (m, l, acc) to float32
//                 scratch.
//   merge kernel  one block per (kv head, batch row), one thread per output
//                 element, rescales and adds the splits' states in split
//                 order: each split's weight first, into shared memory, then
//                 the sums over the splits as independent loads.  With one
//                 split the split kernel writes the output itself.
// One kernel template serves bf16 and f32 (f32 accumulation either way), so
// the f32 parity tests at 2e-4 hold with no second kernel.
#include "common.cuh"
#include "hopper.cuh"

namespace {

constexpr int WARPS = 4;
constexpr int THREADS = WARPS * 32;
constexpr int MAXG = 8;
constexpr int RPW = MAXG / WARPS;  // query rows per warp
constexpr int TILE = 32;           // cache entries per staged tile (one per lane)

struct Strides {  // element strides of (b, head, row) for one tensor; d is 1
  long long b, h, r;
};

template <typename T, int DH>
struct Smem {
  static constexpr int ROW = DH * (int)sizeof(T) + 16;  // bytes of one padded row
  static constexpr int STAGE = 2 * TILE * ROW;         // a key and a value tile
};

// Does lane own its c-th value column?  Every column below DH has one owner;
// the test folds away when 32 divides DH.
template <int DH>
__device__ __forceinline__ bool col_ok_dh(int lane, int c) {
  return DH % 32 == 0 || lane * ((DH + 31) / 32) + c < DH;
}

template <typename T, int DH>
__global__ void __launch_bounds__(THREADS)
decode_split_kernel(const T* __restrict__ q, const T* __restrict__ kc,
                    const T* __restrict__ vc, const int* __restrict__ lengths,
                    T* __restrict__ o, float* __restrict__ part_acc,
                    float* __restrict__ part_ml, int G, int S, int chunk,
                    Strides sq, Strides sk, Strides sv, Strides so, int window,
                    float scale) {
  // value columns per lane: lane owns lane*VPL .. +VPL, those below DH (at
  // DH = 80 lanes 0-26 own 3 columns each, the last lane 2, lanes 27-31 none)
  constexpr int VPL = (DH + 31) / 32;
  constexpr int CPR = DH * (int)sizeof(T) / 16;  // 16-byte chunks per row
  constexpr int PER16 = 16 / (int)sizeof(T);
  constexpr int ROW = Smem<T, DH>::ROW;
  constexpr int STAGE = Smem<T, DH>::STAGE;
  extern __shared__ __align__(16) unsigned char smem[];  // 1 stage, or 2 when chunk > TILE
  __shared__ __align__(16) float Qs[MAXG][DH];

  const int split = blockIdx.x, splits = gridDim.x;
  const int kh = blockIdx.y, b = blockIdx.z, K = gridDim.y;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;

  const int len = min(lengths[b], S);
  const int begin = window >= 0 ? max(0, len - window) : 0;
  const int lo = max(split * chunk, begin);
  const int hi = min(split * chunk + chunk, len);
  const long long part = ((long long)(b * K + kh) * splits + split) * G;

  if (lo >= hi) {  // no entry of this split is attended: an empty state
    if (splits == 1) {
      for (int i = tid; i < G * DH; i += THREADS)
        o[b * so.b + kh * so.h + (i / DH) * so.r + i % DH] = from_f32<T>(0.f);
    } else if (tid < G) {
      part_ml[(part + tid) * 2 + 1] = 0.f;
    }
    return;
  }

  const T* kbase = kc + b * sk.b + kh * sk.h;
  const T* vbase = vc + b * sv.b + kh * sv.h;
  const int first = split * chunk + (lo - split * chunk) / TILE * TILE;
  const int ntiles = (hi - first + TILE - 1) / TILE;

  auto issue = [&](int t) {  // 16 threads per 256-byte row: coalesced
    const int base = first + t * TILE;
    unsigned char* ks = smem + (t & 1) * STAGE;
    unsigned char* vs = ks + STAGE / 2;
    for (int i = tid; i < TILE * CPR; i += THREADS) {
      const int r = i / CPR, c = i % CPR;
      const bool ok = base + r >= lo && base + r < hi;  // others are zeros
      const long long e = ok ? base + r : lo;
      cp_async16(ks + r * ROW + c * 16, kbase + e * sk.r + c * PER16, ok);
      cp_async16(vs + r * ROW + c * 16, vbase + e * sv.r + c * PER16, ok);
    }
  };

  issue(0);
  cp_async_commit();
  if (ntiles > 1) issue(1);
  cp_async_commit();
  for (int i = tid; i < G * DH; i += THREADS) {  // while the first tiles land
    const int g = i / DH, d = i % DH;
    Qs[g][d] = to_f32(q[b * sq.b + kh * sq.h + g * sq.r + d]) * scale;
  }

  float m[RPW], l[RPW], acc[RPW][VPL];
#pragma unroll
  for (int r = 0; r < RPW; ++r) {
    m[r] = REPRO_NEG_INF;
    l[r] = 0.f;
#pragma unroll
    for (int c = 0; c < VPL; ++c) acc[r][c] = 0.f;
  }

  for (int t = 0; t < ntiles; ++t) {
    cp_async_wait<1>();  // tile t has landed (for this thread's copies) ...
    __syncthreads();     // ... and for every thread's; Qs is written too
    const unsigned char* ks = smem + (t & 1) * STAGE;
    const unsigned char* vs = ks + STAGE / 2;
    const int key = first + t * TILE + lane;
    const bool valid = key >= lo && key < hi;
    // scores of key row `lane` against the warp's query rows, as PER16
    // independent partial sums per row (not one chain of DH dependent FMAs)
    float dot[RPW][PER16] = {};
    const T* krow = reinterpret_cast<const T*>(ks + lane * ROW);
#pragma unroll 4
    for (int d0 = 0; d0 < DH; d0 += PER16) {
      float kv[PER16];
      unpack16(krow + d0, kv);
#pragma unroll
      for (int r = 0; r < RPW; ++r) {
        const int g = warp + r * WARPS;
        if (g < G) {
#pragma unroll
          for (int e = 0; e < PER16; ++e) dot[r][e] = fmaf(Qs[g][d0 + e], kv[e], dot[r][e]);
        }
      }
    }
    float p[RPW] = {};
#pragma unroll
    for (int r = 0; r < RPW; ++r) {
      if (warp + r * WARPS >= G) break;  // warp-uniform
      float sg = 0.f;
#pragma unroll
      for (int e = 0; e < PER16; ++e) sg += dot[r][e];
      sg = valid ? sg : REPRO_NEG_INF;
      const float m_new = fmaxf(m[r], warp_max(sg));
      p[r] = valid ? expf(sg - m_new) : 0.f;
      const float alpha = expf(m[r] - m_new);
      l[r] = l[r] * alpha + warp_sum(p[r]);
      m[r] = m_new;
#pragma unroll
      for (int c = 0; c < VPL; ++c) acc[r][c] *= alpha;
    }
    // P.V: lane owns value columns lane*VPL .. +VPL; rows past hi are zeros
#pragma unroll 8
    for (int j = 0; j < TILE; ++j) {
      const T* vrow = reinterpret_cast<const T*>(vs + j * ROW) + lane * VPL;
      float vv[VPL];
#pragma unroll
      for (int c = 0; c < VPL; ++c) vv[c] = col_ok_dh<DH>(lane, c) ? to_f32(vrow[c]) : 0.f;
#pragma unroll
      for (int r = 0; r < RPW; ++r) {
        if (warp + r * WARPS >= G) break;
        const float pj = __shfl_sync(0xffffffffu, p[r], j);
#pragma unroll
        for (int c = 0; c < VPL; ++c) acc[r][c] = fmaf(pj, vv[c], acc[r][c]);
      }
    }
    __syncthreads();  // every warp is done with this stage before it refills
    if (t + 2 < ntiles) issue(t + 2);
    cp_async_commit();
  }
  cp_async_wait<0>();

#pragma unroll
  for (int r = 0; r < RPW; ++r) {
    const int g = warp + r * WARPS;
    if (g >= G) break;
    if (splits == 1) {  // the only split: the output itself
      const float inv = 1.f / fmaxf(l[r], 1e-20f);
#pragma unroll
      for (int c = 0; c < VPL; ++c)
        if (col_ok_dh<DH>(lane, c))
          o[b * so.b + kh * so.h + g * so.r + lane * VPL + c] = from_f32<T>(acc[r][c] * inv);
      continue;
    }
    if (lane == 0) {
      part_ml[(part + g) * 2] = m[r];
      part_ml[(part + g) * 2 + 1] = l[r];
    }
#pragma unroll
    for (int c = 0; c < VPL; ++c)
      if (col_ok_dh<DH>(lane, c)) part_acc[(part + g) * DH + lane * VPL + c] = acc[r][c];
  }
}

// Merge the splits' (m, l, acc) of one (kv head, batch row), in split order,
// one thread per output element.  The weights exp(m_s - max m) of every
// (g, split) go to shared memory first, so the sums over the splits are
// independent loads rather than a chain that waits on each split's state.
// A split with l = 0 attended nothing: its weight is 0 and its m and acc
// (not written, so possibly garbage) are passed over.
template <typename T>
__global__ void __launch_bounds__(MAXG * 128)
decode_merge_kernel(const float* __restrict__ part_acc, const float* __restrict__ part_ml,
                    T* __restrict__ o, int G, int dh, int splits, Strides so) {
  extern __shared__ float wts[];  // [G][splits] weights, then [G] 1 / sum of weighted l
  const int kh = blockIdx.x, b = blockIdx.y, K = gridDim.x;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32, warps = blockDim.x / 32;
  const long long base = (long long)(b * K + kh) * splits;
  for (int g = warp; g < G; g += warps) {
    float mx = REPRO_NEG_INF;
    for (int sp = lane; sp < splits; sp += 32) {
      const long long ps = (base + sp) * G + g;
      if (part_ml[ps * 2 + 1] > 0.f) mx = fmaxf(mx, part_ml[ps * 2]);
    }
    mx = warp_max(mx);
    float lsum = 0.f;
    for (int sp = lane; sp < splits; sp += 32) {
      const long long ps = (base + sp) * G + g;
      const float ls = part_ml[ps * 2 + 1];
      const float f = ls > 0.f ? expf(part_ml[ps * 2] - mx) : 0.f;
      wts[g * splits + sp] = f;
      lsum += ls * f;
    }
    lsum = warp_sum(lsum);
    if (lane == 0) wts[G * splits + g] = 1.f / fmaxf(lsum, 1e-20f);
  }
  __syncthreads();
  for (int i = threadIdx.x; i < G * dh; i += blockDim.x) {
    const int g = i / dh, d = i % dh;
    const float* w = wts + g * splits;
    const float* acc = part_acc + (base * G + g) * dh + d;
    float a = 0.f;
#pragma unroll 16
    for (int sp = 0; sp < splits; ++sp) {
      const float v = acc[(long long)sp * G * dh];  // garbage where w is 0: not used
      a = w[sp] != 0.f ? fmaf(w[sp], v, a) : a;
    }
    o[b * so.b + kh * so.h + g * so.r + d] = from_f32<T>(a * wts[G * splits + g]);
  }
}

template <typename T, int DH>
int launch(const void* q, const void* kc, const void* vc, const int* lengths, void* o,
           float* part_acc, float* part_ml, int B, int K, int G, int S, int splits,
           int chunk, Strides sq, Strides sk, Strides sv, Strides so, int window,
           float scale, cudaStream_t stream) {
  // a split of one tile needs one stage: more blocks fit on an SM
  const int smem = (chunk > TILE ? 2 : 1) * Smem<T, DH>::STAGE;
  static bool configured = false;
  if (!configured) {
    const cudaError_t e = cudaFuncSetAttribute(decode_split_kernel<T, DH>,
                                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                                               2 * Smem<T, DH>::STAGE);
    if (e != cudaSuccess) return static_cast<int>(e);
    configured = true;
  }
  decode_split_kernel<T, DH><<<dim3(splits, K, B), THREADS, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(kc), static_cast<const T*>(vc),
      lengths, static_cast<T*>(o), part_acc, part_ml, G, S, chunk, sq, sk, sv, so, window,
      scale);
  // the merge in whole warps (G * DH = 80 at G = 1, DH = 80): its warp loop
  // counts only full warps, and a thread past G * DH takes no element
  if (splits > 1)
    decode_merge_kernel<T><<<dim3(K, B), (G * DH + 31) / 32 * 32,
                             (G * splits + G) * sizeof(float), stream>>>(
        part_acc, part_ml, static_cast<T*>(o), G, DH, splits, so);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int dispatch_dh(int dh, const void* q, const void* kc, const void* vc, const int* lengths,
                void* o, float* pa, float* pm, int B, int K, int G, int S, int splits,
                int chunk, Strides sq, Strides sk, Strides sv, Strides so, int window,
                float scale, cudaStream_t s) {
  switch (dh) {
    case 32:
      return launch<T, 32>(q, kc, vc, lengths, o, pa, pm, B, K, G, S, splits, chunk, sq, sk,
                           sv, so, window, scale, s);
    case 64:
      return launch<T, 64>(q, kc, vc, lengths, o, pa, pm, B, K, G, S, splits, chunk, sq, sk,
                           sv, so, window, scale, s);
    case 80:
      return launch<T, 80>(q, kc, vc, lengths, o, pa, pm, B, K, G, S, splits, chunk, sq, sk,
                           sv, so, window, scale, s);
    case 128:
      return launch<T, 128>(q, kc, vc, lengths, o, pa, pm, B, K, G, S, splits, chunk, sq, sk,
                            sv, so, window, scale, s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// Strides are in elements for the (b, kv head, row) axes: the row axis is the
// query group for q and out and the cache position for the caches; the last
// axis is contiguous.  window < 0 means no window.  G <= 8.  splits * chunk
// >= S with chunk a multiple of 32; part_acc (B, K, splits, G, dh) and
// part_ml (B, K, splits, G, 2) are float32 scratch, unused when splits == 1.
extern "C" int decode_attention_fwd(
    const void* q, const void* kc, const void* vc, const void* lengths, void* o,
    void* part_acc, void* part_ml, int dtype, int B, int K, int G, int dh, int S,
    int splits, int chunk,
    long long sqb, long long sqh, long long sqr,
    long long skb, long long skh, long long skr,
    long long svb, long long svh, long long svr,
    long long sob, long long soh, long long sor,
    int window, float scale, void* stream) {
  if (G < 1 || G > MAXG || splits < 1 || chunk % TILE != 0 ||
      (long long)splits * chunk < S)
    return static_cast<int>(cudaErrorInvalidValue);
  const Strides sq{sqb, sqh, sqr}, sk{skb, skh, skr}, sv{svb, svh, svr}, so{sob, soh, sor};
  const int* len = static_cast<const int*>(lengths);
  float* pa = static_cast<float*>(part_acc);
  float* pm = static_cast<float*>(part_ml);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == REPRO_F32)
    return dispatch_dh<float>(dh, q, kc, vc, len, o, pa, pm, B, K, G, S, splits, chunk, sq,
                              sk, sv, so, window, scale, s);
  return dispatch_dh<__nv_bfloat16>(dh, q, kc, vc, len, o, pa, pm, B, K, G, S, splits, chunk,
                                    sq, sk, sv, so, window, scale, s);
}
