// K5 backward: the reverse WKV scan, the gradients of the RWKV6 recurrence,
// for Hopper (sm_90a).
//
// The TPU kernel (src/repro/kernels/rwkv6_scan.py:rwkv6_scan) has no
// backward of its own: the JAX package differentiates the model's lax.scan
// over rwkv6_wkv_step (src/repro/models/ssm.py:111-116) by autodiff.  This
// kernel takes the place of that VJP on the card.  Per (batch b, head h),
// with S_t the dh x dh f32 state entering step t (S_0 = s0) and dS the
// state's adjoint, starting at ds_final (or zero) and carried from t = T-1
// down to 0:
//   dr_t[i] = sum_j dout_t[j] (u[i] k_t[i] v_t[j] + S_t[i,j])
//   dk_t[i] = r_t[i] u[i] (v_t . dout_t) + sum_j dS[i,j] v_t[j]
//   dv_t[j] = sum_i r_t[i] u[i] k_t[i] dout_t[j] + sum_i dS[i,j] k_t[i]
//   dw_t[i] = sum_j dS[i,j] S_t[i,j]
//   du[h,i] = sum_{b,t} r_t[i] k_t[i] (v_t . dout_t)
//   dS <- diag(w_t) dS + r_t dout_t^T;   ds0 = dS at the end.
// float32 throughout (the model feeds K5 float32).
//
// What bounds it on the H100: at rwkv6-3b's training shape (B 2, H 40,
// T 512, dh 64) it must read r, k, v, w, dout, u and s0 and write dr, dk,
// dv, dw, du and ds0: 97.0 MB (0.029 ms at 3.35 TB/s), against ~15 dh^2
// operations a step, the recompute included (2.5 GFLOP, 0.038 ms at 67
// TFLOP/s f32; chip_smoke.py counts both).  Both are far below what a chain
// of T dependent steps per (b, h) allows: only independent columns and rows
// fill the card around it, so the design is about latency: short serial
// chains, many warps an SM, the next inputs in flight, and no round trip of
// partial sums through device memory.
//
// Design.  dw_t and dr_t need S_t, and the walk runs backward in time;
// recovering S_t by dividing by w_t is unstable (w can be near 0), so the
// forward, under autograd, writes the state entering every chunk of CK = 16
// steps (csrc/rwkv6_scan.cu's ckpt), and the backward recomputes each
// chunk's states from its checkpoint, last chunk first.  One block of 4 dh
// threads per (value-column slice of JB = 16 columns, head, batch), the
// dh / 16 slices of a head one thread block cluster: thread (i, q) holds
// columns 4q..4q+3 of row i of the slice's S while recomputing and of dS
// throughout, so a step's serial chain is 4 columns long; each thread forms
// its 4 columns' share of the step's partial dr, dk, dw and du term (from
// v.dout, dout.S_t, dS.v, dS.S_t), and the four adjacent lanes of a row sum
// the four values at once with three __shfl_xor_sync, lane q keeping value q.
//   wkvbwd_scan    per chunk: its r, k, w (dh wide) and v, dout (the
//                  slice's columns) were copied into shared memory by
//                  cp.async while the chunk before ran, and the next
//                  chunk's copies (and its checkpoint row) start at once
//                  (two buffers).  The chunk is walked in two halves of 8
//                  steps, so only 8 states are held (8 x dh x 16 floats):
//                  steps 0-7 are run from the checkpoint without storing,
//                  the states of steps 8-15 stored and walked back through;
//                  then steps 0-7 are recomputed, stored and walked back
//                  through; the loops over a half's steps are unrolled.
//                  Each step puts this slice's partial dr, dk and dw of row
//                  i in shared memory (one of the row's four threads each)
//                  and the row's contribution to dv_t[j] (k_t[i] dS[i,j] +
//                  r_t[i] u[i] k_t[i] dout_t[j]) in the state's slot.  After
//                  each half every block sums its slots over the rows into
//                  dv, two threads a (step, column), each over every other
//                  row in order, the two sums then added, while the cluster
//                  barrier (arrived at before, waited on after) completes;
//                  then block c of the cluster sums rows 16c..16c+15 of the
//                  cluster's partials, read from each block's shared memory
//                  in slice order, into dr, dk, dw.  The partials are
//                  double-buffered by half, so the next cluster barrier
//                  also frees them.  du's partial sums over the steps in a
//                  register.
//   wkvbwd_du      du (over b and the slices): the per-slice partials
//                  summed in slice order, then b order.
// No atomics: two calls give the same bits.  At rwkv6-3b's B 2 H 40: 80
// clusters of 4 blocks of 256 threads with 73,728 bytes of shared memory
// each, three blocks an SM: one wave on 132 SMs
// (kernels/rwkv6_scan_bwd.py:plan).
// Measured and not kept (PERF.md): one thread a row and 16 columns, all 16
// states in shared memory (81 KB, two blocks an SM: two rounds); a chunk's
// r, k, w held in registers, loaded all at once (255 registers and spills);
// the half-chunk form with its partials reduced through device memory by a
// second kernel, with and without its step loops unrolled.
#include "common.cuh"
#include "hopper.cuh"

namespace {

constexpr int CK = 16;      // steps between the forward's checkpoints (rwkv6_scan.cu CHUNK)
constexpr int HALF = 8;     // steps whose states are held at once
constexpr int JB = 16;      // value columns of one block
constexpr int QCOLS = 4;    // value columns of one thread: JB / 4 threads a row

struct Seq {  // element strides of (batch, head, time); d is 1
  long long b, h, t;
};

// shared floats of one block: the held states, two buffers of a chunk's r,
// k, w ([CK][dh] each) and v, dout ([CK][JB] each), and two buffers of a
// half's partial dr, dk, dw ([3][HALF][dh])
__host__ __device__ constexpr int buf_floats(int dh) { return 3 * CK * dh + 2 * CK * JB; }
__host__ __device__ constexpr int part_floats(int dh) { return 3 * HALF * dh; }
__host__ __device__ constexpr int scan_smem_floats(int dh) {
  return HALF * dh * JB + 2 * buf_floats(dh) + 2 * part_floats(dh);
}

__device__ __forceinline__ float4 ld4(const float* p) {
  return make_float4(p[0], p[1], p[2], p[3]);
}
__device__ __forceinline__ float dot4(float4 a, float4 b, float acc) {
  return fmaf(a.w, b.w, fmaf(a.z, b.z, fmaf(a.y, b.y, fmaf(a.x, b.x, acc))));
}
// Four sums over the four lanes of a row at once: lane q holds a[0..3] and
// gets a[q] summed over the lanes, as (lane 0 + lane 1) + (lane 2 + lane 3),
// with three shuffles (each lane passes on the halves it does not keep).
__device__ __forceinline__ float quad_transpose_sum(const float (&a)[4], int q) {
  const bool odd = q & 1, high = q & 2;
  float k0 = odd ? a[1] : a[0], k1 = odd ? a[3] : a[2];
  k0 += __shfl_xor_sync(0xffffffffu, odd ? a[0] : a[1], 1);
  k1 += __shfl_xor_sync(0xffffffffu, odd ? a[2] : a[3], 1);
  const float keep = high ? k1 : k0;
  return keep + __shfl_xor_sync(0xffffffffu, high ? k0 : k1, 2);
}

template <int DH>
__global__ void __launch_bounds__(4 * DH, 3)
wkvbwd_scan(const float* __restrict__ r, const float* __restrict__ k,
            const float* __restrict__ v, const float* __restrict__ w,
            const float* __restrict__ u, const float* __restrict__ ckpt,
            const float* __restrict__ dout, const float* __restrict__ ds_final,
            float* __restrict__ dr, float* __restrict__ dk, float* __restrict__ dv,
            float* __restrict__ dw, float* __restrict__ ds0, float* __restrict__ du_part,
            int B, int H, int T_len, Seq sr, Seq sk, Seq sv, Seq sw, Seq sdo, Seq sdr,
            Seq sdk, Seq sdv, Seq sdw) {
  constexpr int NT = 4 * DH;             // threads
  constexpr int SLICES = DH / JB;        // blocks of the cluster
  constexpr int BUF = buf_floats(DH);
  constexpr int PART = part_floats(DH);
  extern __shared__ __align__(16) float bwd_smem[];
  float* Ss = bwd_smem;                  // [HALF][DH][JB]: S_t, then dv's contributions
  float* bufs = Ss + HALF * DH * JB;     // [2][BUF]
  float* parts = bufs + 2 * BUF;         // [2][3][HALF][DH]: this slice's dr, dk, dw

  const int tid = threadIdx.x;
  const int i = tid >> 2, q = tid & 3;   // row i, columns 4q..4q+3 of the slice
  const int slice = blockIdx.x, h = blockIdx.y, b = blockIdx.z;  // slice: the cluster rank
  const int j0 = slice * JB;
  const float ui = u[h * DH + i];
  const float* rb = r + b * sr.b + h * sr.h;
  const float* kb = k + b * sk.b + h * sk.h;
  const float* vb = v + b * sv.b + h * sv.h + j0;
  const float* wb = w + b * sw.b + h * sw.h;
  const float* db = dout + b * sdo.b + h * sdo.h + j0;
  float* dvb = dv + b * sdv.b + h * sdv.h + j0;
  const long long bh = (long long)b * H + h;
  const int n_chunks = (T_len + CK - 1) / CK;

  // the chunk's inputs into buffer `to`: 4-byte copies, consecutive threads
  // on consecutive floats
  auto load_chunk = [&](int ch, float* to) {
    const int t0 = ch * CK, n = min(CK, T_len - t0);
    for (int idx = tid; idx < n * DH; idx += NT) {
      const int tt = idx / DH, c = idx % DH;
      cp_async4(to + idx, rb + (t0 + tt) * sr.t + c);
      cp_async4(to + CK * DH + idx, kb + (t0 + tt) * sk.t + c);
      cp_async4(to + 2 * CK * DH + idx, wb + (t0 + tt) * sw.t + c);
    }
    for (int idx = tid; idx < n * JB; idx += NT) {
      const int tt = idx / JB, jj = idx % JB;
      cp_async4(to + 3 * CK * DH + idx, vb + (t0 + tt) * sv.t + jj);
      cp_async4(to + 3 * CK * DH + CK * JB + idx, db + (t0 + tt) * sdo.t + jj);
    }
  };

  float4 dS = make_float4(0.f, 0.f, 0.f, 0.f);
  if (ds_final != nullptr) dS = ld4(ds_final + (bh * DH + i) * DH + j0 + QCOLS * q);
  float du_acc = 0.f;  // lane 3 of a row: du's partial sum over the steps
  const float* ck_row = ckpt + (bh * n_chunks * DH + i) * DH + j0 + QCOLS * q;
  float4 cp_next = ld4(ck_row + (long long)(n_chunks - 1) * DH * DH);
  int hb = 0;  // the partials' buffer of this half

  load_chunk(n_chunks - 1, bufs);
  cp_async_commit();
  for (int ch = n_chunks - 1, cur = 0; ch >= 0; --ch, cur ^= 1) {
    cp_async_wait<0>();
    __syncthreads();  // this chunk's inputs have landed; the last chunk's are consumed
    if (ch > 0) load_chunk(ch - 1, bufs + (cur ^ 1) * BUF);
    cp_async_commit();
    const float* Rs = bufs + cur * BUF;  // [CK][DH]
    const float* Ks = Rs + CK * DH;
    const float* Ws = Ks + CK * DH;
    const float* Vs = Ws + CK * DH;      // [CK][JB]
    const float* Ds = Vs + CK * JB;
    const int t0 = ch * CK, n = min(CK, T_len - t0);
    const float4 cp = cp_next;           // the state entering the chunk, row i, 4 columns
    if (ch > 0) cp_next = ld4(ck_row + (long long)(ch - 1) * DH * DH);
    auto step = [&](float4 S, int tt) {  // S_{t+1} from S_t, t = t0 + tt
      const float kt = Ks[tt * DH + i], wt = Ws[tt * DH + i];
      const float4 vj = *reinterpret_cast<const float4*>(Vs + tt * JB + QCOLS * q);
      return make_float4(fmaf(wt, S.x, kt * vj.x), fmaf(wt, S.y, kt * vj.y),
                         fmaf(wt, S.z, kt * vj.z), fmaf(wt, S.w, kt * vj.w));
    };

    // the later half (steps 8..n-1) first, then steps 0..min(n, 8)-1; the
    // loops over a half's steps are unrolled, their last ones skipped in a
    // ragged chunk
    for (int half = n > HALF ? 1 : 0; half >= 0; --half, hb ^= 1) {
      const int base = half * HALF, cnt = half ? n - HALF : min(n, HALF);
      float* P = parts + hb * PART;      // [3][HALF][DH]
      float4 S = cp;
      if (half) {
#pragma unroll
        for (int tt = 0; tt < HALF; ++tt) S = step(S, tt);  // run without storing
      }
#pragma unroll
      for (int s = 0; s < HALF; ++s) {  // recompute and store the half's states
        if (s < cnt) {
          *reinterpret_cast<float4*>(Ss + (s * DH + i) * JB + QCOLS * q) = S;
          S = step(S, base + s);
        }
      }
      // back through the half; row i's slots are its four threads' alone until the sync
#pragma unroll
      for (int s = HALF - 1; s >= 0; --s) {
        if (s >= cnt) continue;
        const int tt = base + s;
        const float rt = Rs[tt * DH + i], kt = Ks[tt * DH + i], wt = Ws[tt * DH + i];
        const float ruk = rt * ui * kt;
        const float4 vj = *reinterpret_cast<const float4*>(Vs + tt * JB + QCOLS * q);
        const float4 dj = *reinterpret_cast<const float4*>(Ds + tt * JB + QCOLS * q);
        float4* slot = reinterpret_cast<float4*>(Ss + (s * DH + i) * JB + QCOLS * q);
        const float4 st = *slot;
        // this thread's 4 columns of the slice's partial dr, dk, dw of row i
        // and of du's term, each summed over the row's lanes into lane 0, 1,
        // 2 and 3
        const float vdo = dot4(vj, dj, 0.f);
        const float a[4] = {fmaf(ui * kt, vdo, dot4(dj, st, 0.f)),
                            fmaf(rt * ui, vdo, dot4(dS, vj, 0.f)), dot4(dS, st, 0.f),
                            rt * kt * vdo};
        *slot = make_float4(fmaf(kt, dS.x, ruk * dj.x), fmaf(kt, dS.y, ruk * dj.y),
                            fmaf(kt, dS.z, ruk * dj.z), fmaf(kt, dS.w, ruk * dj.w));
        dS = make_float4(fmaf(wt, dS.x, rt * dj.x), fmaf(wt, dS.y, rt * dj.y),
                         fmaf(wt, dS.z, rt * dj.z), fmaf(wt, dS.w, rt * dj.w));
        const float sum = quad_transpose_sum(a, q);
        if (q < 3) P[(q * HALF + s) * DH + i] = sum;
        else du_acc += sum;
      }
      cluster_arrive();  // this block's partials of the half are written
      __syncthreads();   // ... and its slots
      // dv of the half: item (step, column, parity p) sums rows p, p + 2, ...
      // in order; lanes 2m and 2m + 1 hold one (step, column), added even first
      for (int idx = tid; idx < cnt * JB * 2; idx += NT) {
        const int s = idx >> 5, jj = (idx >> 1) & (JB - 1), p = idx & 1;
        const float* col = Ss + (s * DH + p) * JB + jj;
        float acc = 0.f;
#pragma unroll
        for (int ii = 0; ii < DH; ii += 2) acc += col[ii * JB];
        const float odd = __shfl_xor_sync(0xffffffffu, acc, 1);
        if (p == 0) dvb[(long long)(t0 + base + s) * sdv.t + jj] = acc + odd;
      }
      cluster_wait();  // every slice's partials of the half are written
      // dr, dk, dw of rows 16 slice .. +16: the slices' partials in slice order
      for (int idx = tid; idx < 3 * cnt * JB; idx += NT) {
        const int a = idx / (cnt * JB), s = (idx / JB) % cnt, row = slice * JB + idx % JB;
        const uint32_t at = smem_u32(P + (a * HALF + s) * DH + row);
        float acc = 0.f;
#pragma unroll
        for (int c = 0; c < SLICES; ++c) acc += ld_cluster_f32(cluster_map(at, c));
        float* out = a == 0 ? dr : a == 1 ? dk : dw;
        const Seq& so = a == 0 ? sdr : a == 1 ? sdk : sdw;
        out[b * so.b + h * so.h + (long long)(t0 + base + s) * so.t + row] = acc;
      }
      __syncthreads();  // the slots are read before the next half's states overwrite them
    }
  }
  cluster_arrive();  // no block leaves while another still reads its partials
  cluster_wait();

  float* d0 = ds0 + (bh * DH + i) * DH + j0 + QCOLS * q;
  d0[0] = dS.x; d0[1] = dS.y; d0[2] = dS.z; d0[3] = dS.w;
  if (q == 3) du_part[((long long)slice * B * H + bh) * DH + i] = du_acc;
}

// du (H, dh) from du_part (slices, B, H, dh), summed in slice order, then b order
__global__ void __launch_bounds__(256)
wkvbwd_du(const float* __restrict__ du_part, float* __restrict__ du, int B, int H, int dh,
          int slices) {
  const int hi = blockIdx.x * blockDim.x + threadIdx.x;  // h * dh + i
  if (hi >= H * dh) return;
  float acc = 0.f;
  for (int b = 0; b < B; ++b)
    for (int s = 0; s < slices; ++s) acc += du_part[((long long)s * B + b) * H * dh + hi];
  du[hi] = acc;
}

// one head dim's scan: (dh / 16, H, B) blocks of 4 dh threads, the dh / 16
// slices of a head one cluster
template <int DH>
cudaError_t launch_scan(const float* r, const float* k, const float* v, const float* w,
                        const float* u, const float* ckpt, const float* dout,
                        const float* ds_final, float* dr, float* dk, float* dv, float* dw,
                        float* ds0, float* du_part, int B, int H, int T_len, const Seq* seqs,
                        cudaStream_t s) {
  const int smem = scan_smem_floats(DH) * 4;
  static bool configured = false;
  if (!configured) {
    cudaError_t e = cudaFuncSetAttribute(
        wkvbwd_scan<DH>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    // as much of the SM's 256 KB as shared memory as it takes: three blocks of 72 KB at dh 64
    if (e == cudaSuccess)
      e = cudaFuncSetAttribute(wkvbwd_scan<DH>, cudaFuncAttributePreferredSharedMemoryCarveout,
                               cudaSharedmemCarveoutMaxShared);
    if (e != cudaSuccess) return e;
    configured = true;
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(DH / JB, H, B);
  cfg.blockDim = dim3(4 * DH);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = s;
  cudaLaunchAttribute cluster[1];
  cluster[0].id = cudaLaunchAttributeClusterDimension;
  cluster[0].val.clusterDim.x = DH / JB;
  cluster[0].val.clusterDim.y = 1;
  cluster[0].val.clusterDim.z = 1;
  cfg.attrs = cluster;
  cfg.numAttrs = 1;
  return cudaLaunchKernelEx(&cfg, wkvbwd_scan<DH>, r, k, v, w, u, ckpt, dout, ds_final, dr, dk,
                            dv, dw, ds0, du_part, B, H, T_len, seqs[0], seqs[1], seqs[2],
                            seqs[3], seqs[4], seqs[5], seqs[6], seqs[7], seqs[8]);
}

}  // namespace

// r/k/v/w and dout: (B, H, T, dh) f32, read with element strides (b, h, t)
// and unit d stride; u: (H, dh) f32 contiguous; ckpt: (B, H, ceil(T / 16),
// dh, dh) f32 contiguous, written by rwkv6_scan_fwd; ds_final: (B, H, dh, dh)
// f32 contiguous or null (zero).  Writes dr, dk, dv, dw (by strides), ds0
// (B, H, dh, dh) contiguous, and through du_part (slices, B, H, dh) f32
// scratch du (H, dh).  dh is 16, 32 or 64; slices = dh / 16; 4 dh threads a
// block.
extern "C" int rwkv6_scan_bwd(const void* r, const void* k, const void* v, const void* w,
                              const void* u, const void* ckpt, const void* dout,
                              const void* ds_final, void* dr, void* dk, void* dv, void* dw,
                              void* du, void* ds0, void* du_part, int B, int H, int T_len,
                              int dh, long long rb, long long rh, long long rt, long long kb,
                              long long kh, long long kt, long long vb, long long vh,
                              long long vt, long long wb, long long wh, long long wt,
                              long long dob, long long doh, long long dot, long long drb,
                              long long drh, long long drt, long long dkb, long long dkh,
                              long long dkt, long long dvb, long long dvh, long long dvt,
                              long long dwb, long long dwh, long long dwt, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dh != 16 && dh != 32 && dh != 64) return static_cast<int>(cudaErrorInvalidValue);
  const Seq seqs[9] = {{rb, rh, rt},    {kb, kh, kt},    {vb, vh, vt},
                       {wb, wh, wt},    {dob, doh, dot}, {drb, drh, drt},
                       {dkb, dkh, dkt}, {dvb, dvh, dvt}, {dwb, dwh, dwt}};
  const auto f = [](const void* p) { return static_cast<const float*>(p); };
  const auto o = [](void* p) { return static_cast<float*>(p); };
  cudaError_t e;
  switch (dh) {
    case 16: e = launch_scan<16>(f(r), f(k), f(v), f(w), f(u), f(ckpt), f(dout), f(ds_final),
                                 o(dr), o(dk), o(dv), o(dw), o(ds0), o(du_part), B, H, T_len,
                                 seqs, s); break;
    case 32: e = launch_scan<32>(f(r), f(k), f(v), f(w), f(u), f(ckpt), f(dout), f(ds_final),
                                 o(dr), o(dk), o(dv), o(dw), o(ds0), o(du_part), B, H, T_len,
                                 seqs, s); break;
    default: e = launch_scan<64>(f(r), f(k), f(v), f(w), f(u), f(ckpt), f(dout), f(ds_final),
                                 o(dr), o(dk), o(dv), o(dw), o(ds0), o(du_part), B, H, T_len,
                                 seqs, s); break;
  }
  if (e != cudaSuccess) return static_cast<int>(e);
  wkvbwd_du<<<(H * dh + 255) / 256, 256, 0, s>>>(f(du_part), o(du), B, H, dh, dh / JB);
  return static_cast<int>(cudaGetLastError());
}
