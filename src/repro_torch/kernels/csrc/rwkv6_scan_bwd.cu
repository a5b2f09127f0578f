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
// T 512, dh 64) it reads r, k, v, w, dout and the 42 MB of checkpoints and
// writes dr, dk, dv, dw: about 136 MB (0.041 ms at 3.35 TB/s), against ~15
// dh^2 operations a step, the recompute included (2.5 GFLOP, 0.038 ms at
// 67 TFLOP/s f32).  Both are far below what a chain of T dependent steps
// per (b, h) allows: only independent columns fill the card around it.
//
// Design.  dw_t and dr_t need S_t, and the walk runs backward in time;
// recovering S_t by dividing by w_t is unstable (w can be near 0), so the
// forward, under autograd, writes the state entering every chunk of CK = 16
// steps (csrc/rwkv6_scan.cu's ckpt), and the backward recomputes each
// chunk's states from its checkpoint, last chunk first.  One block of dh
// threads per (value-column slice of JB columns, head, batch); thread i
// holds row i of S[:, slice] while recomputing and of dS[:, slice]
// throughout, so every sum over j is a sum inside one thread:
//   wkvbwd_scan    per chunk: stage r, k, w (dh wide) and v, dout (the
//                  slice's columns) in shared memory; recompute the chunk's
//                  states into shared memory (CK x JB x dh floats, rows
//                  padded by one float so both access patterns below are
//                  free of bank conflicts); then step back through the
//                  chunk.  Each step writes this slice's partial dr, dk and
//                  dw of row i to a float32 scratch, and puts its row's
//                  contribution to dv_t[j] (k_t[i] dS[i,j] + r_t[i] u[i]
//                  k_t[i] dout_t[j]) in the state's slot; after the chunk
//                  the slots are summed over i in row order into dv.  du's
//                  partial sums over the steps in a register.
//   wkvbwd_reduce  dr, dk, dw (sums over j span the slices) and du (over b,
//                  t and the slices): the per-slice partials summed in slice
//                  order, then b order for du.  No atomics: two calls give
//                  the same bits.
// JB = 16 (kernels/rwkv6_scan_bwd.py:plan): 320 blocks of 64 threads at
// rwkv6-3b's B 2 H 40, 81 KB of shared memory each, two blocks an SM.
// Measured and not kept (PERF.md): a chunk's r, k, w held in registers,
// loaded all at once (255 registers and spills: slower).
#include "common.cuh"

namespace {

constexpr int CK = 16;  // steps between the forward's checkpoints (rwkv6_scan.cu CHUNK)
constexpr int JB = 16;  // value columns of one block

struct Seq {  // element strides of (batch, head, time); d is 1
  long long b, h, t;
};

__host__ __device__ constexpr int scan_smem_floats(int dh) {
  return CK * JB * (dh + 1) + 3 * CK * dh + 2 * CK * JB;
}

__global__ void __launch_bounds__(64)
wkvbwd_scan(const float* __restrict__ r, const float* __restrict__ k,
            const float* __restrict__ v, const float* __restrict__ w,
            const float* __restrict__ u, const float* __restrict__ ckpt,
            const float* __restrict__ dout, const float* __restrict__ ds_final,
            float* __restrict__ dv, float* __restrict__ ds0, float* __restrict__ part,
            float* __restrict__ du_part, int B, int H, int T_len, int dh, Seq sr, Seq sk,
            Seq sv, Seq sw, Seq sdo, Seq sdv) {
  extern __shared__ __align__(16) float bwd_smem[];
  const int LD = dh + 1;
  float* Ss = bwd_smem;                  // [CK * JB][dh + 1]: S_t, then dv's contributions
  float* Rs = Ss + CK * JB * LD;         // [CK][dh]
  float* Ks = Rs + CK * dh;
  float* Ws = Ks + CK * dh;
  float* Vs = Ws + CK * dh;              // [CK][JB]
  float* Ds = Vs + CK * JB;              // [CK][JB]: dout

  const int i = threadIdx.x;
  const int slice = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int slices = gridDim.x;
  const int j0 = slice * JB;
  const float ui = u[h * dh + i];
  const float* rb = r + b * sr.b + h * sr.h;
  const float* kb = k + b * sk.b + h * sk.h;
  const float* vb = v + b * sv.b + h * sv.h + j0;
  const float* wb = w + b * sw.b + h * sw.h;
  const float* db = dout + b * sdo.b + h * sdo.h + j0;
  float* dvb = dv + b * sdv.b + h * sdv.h + j0;
  const long long bh = (long long)b * H + h;
  // this slice's partial dr, dk, dw: part[array][slice][b][h][t][i]
  const long long pstride = (long long)slices * B * H * T_len * dh;
  float* pr = part + ((long long)slice * B * H + bh) * T_len * dh;
  float* pk = pr + pstride;
  float* pw = pk + pstride;

  float dS[JB];
#pragma unroll
  for (int jj = 0; jj < JB; ++jj)
    dS[jj] = ds_final != nullptr ? ds_final[(bh * dh + i) * dh + j0 + jj] : 0.f;
  float du_acc = 0.f;
  const int n_chunks = (T_len + CK - 1) / CK;

  for (int ch = n_chunks - 1; ch >= 0; --ch) {
    const int t0 = ch * CK, n = min(CK, T_len - t0);
    __syncthreads();  // the previous chunk's shared memory is consumed
    for (int tt = 0; tt < n; ++tt) {
      Rs[tt * dh + i] = rb[(t0 + tt) * sr.t + i];
      Ks[tt * dh + i] = kb[(t0 + tt) * sk.t + i];
      Ws[tt * dh + i] = wb[(t0 + tt) * sw.t + i];
    }
    for (int idx = i; idx < n * JB; idx += dh) {
      const int tt = idx / JB, jj = idx % JB;
      Vs[idx] = vb[(t0 + tt) * sv.t + jj];
      Ds[idx] = db[(t0 + tt) * sdo.t + jj];
    }
    __syncthreads();

    // the chunk's states from its checkpoint: S_t of row i into its slots
    {
      float S[JB];
      const float* cp = ckpt + ((bh * n_chunks + ch) * dh + i) * dh + j0;
#pragma unroll
      for (int jj = 0; jj < JB; ++jj) S[jj] = cp[jj];
      for (int tt = 0; tt < n; ++tt) {
        const float kt = Ks[tt * dh + i], wt = Ws[tt * dh + i];
#pragma unroll
        for (int jj = 0; jj < JB; ++jj) {
          Ss[(tt * JB + jj) * LD + i] = S[jj];
          S[jj] = fmaf(wt, S[jj], kt * Vs[tt * JB + jj]);
        }
      }
    }

    // back through the chunk; row i's slots are this thread's alone until the sync
    for (int tt = n - 1; tt >= 0; --tt) {
      const float rt = Rs[tt * dh + i], kt = Ks[tt * dh + i], wt = Ws[tt * dh + i];
      const float ruk = rt * ui * kt;
      float vdo = 0.f, sdo = 0.f, dsv = 0.f, dss = 0.f;
#pragma unroll
      for (int jj = 0; jj < JB; ++jj) {
        const float vj = Vs[tt * JB + jj], dj = Ds[tt * JB + jj];
        float* slot = &Ss[(tt * JB + jj) * LD + i];
        const float st = *slot;
        vdo = fmaf(vj, dj, vdo);
        sdo = fmaf(dj, st, sdo);
        dsv = fmaf(dS[jj], vj, dsv);
        dss = fmaf(dS[jj], st, dss);
        *slot = fmaf(kt, dS[jj], ruk * dj);   // row i's share of dv_t[j]
        dS[jj] = fmaf(wt, dS[jj], rt * dj);
      }
      const long long at = (long long)(t0 + tt) * dh + i;
      pr[at] = fmaf(ui * kt, vdo, sdo);
      pk[at] = fmaf(rt * ui, vdo, dsv);
      pw[at] = dss;
      du_acc = fmaf(rt * kt, vdo, du_acc);
    }
    __syncthreads();
    // dv of the chunk: each (step, column) summed over the rows in row order
    for (int idx = i; idx < n * JB; idx += dh) {
      const float* row = Ss + idx * LD;
      float acc = 0.f;
      for (int ii = 0; ii < dh; ++ii) acc += row[ii];
      dvb[(t0 + idx / JB) * sdv.t + idx % JB] = acc;
    }
  }

#pragma unroll
  for (int jj = 0; jj < JB; ++jj) ds0[(bh * dh + i) * dh + j0 + jj] = dS[jj];
  du_part[((long long)slice * B * H + bh) * dh + i] = du_acc;
}

// dr, dk, dw (B, H, T, dh) written by stride from the slices' partials, and
// du (H, dh) from du_part (slices, B, H, dh), each summed in a fixed order.
__global__ void __launch_bounds__(256)
wkvbwd_reduce(const float* __restrict__ part, const float* __restrict__ du_part,
              float* __restrict__ dr, float* __restrict__ dk, float* __restrict__ dw,
              float* __restrict__ du, int B, int H, int T_len, int dh, int slices, Seq sdr,
              Seq sdk, Seq sdw) {
  const long long n = (long long)B * H * T_len * dh;
  const long long idx = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx < n) {
    const int i = idx % dh;
    const long long t = (idx / dh) % T_len;
    const int h = (idx / ((long long)dh * T_len)) % H;
    const int b = idx / ((long long)dh * T_len * H);
    const long long array = (long long)slices * n;   // part[array][slice][b][h][t][i]
    float ar = 0.f, ak = 0.f, aw = 0.f;
    for (int s = 0; s < slices; ++s) {
      const float* p = part + s * n + idx;
      ar += p[0];
      ak += p[array];
      aw += p[2 * array];
    }
    dr[b * sdr.b + h * sdr.h + t * sdr.t + i] = ar;
    dk[b * sdk.b + h * sdk.h + t * sdk.t + i] = ak;
    dw[b * sdw.b + h * sdw.h + t * sdw.t + i] = aw;
  } else if (idx < n + (long long)H * dh) {
    const int hi = idx - n;  // h * dh + i
    float acc = 0.f;
    for (int b = 0; b < B; ++b)
      for (int s = 0; s < slices; ++s) acc += du_part[((long long)s * B + b) * H * dh + hi];
    du[hi] = acc;
  }
}

}  // namespace

// r/k/v/w and dout: (B, H, T, dh) f32, read with element strides (b, h, t)
// and unit d stride; u: (H, dh) f32 contiguous; ckpt: (B, H, ceil(T / 16),
// dh, dh) f32 contiguous, written by rwkv6_scan_fwd; ds_final: (B, H, dh, dh)
// f32 contiguous or null (zero).  Writes dv (by strides sdv), ds0 (B, H, dh,
// dh) contiguous, and through part (3, slices, B, H, T, dh) and du_part
// (slices, B, H, dh) f32 scratch: dr, dk, dw (by strides) and du (H, dh).
// dh is 16, 32 or 64; slices = dh / 16.
extern "C" int rwkv6_scan_bwd(const void* r, const void* k, const void* v, const void* w,
                              const void* u, const void* ckpt, const void* dout,
                              const void* ds_final, void* dr, void* dk, void* dv, void* dw,
                              void* du, void* ds0, void* part, void* du_part, int B, int H,
                              int T_len, int dh, long long rb, long long rh, long long rt,
                              long long kb, long long kh, long long kt, long long vb,
                              long long vh, long long vt, long long wb, long long wh,
                              long long wt, long long dob, long long doh, long long dot,
                              long long drb, long long drh, long long drt, long long dkb,
                              long long dkh, long long dkt, long long dvb, long long dvh,
                              long long dvt, long long dwb, long long dwh, long long dwt,
                              void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dh != 16 && dh != 32 && dh != 64) return static_cast<int>(cudaErrorInvalidValue);
  const int slices = dh / JB;
  const int smem = scan_smem_floats(dh) * 4;
  static bool configured = false;
  if (!configured) {
    const cudaError_t e = cudaFuncSetAttribute(
        wkvbwd_scan, cudaFuncAttributeMaxDynamicSharedMemorySize, scan_smem_floats(64) * 4);
    if (e != cudaSuccess) return static_cast<int>(e);
    configured = true;
  }
  wkvbwd_scan<<<dim3(slices, H, B), dh, smem, s>>>(
      static_cast<const float*>(r), static_cast<const float*>(k), static_cast<const float*>(v),
      static_cast<const float*>(w), static_cast<const float*>(u),
      static_cast<const float*>(ckpt), static_cast<const float*>(dout),
      static_cast<const float*>(ds_final), static_cast<float*>(dv), static_cast<float*>(ds0),
      static_cast<float*>(part), static_cast<float*>(du_part), B, H, T_len, dh,
      {rb, rh, rt}, {kb, kh, kt}, {vb, vh, vt}, {wb, wh, wt}, {dob, doh, dot}, {dvb, dvh, dvt});
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  const long long total = (long long)B * H * T_len * dh + (long long)H * dh;
  wkvbwd_reduce<<<(unsigned)((total + 255) / 256), 256, 0, s>>>(
      static_cast<const float*>(part), static_cast<const float*>(du_part),
      static_cast<float*>(dr), static_cast<float*>(dk), static_cast<float*>(dw),
      static_cast<float*>(du), B, H, T_len, dh, slices, {drb, drh, drt}, {dkb, dkh, dkt},
      {dwb, dwh, dwt});
  return static_cast<int>(cudaGetLastError());
}
