// K4's wgmma path, shared by its forward (csrc/moe_gmm.cu: out = x w) and
// its backward's dx (csrc/moe_gmm_bwd.cu: dx = dy w^T; its dw kernel uses the
// product, the tile constants, the epilogue's staging and the tensor-map
// encoder): a grouped product out[e] (C x N) = a[e] (C x K) b[e] (K x N)
// over the live rows of each expert, bf16 in, f32 accumulate, bf16 out
// (E, C, N) contiguous.
//
// A persistent grid (one block per SM) walks the live tiles of out, 128 x
// 256 each: one producer warp keeps a ring of TMA copies in flight (an a
// tile 128 rows x 64 deep, K-major; a b tile 64 deep x 256 wide, both
// 128-byte swizzled), and two consumer warpgroups each run wgmma.m64n256k16
// on 64 of the rows.  The b operand lies in one of two layouts, a template
// flag of the body:
//   MN-major (the forward: w (E, D, F) with F contiguous, the product's N
//            axis): four 64 x 64 boxes a stage, read through the
//            instruction's transpose flag;
//   K-major  (the backward's dx: w^T, whose contraction axis F is w's
//            contiguous one): one box 64 deep x 256 rows a stage, read as
//            the a operand is, with no transpose and no copy of w.
// The tile list comes from group_sizes on the device: each block sums
// ceil(live_e / 128) in shared memory at its start, so no tile at or past
// group_sizes[e] reads a byte of b.  Tiles run expert by expert, column slab
// by column slab, row tile fastest, so the blocks that share a b slab run
// side by side and read it from L2.  Masking is in the epilogue: an output
// row depends only on its own a row, so writing zeros for rows >=
// group_sizes[e] (and for the rows of wholly dead tiles, which the consumers
// clear first) is exactly the TPU kernel's masking of x rows, and TMA loads
// whole tiles (rows past C, columns past N and depth past K come in as
// zeros).
//
// The schedule, a second template flag:
//   whole tiles (the forward): block b takes tiles b, b + G, b + 2G, ...
//            (G blocks) with a 4-stage ring, and its consumers store each
//            tile's bf16 values straight from the accumulators.
//   stream-K (dx): the full rounds of G tiles run as above, in step, so the
//            blocks sharing a slab still meet in L2; each of the R < G tiles
//            left (the last, partial wave, which left G - R SMs idle) is cut
//            at the same k-steps into P = G / R pieces (at least
//            SK_MIN_STEPS deep), one a block, so the pieces that read the
//            same slab rows still run side by side.  (Cutting the R x K
//            k-steps into G equal ranges instead puts the blocks of sibling
//            tiles at different k-steps: each then reads the slab from
//            memory, slower in all at mixtral's gate/up.)  A block whose
//            piece starts inside a tile writes its f32 sums of that tile to
//            its own slot of a workspace and raises its flag; the block that
//            ran the tile's first k-steps waits for the flags of the blocks
//            after it that hold the rest and adds their sums in block order
//            (no atomic add: the same bits on every call).  Only a tile's
//            first block waits, and only on later blocks, which write their
//            sums first; with one block an SM they all run at once.  The
//            epilogue stages the bf16 tile in a swizzled buffer, half a tile
//            at a time beside a 4-stage ring, and one thread a warpgroup
//            stores it by TMA, which drains while the next products run.
// Measured and not kept (PERF.md): a consumer warpgroup whose 64 rows all
// lie at or past group_sizes[e] skipping its products (slower dx).
#pragma once

#include "common.cuh"
#include "hopper.cuh"

namespace {

constexpr int W_BM = 128;                     // rows of out per tile (2 warpgroups x 64)
constexpr int W_BN = 256;                     // columns of out per tile
constexpr int W_BK = 64;                      // depth of one stage: 128 bytes of bf16
constexpr int W_STAGES = 4;                   // the ring of the whole-tile schedule
constexpr int SK_STAGES = 4;                  // the ring of stream-K, beside its epilogue buffer
constexpr int W_CONSUMERS = 256;
constexpr int W_THREADS = W_CONSUMERS + 32;   // + one producer warp
constexpr int W_X_BYTES = W_BM * W_BK * 2;    // 16 KB
constexpr int W_BOX_BYTES = W_BK * 64 * 2;    // one 64 deep x 64 wide MN-major b box, 8 KB
constexpr int W_W_BYTES = W_BN * W_BK * 2;    // 32 KB of b a stage, either layout
constexpr int W_MAX_E = 1024;
constexpr int W_SMEM = W_STAGES * (W_X_BYTES + W_W_BYTES) + 2 * W_STAGES * 8 +
                       (W_MAX_E + 1) * 4 + 1024;  // + alignment slack
constexpr int SK_OUT_BYTES = W_BM * W_BN;     // half a bf16 tile of out: 2 boxes of 64 x 64 a warpgroup
constexpr int SK_MAX_E = 256;                 // experts stream-K's shared tile list holds
constexpr int SK_SMEM = SK_STAGES * (W_X_BYTES + W_W_BYTES) + SK_OUT_BYTES +
                        2 * SK_STAGES * 8 + (SK_MAX_E + 1) * 4 + 1024;  // 231,492 bytes
constexpr int SK_MIN_STEPS = 16;              // stream-K cuts no piece below this many k-steps
constexpr int SK_PART_FLOATS = W_BM * W_BN;   // one block's f32 sums of a tile: 128 KB

// Live rows of expert e: group_sizes[e] clamped to [0, C]; all C without sizes.
__device__ __forceinline__ int live_rows(const int* gs, int e, int C) {
  return gs == nullptr ? C : min(max(gs[e], 0), C);
}

// one m64n256k16 product: acc = A (64 x 16, smem) * B (16 x 256, smem) +
// (accumulate ? acc : 0); TA, TB = 1: that operand is MN-major, read through
// the instruction's transpose flag; 0: K-major
template <int TA, int TB>
__device__ __forceinline__ void wgmma_m64n256k16(float* d, uint64_t da, uint64_t db,
                                                 int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %130, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, "
      "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95, "
      "%96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, %111, "
      "%112, %113, %114, %115, %116, %117, %118, %119, %120, %121, %122, %123, %124, %125, %126, %127"
      "}, %128, %129, p, 1, 1, %131, %132;\n}\n"
      :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]),
        "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
        "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
        "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]),
        "+f"(d[88]), "+f"(d[89]), "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]),
        "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]), "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]),
        "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]), "+f"(d[108]), "+f"(d[109]), "+f"(d[110]), "+f"(d[111]),
        "+f"(d[112]), "+f"(d[113]), "+f"(d[114]), "+f"(d[115]), "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]),
        "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]), "+f"(d[124]), "+f"(d[125]), "+f"(d[126]), "+f"(d[127])
      : "l"(da), "l"(db), "r"(accumulate), "n"(TA), "n"(TB));
}

struct Tile {
  int e, m0, n0;
};

// Live tile t of the expert-major, column-slab, row-tile-fastest order;
// first[e] is the number of live row tiles of the experts before e.
__device__ __forceinline__ Tile tile_at(const int* first, int E, int n_tiles, int t) {
  int lo = 0, hi = E;  // the last e with first[e] * n_tiles <= t
  while (hi - lo > 1) {
    const int mid = (lo + hi) / 2;
    if (first[mid] * n_tiles <= t) lo = mid;
    else hi = mid;
  }
  const int mt = first[lo + 1] - first[lo];
  const int local = t - first[lo] * n_tiles;
  return {lo, (local % mt) * W_BM, (local / mt) * W_BN};
}

// The stream-K schedule (the grid's, the same in every block): `rounds`
// full rounds of G whole tiles, then each of the `left` tiles left in
// `pieces` pieces, P = G / left but none below SK_MIN_STEPS k-steps, one a
// block: blocks P i .. P i + P - 1 run tile i's pieces, cut at the same
// k-steps in every tile.
struct SkSchedule {
  int rounds, ktiles, left, pieces;
};

__device__ __forceinline__ SkSchedule sk_schedule(int tiles, int ktiles, int grid) {
  const int rounds = tiles / grid, left = tiles - rounds * grid;
  return {rounds, ktiles, left, left ? max(1, min(grid / left, ktiles / SK_MIN_STEPS)) : 0};
}

enum { UNIT_WHOLE = 0, UNIT_PART = 1, UNIT_HEAD = 2 };

// One unit of a block's work: k-steps [k0, k1) of live tile `tile`.  WHOLE:
// all of them; PART: a piece that does not start the tile (its sums go to
// the block's slot of the workspace); HEAD: the tile's first piece (the
// block adds the sums of blocks b + 1 .. b + pieces - 1 and stores the
// tile).
struct SkUnit {
  int tile, k0, k1, kind;
};

// unit n of block b into u (its whole tiles, then its piece); false past
// its last (int arithmetic: the launcher keeps k-steps x G below 2^31)
__device__ __forceinline__ bool sk_unit(const SkSchedule& s, int b, int grid, int n, SkUnit& u) {
  if (n < s.rounds) {
    u = {n * grid + b, 0, s.ktiles, UNIT_WHOLE};
    return true;
  }
  if (n > s.rounds || b >= s.left * s.pieces) return false;
  const int i = b / s.pieces, j = b - i * s.pieces;
  u = {s.rounds * grid + i, j * s.ktiles / s.pieces, (j + 1) * s.ktiles / s.pieces,
       j > 0 ? UNIT_PART : (s.pieces > 1 ? UNIT_HEAD : UNIT_WHOLE)};
  return true;
}

// flags of the stream-K fixup: a release store by the writer, acquire loads
// by the reader (a wait that never completes traps, as mbar_wait does)
__device__ __forceinline__ void flag_release(unsigned* p) {
  asm volatile("st.release.gpu.global.u32 [%0], %1;" ::"l"(p), "r"(1u) : "memory");
}
__device__ __forceinline__ void flag_wait(const unsigned* p) {
  for (uint32_t polls = 0;; ++polls) {
    unsigned v;
    asm volatile("ld.acquire.gpu.global.u32 %0, [%1];" : "=r"(v) : "l"(p) : "memory");
    if (v != 0u) return;
    if (polls == (1u << 22)) __trap();
  }
}

// bf16 of accumulator group c (columns 8c + 2 (lane % 4), + 1; rows r and r
// + 8 of the warpgroup's 64) into a warpgroup's staging buffer of four 64 x
// 64 boxes: column group c lies in box c / 8 as its 16-byte chunk c % 8 of
// row r, at chunk (c % 8) ^ (r % 8) under the 128-byte swizzle (rows r and
// r + 8 share the pattern); a row not kept is written as zeros
__device__ __forceinline__ void stage_bf16(uint8_t* ob, int c, int r, int lane, float v0,
                                           float v1, float v2, float v3, bool keep_r,
                                           bool keep_r8) {
  uint8_t* p = ob + (c >> 3) * W_BOX_BYTES + r * 128 + (((c & 7) ^ (r & 7)) << 4) + (lane & 3) * 4;
  *reinterpret_cast<__nv_bfloat162*>(p) =
      keep_r ? __floats2bfloat162_rn(v0, v1) : __floats2bfloat162_rn(0.f, 0.f);
  *reinterpret_cast<__nv_bfloat162*>(p + 8 * 128) =
      keep_r8 ? __floats2bfloat162_rn(v2, v3) : __floats2bfloat162_rn(0.f, 0.f);
}

// The producer's copies of k-step kt of tile tl into ring position it: the a
// tile, and b as one K-major box or four MN-major ones.
template <bool KMAJOR_B, int STAGES>
__device__ __forceinline__ void produce_stage(const CUtensorMap* tmap_a, const CUtensorMap* tmap_b,
                                              uint8_t* xs, uint8_t* ws, uint64_t* full,
                                              uint64_t* empty, const Tile& tl, int kt, int it) {
  const int s = it % STAGES;
  mbar_wait(smem_u32(&empty[s]), ((it / STAGES) & 1) ^ 1);
  const uint32_t fb = smem_u32(&full[s]);
  mbar_expect_tx(fb, W_X_BYTES + W_W_BYTES);
  tma_load_3d(smem_u32(xs + s * W_X_BYTES), tmap_a, fb, kt * W_BK, tl.m0, tl.e);
  if (KMAJOR_B) {
    tma_load_3d(smem_u32(ws + s * W_W_BYTES), tmap_b, fb, kt * W_BK, tl.n0, tl.e);
  } else {
#pragma unroll
    for (int i = 0; i < W_BN / 64; ++i)
      tma_load_3d(smem_u32(ws + s * W_W_BYTES + i * W_BOX_BYTES), tmap_b, fb, tl.n0 + i * 64,
                  kt * W_BK, tl.e);
  }
}

// A consumer warpgroup's products of k-steps [k0, k1) of one tile into acc
// (the first does not accumulate), from ring position it on, each stage
// released once read.
template <bool KMAJOR_B, int STAGES>
__device__ __forceinline__ void consume_steps(float* acc, uint8_t* xs, uint8_t* ws,
                                              uint64_t* full, uint64_t* empty, int wg, int tid,
                                              int k0, int k1, int& it) {
  for (int kt = k0; kt < k1; ++kt, ++it) {
    const int s = it % STAGES;
    mbar_wait(smem_u32(&full[s]), (it / STAGES) & 1);
    wgmma_fence();
    const uint64_t da = gmma_desc(smem_u32(xs + s * W_X_BYTES + wg * 64 * 128));
    const uint64_t db = KMAJOR_B ? gmma_desc(smem_u32(ws + s * W_W_BYTES))
                                 : gmma_desc_mn(smem_u32(ws + s * W_W_BYTES), W_BOX_BYTES);
#pragma unroll
    for (int j = 0; j < W_BK / 16; ++j)  // A: 16 k = 32 bytes; B: 32 bytes K-major,
                                         // 16 k rows = 2048 bytes MN-major
      wgmma_m64n256k16<0, KMAJOR_B ? 0 : 1>(acc, da + 2 * j,
                                            db + (KMAJOR_B ? 2 : (2048 >> 4)) * j,
                                            kt > k0 || j > 0);
    wgmma_commit();
    wgmma_wait<1>();  // the product of step it-1 is done: release its stage
    if (kt > k0 && (tid & 127) == 0) mbar_arrive(smem_u32(&empty[(it - 1) % STAGES]));
  }
  wgmma_wait<0>();
  if ((tid & 127) == 0) mbar_arrive(smem_u32(&empty[(it - 1) % STAGES]));
  fence_acc<128>(acc);
}

// The block's work: out (E, C, N) = a (E, C, K) b over the live rows.  tmap_a
// is a as (K, C, E) in boxes of 64 x 128; tmap_b is b as (N, K, E) in 64 x 64
// boxes (MN-major) or (K, N, E) in 64 x 256 boxes (K-major); smem_raw is the
// kernel's dynamic shared memory, W_SMEM bytes (SK_SMEM with STREAM_K).
// STREAM_K also takes tmap_out, out as (N, C, E) in 64 x 64 boxes, and the
// workspace: `partials` (SK_PART_FLOATS a block) and `flags` (one a block,
// zero at the launch).
template <bool KMAJOR_B, bool STREAM_K>
__device__ __forceinline__ void gmm_wgmma_body(const CUtensorMap* tmap_a,
                                               const CUtensorMap* tmap_b,
                                               const CUtensorMap* tmap_out,
                                               const int* __restrict__ group_sizes,
                                               __nv_bfloat16* __restrict__ out,
                                               float* __restrict__ partials,
                                               unsigned* __restrict__ flags, int E, int C,
                                               int K, int N, uint8_t* smem_raw) {
  constexpr int STAGES = STREAM_K ? SK_STAGES : W_STAGES;
  // the swizzled tiles need 1024-byte alignment in the shared window
  const uint32_t raw = smem_u32(smem_raw);
  uint8_t* smem = smem_raw + (((raw + 1023u) & ~1023u) - raw);
  uint8_t* xs = smem;                                 // [stage][128 m][64 k] bf16
  uint8_t* ws = xs + STAGES * W_X_BYTES;              // [stage] one b tile, 32 KB
  uint8_t* os = ws + STAGES * W_W_BYTES;              // stream-K: [warpgroup][2 boxes] bf16
  uint64_t* full = reinterpret_cast<uint64_t*>(os + (STREAM_K ? SK_OUT_BYTES : 0));
  uint64_t* empty = full + STAGES;
  int* first = reinterpret_cast<int*>(empty + STAGES);  // [E + 1]

  const int tid = threadIdx.x;
  const int n_tiles = (N + W_BN - 1) / W_BN;
  const int ktiles = (K + W_BK - 1) / W_BK;

  if (tid < 32) {  // live row tiles per expert, prefix-summed by one warp
    int carry = 0;
    for (int e0 = 0; e0 < E; e0 += 32) {
      const int e = e0 + tid;
      const int mt = e < E ? (live_rows(group_sizes, e, C) + W_BM - 1) / W_BM : 0;
      int incl = mt;
#pragma unroll
      for (int o = 1; o < 32; o <<= 1) {
        const int v = __shfl_up_sync(0xffffffffu, incl, o);
        if (tid >= o) incl += v;
      }
      if (e < E) first[e] = carry + incl - mt;
      carry += __shfl_sync(0xffffffffu, incl, 31);
    }
    if (tid == 0) first[E] = carry;
  }
  if (tid == 32) {
#pragma unroll
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(smem_u32(&full[s]), 1);
      mbar_init(smem_u32(&empty[s]), 2);  // one arrival per consumer warpgroup
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();
  const int total = first[E] * n_tiles;

  if (tid >= W_CONSUMERS) {  // producer warp: one thread issues the copies
    if (tid == W_CONSUMERS) {
      int it = 0;  // ring position, continued from tile to tile
      if constexpr (STREAM_K) {
        const SkSchedule sk = sk_schedule(total, ktiles, gridDim.x);
        SkUnit u;
        for (int n = 0; sk_unit(sk, blockIdx.x, gridDim.x, n, u); ++n) {
          const Tile tl = tile_at(first, E, n_tiles, u.tile);
          for (int kt = u.k0; kt < u.k1; ++kt, ++it)
            produce_stage<KMAJOR_B, STAGES>(tmap_a, tmap_b, xs, ws, full, empty, tl, kt, it);
        }
      } else {
        for (int t = blockIdx.x; t < total; t += gridDim.x) {
          const Tile tl = tile_at(first, E, n_tiles, t);
          for (int kt = 0; kt < ktiles; ++kt, ++it)
            produce_stage<KMAJOR_B, STAGES>(tmap_a, tmap_b, xs, ws, full, empty, tl, kt, it);
        }
      }
    }
    return;
  }

  // zeros for the rows of every expert's dead tiles, [128 * tiles_e, C): no
  // tile covers them; the producer's first copies land meanwhile
  const long long grid_threads = (long long)gridDim.x * W_CONSUMERS;
  for (int e = 0; e < E; ++e) {
    const int r0 = min((first[e + 1] - first[e]) * W_BM, C);
    const long long n16 = (long long)(C - r0) * N / 8;  // 16-byte stores of 8 bf16
    uint4* dst = reinterpret_cast<uint4*>(out + ((long long)e * C + r0) * N);
    for (long long i = (long long)blockIdx.x * W_CONSUMERS + tid; i < n16; i += grid_threads)
      dst[i] = make_uint4(0u, 0u, 0u, 0u);
  }

  // consumer warpgroup: rows wg*64 .. +64 of the tile (stream-K reads it
  // through a shuffle, so ptxas knows it is the same in every lane of a warp)
  const int wg = STREAM_K ? __shfl_sync(0xffffffffu, tid >> 7, 0) : tid >> 7;
  const int lane = tid & 31;
  float acc[128];  // no initial value: a unit's first product does not accumulate
  int it = 0;
  // accumulator fragment: row (warp%4)*16 + lane/4 (+8) of the warpgroup's
  // 64, column 8c + 2*(lane%4) (+1)
  const int r = ((tid >> 5) & 3) * 16 + (lane >> 2);

  if constexpr (!STREAM_K) {
    for (int t = blockIdx.x; t < total; t += gridDim.x) {
      const Tile tl = tile_at(first, E, n_tiles, t);
      consume_steps<KMAJOR_B, STAGES>(acc, xs, ws, full, empty, wg, tid, 0, ktiles, it);
      // rows at or past group_sizes[e] are zeros, rows past C are not written
      const int live = live_rows(group_sizes, tl.e, C);
      const int row0 = tl.m0 + wg * 64 + r;
      __nv_bfloat16* oe = out + (long long)tl.e * C * N;
#pragma unroll
      for (int c = 0; c < W_BN / 8; ++c) {
        const int col = tl.n0 + c * 8 + (lane & 3) * 2;
        if (col >= N) continue;  // N % 8 == 0: col + 1 < N as well
        if (row0 < C)
          *reinterpret_cast<__nv_bfloat162*>(oe + (long long)row0 * N + col) =
              row0 < live ? __floats2bfloat162_rn(acc[4 * c], acc[4 * c + 1])
                          : __floats2bfloat162_rn(0.f, 0.f);
        if (row0 + 8 < C)
          *reinterpret_cast<__nv_bfloat162*>(oe + (long long)(row0 + 8) * N + col) =
              row0 + 8 < live ? __floats2bfloat162_rn(acc[4 * c + 2], acc[4 * c + 3])
                              : __floats2bfloat162_rn(0.f, 0.f);
      }
    }
  } else {
    const int wtid = tid & 127;
    uint8_t* ob = os + wg * (SK_OUT_BYTES / 2);
    // this thread's float4 of accumulator group c in block b's slot is
    // mine[b * SK_PART_FLOATS / 4 + c * W_CONSUMERS]: coalesced across the block
    float4* mine = reinterpret_cast<float4*>(partials) + tid;
    const SkSchedule sk = sk_schedule(total, ktiles, gridDim.x);
    SkUnit u;
    for (int n = 0; sk_unit(sk, blockIdx.x, gridDim.x, n, u); ++n) {
      const Tile tl = tile_at(first, E, n_tiles, u.tile);
      consume_steps<KMAJOR_B, STAGES>(acc, xs, ws, full, empty, wg, tid, u.k0, u.k1, it);
      if (u.kind == UNIT_PART) {  // sums to this block's slot, then its flag
#pragma unroll
        for (int c = 0; c < W_BN / 8; ++c)
          __stcg(mine + (long long)blockIdx.x * (SK_PART_FLOATS / 4) + c * W_CONSUMERS,
                 make_float4(acc[4 * c], acc[4 * c + 1], acc[4 * c + 2], acc[4 * c + 3]));
        __threadfence();
        named_barrier(1, W_CONSUMERS);
        if (tid == 0) flag_release(flags + blockIdx.x);
        continue;
      }
      // a HEAD adds the pieces of blocks blockIdx.x + 1 .. last, in order,
      // into its accumulators (no product is in flight)
      const int last = u.kind == UNIT_HEAD ? blockIdx.x + sk.pieces - 1 : blockIdx.x;
      if (last > (int)blockIdx.x) {
        if (tid == 0)
          for (int b = blockIdx.x + 1; b <= last; ++b) flag_wait(flags + b);
        named_barrier(1, W_CONSUMERS);
        for (int b = blockIdx.x + 1; b <= last; ++b) {
          const float4* src = mine + (long long)b * (SK_PART_FLOATS / 4);
#pragma unroll
          for (int c = 0; c < W_BN / 8; ++c) {
            const float4 p = __ldcg(src + c * W_CONSUMERS);
            acc[4 * c] += p.x, acc[4 * c + 1] += p.y, acc[4 * c + 2] += p.z, acc[4 * c + 3] += p.w;
          }
        }
      }
      // rows at or past group_sizes[e] are zeros; rows past C are clipped by
      // the store.  The tile goes out in two halves of 128 columns through
      // the warpgroup's 16 KB buffer, each rewritten only once the store
      // before has read it.
      const int live = live_rows(group_sizes, tl.e, C);
      const int row0 = tl.m0 + wg * 64 + r;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        if (wtid == 0) bulk_wait_group_read<0>();
        named_barrier(2 + wg, 128);
#pragma unroll
        for (int c = 0; c < W_BN / 16; ++c) {
          const int g = h * (W_BN / 16) + c;  // the accumulator group
          stage_bf16(ob, c, r, lane, acc[4 * g], acc[4 * g + 1], acc[4 * g + 2], acc[4 * g + 3],
                     row0 < live, row0 + 8 < live);
        }
        fence_proxy_async();  // the buffer's writes visible to the TMA store
        named_barrier(2 + wg, 128);
        if (wtid == 0) {  // columns past N and rows past C are clipped by the store
#pragma unroll
          for (int i = 0; i < 2; ++i)
            tma_store_3d(tmap_out, smem_u32(ob + i * W_BOX_BYTES), tl.n0 + (2 * h + i) * 64,
                         tl.m0 + wg * 64, tl.e);
          bulk_commit_group();
        }
      }
    }
    if (wtid == 0) bulk_wait_group<0>();
  }
}

// A bf16 (d2, d1, d0) tensor as a 3-D tensor map, innermost axis first
// (extents d0, d1, d2; element strides s1, s2 of axes 1 and 2) in boxes of
// box0 x box1 x 1, 128-byte swizzle, zeros outside the tensor.
CUresult encode_bf16_3d(EncodeTiledFn encode, CUtensorMap* map, const void* base, long long d0,
                        long long d1, long long d2, long long s1, long long s2, int box0,
                        int box1) {
  const cuuint32_t ones[3] = {1, 1, 1};
  const cuuint64_t dim[3] = {(cuuint64_t)d0, (cuuint64_t)d1, (cuuint64_t)d2};
  const cuuint64_t stride[2] = {(cuuint64_t)s1 * 2, (cuuint64_t)s2 * 2};
  const cuuint32_t box[3] = {(cuuint32_t)box0, (cuuint32_t)box1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, const_cast<void*>(base), dim, stride,
                box, ones, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
}

}  // namespace
