// Kernel #1's wgmma path, shared by the shipped library (score_mlp.cu, the
// `FULL` epilogue only) and the probe library (score_mlp_probe.cu, the
// eight epilogue variants of tools/bench_kernel.py --probe at the probe
// shape): the layer arguments, the `wgmma_layer` kernel with its epilogue,
// and the host sequence of one forward on it.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "hopper.cuh"

namespace {

constexpr float GN_EPS = 1e-5f;

// Epilogue of one dense layer.
enum Mode {
  GN_SILU_FIRST = 0,  // y = silu(gn(acc + vec)); resid = y; act = bf16(y)
  GN_SILU = 1,        // act = bf16(silu(gn(acc + vec)))
  GN_SILU_RESID = 2,  // h = resid + silu(gn(acc + vec)); resid = h if store_resid; act = bf16(h)
  BIAS_OUT = 3,       // out = acc + vec, first ldo columns only
};

struct LayerArgs {
  const void* a;          // [M, lda] bf16, or f32 for the first layer
  int lda;                // row stride of a, in elements
  int k_valid;            // columns of a that hold data (f32 input only)
  int K;                  // depth of w, a multiple of BK
  const __nv_bfloat16* w; // [K, N], input-major
  int N;                  // width of w, a multiple of the column tile
  const float* vec;       // [N] per-step vector (or output bias)
  const float* gn_scale;  // [N]
  const float* gn_bias;   // [N]
  int group;              // GroupNorm group size, divides the column tile
  int gn_bf16;            // GroupNorm statistics mode: 1 bf16, 0 f32
  int mode;               // Mode
  float* resid;           // [M, N] f32 residual stream
  int store_resid;        // 0 when no later layer reads the residual: not written
  __nv_bfloat16* act;     // [M, N] bf16 input of the next layer
  float* out;             // [M, ldo] f32 output (BIAS_OUT)
  int ldo;
  int M;
  const __nv_bfloat16* ind;  // [N, 128] group indicator / group (GN_BCAST_VPU only)
};

using hopper::round_bf16;

// one channel's contribution to its group's sum of squares
__device__ __forceinline__ float square(float v, bool bf16) {
  return bf16 ? round_bf16(v * v) : v * v;
}

// ---------------------------------------------------------------------------
// `wgmma_layer`: the same dense layer, redesigned for Hopper.
//
// Replaces the per-layer body of zedo_tpu/ops/pallas/score_kernel.py:_kernel
// (a dense product, `_gn_silu`, the residual add) for the widths named at the
// head of score_mlp.cu.
//
// What bounds it on an H100: a hidden layer at 44,300 x 1024 is 92.9 GFLOP,
// 0.094 ms at the 989 TFLOP/s bf16 peak, and moves 4 to 12 bytes a channel
// (0.05 to 0.16 ms at 3.35 TB/s), so the residual layers sit where the two
// bounds meet and the product has to overlap the epilogue's traffic. (The
// second residual layer writes no residual, 8 bytes a channel: only the post
// layer follows, and it reads the bf16 activation.)
//
// What the design does about it:
//   * The product is wgmma m64n128k16 (bf16 x bf16 -> f32), A and B both read
//     from shared memory through matrix descriptors, the only way to the full
//     tensor-core rate. A block owns a 128 x 128 output tile: two consumer
//     warpgroups of 64 x 128, 64 f32 accumulators a thread. The packed
//     weights are [K, N] with N contiguous, so B is read through the
//     MN-major ("transposed") form of the descriptor; nothing is repacked.
//   * A ring of STAGES stages is fed by TMA tile loads under the 128-byte
//     swizzle: A [128, 64] as one box, B [64, 128] as two boxes of 64
//     columns. `full` / `empty` mbarriers per stage take the place of
//     block-wide syncs. One consumer thread starts the loads: when the
//     products of a stage have finished and every warp has released it, it
//     refills that stage with the tile STAGES steps ahead. (A producer warp
//     of its own was built first; a ninth warp cuts the registers of two
//     resident blocks from 128 to 96 a thread, and the epilogue needs them.)
//     TMA fills the rows past M with zeros, so ragged row counts need no
//     clamp.
//   * GroupNorm, SiLU and the residual run on the accumulators in registers.
//     A thread holds two rows and, for each j, the column pair 8j + 2(l%4):
//     a group of G >= 8 channels is G/8 values of j times the four lanes of a
//     quad, so its sum of squares is in-thread adds and two shuffles (one for
//     G = 4). The tile's `vec`, `gn_scale` and `gn_bias` are loaded to shared
//     memory once per block.
//   * Every store fills whole 32-byte sectors. The f32 residual goes out as
//     8-byte pairs straight from the accumulator layout (a quad fills a
//     sector); the bf16 activation as 8-byte quadruples after one shuffle
//     between neighbouring lanes (a quad fills a sector again: 4-byte pairs
//     half-fill sectors, which the memory system pays for dearly). The
//     residual loads of the next 32 columns are started before the current 32
//     are finished.
//   * Two blocks fit an SM (256 threads of at most 128 registers, ~100 KB of
//     shared memory each), so one block's epilogue, which is bound by its
//     global loads and stores, runs under the other block's products.
//   * The first layer reads a bf16 copy of x, zero-padded to a multiple of 64
//     columns by `pad_input` (TMA needs 16-byte row strides; x has 51 f32
//     columns), and multiplies only those 64 rows of w_pre: the rest of its
//     128 rows meet zeros.
//
// Built, measured on an H100 and not kept, because each was slower or no
// faster: a persistent grid (one block walking over tiles, its next tile's
// loads under its epilogue: the other resident block already hides that), two
// stages, four or six stages with one block per SM, prefetching the residual
// tile into L2 at block start, streaming cache hints on the residual, a
// 256-byte L2 promotion in the tensor maps, and 16-byte residual loads and
// stores through two more shuffles.
//
// SiLU is x * (0.5 * tanh(x / 2) + 0.5) with `tanh.approx.f32`
// (hopper::silu); the wmma kernel and the plain version use the precise
// tanhf, and the kernel is held against the plain version within the same
// tolerance.
//
// The epilogue variants (EPI). The shipped library builds FULL alone. The
// probe library builds all eight at the probe shape (bf16 statistics,
// groups of 32 channels): kernel #1 with the GroupNorm + SiLU body that
// tools/bench_kernel.py --probe puts in place of `_gn_silu`, to split the
// kernel's time between the products, the statistics, the SiLU and the
// stores, which every variant keeps. On v = acc + vec of each channel:
enum Epilogue {
  FULL = 0,          // silu(v * rstd * scale + bias), tanh.approx.f32 (the shipped epilogue)
  NO_SILU = 1,       // v * rstd * scale + bias
  NO_GN = 2,         // silu(v + bias): no statistics
  DENSE_ONLY = 3,    // v
  TANH_SILU = 4,     // FULL with the precise tanhf: prices tanh.approx.f32
  BF16_SILU = 5,     // xn = bf16(v * rstd * scale + bias); xn * sigmoid(xn) in bf16x2 math
  GN_VPU = 6,        // statistics by group sums in f32; silu(v * rstd * 1.01 + bias)
  GN_BCAST_VPU = 7,  // statistics through mma.sync with `ind`; silu(v * rstd * 1.01 + bias)
  EPILOGUES = 8,
};
// what GN_VPU and GN_BCAST_VPU multiply by in place of the channel scale,
// as JAX's probe bodies do
constexpr float CHANNEL_SCALE = 1.01f;
// the probe library's shape: groups of 32 channels, bf16 statistics
constexpr int PROBE_GROUP = 32;

namespace wg {

using namespace hopper;

constexpr int BM = 128;      // rows of an output tile (two warpgroups of 64)
constexpr int BN = 128;      // columns of an output tile
constexpr int BK = 64;       // depth of a stage: one 128-byte swizzle row
constexpr int STAGES = 3;
constexpr int THREADS = 256; // two warpgroups
constexpr int A_BYTES = BM * BK * 2;
constexpr int B_HALF_BYTES = BK * 64 * 2;  // one 64-column box of B
constexpr int STAGE_BYTES = A_BYTES + 2 * B_HALF_BYTES;
// the ring (aligned to 1024 bytes by hand), vec / gn_scale / gn_bias of the
// tile's columns, and the full and empty barriers
constexpr int SMEM_BYTES = 1024 + STAGES * STAGE_BYTES + 3 * BN * 4 + 2 * STAGES * 8;
// GN_BCAST_VPU also stages the tile's 128 rows of `ind` at the 8 columns that
// hold its groups, transposed: 8 rows of 128 bf16 (k contiguous), padded to
// IND_LD words so the B-fragment loads of a warp fall in 32 banks
constexpr int IND_COLS = 128;  // columns of `ind`
constexpr int IND_LD = BN / 2 + 4;
template <int EPI>
constexpr int smem_bytes() {
  return SMEM_BYTES + (EPI == GN_BCAST_VPU ? 8 * IND_LD * 4 : 0);
}

// Columns of the bf16 copy of x that the first layer reads: c rounded up to
// the depth of one pipeline stage.
inline int padded_input(int c) { return (c + BK - 1) / BK * BK; }

template <int G>
__device__ __forceinline__ float rstd_of(float ss, bool bf16) {
  if (bf16) return round_bf16(rsqrtf(ss * round_bf16(1.f / G) + GN_EPS));
  return rsqrtf(ss / G + GN_EPS);
}

// x [m, c] f32 -> xp [m, k0] bf16, the columns past c zero; one thread per
// 8 output columns (16 bytes)
__global__ void pad_input(const float* __restrict__ x, int m, int c, __nv_bfloat16* xp, int k0) {
  const int chunks = k0 / 8;
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= m * chunks) return;
  const int r = i / chunks, c0 = (i % chunks) * 8;
  __align__(16) __nv_bfloat16 v[8];
#pragma unroll
  for (int e = 0; e < 8; ++e)
    v[e] = __float2bfloat16(c0 + e < c ? x[(size_t)r * c + c0 + e] : 0.f);
  *reinterpret_cast<uint4*>(xp + (size_t)r * k0 + c0) = *reinterpret_cast<const uint4*>(v);
}

// The variant's activation of one column pair of a row, v = acc + vec,
// given its group's rstd and the columns' scale and bias.
template <int EPI>
__device__ __forceinline__ float2 activate(float v0, float v1, float rstd, float2 sc, float2 bi) {
  if constexpr (EPI == FULL) {
    return make_float2(silu(v0 * (rstd * sc.x) + bi.x), silu(v1 * (rstd * sc.y) + bi.y));
  } else if constexpr (EPI == NO_SILU) {
    return make_float2(v0 * (rstd * sc.x) + bi.x, v1 * (rstd * sc.y) + bi.y);
  } else if constexpr (EPI == NO_GN) {
    return make_float2(silu(v0 + bi.x), silu(v1 + bi.y));
  } else if constexpr (EPI == DENSE_ONLY) {
    return make_float2(v0, v1);
  } else if constexpr (EPI == TANH_SILU) {
    return make_float2(silu_precise(v0 * (rstd * sc.x) + bi.x),
                       silu_precise(v1 * (rstd * sc.y) + bi.y));
  } else if constexpr (EPI == BF16_SILU) {
    // JAX's bf16 body: xn rounded to bf16, then 1 / (1 + exp(-xn)) and the
    // product, each rounded to bf16
    const __nv_bfloat162 xn = __floats2bfloat162_rn(v0 * (rstd * sc.x) + bi.x,
                                                    v1 * (rstd * sc.y) + bi.y);
    const __nv_bfloat162 one = __float2bfloat162_rn(1.f);
    const __nv_bfloat162 sig = h2rcp(__hadd2(one, h2exp(__hneg2(xn))));
    return __bfloat1622float2(__hmul2(xn, sig));
  } else {  // GN_VPU, GN_BCAST_VPU
    return make_float2(silu(v0 * rstd * CHANNEL_SCALE + bi.x),
                       silu(v1 * rstd * CHANNEL_SCALE + bi.y));
  }
}

// GN_BCAST_VPU: stage the tile's rows of `ind` at the 8 columns that hold
// its groups, one row (k = tid) a thread, as sInd[n][k] (bf16, IND_LD words
// a row of n).
template <int G>
__device__ __forceinline__ void stage_ind(const LayerArgs& p, uint32_t* sInd, int col0, int tid) {
  const int nb = (col0 / G) & ~7;
  const uint4 w = __ldg(reinterpret_cast<const uint4*>(p.ind + (size_t)(col0 + tid) * IND_COLS + nb));
  const __nv_bfloat16* e = reinterpret_cast<const __nv_bfloat16*>(&w);
  __nv_bfloat16* dst = reinterpret_cast<__nv_bfloat16*>(sInd);
#pragma unroll
  for (int n = 0; n < 8; ++n) dst[n * IND_LD * 2 + tid] = e[n];
}

// GN_BCAST_VPU's statistics, JAX's `gn_bcast_vpu`: v = acc + vec for all 64
// accumulators, then each row's sum over a group of bf16(v * v) / G through
// a tensor-core product with the tile's rows of `ind` (1/G at (c, c / G)).
// In the accumulator layout (hopper::wgmma_m64n128k16) the values of 16
// columns 16kb..16kb+15 are, as they stand, the A fragment of mma.sync
// m16n8k16 (rows l/4 and l/4 + 8, columns 2(l%4) and + 8: j = 2kb and
// 2kb + 1), as FlashAttention reuses P for P.V. B is `ind`'s 8 columns that
// hold the tile's BN/G groups; the product's D then holds, in lane l, the
// rows l/4 and l/4 + 8 at the groups 2(l%4), 2(l%4) + 1 of those 8. rb[q][h]
// gets the rstd of the tile's group q at this thread's row h, from its quad.
template <int G>
__device__ __forceinline__ void bcast_rstd(float (&acc)[64], const float* sVec,
                                           const uint32_t* sInd, int col0, int lane,
                                           float (&rb)[BN / G][2]) {
  static_assert(BN / G <= 8 && 8 % (BN / G) == 0, "a tile's groups must fit one n8 block");
  const int cq = 2 * (lane & 3);
#pragma unroll
  for (int j = 0; j < 16; ++j) {
    const float2 v = *reinterpret_cast<const float2*>(sVec + 8 * j + cq);
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      acc[4 * j + 2 * h] += v.x;
      acc[4 * j + 2 * h + 1] += v.y;
    }
  }
  auto sq = [&](int i) {
    const __nv_bfloat162 p2 = __floats2bfloat162_rn(acc[i] * acc[i], acc[i + 1] * acc[i + 1]);
    return *reinterpret_cast<const uint32_t*>(&p2);
  };
  float d[4] = {0.f, 0.f, 0.f, 0.f};
  const uint32_t* b = sInd + (lane >> 2) * IND_LD + (lane & 3);
#pragma unroll
  for (int kb = 0; kb < 8; ++kb) {
    const int j0 = 8 * kb, j1 = 8 * kb + 4;  // acc index of j = 2kb and 2kb + 1
    const uint32_t a[4] = {sq(j0), sq(j0 + 2), sq(j1), sq(j1 + 2)};
    mma_m16n8k16_bf16(d, a, b[8 * kb], b[8 * kb + 4]);
  }
  float r[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) r[i] = rsqrtf(d[i] + GN_EPS);
  const int n0 = (col0 / G) & 7;  // the tile's first group among the 8 columns
#pragma unroll
  for (int q = 0; q < BN / G; ++q) {
    const int n = n0 + q;
    const int src = (lane & ~3) | (n >> 1);
#pragma unroll
    for (int h = 0; h < 2; ++h)
      rb[q][h] = __shfl_sync(0xffffffffu, (n & 1) ? r[2 * h + 1] : r[2 * h], src);
  }
}

// The epilogue of one thread's 2 rows x 64 columns of accumulators.
// MODE: the layer's epilogue; GN: GroupNorm statistics mode (1 bf16, 0 f32);
// G: channels per GroupNorm group (4, 8, 16, 32 or 64); EPI: the variant.
template <int MODE, int GN, int G, int EPI>
__device__ __forceinline__ void epilogue(const LayerArgs& p, float (&acc)[64], const float* sVec,
                                         const float* sScale, const float* sBias,
                                         const uint32_t* sInd, int row0, int col0, int tid) {
  const int warp = tid >> 5, lane = tid & 31;
  const int cq = 2 * (lane & 3);  // this lane's column pair within each 8 columns
  const int r = (warp >> 2) * 64 + (warp & 3) * 16 + (lane >> 2);
  const int gr[2] = {row0 + r, row0 + r + 8};
  const bool valid[2] = {gr[0] < p.M, gr[1] < p.M};
  const bool keep[2] = {valid[0] && p.store_resid, valid[1] && p.store_resid};

  if constexpr (MODE == BIAS_OUT) {
#pragma unroll
    for (int j = 0; j < 16; ++j)
#pragma unroll
      for (int h = 0; h < 2; ++h)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int c = 8 * j + cq + e;
          if (valid[h] && col0 + c < p.ldo)
            p.out[(size_t)gr[h] * p.ldo + col0 + c] = acc[4 * j + 2 * h + e] + sVec[c];
        }
  } else {
    constexpr bool bf16 = GN == 1;
    constexpr int JPG = G >= 8 ? G / 8 : 1;  // values of j in one group
    constexpr int JC = 4;                    // values of j finished together: 32 columns
    // statistics by group sums in registers (every variant but these three),
    // the squares rounded as the GroupNorm mode rounds them (GN_VPU: f32)
    constexpr bool sums = EPI != NO_GN && EPI != DENSE_ONLY && EPI != GN_BCAST_VPU;
    constexpr bool sq_bf16 = bf16 && EPI != GN_VPU;
    // this thread's two rows at its first column pair; column 8j is a
    // constant offset from there
    const size_t o0 = (size_t)gr[0] * p.N + col0 + cq, o1 = (size_t)gr[1] * p.N + col0 + cq;
    float* const rrow[2] = {p.resid + o0, p.resid + o1};
    __nv_bfloat16* const arow[2] = {p.act + o0, p.act + o1};

    // v = acc + vec and the rstd of the group that starts at j0, per row
    auto stats = [&](int j0, float (&out)[2]) {
      float ss[2] = {0.f, 0.f};
#pragma unroll
      for (int jj = 0; jj < JPG; ++jj) {
        const int j = j0 + jj;
        const float2 v = *reinterpret_cast<const float2*>(sVec + 8 * j + cq);
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          acc[4 * j + 2 * h] += v.x;
          acc[4 * j + 2 * h + 1] += v.y;
          if constexpr (sums)
            ss[h] += square(acc[4 * j + 2 * h], sq_bf16) +
                     square(acc[4 * j + 2 * h + 1], sq_bf16);
        }
      }
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        if constexpr (sums) {
          // the lanes of a quad hold one row's 8 columns of each j; a group of
          // 4 channels is half a quad
          ss[h] += __shfl_xor_sync(0xffffffffu, ss[h], 1);
          if (G >= 8) ss[h] += __shfl_xor_sync(0xffffffffu, ss[h], 2);
          out[h] = rstd_of<G>(ss[h], sq_bf16);
        } else {
          out[h] = 0.f;  // not read
        }
      }
    };
    auto load_resid = [&](int jc, float2 (&res)[JC][2]) {
#pragma unroll
      for (int jj = 0; jj < JC; ++jj)
#pragma unroll
        for (int h = 0; h < 2; ++h)
          res[jj][h] = valid[h] ? *reinterpret_cast<const float2*>(rrow[h] + 8 * (jc + jj))
                                : make_float2(0.f, 0.f);
    };

    float rb[EPI == GN_BCAST_VPU ? BN / G : 1][2];  // GN_BCAST_VPU: each group's rstd, per row
    if constexpr (EPI == GN_BCAST_VPU) bcast_rstd<G>(acc, sVec, sInd, col0, lane, rb);
    float2 next[JC][2];
    if constexpr (MODE == GN_SILU_RESID) load_resid(0, next);
    float rstd[JC][2];  // of the chunk's j-th column block, per row
#pragma unroll
    for (int jc = 0; jc < 16; jc += JC) {
      if constexpr (EPI == GN_BCAST_VPU) {
#pragma unroll
        for (int jj = 0; jj < JC; ++jj) {
          rstd[jj][0] = rb[(jc + jj) / JPG][0];
          rstd[jj][1] = rb[(jc + jj) / JPG][1];
        }
      } else if constexpr (JPG >= JC) {
        if (jc % JPG == 0) {
          stats(jc, rstd[0]);
#pragma unroll
          for (int jj = 1; jj < JC; ++jj) {
            rstd[jj][0] = rstd[0][0];
            rstd[jj][1] = rstd[0][1];
          }
        }
      } else {
#pragma unroll
        for (int jg = 0; jg < JC; jg += JPG) {
          stats(jc + jg, rstd[jg]);
#pragma unroll
          for (int jj = 1; jj < JPG; ++jj) {
            rstd[jg + jj][0] = rstd[jg][0];
            rstd[jg + jj][1] = rstd[jg][1];
          }
        }
      }
      float2 res[JC][2];
      if constexpr (MODE == GN_SILU_RESID) {
#pragma unroll
        for (int jj = 0; jj < JC; ++jj) {
          res[jj][0] = next[jj][0];
          res[jj][1] = next[jj][1];
        }
        if (jc + JC < 16) load_resid(jc + JC, next);
      }
      __nv_bfloat162 act[JC][2];  // the chunk's activations, as bf16 pairs
#pragma unroll
      for (int jj = 0; jj < JC; ++jj) {
        const int j = jc + jj;
        // gn_scale is rounded to bf16 where it is loaded, in the bf16 mode
        const float2 sc = *reinterpret_cast<const float2*>(sScale + 8 * j + cq);
        const float2 bi = *reinterpret_cast<const float2*>(sBias + 8 * j + cq);
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const float2 y = activate<EPI>(acc[4 * j + 2 * h], acc[4 * j + 2 * h + 1],
                                         rstd[jj][h], sc, bi);
          float y0 = y.x, y1 = y.y;
          if constexpr (MODE == GN_SILU_RESID) {
            y0 += res[jj][h].x;
            y1 += res[jj][h].y;
          }
          if constexpr (MODE != GN_SILU)
            if (keep[h]) *reinterpret_cast<float2*>(rrow[h] + 8 * j) = make_float2(y0, y1);
          act[jj][h] = __floats2bfloat162_rn(y0, y1);
        }
      }
      // A quad's four bf16 pairs of one j are 16 bytes, half a 32-byte
      // sector, and half-written sectors cost the memory system far more
      // than whole ones. Neighbouring lanes swap a pair of j against a pair
      // of j + 1, so that each lane stores 8 bytes and the quad a whole
      // sector: even lanes the columns 8j + 2(l%4) .. + 3, odd lanes
      // 8(j+1) + 2(l%4 - 1) .. + 3.
      const bool odd = lane & 1;
#pragma unroll
      for (int jj = 0; jj < JC; jj += 2)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const uint32_t a = *reinterpret_cast<const uint32_t*>(&act[jj][h]);
          const uint32_t b = *reinterpret_cast<const uint32_t*>(&act[jj + 1][h]);
          const uint32_t got = __shfl_xor_sync(0xffffffffu, odd ? a : b, 1);
          const int c = odd ? 8 * (jc + jj + 1) - 2 : 8 * (jc + jj);
          if (valid[h])
            *reinterpret_cast<uint2*>(arow[h] + c) = odd ? make_uint2(got, b) : make_uint2(a, got);
        }
    }
  }
}

template <int MODE, int GN, int G, int EPI>
__global__ void __launch_bounds__(THREADS, 2)
wgmma_layer(const __grid_constant__ CUtensorMap map_a, const __grid_constant__ CUtensorMap map_b,
            const LayerArgs p) {
  extern __shared__ unsigned char smem_raw[];
  // the swizzle pattern repeats every 1024 bytes: the stages start on such a
  // boundary
  const uint32_t ring = (smem_u32(smem_raw) + 1023u) & ~1023u;
  unsigned char* tail = smem_raw + (ring - smem_u32(smem_raw)) + STAGES * STAGE_BYTES;
  float* sVec = reinterpret_cast<float*>(tail);
  float* sScale = sVec + BN;
  float* sBias = sScale + BN;
  const uint32_t full = smem_u32(sBias + BN);  // STAGES barriers, then STAGES more
  const uint32_t empty = full + STAGES * 8;
  uint32_t* sInd = reinterpret_cast<uint32_t*>(sBias + BN + 4 * STAGES);  // GN_BCAST_VPU

  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  // column tiles of one row tile are neighbours in the grid: they share
  // their A tile in L2
  const int row0 = blockIdx.y * BM, col0 = blockIdx.x * BN;
  const int kt_count = p.K / BK;

  // tile kt of A and B into a stage, completion reported to the stage's
  // full barrier; called by thread 0 only
  auto load_tile = [&](int kt, int stage) {
    const uint32_t bar = full + 8 * stage;
    const uint32_t sA = ring + stage * STAGE_BYTES, sB = sA + A_BYTES;
    mbar_arrive_expect_tx(bar, STAGE_BYTES);
    tma_load_2d(sA, &map_a, bar, kt * BK, row0);
    tma_load_2d(sB, &map_b, bar, col0, kt * BK);
    tma_load_2d(sB + B_HALF_BYTES, &map_b, bar, col0 + 64, kt * BK);
  };

  if (tid == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(full + 8 * s, 1);              // thread 0's arrive.expect_tx
      mbar_init(empty + 8 * s, THREADS / 32);  // lane 0 of each warp
    }
    mbar_init_fence();
    for (int kt = 0; kt < STAGES && kt < kt_count; ++kt) load_tile(kt, kt);
  }
  if (tid < BN) {
    sVec[tid] = p.vec[col0 + tid];
    if (MODE != BIAS_OUT) {
      const float sc = p.gn_scale[col0 + tid];
      sScale[tid] = GN == 1 ? round_bf16(sc) : sc;
      sBias[tid] = p.gn_bias[col0 + tid];
      if constexpr (EPI == GN_BCAST_VPU) stage_ind<G>(p, sInd, col0, tid);
    }
  }
  __syncthreads();

  float acc[64];
#pragma unroll
  for (int i = 0; i < 64; ++i) acc[i] = 0.f;
  const uint32_t a_off = (warp >> 2) * (64 * BK * 2);  // this warpgroup's 64 rows of A
  int stage = 0;
  uint32_t phase = 0;
  for (int kt = 0; kt < kt_count; ++kt) {
    mbar_wait(full + 8 * stage, phase);
    const uint32_t sA = ring + stage * STAGE_BYTES + a_off;
    const uint32_t sB = ring + stage * STAGE_BYTES + A_BYTES;
    // A: K-major rows of 128 bytes, 8-row groups 1024 bytes apart; 16 k =
    // 32 bytes along a row. B: MN-major rows of 64 n, one row per k; the
    // second 64 columns one box later, 8-k groups 1024 bytes apart; 16 k =
    // 16 rows = 2048 bytes.
    const uint64_t da = smem_desc(sA, 16, 1024);
    const uint64_t db = smem_desc(sB, B_HALF_BYTES, 1024);
    wgmma_fence();
#pragma unroll
    for (int k = 0; k < BK / 16; ++k)
      wgmma_m64n128k16(acc, da + ((k * 32) >> 4), db + ((k * 2048) >> 4));
    wgmma_commit();
    if (kt > 0) {
      // the products of the step before have finished: release its stage
      // and, once every warp has, refill it with the tile STAGES steps on.
      // That stage's phase bit is `phase`, flipped if the ring just wrapped.
      wgmma_wait<1>();
      const int prev = stage == 0 ? STAGES - 1 : stage - 1;
      if (lane == 0) mbar_arrive(empty + 8 * prev);
      if (tid == 0 && kt - 1 + STAGES < kt_count) {
        mbar_wait(empty + 8 * prev, stage == 0 ? phase ^ 1 : phase);
        load_tile(kt - 1 + STAGES, prev);
      }
    }
    if (++stage == STAGES) {
      stage = 0;
      phase ^= 1;
    }
  }
  wgmma_wait<0>();
  accumulator_fence(acc);
  epilogue<MODE, GN, G, EPI>(p, acc, sVec, sScale, sBias, sInd, row0, col0, tid);
}

template <int MODE, int GN, int G, int EPI>
cudaError_t launch(const CUtensorMap& map_a, const CUtensorMap& map_b, const LayerArgs& p,
                   cudaStream_t stream) {
  constexpr int smem = smem_bytes<EPI>();
  static int limits[MAX_DEVICES];
  cudaError_t err = raise_smem_limit(limits, wgmma_layer<MODE, GN, G, EPI>, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid(p.N / BN, (p.M + BM - 1) / BM);
  wgmma_layer<MODE, GN, G, EPI><<<grid, THREADS, smem, stream>>>(map_a, map_b, p);
  return cudaGetLastError();
}

// Blocks of one instantiation that an SM holds at a time; 0 on error.
template <int MODE, int GN, int G, int EPI>
int blocks_per_sm() {
  constexpr int smem = smem_bytes<EPI>();
  auto kernel = wgmma_layer<MODE, GN, G, EPI>;
  int blocks = 0;
  if (cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem) !=
          cudaSuccess ||
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, kernel, THREADS, smem) !=
          cudaSuccess)
    return 0;
  return blocks;
}

template <int MODE, int GN>
cudaError_t launch_group(const CUtensorMap& a, const CUtensorMap& b, const LayerArgs& p,
                         cudaStream_t s) {
  switch (p.group) {
    case 4: return launch<MODE, GN, 4, FULL>(a, b, p, s);
    case 8: return launch<MODE, GN, 8, FULL>(a, b, p, s);
    case 16: return launch<MODE, GN, 16, FULL>(a, b, p, s);
    case 32: return launch<MODE, GN, 32, FULL>(a, b, p, s);
    case 64: return launch<MODE, GN, 64, FULL>(a, b, p, s);
    default: return cudaErrorInvalidValue;
  }
}

// One layer: a [M, K] bf16 (row stride lda = p.lda), w [w_rows, N] bf16. The
// weights' map comes from the cache; the activations are allocated anew each
// forward, so their map is encoded here. The shipped library (PROBE false)
// takes every group of `takes` in both GroupNorm modes with the FULL
// epilogue; the probe library only its shape, with the variant's.
template <int MODE, int EPI, bool PROBE>
cudaError_t layer(const LayerArgs& p, int w_rows, cudaStream_t s) {
  static_assert(PROBE || EPI == FULL, "the shipped library builds the FULL epilogue only");
  CUtensorMap map_a, map_b;
  if (!encode_bf16_map(&map_a, p.a, p.M, p.lda, BM, BK) ||
      !cached_bf16_map(&map_b, p.w, w_rows, p.N, BK, 64))
    return cudaErrorNotSupported;  // libcuda refused the map or lacks the call
  if constexpr (MODE == BIAS_OUT)
    return launch<BIAS_OUT, 0, 32, FULL>(map_a, map_b, p, s);
  else if constexpr (PROBE)
    return p.gn_bf16 == 1 && p.group == PROBE_GROUP
               ? launch<MODE, 1, PROBE_GROUP, EPI>(map_a, map_b, p, s)
               : cudaErrorInvalidValue;
  else
    return p.gn_bf16 ? launch_group<MODE, 1>(map_a, map_b, p, s)
                     : launch_group<MODE, 0>(map_a, map_b, p, s);
}

// widths and groups this kernel takes (score_kernel.kernel_path mirrors it)
inline bool takes(int h, int group, int tile) {
  return h % BN == 0 && tile == BN &&
         (group == 4 || group == 8 || group == 16 || group == 32 || group == 64);
}

// The operands of one forward (score_mlp.cu: zedo_score_mlp_forward).
struct Forward {
  const float* x;
  int m, c, io_pad, h, group, gn_bf16;
  const __nv_bfloat16* w_pre;
  const __nv_bfloat16* w_b[4];
  const __nv_bfloat16* w_post;
  const float *vecs, *gn_scale, *gn_bias, *bias_post;
  const __nv_bfloat16* ind;  // GN_BCAST_VPU only
  float *out, *resid;
  __nv_bfloat16 *act_h, *act_h1, *x_pad;
};

// One forward on this kernel: the bf16 copy of x, pre_dense -> GN -> SiLU,
// two residual blocks of (dense, GN, SiLU) x2 + skip, post_dense + bias.
// Seven launches on stream s; nothing allocates or synchronises. Returns the
// first CUDA error, or cudaSuccess.
template <int EPI, bool PROBE>
cudaError_t forward(const Forward& f, cudaStream_t s) {
  LayerArgs p{};
  p.M = f.m;
  p.group = f.group;
  p.gn_bf16 = f.gn_bf16;
  p.resid = f.resid;
  p.store_resid = 1;
  p.ind = f.ind;

  // pre_dense -> GN -> SiLU on the bf16 copy of x: starts the residual stream
  const int k0 = padded_input(f.c);
  const int chunks = f.m * (k0 / 8);
  pad_input<<<(chunks + 255) / 256, 256, 0, s>>>(f.x, f.m, f.c, f.x_pad, k0);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  p.a = f.x_pad; p.lda = k0; p.K = k0;
  p.w = f.w_pre; p.N = f.h;
  p.vec = f.vecs; p.gn_scale = f.gn_scale; p.gn_bias = f.gn_bias; p.act = f.act_h;
  p.mode = GN_SILU_FIRST;
  err = layer<GN_SILU_FIRST, EPI, PROBE>(p, f.io_pad, s);
  if (err != cudaSuccess) return err;

  const int h = f.h;
  p.lda = h; p.K = h;
  for (int blk = 0; blk < 2; ++blk) {
    const int l1 = 1 + 2 * blk, l2 = 2 + 2 * blk;
    p.a = f.act_h; p.w = f.w_b[2 * blk];
    p.vec = f.vecs + l1 * h; p.gn_scale = f.gn_scale + l1 * h; p.gn_bias = f.gn_bias + l1 * h;
    p.act = f.act_h1; p.mode = GN_SILU;
    err = layer<GN_SILU, EPI, PROBE>(p, h, s);
    if (err != cudaSuccess) return err;

    p.a = f.act_h1; p.w = f.w_b[2 * blk + 1];
    p.vec = f.vecs + l2 * h; p.gn_scale = f.gn_scale + l2 * h; p.gn_bias = f.gn_bias + l2 * h;
    p.act = f.act_h; p.mode = GN_SILU_RESID;
    p.store_resid = blk == 0;  // after the second block only the post layer follows
    err = layer<GN_SILU_RESID, EPI, PROBE>(p, h, s);
    if (err != cudaSuccess) return err;
  }

  // post_dense + bias
  p.a = f.act_h; p.w = f.w_post; p.N = f.io_pad;
  p.vec = f.bias_post; p.gn_scale = nullptr; p.gn_bias = nullptr;
  p.out = f.out; p.ldo = f.c; p.act = nullptr; p.mode = BIAS_OUT;
  return layer<BIAS_OUT, EPI, PROBE>(p, h, s);
}

}  // namespace wg

}  // namespace
