// Fused ScoreMLP forward for Hopper (sm_90a): one dense layer with a fused
// GroupNorm / SiLU / residual epilogue per launch, six such launches per
// forward (plus one small conversion of the input on the wgmma path).
//
// Replaces zedo_tpu/ops/pallas/score_kernel.py:fused_score_forward (body
// `_kernel`, `_gn_silu`). It computes the same function on the same packed
// weights (zedo_tpu_torch/ops/kernels/score_kernel.py:pack_weights): the dense
// weights come pre-centred by (I - P), so every GroupNorm only has to reduce
// the variance of its group.
//
// Two kernels live here and the C entry point picks one by width and group:
//   * `wgmma_layer` (second half of this file, with its own note): wgmma
//     products fed by a TMA/mbarrier ring, GroupNorm in the accumulator
//     registers. It takes the widths whose column tile is 128 with a
//     power-of-two group of 4..64 channels: 128, 256, 512, 1024 (the
//     published width), 2048.
//   * `dense_layer` (first half): nvcuda::wmma fragments fed by a two-stage
//     cp.async pipeline, epilogue through an f32 tile staged in shared
//     memory. It takes every other lane-aligned width (384 and 768: column
//     tiles of 96, groups of 12 and 24) and, when the caller forces it, the
//     widths above too, so that the two can be timed against each other.
//
// What bounds the forward on an H100: at the OIL shapes (B = S*N rows,
// H = 1024) it does 2*B*(51*H + 4*H*H + H*51) operations against ~9 MB of
// bf16 weights. The TPU kernel kept all weights in VMEM for the whole grid;
// an SM has 227 KB of shared memory, so here each launch streams its [K, N]
// weight tiles from L2 (9 MB fits the 50 MB L2 many times over) and keeps the
// product of a 128-row output tile in registers. The tile is a whole number
// of GroupNorm groups wide, so GroupNorm, SiLU and the residual add run in
// the epilogue on the tile's f32 accumulators: the only bytes that go through
// device memory between layers are one bf16 activation and the f32 residual
// stream. That traffic is the second bound of a one-launch-per-layer design:
// B*H*(6 + 2*4 + 12 + 8 + 2) = 36*B*H bytes (layer 0 writes 6 bytes a
// channel, a plain GroupNorm layer reads 2 and writes 2, the first residual
// layer reads 6 and writes 6, the second reads 6 and writes only the bf16
// activation, since no later layer reads its residual, and the last layer
// reads 2), 1.63 GB at 44,300 x 1024.
//
// Column tile of `dense_layer`: 16 * NF columns, a multiple of both 16 and
// the GroupNorm group size (the wrapper picks it, score_kernel.column_tile):
// 128 for groups of 4, 8, 16, 32 and 64, 96 for 12 and 24, 80 for 20, 112
// for 28, 144 for 36, up to 256. Groups of a power of two of at most 32
// channels reduce with warp shuffles; every other group size reduces each
// (row, group) through the f32 tile the epilogue stages in shared memory, so
// a group may span warps. The shuffle path is instantiated for each epilogue
// and GroupNorm mode, so its branches fold away; the other widths read the
// modes at run time, one instantiation per column tile.
//
// GroupNorm statistics in two modes, those of the TPU kernel's `gn_dtype`:
//   f32:  var = sum(v*v) / group; factor = rsqrt(var + eps) * scale
//   bf16: var = sum(bf16(v*v)) * bf16(1/group);
//         factor = bf16(rsqrt(var + eps)) * bf16(scale)
// (the bf16 mode rounds where the TPU kernel's two indicator products round
// their operands; the products of two bf16 values are exact in f32).
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

#include "hopper.cuh"

using namespace nvcuda;

namespace {

constexpr int BM = 128;       // rows of an output tile
constexpr int BK = 32;        // depth of one pipeline stage
constexpr int THREADS = 256;  // 8 warps
constexpr int A_LD = BK + 8;  // bf16 row stride in shared memory (80 bytes)
constexpr int A_STAGE = BM * A_LD;
constexpr int MIN_NF = 5;     // narrowest column tile: 80
constexpr int MAX_NF = 16;    // widest column tile: 256
constexpr float GN_EPS = 1e-5f;

// Shapes of a 16*NF-column tile. Warps tile it 4 x 2 when NF is even and
// 8 x 1 when it is odd; each warp holds FM x FN 16x16 f32 accumulators.
template <int NF>
struct Tile {
  static constexpr int BN = 16 * NF;
  static constexpr int WN = NF % 2 == 0 ? 2 : 1;
  static constexpr int WM = 8 / WN;
  static constexpr int FM = BM / WM / 16;
  static constexpr int FN = NF / WN;
  static constexpr int B_LD = BN + 8;  // bf16, keeps rows 16-byte aligned
  static constexpr int C_LD = BN + 4;  // f32 epilogue tile row stride
  static constexpr int B_STAGE = BK * B_LD;
  static constexpr int MAIN_SMEM = 2 * (A_STAGE + B_STAGE) * 2;
  static constexpr int EPI_SMEM = BM * C_LD * 4;
};

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
};

__device__ __forceinline__ float round_bf16(float x) {
  return __bfloat162float(__float2bfloat16(x));
}

// A kernel's epilogue mode and GroupNorm statistics mode (1 bf16, 0 f32)
// are template arguments where the kernel is instantiated for them (the
// published width's shuffle path), so their branches fold away, or RUNTIME
// to read them from LayerArgs (the other widths, one kernel per tile).
constexpr int RUNTIME = -1;

// one channel's contribution to its group's sum of squares
__device__ __forceinline__ float square(float v, bool bf16) {
  return bf16 ? round_bf16(v * v) : v * v;
}

__device__ __forceinline__ float group_rstd(float ss, const LayerArgs& p, bool bf16) {
  if (bf16) return round_bf16(rsqrtf(ss * round_bf16(1.f / p.group) + GN_EPS));
  return rsqrtf(ss / p.group + GN_EPS);
}

// GroupNorm (given the group's rstd), SiLU and the layer's write-back of
// one element v = acc + vec at row gr, column gc
__device__ __forceinline__ void finish(const LayerArgs& p, int mode, bool bf16, float v,
                                       float rstd, int gr, int gc) {
  const float scale = bf16 ? round_bf16(p.gn_scale[gc]) : p.gn_scale[gc];
  const float xn = v * (rstd * scale) + p.gn_bias[gc];
  float y = xn * (0.5f * tanhf(0.5f * xn) + 0.5f);
  if (gr < p.M) {
    const size_t o = (size_t)gr * p.N + gc;
    if (mode == GN_SILU_RESID) y += p.resid[o];
    if (mode != GN_SILU && p.store_resid) p.resid[o] = y;
    p.act[o] = __float2bfloat16(y);
  }
}

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(gmem));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

template <bool A_F32, int NF>
__device__ __forceinline__ void load_stage(const LayerArgs& p, __nv_bfloat16* dA,
                                           __nv_bfloat16* dB, int row0, int col0,
                                           int k0, int tid) {
  using T = Tile<NF>;
  if constexpr (A_F32) {
    // the first layer reads the f32 poses, casts them to bf16 and reads the
    // columns past k_valid and the rows past M as zero
    const float* a = static_cast<const float*>(p.a);
    for (int i = tid; i < BM * BK; i += THREADS) {
      const int r = i / BK, c = i % BK;
      const int gr = row0 + r, gc = k0 + c;
      const float v = (gr < p.M && gc < p.k_valid) ? a[(size_t)gr * p.lda + gc] : 0.f;
      dA[r * A_LD + c] = __float2bfloat16(v);
    }
  } else {
    const __nv_bfloat16* a = static_cast<const __nv_bfloat16*>(p.a);
    for (int i = tid; i < BM * BK / 8; i += THREADS) {
      const int r = i / (BK / 8), c = (i % (BK / 8)) * 8;
      // rows past M read row M-1: their results are never stored
      const int gr = min(row0 + r, p.M - 1);
      cp_async16(dA + r * A_LD + c, a + (size_t)gr * p.lda + k0 + c);
    }
  }
  for (int i = tid; i < BK * T::BN / 8; i += THREADS) {
    const int r = i / (T::BN / 8), c = (i % (T::BN / 8)) * 8;
    cp_async16(dB + r * T::B_LD + c, p.w + (size_t)(k0 + r) * p.N + col0 + c);
  }
}

// SHFL: groups of a power of two of at most 32 channels in a 128-column
// tile, reduced with warp shuffles; otherwise through the staged tile.
// MODE, GN: the epilogue and GroupNorm statistics modes, or RUNTIME.
template <bool A_F32, int NF, bool SHFL, int MODE, int GN>
__global__ void __launch_bounds__(THREADS) dense_layer(const LayerArgs p) {
  using T = Tile<NF>;
  static_assert(!SHFL || T::BN == 128, "the shuffle reduction needs 32-column warp rows");
  const int mode = MODE == RUNTIME ? p.mode : MODE;
  const bool bf16 = GN == RUNTIME ? p.gn_bf16 != 0 : GN == 1;
  extern __shared__ __align__(128) unsigned char smem[];
  __nv_bfloat16* sA = reinterpret_cast<__nv_bfloat16*>(smem);
  __nv_bfloat16* sB = sA + 2 * A_STAGE;
  float* sC = reinterpret_cast<float*>(smem);

  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  // shifts, not a signed division: the loop's addresses stay cheap
  const int wm = T::WN == 2 ? warp >> 1 : warp, wn = T::WN == 2 ? warp & 1 : 0;
  const int row0 = blockIdx.y * BM, col0 = blockIdx.x * T::BN;

  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[T::FM][T::FN];
#pragma unroll
  for (int i = 0; i < T::FM; ++i)
#pragma unroll
    for (int j = 0; j < T::FN; ++j) wmma::fill_fragment(acc[i][j], 0.f);

  const int kt_count = p.K / BK;
  load_stage<A_F32, NF>(p, sA, sB, row0, col0, 0, tid);
  cp_async_commit();
  for (int kt = 0; kt < kt_count; ++kt) {
    const int stage = kt & 1;
    if (kt + 1 < kt_count) {
      load_stage<A_F32, NF>(p, sA + (stage ^ 1) * A_STAGE, sB + (stage ^ 1) * T::B_STAGE,
                            row0, col0, (kt + 1) * BK, tid);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const __nv_bfloat16* tA = sA + stage * A_STAGE;
    const __nv_bfloat16* tB = sB + stage * T::B_STAGE;
#pragma unroll
    for (int kk = 0; kk < BK; kk += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, wmma::row_major> fa[T::FM];
#pragma unroll
      for (int i = 0; i < T::FM; ++i)
        wmma::load_matrix_sync(fa[i], tA + (wm * (T::FM * 16) + i * 16) * A_LD + kk, A_LD);
      wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, wmma::row_major> fb[T::FN];
#pragma unroll
      for (int j = 0; j < T::FN; ++j)
        // a warp base plus a constant per fragment: the loads take immediate offsets
        wmma::load_matrix_sync(fb[j], tB + kk * T::B_LD + wn * (T::FN * 16) + j * 16, T::B_LD);
#pragma unroll
      for (int i = 0; i < T::FM; ++i)
#pragma unroll
        for (int j = 0; j < T::FN; ++j) wmma::mma_sync(acc[i][j], fa[i], fb[j], acc[i][j]);
    }
    __syncthreads();
  }

  // the pipeline buffers are free now: stage the f32 tile for the epilogue
#pragma unroll
  for (int i = 0; i < T::FM; ++i)
#pragma unroll
    for (int j = 0; j < T::FN; ++j)
      wmma::store_matrix_sync(
          sC + (wm * (T::FM * 16) + i * 16) * T::C_LD + wn * (T::FN * 16) + j * 16, acc[i][j],
          T::C_LD, wmma::mem_row_major);
  __syncthreads();

  if (mode == BIAS_OUT) {
    for (int idx = tid; idx < BM * T::BN; idx += THREADS) {
      const int r = idx / T::BN, c = idx % T::BN;
      const int gr = row0 + r, gc = col0 + c;
      if (gr < p.M && gc < p.ldo) p.out[(size_t)gr * p.ldo + gc] = sC[r * T::C_LD + c] + p.vec[gc];
    }
    return;
  }

  if constexpr (SHFL) {
    // A warp covers 32 consecutive columns of one row, so the lanes of one
    // GroupNorm group are neighbours and reduce with shuffles. Every lane
    // runs the same number of iterations, so the shuffles see the full warp.
    for (int idx = tid; idx < BM * T::BN; idx += THREADS) {
      const int r = idx / T::BN, c = idx % T::BN;
      const float v = sC[r * T::C_LD + c] + p.vec[col0 + c];
      float ss = square(v, bf16);
      for (int off = p.group >> 1; off > 0; off >>= 1)
        ss += __shfl_xor_sync(0xffffffffu, ss, off);
      finish(p, mode, bf16, v, group_rstd(ss, p, bf16), row0 + r, col0 + c);
    }
  } else {
    // one thread per (row, group): consecutive threads take consecutive
    // rows of one group; the group's rstd goes to shared memory after the
    // staged tile
    float* sR = sC + BM * T::C_LD;
    const int gpt = T::BN / p.group;  // groups per tile
    const bool vec4 = (p.group & 3) == 0;
    for (int q = tid; q < BM * gpt; q += THREADS) {
      const int r = q % BM, c0 = (q / BM) * p.group;
      const float* row = sC + r * T::C_LD + c0;
      const float* vec = p.vec + col0 + c0;
      float ss = 0.f;
      if (vec4) {
        for (int k = 0; k < p.group; k += 4) {
          const float4 a = *reinterpret_cast<const float4*>(row + k);
          const float4 b = __ldg(reinterpret_cast<const float4*>(vec + k));
          ss += square(a.x + b.x, bf16) + square(a.y + b.y, bf16) +
                square(a.z + b.z, bf16) + square(a.w + b.w, bf16);
        }
      } else {
        for (int k = 0; k < p.group; ++k) ss += square(row[k] + vec[k], bf16);
      }
      sR[r * gpt + q / BM] = group_rstd(ss, p, bf16);
    }
    __syncthreads();
    for (int idx = tid; idx < BM * T::BN; idx += THREADS) {
      const int r = idx / T::BN, c = idx % T::BN;
      const float v = sC[r * T::C_LD + c] + p.vec[col0 + c];
      finish(p, mode, bf16, v, sR[r * gpt + c / p.group], row0 + r, col0 + c);
    }
  }
}

template <bool A_F32, int NF, bool SHFL, int MODE = RUNTIME, int GN = RUNTIME>
cudaError_t launch(const LayerArgs& p, cudaStream_t stream) {
  using T = Tile<NF>;
  if (p.N % T::BN != 0 || (p.mode != BIAS_OUT && T::BN % p.group != 0))
    return cudaErrorInvalidValue;
  const int rstd_bytes = SHFL || p.mode == BIAS_OUT ? 0 : BM * (T::BN / p.group) * 4;
  const int epi = T::EPI_SMEM + rstd_bytes;
  const int smem = T::MAIN_SMEM > epi ? T::MAIN_SMEM : epi;
  cudaError_t err = cudaFuncSetAttribute(dense_layer<A_F32, NF, SHFL, MODE, GN>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid(p.N / T::BN, (p.M + BM - 1) / BM);
  dense_layer<A_F32, NF, SHFL, MODE, GN><<<grid, THREADS, smem, stream>>>(p);
  return cudaGetLastError();
}

// a layer of the published width's path: 128-column tile, shuffle
// reduction, modes fixed at compile time
template <bool A_F32, int MODE>
cudaError_t launch_shfl(const LayerArgs& p, cudaStream_t s) {
  return p.gn_bf16 ? launch<A_F32, 8, true, MODE, 1>(p, s)
                   : launch<A_F32, 8, true, MODE, 0>(p, s);
}

// a layer of any other width: the instantiation for its column tile
template <bool A_F32>
cudaError_t launch_tile(const LayerArgs& p, int tile, cudaStream_t s) {
  switch (tile) {
    case 80: return launch<A_F32, 5, false>(p, s);
    case 96: return launch<A_F32, 6, false>(p, s);
    case 112: return launch<A_F32, 7, false>(p, s);
    case 128: return launch<A_F32, 8, false>(p, s);
    case 144: return launch<A_F32, 9, false>(p, s);
    case 160: return launch<A_F32, 10, false>(p, s);
    case 176: return launch<A_F32, 11, false>(p, s);
    case 192: return launch<A_F32, 12, false>(p, s);
    case 208: return launch<A_F32, 13, false>(p, s);
    case 224: return launch<A_F32, 14, false>(p, s);
    case 240: return launch<A_F32, 15, false>(p, s);
    case 256: return launch<A_F32, 16, false>(p, s);
    default: return cudaErrorInvalidValue;
  }
}


// ---------------------------------------------------------------------------
// `wgmma_layer`: the same dense layer, redesigned for Hopper.
//
// Replaces the per-layer body of zedo_tpu/ops/pallas/score_kernel.py:_kernel
// (a dense product, `_gn_silu`, the residual add) for the widths named at the
// head of this file.
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
// SiLU is x * (0.5 * tanh(x / 2) + 0.5) with `tanh.approx.f32` (one MUFU
// operation, relative error about 2^-11, an eighth of a bf16 rounding
// step); the wmma kernel and the plain version use the precise tanhf, and
// the kernel is held against the plain version within the same tolerance.
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

template <int G>
__device__ __forceinline__ float rstd_of(float ss, bool bf16) {
  if (bf16) return round_bf16(rsqrtf(ss * round_bf16(1.f / G) + GN_EPS));
  return rsqrtf(ss / G + GN_EPS);
}

__device__ __forceinline__ float silu(float x) {
  float t;
  asm("tanh.approx.f32 %0, %1;\n" : "=f"(t) : "f"(0.5f * x));
  return x * (0.5f * t + 0.5f);
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

// The epilogue of one thread's 2 rows x 64 columns of accumulators.
// MODE: the layer's epilogue; GN: GroupNorm statistics mode (1 bf16, 0 f32);
// G: channels per GroupNorm group (4, 8, 16, 32 or 64).
template <int MODE, int GN, int G>
__device__ __forceinline__ void epilogue(const LayerArgs& p, float (&acc)[64], const float* sVec,
                                         const float* sScale, const float* sBias, int row0,
                                         int col0, int tid) {
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
          ss[h] += square(acc[4 * j + 2 * h], bf16) + square(acc[4 * j + 2 * h + 1], bf16);
        }
      }
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        // the lanes of a quad hold one row's 8 columns of each j; a group of
        // 4 channels is half a quad
        ss[h] += __shfl_xor_sync(0xffffffffu, ss[h], 1);
        if (G >= 8) ss[h] += __shfl_xor_sync(0xffffffffu, ss[h], 2);
        out[h] = rstd_of<G>(ss[h], bf16);
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

    float2 next[JC][2];
    if constexpr (MODE == GN_SILU_RESID) load_resid(0, next);
    float rstd[JC][2];  // of the chunk's j-th column block, per row
#pragma unroll
    for (int jc = 0; jc < 16; jc += JC) {
      if constexpr (JPG >= JC) {
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
          float y0 = silu(acc[4 * j + 2 * h] * (rstd[jj][h] * sc.x) + bi.x);
          float y1 = silu(acc[4 * j + 2 * h + 1] * (rstd[jj][h] * sc.y) + bi.y);
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

template <int MODE, int GN, int G>
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
  epilogue<MODE, GN, G>(p, acc, sVec, sScale, sBias, row0, col0, tid);
}

template <int MODE, int GN, int G>
cudaError_t launch(const CUtensorMap& map_a, const CUtensorMap& map_b, const LayerArgs& p,
                   cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(wgmma_layer<MODE, GN, G>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_BYTES);
  if (err != cudaSuccess) return err;
  const dim3 grid(p.N / BN, (p.M + BM - 1) / BM);
  wgmma_layer<MODE, GN, G><<<grid, THREADS, SMEM_BYTES, stream>>>(map_a, map_b, p);
  return cudaGetLastError();
}

template <int MODE, int GN>
cudaError_t launch_group(const CUtensorMap& a, const CUtensorMap& b, const LayerArgs& p,
                         cudaStream_t s) {
  switch (p.group) {
    case 4: return launch<MODE, GN, 4>(a, b, p, s);
    case 8: return launch<MODE, GN, 8>(a, b, p, s);
    case 16: return launch<MODE, GN, 16>(a, b, p, s);
    case 32: return launch<MODE, GN, 32>(a, b, p, s);
    case 64: return launch<MODE, GN, 64>(a, b, p, s);
    default: return cudaErrorInvalidValue;
  }
}

// One layer: a [M, K] bf16 (row stride lda = p.lda), w [w_rows, N] bf16.
template <int MODE>
cudaError_t layer(const LayerArgs& p, int w_rows, cudaStream_t s) {
  CUtensorMap map_a, map_b;
  if (!encode_bf16_map(&map_a, p.a, p.M, p.lda, BM, BK) ||
      !encode_bf16_map(&map_b, p.w, w_rows, p.N, BK, 64))
    return cudaErrorNotSupported;  // libcuda refused the map or lacks the call
  if constexpr (MODE == BIAS_OUT)
    return launch<BIAS_OUT, 0, 32>(map_a, map_b, p, s);
  else
    return p.gn_bf16 ? launch_group<MODE, 1>(map_a, map_b, p, s)
                     : launch_group<MODE, 0>(map_a, map_b, p, s);
}

// widths and groups this kernel takes (score_kernel.kernel_path mirrors it)
inline bool takes(int h, int group, int tile) {
  return h % BN == 0 && tile == BN &&
         (group == 4 || group == 8 || group == 16 || group == 32 || group == 64);
}

}  // namespace wg

}  // namespace

extern "C" {

// Narrowest and widest column tiles the wmma kernel is built for.
int zedo_score_mlp_min_column_tile() { return 16 * MIN_NF; }
int zedo_score_mlp_max_column_tile() { return 16 * MAX_NF; }

// 1 when a forward at this width takes the wgmma kernel, 0 the wmma kernel.
int zedo_score_mlp_takes_wgmma(int h, int group, int tile) { return wg::takes(h, group, tile); }

// Columns of the bf16 copy of x that the wgmma path reads: c rounded up to
// the depth of one pipeline stage.
int zedo_score_mlp_padded_input(int c) { return (c + wg::BK - 1) / wg::BK * wg::BK; }

// Blocks of the wgmma kernel (the published width's residual layer) that one
// SM holds at a time; the design counts on two. 0 on error.
int zedo_score_mlp_wgmma_blocks_per_sm() {
  auto kernel = wg::wgmma_layer<GN_SILU_RESID, 1, 32>;
  int blocks = 0;
  if (cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           wg::SMEM_BYTES) != cudaSuccess ||
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, kernel, wg::THREADS,
                                                    wg::SMEM_BYTES) != cudaSuccess)
    return 0;
  return blocks;
}

// out [m, ldo] f32 = a [m, k] bf16 @ w [k, n] bf16 + bias [n] f32, first ldo
// columns, through the wgmma kernel's product and its bias epilogue: the
// kernel's product alone, for checks against a matrix product. k a multiple
// of 64, n of 128.
int zedo_score_mlp_product(const void* a, int m, int k, const void* w, int n, const float* bias,
                           float* out, int ldo, void* stream) {
  if (m <= 0) return 0;
  if (k % wg::BK != 0 || n % wg::BN != 0) return static_cast<int>(cudaErrorInvalidValue);
  LayerArgs p{};
  p.M = m; p.a = a; p.lda = k; p.K = k;
  p.w = static_cast<const __nv_bfloat16*>(w); p.N = n;
  p.vec = bias; p.out = out; p.ldo = ldo; p.mode = BIAS_OUT;
  return static_cast<int>(wg::layer<BIAS_OUT>(p, k, static_cast<cudaStream_t>(stream)));
}

// One fused forward: x [m, c] f32 -> out [m, c] f32, c <= io_pad.
// Weights are bf16 in input-major layout: w_pre [io_pad, h], w_b* [h, h],
// w_post [h, io_pad]. vecs, gn_scale and gn_bias are [5, h] f32, bias_post
// [io_pad] f32. resid [m, h] f32, act_h, act_h1 [m, h] bf16 and x_pad
// [m, zedo_score_mlp_padded_input(c)] bf16 are scratch.
// tile: the column tile of the hidden layers (a multiple of 16 and of
// `group`, dividing h); gn_bf16: GroupNorm statistics mode (1 bf16, 0 f32);
// force_wmma: 1 runs the wmma kernel at a width the wgmma kernel takes.
// Nothing here allocates or synchronises. Returns the first CUDA error of
// the launches, or 0.
int zedo_score_mlp_forward(const float* x, int m, int c, int io_pad, int h, int group,
                           int tile, int gn_bf16, int force_wmma, const void* w_pre,
                           const void* w_b1, const void* w_b2, const void* w_b3,
                           const void* w_b4, const void* w_post, const float* vecs,
                           const float* gn_scale, const float* gn_bias,
                           const float* bias_post, float* out, float* resid, void* act_h,
                           void* act_h1, void* x_pad, void* stream) {
  if (m <= 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  __nv_bfloat16* hb = static_cast<__nv_bfloat16*>(act_h);
  __nv_bfloat16* h1b = static_cast<__nv_bfloat16*>(act_h1);
  const __nv_bfloat16* wb[4] = {
      static_cast<const __nv_bfloat16*>(w_b1), static_cast<const __nv_bfloat16*>(w_b2),
      static_cast<const __nv_bfloat16*>(w_b3), static_cast<const __nv_bfloat16*>(w_b4)};

  LayerArgs p{};
  p.M = m;
  p.group = group;
  p.gn_bf16 = gn_bf16;
  p.resid = resid;
  p.store_resid = 1;
  const bool wgmma = !force_wmma && wg::takes(h, group, tile);
  const bool shfl = tile == 128 && group <= 32 && (group & (group - 1)) == 0;
  cudaError_t err;

  // pre_dense -> GN -> SiLU: starts the residual stream
  p.w = static_cast<const __nv_bfloat16*>(w_pre); p.N = h;
  p.vec = vecs; p.gn_scale = gn_scale; p.gn_bias = gn_bias; p.act = hb;
  p.mode = GN_SILU_FIRST;
  if (wgmma) {
    const int k0 = zedo_score_mlp_padded_input(c);
    __nv_bfloat16* xp = static_cast<__nv_bfloat16*>(x_pad);
    const int chunks = m * (k0 / 8);
    wg::pad_input<<<(chunks + 255) / 256, 256, 0, s>>>(x, m, c, xp, k0);
    err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
    p.a = xp; p.lda = k0; p.K = k0;
    err = wg::layer<GN_SILU_FIRST>(p, io_pad, s);
  } else {
    p.a = x; p.lda = c; p.k_valid = c; p.K = io_pad;
    err = shfl ? launch_shfl<true, GN_SILU_FIRST>(p, s) : launch_tile<true>(p, tile, s);
  }
  if (err != cudaSuccess) return static_cast<int>(err);

  p.lda = h; p.k_valid = h; p.K = h;
  for (int blk = 0; blk < 2; ++blk) {
    const int l1 = 1 + 2 * blk, l2 = 2 + 2 * blk;
    p.a = hb; p.w = wb[2 * blk];
    p.vec = vecs + l1 * h; p.gn_scale = gn_scale + l1 * h; p.gn_bias = gn_bias + l1 * h;
    p.act = h1b; p.mode = GN_SILU;
    err = wgmma  ? wg::layer<GN_SILU>(p, h, s)
          : shfl ? launch_shfl<false, GN_SILU>(p, s)
                 : launch_tile<false>(p, tile, s);
    if (err != cudaSuccess) return static_cast<int>(err);

    p.a = h1b; p.w = wb[2 * blk + 1];
    p.vec = vecs + l2 * h; p.gn_scale = gn_scale + l2 * h; p.gn_bias = gn_bias + l2 * h;
    p.act = hb; p.mode = GN_SILU_RESID;
    p.store_resid = blk == 0;  // after the second block only the post layer follows
    err = wgmma  ? wg::layer<GN_SILU_RESID>(p, h, s)
          : shfl ? launch_shfl<false, GN_SILU_RESID>(p, s)
                 : launch_tile<false>(p, tile, s);
    if (err != cudaSuccess) return static_cast<int>(err);
  }

  // post_dense + bias
  p.a = hb; p.w = static_cast<const __nv_bfloat16*>(w_post); p.N = io_pad;
  p.vec = bias_post; p.gn_scale = nullptr; p.gn_bias = nullptr;
  p.out = out; p.ldo = c; p.act = nullptr; p.mode = BIAS_OUT;
  err = wgmma ? wg::layer<BIAS_OUT>(p, h, s) : launch<false, 8, true, BIAS_OUT, 0>(p, s);
  return static_cast<int>(err);
}

}  // extern "C"
