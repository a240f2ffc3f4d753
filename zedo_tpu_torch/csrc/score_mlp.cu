// Fused ScoreMLP forward for Hopper (sm_90a), one templated GEMM with a fused
// epilogue, launched once per dense layer (six launches per forward).
//
// Replaces zedo_tpu/ops/pallas/score_kernel.py:fused_score_forward (body
// `_kernel`, `_gn_silu`). It computes the same function on the same packed
// weights (zedo_tpu_torch/ops/kernels/score_kernel.py:pack_weights): the dense
// weights come pre-centred by (I - P), so every GroupNorm only has to reduce
// the variance of its group.
//
// What bounds it on an H100: at the OIL shapes (B = S*N rows, H = 1024) the
// forward does 2*B*(51*H + 4*H*H + H*51) operations against ~9 MB of bf16
// weights, ~300 operations per byte of device traffic even with the
// activations going through memory, so it sits at the edge of being bound
// by the tensor cores. The TPU kernel kept all weights in VMEM for the whole
// grid; an SM has 227 KB of shared memory, so here each launch streams its
// [K, N] weight tiles from L2 (9 MB fits the 50 MB L2 many times over) and
// keeps the product of a 128-row output tile in registers. The tile is a
// whole number of GroupNorm groups wide, so GroupNorm, SiLU and the residual
// add run in the epilogue on the tile's f32 accumulators: the only bytes that
// go through device memory between layers are one bf16 activation and the
// f32 residual stream. The tensor cores are used through nvcuda::wmma (bf16
// fragments, f32 accumulation) with a two-stage cp.async pipeline; wgmma and
// TMA are left for later work.
//
// Column tile: 16 * NF columns, a multiple of both 16 and the GroupNorm
// group size (the wrapper picks it, score_kernel.column_tile): 128 for
// groups of 4, 8, 16, 32 and 64, 96 for 12 and 24, 80 for 20, 112 for 28,
// 144 for 36, up to 256. Groups of a power of two of at most 32 channels
// reduce with warp shuffles (the 128-column tile of the published width,
// groups of 32); every other group size reduces each (row, group) through
// the f32 tile the epilogue stages in shared memory, so a group may span
// warps. The shuffle path is instantiated for each epilogue and GroupNorm
// mode, so its branches fold away; the other widths read the modes at run
// time, one instantiation per column tile.
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
  GN_SILU_RESID = 2,  // h = resid + silu(gn(acc + vec)); resid = h; act = bf16(h)
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
    if (mode != GN_SILU) p.resid[o] = y;
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

}  // namespace

extern "C" {

// Narrowest and widest column tiles the kernel is built for.
int zedo_score_mlp_min_column_tile() { return 16 * MIN_NF; }
int zedo_score_mlp_max_column_tile() { return 16 * MAX_NF; }

// One fused forward: x [m, c] f32 -> out [m, c] f32, c <= io_pad.
// Weights are bf16 in input-major layout: w_pre [io_pad, h], w_b* [h, h],
// w_post [h, io_pad]. vecs, gn_scale and gn_bias are [5, h] f32, bias_post
// [io_pad] f32. resid [m, h] f32 and act_h, act_h1 [m, h] bf16 are scratch.
// tile: the column tile of the hidden layers (a multiple of 16 and of
// `group`, dividing h); gn_bf16: GroupNorm statistics mode (1 bf16, 0 f32).
// Returns the first CUDA error of the six launches, or 0.
int zedo_score_mlp_forward(const float* x, int m, int c, int io_pad, int h, int group,
                           int tile, int gn_bf16, const void* w_pre, const void* w_b1,
                           const void* w_b2, const void* w_b3, const void* w_b4,
                           const void* w_post, const float* vecs, const float* gn_scale,
                           const float* gn_bias, const float* bias_post, float* out,
                           float* resid, void* act_h, void* act_h1, void* stream) {
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

  // pre_dense -> GN -> SiLU: starts the residual stream
  p.a = x; p.lda = c; p.k_valid = c; p.K = io_pad;
  p.w = static_cast<const __nv_bfloat16*>(w_pre); p.N = h;
  p.vec = vecs; p.gn_scale = gn_scale; p.gn_bias = gn_bias; p.act = hb;
  p.mode = GN_SILU_FIRST;
  const bool shfl = tile == 128 && group <= 32 && (group & (group - 1)) == 0;
  cudaError_t err = shfl ? launch_shfl<true, GN_SILU_FIRST>(p, s) : launch_tile<true>(p, tile, s);
  if (err != cudaSuccess) return static_cast<int>(err);

  p.lda = h; p.k_valid = h; p.K = h;
  for (int blk = 0; blk < 2; ++blk) {
    const int l1 = 1 + 2 * blk, l2 = 2 + 2 * blk;
    p.a = hb; p.w = wb[2 * blk];
    p.vec = vecs + l1 * h; p.gn_scale = gn_scale + l1 * h; p.gn_bias = gn_bias + l1 * h;
    p.act = h1b; p.mode = GN_SILU;
    err = shfl ? launch_shfl<false, GN_SILU>(p, s) : launch_tile<false>(p, tile, s);
    if (err != cudaSuccess) return static_cast<int>(err);

    p.a = h1b; p.w = wb[2 * blk + 1];
    p.vec = vecs + l2 * h; p.gn_scale = gn_scale + l2 * h; p.gn_bias = gn_bias + l2 * h;
    p.act = hb; p.mode = GN_SILU_RESID;
    err = shfl ? launch_shfl<false, GN_SILU_RESID>(p, s) : launch_tile<false>(p, tile, s);
    if (err != cudaSuccess) return static_cast<int>(err);
  }

  // post_dense + bias
  p.a = hb; p.w = static_cast<const __nv_bfloat16*>(w_post); p.N = io_pad;
  p.vec = bias_post; p.gn_scale = nullptr; p.gn_bias = nullptr;
  p.out = out; p.ldo = c; p.act = nullptr; p.mode = BIAS_OUT;
  err = launch<false, 8, true, BIAS_OUT, 0>(p, s);
  return static_cast<int>(err);
}

}  // extern "C"
