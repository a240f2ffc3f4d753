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
//   * `wgmma_layer` (score_mlp.cuh, with its own note; the probe library
//     score_mlp_probe.cu builds its epilogue variants): wgmma products fed
//     by a TMA/mbarrier ring, GroupNorm in the accumulator registers. It takes the widths whose column tile is 128 with a
//     power-of-two group of 4..64 channels: 128, 256, 512, 1024 (the
//     published width), 2048.
//   * `dense_layer` (this file): nvcuda::wmma fragments fed by a two-stage
//     cp.async pipeline, epilogue through an f32 tile staged in shared
//     memory. It takes every other lane-aligned width (384 and 768: column
//     tiles of 96, groups of 12 and 24).
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
// for 28, 144 for 36, up to 256. Each (row, group) reduces through the f32
// tile the epilogue stages in shared memory, so a group may span warps. The
// epilogue and GroupNorm modes are read at run time, one instantiation per
// column tile.
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

#include "score_mlp.cuh"

using namespace nvcuda;

namespace {

constexpr int BM = 128;       // rows of an output tile
constexpr int BK = 32;        // depth of one pipeline stage
constexpr int THREADS = 256;  // 8 warps
constexpr int A_LD = BK + 8;  // bf16 row stride in shared memory (80 bytes)
constexpr int A_STAGE = BM * A_LD;
constexpr int MIN_NF = 5;     // narrowest column tile: 80
constexpr int MAX_NF = 16;    // widest column tile: 256
constexpr int LANE_TILE = 128;  // column tile of the post layer (io_pad columns)

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

template <bool A_F32, int NF>
__global__ void __launch_bounds__(THREADS) dense_layer(const LayerArgs p) {
  using T = Tile<NF>;
  const int mode = p.mode;
  const bool bf16 = p.gn_bf16 != 0;
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

  // one thread per (row, group): consecutive threads take consecutive rows
  // of one group; the group's rstd goes to shared memory after the staged
  // tile
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

template <bool A_F32, int NF>
cudaError_t launch(const LayerArgs& p, cudaStream_t stream) {
  using T = Tile<NF>;
  if (p.N % T::BN != 0 || (p.mode != BIAS_OUT && T::BN % p.group != 0))
    return cudaErrorInvalidValue;
  const int rstd_bytes = p.mode == BIAS_OUT ? 0 : BM * (T::BN / p.group) * 4;
  const int epi = T::EPI_SMEM + rstd_bytes;
  const int smem = T::MAIN_SMEM > epi ? T::MAIN_SMEM : epi;
  static int limits[hopper::MAX_DEVICES];
  cudaError_t err = hopper::raise_smem_limit(limits, dense_layer<A_F32, NF>, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid(p.N / T::BN, (p.M + BM - 1) / BM);
  dense_layer<A_F32, NF><<<grid, THREADS, smem, stream>>>(p);
  return cudaGetLastError();
}

// a layer on the instantiation for its column tile
template <bool A_F32>
cudaError_t launch_tile(const LayerArgs& p, int tile, cudaStream_t s) {
  switch (tile) {
    case 80: return launch<A_F32, 5>(p, s);
    case 96: return launch<A_F32, 6>(p, s);
    case 112: return launch<A_F32, 7>(p, s);
    case 128: return launch<A_F32, 8>(p, s);
    case 144: return launch<A_F32, 9>(p, s);
    case 160: return launch<A_F32, 10>(p, s);
    case 176: return launch<A_F32, 11>(p, s);
    case 192: return launch<A_F32, 12>(p, s);
    case 208: return launch<A_F32, 13>(p, s);
    case 224: return launch<A_F32, 14>(p, s);
    case 240: return launch<A_F32, 15>(p, s);
    case 256: return launch<A_F32, 16>(p, s);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// Narrowest and widest column tiles the wmma kernel is built for.
int zedo_score_mlp_min_column_tile() { return 16 * MIN_NF; }
int zedo_score_mlp_max_column_tile() { return 16 * MAX_NF; }

// 1 when a forward at this width takes the wgmma kernel, 0 the wmma kernel.
int zedo_score_mlp_takes_wgmma(int h, int group, int tile) { return wg::takes(h, group, tile); }

// Columns of the bf16 copy of x that the wgmma path reads: c rounded up to
// the depth of one pipeline stage.
int zedo_score_mlp_padded_input(int c) { return wg::padded_input(c); }

// Blocks of the wgmma kernel (the published width's residual layer) that one
// SM holds at a time; the design counts on two. 0 on error.
int zedo_score_mlp_wgmma_blocks_per_sm() {
  return wg::blocks_per_sm<GN_SILU_RESID, 1, 32, FULL>();
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
  return static_cast<int>(
      wg::layer<BIAS_OUT, FULL, false>(p, k, static_cast<cudaStream_t>(stream)));
}

// One fused forward: x [m, c] f32 -> out [m, c] f32, c <= io_pad.
// Weights are bf16 in input-major layout: w_pre [io_pad, h], w_b* [h, h],
// w_post [h, io_pad]. vecs, gn_scale and gn_bias are [5, h] f32, bias_post
// [io_pad] f32. resid [m, h] f32, act_h, act_h1 [m, h] bf16 and x_pad
// [m, zedo_score_mlp_padded_input(c)] bf16 are scratch.
// tile: the column tile of the hidden layers (a multiple of 16 and of
// `group`, dividing h); gn_bf16: GroupNorm statistics mode (1 bf16, 0 f32).
// Nothing here allocates or synchronises. Returns the first CUDA error of
// the launches, or 0.
int zedo_score_mlp_forward(const float* x, int m, int c, int io_pad, int h, int group,
                           int tile, int gn_bf16, const void* w_pre, const void* w_b1,
                           const void* w_b2, const void* w_b3, const void* w_b4,
                           const void* w_post, const float* vecs,
                           const float* gn_scale, const float* gn_bias,
                           const float* bias_post, float* out, float* resid, void* act_h,
                           void* act_h1, void* x_pad, void* stream) {
  if (m <= 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const wg::Forward f{x, m, c, io_pad, h, group, gn_bf16,
                      static_cast<const __nv_bfloat16*>(w_pre),
                      {static_cast<const __nv_bfloat16*>(w_b1),
                       static_cast<const __nv_bfloat16*>(w_b2),
                       static_cast<const __nv_bfloat16*>(w_b3),
                       static_cast<const __nv_bfloat16*>(w_b4)},
                      static_cast<const __nv_bfloat16*>(w_post), vecs, gn_scale, gn_bias,
                      bias_post, nullptr, out, resid, static_cast<__nv_bfloat16*>(act_h),
                      static_cast<__nv_bfloat16*>(act_h1), static_cast<__nv_bfloat16*>(x_pad)};
  if (wg::takes(h, group, tile)) return static_cast<int>(wg::forward<FULL, false>(f, s));

  // the wmma kernel: the same sequence of layers, the first on the f32 x
  LayerArgs p{};
  p.M = m;
  p.group = group;
  p.gn_bf16 = gn_bf16;
  p.resid = resid;
  p.store_resid = 1;
  p.a = x; p.lda = c; p.k_valid = c; p.K = io_pad;
  p.w = f.w_pre; p.N = h;
  p.vec = vecs; p.gn_scale = gn_scale; p.gn_bias = gn_bias; p.act = f.act_h;
  p.mode = GN_SILU_FIRST;
  cudaError_t err = launch_tile<true>(p, tile, s);
  if (err != cudaSuccess) return static_cast<int>(err);

  p.lda = h; p.k_valid = h; p.K = h;
  for (int blk = 0; blk < 2; ++blk) {
    const int l1 = 1 + 2 * blk, l2 = 2 + 2 * blk;
    p.a = f.act_h; p.w = f.w_b[2 * blk];
    p.vec = vecs + l1 * h; p.gn_scale = gn_scale + l1 * h; p.gn_bias = gn_bias + l1 * h;
    p.act = f.act_h1; p.mode = GN_SILU;
    err = launch_tile<false>(p, tile, s);
    if (err != cudaSuccess) return static_cast<int>(err);

    p.a = f.act_h1; p.w = f.w_b[2 * blk + 1];
    p.vec = vecs + l2 * h; p.gn_scale = gn_scale + l2 * h; p.gn_bias = gn_bias + l2 * h;
    p.act = f.act_h; p.mode = GN_SILU_RESID;
    p.store_resid = blk == 0;  // after the second block only the post layer follows
    err = launch_tile<false>(p, tile, s);
    if (err != cudaSuccess) return static_cast<int>(err);
  }

  // post_dense + bias
  p.a = f.act_h; p.w = f.w_post; p.N = io_pad;
  p.vec = bias_post; p.gn_scale = nullptr; p.gn_bias = nullptr;
  p.out = out; p.ldo = c; p.act = nullptr; p.mode = BIAS_OUT;
  return static_cast<int>(launch_tile<false>(p, LANE_TILE, s));
}

}  // extern "C"
