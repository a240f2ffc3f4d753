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
// keeps the product of a 128 x 128 output tile in registers. The tile is a
// whole number of GroupNorm groups wide, so GroupNorm, SiLU and the residual
// add run in the epilogue on the tile's f32 accumulators: the only bytes that
// go through device memory between layers are one bf16 activation and the
// f32 residual stream. The tensor cores are used through nvcuda::wmma (bf16
// fragments, f32 accumulation) with a two-stage cp.async pipeline; wgmma and
// TMA are left for later work.
//
// GroupNorm statistics are reduced in f32 with warp shuffles (a group is
// H/32 contiguous channels, at most 32, so one group never leaves a warp):
// the function of the TPU kernel under gn_dtype=float32.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

using namespace nvcuda;

namespace {

constexpr int BM = 128;  // rows of an output tile
constexpr int BN = 128;  // columns of an output tile (whole GroupNorm groups)
constexpr int BK = 32;   // depth of one pipeline stage
constexpr int THREADS = 256;  // 8 warps, each owns a 32 x 64 sub-tile
constexpr int A_LD = BK + 8;  // bf16 row stride in shared memory (80 bytes)
constexpr int B_LD = BN + 8;  // 272 bytes
constexpr int C_LD = BN + 4;  // f32 epilogue tile row stride
constexpr int A_STAGE = BM * A_LD;
constexpr int B_STAGE = BK * B_LD;
constexpr int MAIN_SMEM = 2 * (A_STAGE + B_STAGE) * 2;
constexpr int EPI_SMEM = BM * C_LD * 4;
constexpr int SMEM_BYTES = MAIN_SMEM > EPI_SMEM ? MAIN_SMEM : EPI_SMEM;

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
  int N;                  // width of w, a multiple of BN
  const float* vec;       // [N] per-step vector (or output bias)
  const float* gn_scale;  // [N]
  const float* gn_bias;   // [N]
  int group;              // GroupNorm group size: a power of two, at most 32
  float* resid;           // [M, N] f32 residual stream
  __nv_bfloat16* act;     // [M, N] bf16 input of the next layer
  float* out;             // [M, ldo] f32 output (BIAS_OUT)
  int ldo;
  int M;
};

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

template <bool A_F32>
__device__ __forceinline__ void load_stage(const LayerArgs& p, __nv_bfloat16* dA,
                                           __nv_bfloat16* dB, int row0, int col0,
                                           int k0, int tid) {
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
  for (int i = tid; i < BK * BN / 8; i += THREADS) {
    const int r = i / (BN / 8), c = (i % (BN / 8)) * 8;
    cp_async16(dB + r * B_LD + c, p.w + (size_t)(k0 + r) * p.N + col0 + c);
  }
}

template <bool A_F32, int MODE>
__global__ void __launch_bounds__(THREADS) dense_layer(const LayerArgs p) {
  extern __shared__ __align__(128) unsigned char smem[];
  __nv_bfloat16* sA = reinterpret_cast<__nv_bfloat16*>(smem);
  __nv_bfloat16* sB = sA + 2 * A_STAGE;
  float* sC = reinterpret_cast<float*>(smem);

  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int wm = warp >> 1, wn = warp & 1;
  const int row0 = blockIdx.y * BM, col0 = blockIdx.x * BN;

  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[2][4];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) wmma::fill_fragment(acc[i][j], 0.f);

  const int kt_count = p.K / BK;
  load_stage<A_F32>(p, sA, sB, row0, col0, 0, tid);
  cp_async_commit();
  for (int kt = 0; kt < kt_count; ++kt) {
    const int stage = kt & 1;
    if (kt + 1 < kt_count) {
      load_stage<A_F32>(p, sA + (stage ^ 1) * A_STAGE, sB + (stage ^ 1) * B_STAGE,
                        row0, col0, (kt + 1) * BK, tid);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const __nv_bfloat16* tA = sA + stage * A_STAGE;
    const __nv_bfloat16* tB = sB + stage * B_STAGE;
#pragma unroll
    for (int kk = 0; kk < BK; kk += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, wmma::row_major> fa[2];
      wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, wmma::row_major> fb[4];
#pragma unroll
      for (int i = 0; i < 2; ++i)
        wmma::load_matrix_sync(fa[i], tA + (wm * 32 + i * 16) * A_LD + kk, A_LD);
#pragma unroll
      for (int j = 0; j < 4; ++j)
        wmma::load_matrix_sync(fb[j], tB + kk * B_LD + wn * 64 + j * 16, B_LD);
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) wmma::mma_sync(acc[i][j], fa[i], fb[j], acc[i][j]);
    }
    __syncthreads();
  }

  // the pipeline buffers are free now: stage the f32 tile for the epilogue
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
      wmma::store_matrix_sync(sC + (wm * 32 + i * 16) * C_LD + wn * 64 + j * 16,
                              acc[i][j], C_LD, wmma::mem_row_major);
  __syncthreads();

  // A warp covers 32 consecutive columns of one row, so the lanes of one
  // GroupNorm group are neighbours and reduce with shuffles. Every lane
  // runs the same number of iterations, so the shuffles see the full warp.
  for (int idx = tid; idx < BM * BN; idx += THREADS) {
    const int r = idx / BN, c = idx % BN;
    const int gr = row0 + r, gc = col0 + c;
    const float v = sC[r * C_LD + c] + p.vec[gc];
    if constexpr (MODE == BIAS_OUT) {
      if (gr < p.M && gc < p.ldo) p.out[(size_t)gr * p.ldo + gc] = v;
    } else {
      float ss = v * v;
      for (int off = p.group >> 1; off > 0; off >>= 1)
        ss += __shfl_xor_sync(0xffffffffu, ss, off);
      const float xn = v * rsqrtf(ss / p.group + 1e-5f) * p.gn_scale[gc] + p.gn_bias[gc];
      float y = xn * (0.5f * tanhf(0.5f * xn) + 0.5f);
      if (gr < p.M) {
        const size_t o = (size_t)gr * p.N + gc;
        if constexpr (MODE == GN_SILU_RESID) y += p.resid[o];
        if constexpr (MODE == GN_SILU_FIRST || MODE == GN_SILU_RESID) p.resid[o] = y;
        p.act[o] = __float2bfloat16(y);
      }
    }
  }
}

template <bool A_F32, int MODE>
cudaError_t launch(const LayerArgs& p, cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(
      dense_layer<A_F32, MODE>, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_BYTES);
  if (err != cudaSuccess) return err;
  const dim3 grid(p.N / BN, (p.M + BM - 1) / BM);
  dense_layer<A_F32, MODE><<<grid, THREADS, SMEM_BYTES, stream>>>(p);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Column tile of the kernel: the hidden width must be a multiple of it.
int zedo_score_mlp_column_tile() { return BN; }

// One fused forward: x [m, c] f32 -> out [m, c] f32, c <= io_pad.
// Weights are bf16 in input-major layout: w_pre [io_pad, h], w_b* [h, h],
// w_post [h, io_pad]. vecs, gn_scale and gn_bias are [5, h] f32, bias_post
// [io_pad] f32. resid [m, h] f32 and act_h, act_h1 [m, h] bf16 are scratch.
// Returns the first CUDA error of the six launches, or 0.
int zedo_score_mlp_forward(const float* x, int m, int c, int io_pad, int h, int group,
                           const void* w_pre, const void* w_b1, const void* w_b2,
                           const void* w_b3, const void* w_b4, const void* w_post,
                           const float* vecs, const float* gn_scale,
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
  p.resid = resid;

  // pre_dense -> GN -> SiLU: starts the residual stream
  p.a = x; p.lda = c; p.k_valid = c; p.K = io_pad;
  p.w = static_cast<const __nv_bfloat16*>(w_pre); p.N = h;
  p.vec = vecs; p.gn_scale = gn_scale; p.gn_bias = gn_bias; p.act = hb;
  cudaError_t err = launch<true, GN_SILU_FIRST>(p, s);
  if (err != cudaSuccess) return static_cast<int>(err);

  p.lda = h; p.k_valid = h; p.K = h;
  for (int blk = 0; blk < 2; ++blk) {
    const int l1 = 1 + 2 * blk, l2 = 2 + 2 * blk;
    p.a = hb; p.w = wb[2 * blk];
    p.vec = vecs + l1 * h; p.gn_scale = gn_scale + l1 * h; p.gn_bias = gn_bias + l1 * h;
    p.act = h1b;
    err = launch<false, GN_SILU>(p, s);
    if (err != cudaSuccess) return static_cast<int>(err);

    p.a = h1b; p.w = wb[2 * blk + 1];
    p.vec = vecs + l2 * h; p.gn_scale = gn_scale + l2 * h; p.gn_bias = gn_bias + l2 * h;
    p.act = hb;
    err = launch<false, GN_SILU_RESID>(p, s);
    if (err != cudaSuccess) return static_cast<int>(err);
  }

  // post_dense + bias
  p.a = hb; p.w = static_cast<const __nv_bfloat16*>(w_post); p.N = io_pad;
  p.vec = bias_post; p.gn_scale = nullptr; p.gn_bias = nullptr;
  p.out = out; p.ldo = c; p.act = nullptr;
  err = launch<false, BIAS_OUT>(p, s);
  return static_cast<int>(err);
}

}  // extern "C"
