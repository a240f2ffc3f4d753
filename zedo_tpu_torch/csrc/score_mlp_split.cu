// Split ScoreMLP forward for Hopper (sm_90a): the whole forward in one
// launch, each row tile run as two independent half-tile chains.
//
// Replaces tools/bench_kernel.py:108 `fwd_split` (body `_kernel_split`), an
// experiment on the TPU kernel zedo_tpu/ops/pallas/score_kernel.py:214: the
// same function (pre-dense, GroupNorm, SiLU, two residual blocks of
// (dense, GroupNorm, SiLU) x 2 plus the skip, post-dense) on the same packed
// weights, with each row tile cut into two halves whose chains are
// independent, so that one half's GroupNorm/SiLU can overlap the other
// half's products. The plain version is
// ops/kernels/score_kernel_split.py:fused_score_forward_split_reference.
//
// What bounds it: the same work as the six-launch kernel (score_mlp.cu),
// 2*B*(51*H + 4*H*H + H*51) operations on ~9.4 MB of bf16 weights: 0.385 ms
// of tensor-core time at 44,300 x 1024 on an H100, bound by operations.
//
// What the design does about it (design (B), the Hopper reading of the TPU
// split):
//   * one launch per forward; the activations of all six layers stay in
//     shared memory as bf16 (each half holds a layer-input and a
//     layer-output buffer of 16 x H), so only x, the output, the weight
//     tiles and the f32 residual stream cross device memory. The residual
//     stream lives in a global scratch of the block's own rows (written by
//     the first layer, read and written by each block's second layer): at
//     H = 1024 two halves' buffers already take 132 KB of the 227 KB;
//   * a block owns 32 rows; warps 0-3 run the first half's chain and warps
//     4-7 the second half's, each with its own named barrier (bar.sync id,
//     128), so the two chains never wait for each other and the scheduler
//     interleaves one half's epilogue with the other half's products;
//   * each half streams its weight tiles ([32 x 128] bf16) from L2 through
//     a three-stage cp.async ring that runs ahead across chunk and layer
//     boundaries (weights do not depend on activations);
//   * products on the tensor cores through nvcuda::wmma (bf16 fragments, f32
//     accumulation); GroupNorm, SiLU and the residual add in the epilogue of
//     each 128-column chunk on the f32 accumulators, staged in shared
//     memory, one thread per (row, group).
// Its cost: every block re-reads all the weights from L2 for its 32 rows
// (~26 GB of L2 traffic per forward at 44,300 rows), and a block fills an
// SM alone (8 warps). Sharing weight tiles between the halves, a cluster
// with TMA multicast, or a larger row tile are later work.
//
// GroupNorm statistics in the two modes of the TPU kernel's `gn_dtype`, as
// in score_mlp.cu: f32, or bf16 (squares rounded to bf16 and summed in f32
// times bf16(1/group); rsqrt rounded to bf16 times bf16(scale)).
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

using namespace nvcuda;

namespace {

constexpr int HALF_ROWS = 16;              // rows of one half chain
constexpr int TILE_ROWS = 2 * HALF_ROWS;   // rows of a block
constexpr int HALF_THREADS = 128;          // 4 warps per half
constexpr int THREADS = 2 * HALF_THREADS;
constexpr int CN = 128;                    // output columns of a chunk
constexpr int BK = 32;                     // depth of a weight tile
constexpr int STAGES = 3;                  // weight tiles in flight per half
constexpr int W_LD = CN + 8;               // bf16 row stride of a weight tile
constexpr int W_STAGE = BK * W_LD;
constexpr int C_LD = CN + 4;               // f32 row stride of the staged chunk
constexpr int MAX_GPC = 64;                // groups per chunk (groups >= 2 channels)
constexpr int N_LAYERS = 6;
constexpr float GN_EPS = 1e-5f;
constexpr int SMEM_LIMIT = 232448;         // dynamic shared memory of an H100 block

__host__ __device__ constexpr int align128(int bytes) { return (bytes + 127) / 128 * 128; }

// shared memory of one half: two activation buffers, the weight ring, the
// staged chunk and the per-(row, group) rstd
__host__ __device__ constexpr int act_ld(int h) { return h + 8; }
__host__ __device__ constexpr int act_bytes(int h) {
  return align128(HALF_ROWS * act_ld(h) * 2);
}
__host__ __device__ constexpr int half_smem(int h) {
  return 2 * act_bytes(h) + align128(STAGES * W_STAGE * 2) +
         align128(HALF_ROWS * C_LD * 4) + align128(HALF_ROWS * MAX_GPC * 4);
}

struct SplitArgs {
  const float* x;               // [M, c] f32
  float* out;                   // [M, c] f32
  float* resid;                 // [M, H] f32 scratch
  const __nv_bfloat16* w[N_LAYERS];  // pre [io, H], 4x [H, H], post [H, io]
  const float* vecs;            // [5, H]
  const float* gn_scale;        // [5, H]
  const float* gn_bias;         // [5, H]
  const float* bias_post;       // [io]
  int M, c, io_pad, H, group, gn_bf16;
};

__device__ __forceinline__ float round_bf16(float x) {
  return __bfloat162float(__float2bfloat16(x));
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

// barrier of the 128 threads of one half (ids 1 and 2; 0 is __syncthreads)
__device__ __forceinline__ void half_sync(int id) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "n"(HALF_THREADS) : "memory");
}

__device__ __forceinline__ int layer_k(const SplitArgs& p, int l) {
  return l == 0 ? p.io_pad : p.H;
}
__device__ __forceinline__ int layer_n(const SplitArgs& p, int l) {
  return l == N_LAYERS - 1 ? p.io_pad : p.H;
}

// Position in the stream of weight tiles: layer, chunk, depth step.
struct Cursor {
  int l, n0, k0;
  __device__ void advance(const SplitArgs& p) {
    k0 += BK;
    if (k0 < layer_k(p, l)) return;
    k0 = 0;
    n0 += CN;
    if (n0 < layer_n(p, l)) return;
    n0 = 0;
    ++l;
  }
};

// copy weight tile (l, n0, k0) into a ring slot; every thread commits a
// group, empty past the last tile, so the wait counts stay uniform
__device__ __forceinline__ void issue(const SplitArgs& p, const Cursor& t,
                                      __nv_bfloat16* slot, int htid) {
  if (t.l < N_LAYERS) {
    const int n = layer_n(p, t.l);
    const __nv_bfloat16* w = p.w[t.l] + (size_t)t.k0 * n + t.n0;
    for (int i = htid; i < BK * CN / 8; i += HALF_THREADS) {
      const int r = i / (CN / 8), col = (i % (CN / 8)) * 8;
      cp_async16(slot + r * W_LD + col, w + (size_t)r * n + col);
    }
  }
  cp_async_commit();
}

__device__ void half_chain(const SplitArgs& p, unsigned char* smem, int row0, int half,
                           int htid) {
  const int bar = 1 + half;
  const int warp = htid >> 5;  // 0..3: the chunk's columns warp*32 .. +31
  const int lda = act_ld(p.H);
  __nv_bfloat16* act[2] = {reinterpret_cast<__nv_bfloat16*>(smem),
                           reinterpret_cast<__nv_bfloat16*>(smem + act_bytes(p.H))};
  __nv_bfloat16* ring = reinterpret_cast<__nv_bfloat16*>(smem + 2 * act_bytes(p.H));
  float* sc = reinterpret_cast<float*>(smem + 2 * act_bytes(p.H) +
                                       align128(STAGES * W_STAGE * 2));
  float* sr = sc + align128(HALF_ROWS * C_LD * 4) / 4;
  const bool bf16 = p.gn_bf16 != 0;
  const int gpc = CN / p.group;

  // the poses, cast to bf16, zero past column c and past row M
  for (int i = htid; i < HALF_ROWS * p.io_pad; i += HALF_THREADS) {
    const int r = i / p.io_pad, col = i % p.io_pad;
    const int gr = row0 + r;
    const float v = (gr < p.M && col < p.c) ? p.x[(size_t)gr * p.c + col] : 0.f;
    act[0][r * lda + col] = __float2bfloat16(v);
  }

  Cursor prod{0, 0, 0};
  for (int s = 0; s < STAGES - 1; ++s) {
    issue(p, prod, ring + s * W_STAGE, htid);
    prod.advance(p);
  }
  int slot_read = 0, slot_write = STAGES - 1;

  for (int l = 0; l < N_LAYERS; ++l) {
    const __nv_bfloat16* in = act[l & 1];
    __nv_bfloat16* out_act = act[(l + 1) & 1];
    const int K = layer_k(p, l), N = layer_n(p, l);
    for (int n0 = 0; n0 < N; n0 += CN) {
      wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[2];
      wmma::fill_fragment(acc[0], 0.f);
      wmma::fill_fragment(acc[1], 0.f);
      for (int k0 = 0; k0 < K; k0 += BK) {
        // this tile has landed, and every thread is done with the slot the
        // next copy overwrites (it was read one step ago)
        cp_async_wait<STAGES - 2>();
        half_sync(bar);
        issue(p, prod, ring + slot_write * W_STAGE, htid);
        prod.advance(p);
        slot_write = slot_write + 1 == STAGES ? 0 : slot_write + 1;
        const __nv_bfloat16* tile = ring + slot_read * W_STAGE;
#pragma unroll
        for (int kk = 0; kk < BK; kk += 16) {
          wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, wmma::row_major> fa;
          wmma::load_matrix_sync(fa, in + k0 + kk, lda);
#pragma unroll
          for (int j = 0; j < 2; ++j) {
            wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, wmma::row_major> fb;
            wmma::load_matrix_sync(fb, tile + kk * W_LD + warp * 32 + j * 16, W_LD);
            wmma::mma_sync(acc[j], fa, fb, acc[j]);
          }
        }
        slot_read = slot_read + 1 == STAGES ? 0 : slot_read + 1;
      }

      wmma::store_matrix_sync(sc + warp * 32, acc[0], C_LD, wmma::mem_row_major);
      wmma::store_matrix_sync(sc + warp * 32 + 16, acc[1], C_LD, wmma::mem_row_major);
      half_sync(bar);

      if (l == N_LAYERS - 1) {
        // post-dense + bias: the output's first c columns
        for (int i = htid; i < HALF_ROWS * CN; i += HALF_THREADS) {
          const int r = i / CN, col = n0 + i % CN;
          const int gr = row0 + r;
          if (gr < p.M && col < p.c)
            p.out[(size_t)gr * p.c + col] = sc[r * C_LD + i % CN] + p.bias_post[col];
        }
        continue;
      }

      // GroupNorm layers 0..4: one thread per (row, group) reduces the
      // group's squares, then every thread finishes its elements
      const float* vec = p.vecs + l * p.H + n0;
      const float* scale = p.gn_scale + l * p.H + n0;
      const float* bias = p.gn_bias + l * p.H + n0;
      for (int q = htid; q < HALF_ROWS * gpc; q += HALF_THREADS) {
        const int r = q % HALF_ROWS, c0 = (q / HALF_ROWS) * p.group;
        float ss = 0.f;
        for (int k = 0; k < p.group; ++k) {
          const float v = sc[r * C_LD + c0 + k] + vec[c0 + k];
          ss += bf16 ? round_bf16(v * v) : v * v;
        }
        const float var = bf16 ? ss * round_bf16(1.f / p.group) : ss / p.group;
        const float rstd = rsqrtf(var + GN_EPS);
        sr[r * MAX_GPC + q / HALF_ROWS] = bf16 ? round_bf16(rstd) : rstd;
      }
      half_sync(bar);
      for (int i = htid; i < HALF_ROWS * CN; i += HALF_THREADS) {
        const int r = i / CN, cc = i % CN;
        const int gr = row0 + r, gc = n0 + cc;
        const float v = sc[r * C_LD + cc] + vec[cc];
        const float sk = bf16 ? round_bf16(scale[cc]) : scale[cc];
        const float xn = v * (sr[r * MAX_GPC + cc / p.group] * sk) + bias[cc];
        float y = xn * (0.5f * tanhf(0.5f * xn) + 0.5f);
        // layer 0 starts the residual stream, layers 2 and 4 add to it
        const size_t o = (size_t)gr * p.H + gc;
        if (l == 2 || l == 4) y += gr < p.M ? p.resid[o] : 0.f;
        if (l % 2 == 0 && gr < p.M) p.resid[o] = y;
        out_act[r * lda + gc] = __float2bfloat16(y);
      }
      // the staged chunk is free again, and the layer's output is complete
      // before the next layer reads it
      half_sync(bar);
    }
  }
  cp_async_wait<0>();
}

__global__ void __launch_bounds__(THREADS, 1) score_mlp_split(const SplitArgs p) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int half = threadIdx.x / HALF_THREADS;
  const int row0 = blockIdx.x * TILE_ROWS + half * HALF_ROWS;
  if (row0 >= p.M) return;  // the ragged last tile: this half has no rows
  half_chain(p, smem + half * half_smem(p.H), row0, half, threadIdx.x % HALF_THREADS);
}

}  // namespace

extern "C" {

// Rows of a block's tile, and the dynamic shared memory a hidden width needs
// (more than zedo_score_mlp_split_smem_limit() cannot launch).
int zedo_score_mlp_split_tile_rows() { return TILE_ROWS; }
int zedo_score_mlp_split_smem_bytes(int h) { return 2 * half_smem(h); }
int zedo_score_mlp_split_smem_limit() { return SMEM_LIMIT; }

// One fused forward in one launch: x [m, c] f32 -> out [m, c] f32, c <=
// io_pad = 128. Weights bf16 input-major: w_pre [io_pad, h], w_b* [h, h],
// w_post [h, io_pad]; vecs, gn_scale, gn_bias [5, h] f32; bias_post [io_pad]
// f32; resid [m, h] f32 scratch. group divides 128; gn_bf16: GroupNorm
// statistics mode (1 bf16, 0 f32). Returns the launch's CUDA error, or 0.
int zedo_score_mlp_split_forward(const float* x, int m, int c, int io_pad, int h, int group,
                                 int gn_bf16, const void* w_pre, const void* w_b1,
                                 const void* w_b2, const void* w_b3, const void* w_b4,
                                 const void* w_post, const float* vecs,
                                 const float* gn_scale, const float* gn_bias,
                                 const float* bias_post, float* out, float* resid,
                                 void* stream) {
  if (m <= 0) return 0;
  const int smem = 2 * half_smem(h);
  if (io_pad != CN || h % CN != 0 || group < 2 || CN % group != 0 || smem > SMEM_LIMIT)
    return static_cast<int>(cudaErrorInvalidValue);
  SplitArgs p{};
  p.x = x; p.out = out; p.resid = resid;
  const void* w[N_LAYERS] = {w_pre, w_b1, w_b2, w_b3, w_b4, w_post};
  for (int i = 0; i < N_LAYERS; ++i) p.w[i] = static_cast<const __nv_bfloat16*>(w[i]);
  p.vecs = vecs; p.gn_scale = gn_scale; p.gn_bias = gn_bias; p.bias_post = bias_post;
  p.M = m; p.c = c; p.io_pad = io_pad; p.H = h; p.group = group; p.gn_bf16 = gn_bf16;
  cudaError_t err = cudaFuncSetAttribute(
      score_mlp_split, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  score_mlp_split<<<(m + TILE_ROWS - 1) / TILE_ROWS, THREADS, smem,
                    static_cast<cudaStream_t>(stream)>>>(p);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
