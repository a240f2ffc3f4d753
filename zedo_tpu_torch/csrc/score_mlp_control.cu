// Kernel #3: the fused forward of ZeDO-i's ControlNet adapter
// (Control_ScoreModelFC_Adv, zedo_tpu_torch/models/control_mlp.py) for
// Hopper (sm_90a), built on kernel #1's layer (score_mlp.cuh) under its own
// names, `control_layer` and `control_input_bf16`.
//
// The adapter runs two residual streams in lockstep, the trunk h and its
// control copy c, with linear bridges (zc_*) from the copy into the trunk.
// Its row path, as checked in, is 3*C*H + (1 + 4n)*H*H multiply-adds a row
// (C = 36 columns, H = 1024, n = 2 blocks: 2.24 times the plain prior's).
// What the checked-in dataflow lets a kernel fold away
// (zedo_tpu_torch/ops/kernels/control_kernel.py packs the weights and the
// per-step vectors):
//   * Each block's second control activation is overwritten by a projection
//     of the time embedding (`c = dense2_t_copy(temb)`), so what it feeds
//     (zc_b*_2, and the copy's residual add) is one vector a step, folded
//     into the step vectors. The copy that enters every block is therefore
//     the pre-layer's activation plus a vector of t alone.
//   * The bridges read raw pre-activations through a linear layer, so their
//     products fold into the weights: zc_layer_2 o pre_dense_copy into the
//     trunk's pre_dense, and zc_b*_1 o b*_dense1_copy into the block's first
//     layer as a second operand along K.
// What is left is five launches and a conversion of x:
//   layer 0   x [M, 64] @ [W_pre' | W_pre_copy]        N = 2H: GN + SiLU of
//             both streams; h to resid and act[:, :H], c to act[:, H:]
//   block b   act [M, 2H] = [h | c] @ [W_b_dense1; W_zc_b_1 W_b_dense1_copy]
//             (K = 2H) -> GN + SiLU -> act_h1; act_h1 @ W_b_dense2 -> GN +
//             SiLU + resid -> resid, act[:, :H] (c stays in act[:, H:])
//   post      act[:, :H] @ W_post + bias -> out
// 3*C*H + 3n*H*H multiply-adds a row, two thirds of the published count at
// the published widths; the roofline counts the published dataflow.
//
// `control_layer` is `wgmma_layer`'s block (the TMA ring, wgmma products, the
// GroupNorm epilogue in registers) with the epilogue's row strides read from
// the arguments (the layer writes the trunk into the first H columns of the
// [M, 2H] activation) and the residual kept for the first H columns only.
// Kernel #1's instantiations do not read those arguments.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "score_mlp.cuh"

namespace {

// x [m, c] f32 -> xp [m, k0] bf16, the columns past c zero: kernel #1's
// `pad_input` under kernel #3's name.
__global__ void control_input_bf16(const float* __restrict__ x, int m, int c, __nv_bfloat16* xp,
                                   int k0) {
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

struct ControlForward {
  const float* x;
  int m, c, io_pad, h, group, gn_bf16;
  const __nv_bfloat16* w_pre;   // [io_pad, 2h]
  const __nv_bfloat16* w_d1[2]; // [2h, h] a block
  const __nv_bfloat16* w_d2[2]; // [h, h] a block
  const __nv_bfloat16* w_post;  // [h, io_pad]
  const float *vecs, *gn_scale, *gn_bias, *bias_post;  // [6, h] x3, [io_pad]
  float *out, *resid;
  __nv_bfloat16 *act_hc, *act_h1, *x_pad;
};

cudaError_t control_forward(const ControlForward& f, cudaStream_t s) {
  using namespace wg;
  const int h = f.h;
  LayerArgs p{};
  p.M = f.m;
  p.group = f.group;
  p.gn_bf16 = f.gn_bf16;
  p.resid = f.resid;
  p.store_resid = 1;
  // the trunk in the first h columns of act_hc, the copy in the last h
  const Strides wide{h, 2 * h, h}, narrow{h, h, h};

  const int k0 = padded_input(f.c);
  const int chunks = f.m * (k0 / 8);
  control_input_bf16<<<(chunks + 255) / 256, 256, 0, s>>>(f.x, f.m, f.c, f.x_pad, k0);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  // layer 0: both streams, their step vectors and GroupNorms rows 0 and 1
  p.a = f.x_pad; p.lda = k0; p.K = k0;
  p.w = f.w_pre; p.N = 2 * h;
  p.vec = f.vecs; p.gn_scale = f.gn_scale; p.gn_bias = f.gn_bias;
  p.act = f.act_hc; p.mode = GN_SILU_FIRST;
  err = layer<GN_SILU_FIRST, FULL, false, true>(p, f.io_pad, s, wide);
  if (err != cudaSuccess) return err;

  for (int blk = 0; blk < 2; ++blk) {
    const int l1 = 2 + 2 * blk, l2 = 3 + 2 * blk;
    p.a = f.act_hc; p.lda = 2 * h; p.K = 2 * h;
    p.w = f.w_d1[blk]; p.N = h;
    p.vec = f.vecs + l1 * h; p.gn_scale = f.gn_scale + l1 * h; p.gn_bias = f.gn_bias + l1 * h;
    p.act = f.act_h1; p.mode = GN_SILU;
    err = layer<GN_SILU, FULL, false, true>(p, 2 * h, s, narrow);
    if (err != cudaSuccess) return err;

    p.a = f.act_h1; p.lda = h; p.K = h;
    p.w = f.w_d2[blk];
    p.vec = f.vecs + l2 * h; p.gn_scale = f.gn_scale + l2 * h; p.gn_bias = f.gn_bias + l2 * h;
    p.act = f.act_hc; p.mode = GN_SILU_RESID;
    p.store_resid = blk == 0;  // after the second block only the post layer follows
    err = layer<GN_SILU_RESID, FULL, false, true>(p, h, s, wide);
    if (err != cudaSuccess) return err;
  }

  // post_dense + bias on the trunk, the first h columns of act_hc
  p.a = f.act_hc; p.lda = 2 * h; p.K = h;
  p.w = f.w_post; p.N = f.io_pad;
  p.vec = f.bias_post; p.gn_scale = nullptr; p.gn_bias = nullptr;
  p.out = f.out; p.ldo = f.c; p.act = nullptr; p.mode = BIAS_OUT;
  return layer<BIAS_OUT, FULL, false, true>(p, h, s);
}

}  // namespace

extern "C" {

// 1 when kernel #3 takes this width: kernel #1's wgmma rule.
int zedo_control_takes(int h, int group, int tile) { return wg::takes(h, group, tile); }

// Columns of the bf16 copy of x that the first layer reads.
int zedo_control_padded_input(int c) { return wg::padded_input(c); }

// Blocks of a block's first layer (K = 2h) at the published width that one
// SM holds at a time; 0 on error.
int zedo_control_blocks_per_sm() { return wg::blocks_per_sm<GN_SILU, 1, 32, FULL, true>(); }

// One fused control forward: x [m, c] f32 -> out [m, c] f32, c <= io_pad.
// Weights bf16, input-major: w_pre [io_pad, 2h], w_d1_* [2h, h], w_d2_* [h, h],
// w_post [h, io_pad]. vecs, gn_scale and gn_bias [6, h] f32 (trunk pre,
// copy pre, then each block's two layers), bias_post [io_pad] f32. Scratch:
// resid [m, h] f32, act_hc [m, 2h] bf16, act_h1 [m, h] bf16, x_pad
// [m, zedo_control_padded_input(c)] bf16. tile: the column tile of the hidden
// layers; gn_bf16: GroupNorm statistics mode (1 bf16, 0 f32). Nothing here
// allocates or synchronises. Returns the first CUDA error, or 0.
int zedo_control_forward(const float* x, int m, int c, int io_pad, int h, int group, int tile,
                         int gn_bf16, const void* w_pre, const void* w_d1_1, const void* w_d2_1,
                         const void* w_d1_2, const void* w_d2_2, const void* w_post,
                         const float* vecs, const float* gn_scale, const float* gn_bias,
                         const float* bias_post, float* out, float* resid, void* act_hc,
                         void* act_h1, void* x_pad, void* stream) {
  if (!wg::takes(h, group, tile)) return static_cast<int>(cudaErrorInvalidValue);
  if (m <= 0) return 0;
  using bf = const __nv_bfloat16*;
  const ControlForward f{x, m, c, io_pad, h, group, gn_bf16, static_cast<bf>(w_pre),
                         {static_cast<bf>(w_d1_1), static_cast<bf>(w_d1_2)},
                         {static_cast<bf>(w_d2_1), static_cast<bf>(w_d2_2)},
                         static_cast<bf>(w_post), vecs, gn_scale, gn_bias, bias_post, out, resid,
                         static_cast<__nv_bfloat16*>(act_hc), static_cast<__nv_bfloat16*>(act_h1),
                         static_cast<__nv_bfloat16*>(x_pad)};
  return static_cast<int>(control_forward(f, static_cast<cudaStream_t>(stream)));
}

}  // extern "C"
