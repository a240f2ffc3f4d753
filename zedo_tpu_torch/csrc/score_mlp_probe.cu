// Kernel #1's decomposition probes for Hopper (sm_90a): the wgmma forward of
// score_mlp.cu with one of eight epilogues, a library of its own so that the
// shipped one keeps the FULL epilogue alone.
//
// Replaces the `--probe` variants of tools/bench_kernel.py: the TPU kernel
// zedo_tpu/ops/pallas/score_kernel.py:fused_score_forward with `_gn_silu`
// swapped for each of the probe bodies, run through
// `fused_score_forward.__wrapped__` (its pl.pallas_call) at ScoreMLPConfig():
// hidden 1024, GroupNorm groups of 32 channels, statistics in bf16. Every
// variant is `wg::wgmma_layer` (score_mlp.cuh) with the epilogue named by
// `Epilogue` there; the products, the TMA ring, the residual adds and every
// store are the shipped kernel's, so a variant's time against FULL's is what
// its epilogue costs or saves. What bounds them is what bounds kernel #1
// (score_mlp.cuh): the products at the tensor-core rate and, in the residual
// layers, the f32 residual traffic; DENSE_ONLY keeps that traffic, so it
// cannot go below the per-layer traffic floor.
//
// GN_BCAST_VPU asks the TPU design's question on this card: its statistics
// go through a tensor-core product of the squared activations with `ind`
// (mma.sync m16n8k16 with the accumulators as A fragments), in place of the
// shipped sums and quad shuffles.
//
// On an H100 80GB HBM3 at 700 W (chip_smoke.py phase 3b, 44,300 x 1024, each
// variant in turns beside FULL's ~1.05 ms): DENSE_ONLY, NO_GN, NO_SILU and
// GN_VPU are within 0.025 ms of FULL, TANH_SILU and BF16_SILU 0.05-0.08 ms
// slower, GN_BCAST_VPU 0.02-0.06 ms slower. The epilogue hides under the
// products and their operand stream; the product for the statistics does not
// pay here.
#include "score_mlp.cuh"

extern "C" {

// Number of epilogue variants (score_kernel_probe.PROBE_VARIANTS, same order).
int zedo_score_mlp_probe_variants() { return EPILOGUES; }

// 1 when the probe kernels take this width: column tiles of 128 holding whole
// groups of 32 channels, bf16 statistics.
int zedo_score_mlp_probe_takes(int h, int group, int gn_bf16) {
  return h % wg::BN == 0 && group == PROBE_GROUP && gn_bf16 == 1;
}

// Blocks of a variant's residual layer that one SM holds at a time; 0 on
// error or for an unknown variant.
int zedo_score_mlp_probe_blocks_per_sm(int variant) {
  switch (variant) {
    case FULL: return wg::blocks_per_sm<GN_SILU_RESID, 1, PROBE_GROUP, FULL>();
    case NO_SILU: return wg::blocks_per_sm<GN_SILU_RESID, 1, PROBE_GROUP, NO_SILU>();
    case NO_GN: return wg::blocks_per_sm<GN_SILU_RESID, 1, PROBE_GROUP, NO_GN>();
    case DENSE_ONLY: return wg::blocks_per_sm<GN_SILU_RESID, 1, PROBE_GROUP, DENSE_ONLY>();
    case TANH_SILU: return wg::blocks_per_sm<GN_SILU_RESID, 1, PROBE_GROUP, TANH_SILU>();
    case BF16_SILU: return wg::blocks_per_sm<GN_SILU_RESID, 1, PROBE_GROUP, BF16_SILU>();
    case GN_VPU: return wg::blocks_per_sm<GN_SILU_RESID, 1, PROBE_GROUP, GN_VPU>();
    case GN_BCAST_VPU: return wg::blocks_per_sm<GN_SILU_RESID, 1, PROBE_GROUP, GN_BCAST_VPU>();
    default: return 0;
  }
}

// One fused forward with the epilogue `variant`: the operands of
// zedo_score_mlp_forward (score_mlp.cu) without its column tile, and `ind`
// [h, 128] bf16, the packed group indicator (read by GN_BCAST_VPU). x_pad is
// [m, wg::padded_input(c)] bf16 scratch. Nothing here allocates
// or synchronises. Returns the first CUDA error of the launches, or 0.
int zedo_score_mlp_probe_forward(int variant, const float* x, int m, int c, int io_pad, int h,
                                 int group, int gn_bf16, const void* w_pre, const void* w_b1,
                                 const void* w_b2, const void* w_b3, const void* w_b4,
                                 const void* w_post, const float* vecs, const float* gn_scale,
                                 const float* gn_bias, const float* bias_post, const void* ind,
                                 float* out, float* resid, void* act_h, void* act_h1,
                                 void* x_pad, void* stream) {
  if (!zedo_score_mlp_probe_takes(h, group, gn_bf16))
    return static_cast<int>(cudaErrorInvalidValue);
  if (m <= 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const wg::Forward f{x, m, c, io_pad, h, group, gn_bf16,
                      static_cast<const __nv_bfloat16*>(w_pre),
                      {static_cast<const __nv_bfloat16*>(w_b1),
                       static_cast<const __nv_bfloat16*>(w_b2),
                       static_cast<const __nv_bfloat16*>(w_b3),
                       static_cast<const __nv_bfloat16*>(w_b4)},
                      static_cast<const __nv_bfloat16*>(w_post), vecs, gn_scale, gn_bias,
                      bias_post, static_cast<const __nv_bfloat16*>(ind), out, resid,
                      static_cast<__nv_bfloat16*>(act_h), static_cast<__nv_bfloat16*>(act_h1),
                      static_cast<__nv_bfloat16*>(x_pad)};
  cudaError_t err;
  switch (variant) {
    case FULL: err = wg::forward<FULL, true>(f, s); break;
    case NO_SILU: err = wg::forward<NO_SILU, true>(f, s); break;
    case NO_GN: err = wg::forward<NO_GN, true>(f, s); break;
    case DENSE_ONLY: err = wg::forward<DENSE_ONLY, true>(f, s); break;
    case TANH_SILU: err = wg::forward<TANH_SILU, true>(f, s); break;
    case BF16_SILU: err = wg::forward<BF16_SILU, true>(f, s); break;
    case GN_VPU: err = wg::forward<GN_VPU, true>(f, s); break;
    case GN_BCAST_VPU: err = wg::forward<GN_BCAST_VPU, true>(f, s); break;
    default: err = cudaErrorInvalidValue;
  }
  return static_cast<int>(err);
}

}  // extern "C"
