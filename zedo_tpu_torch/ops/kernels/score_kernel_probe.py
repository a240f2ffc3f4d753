"""Kernel #1's decomposition probes: eight epilogue variants as CUDA kernels,
each beside its plain version.

Port of the `--probe` variants of tools/bench_kernel.py: the TPU kernel
(zedo_tpu/ops/pallas/score_kernel.py:fused_score_forward) with its
GroupNorm + SiLU body `_gn_silu` swapped for another function, run through
`fused_score_forward.__wrapped__` at `ScoreMLPConfig()`. Timed against the
shipped epilogue they say where the kernel's time goes: the products
(`dense_only`), the GroupNorm statistics (`no_gn`), the SiLU (`no_silu`),
the SiLU's form (`tanh_silu`, `bf16_silu`) and GroupNorm without a product
(`gn_vpu`) or with its statistics through one (`gn_bcast_vpu`).

On the card each variant is kernel #1's wgmma path (csrc/score_mlp.cuh:
`wgmma_layer` and its `epilogue`) instantiated with the variant's epilogue
on the accumulators, in a library of its own, `score_mlp_probe`
(csrc/score_mlp_probe.cu), so that the shipped `score_mlp` holds only the
`full` epilogue. Every variant keeps the residual adds and every store of
the shipped kernel, as JAX's `_kernel` keeps them. Only JAX's probe shape
is built: hidden 1024 in 32 GroupNorm groups (JAX's `gn_vpu` and
`gn_bcast_vpu` fix 32 groups) with the statistics in bf16, the default of
`pack_weights`; other packed weights raise on the card.

The variants, in JAX's order (each computes the JAX body named; the plain
versions below are transcriptions of them):
  * full: `_gn_silu`, the shipped epilogue (`tanh.approx.f32` SiLU);
  * no_silu: GroupNorm only, v * rstd * scale + bias;
  * no_gn: silu(v + bias), no statistics;
  * dense_only: v;
  * tanh_silu: JAX's shipped `_gn_silu` took this form, so it is the same
    function as `full`; the card computes its SiLU with the precise `tanhf`
    in place of `tanh.approx.f32`, so the pair prices the approximation;
  * bf16_silu: xn rounded to bf16 and the sigmoid in bf16 (packed bf16x2
    exp, add, reciprocal and product on the card);
  * gn_vpu: the statistics by group sums (the shipped shuffles are this),
    in f32, and x 1.01 in place of the channel scale;
  * gn_bcast_vpu: the statistics through a tensor-core product of the
    squared activations (bf16) with `packed.ind` (mma.sync m16n8k16, the
    accumulators repacked as its A fragments), rstd broadcast in registers,
    x 1.01 in place of the scale.

`fused_score_forward_probe` launches the variant's kernel for CUDA tensors
and takes its plain version only for CPU tensors. Its launches are counted
by variant in `launch_counts`, apart from kernel #1's counters.
"""
from __future__ import annotations

import ctypes

import torch

from zedo_tpu_torch.ops.kernels import build
from zedo_tpu_torch.ops.kernels import score_kernel as sk

# JAX's order (tools/bench_kernel.py, the loop over the probes); the index is
# the variant's number in the C library
PROBE_VARIANTS = ("full", "no_silu", "no_gn", "dense_only", "tanh_silu", "bf16_silu",
                  "gn_vpu", "gn_bcast_vpu")
PROBE_GROUPS = 32  # GroupNorm groups of JAX's probe bodies
PROBE_HIDDEN = 1024  # the width JAX probes (ScoreMLPConfig())
CHANNEL_SCALE = 1.01  # what gn_vpu and gn_bcast_vpu multiply by in place of the scale

# launches of each variant's kernel, one a forward (six layer launches and
# the input's conversion in the C library)
launch_counts = {name: 0 for name in PROBE_VARIANTS}


def reset_launch_counts() -> None:
    for name in launch_counts:
        launch_counts[name] = 0


def _rstd(c, ind):
    """1 / sqrt of each row's group variances, [T, LANE]: the statistics
    product of `_gn_silu` on operands rounded to the packed GN dtype."""
    return torch.rsqrt((c * c).to(ind.dtype).float() @ ind.float() + sk.GN_EPS)


def _by_channel(c, ind, bcast_scaled):
    """rstd x scale per channel, through the broadcast product of `_gn_silu`."""
    return _rstd(c, ind).to(bcast_scaled.dtype).float() @ bcast_scaled.float()


def _silu_tanh(xn):
    return xn * (0.5 * torch.tanh(0.5 * xn) + 0.5)


def no_silu(c, ind, bcast_scaled, bias):
    return c * _by_channel(c, ind, bcast_scaled) + bias


def no_gn(c, ind, bcast_scaled, bias):
    xn = c + bias
    return xn * torch.sigmoid(xn)


def dense_only(c, ind, bcast_scaled, bias):
    return c


def bf16_silu(c, ind, bcast_scaled, bias):
    xn = (c * _by_channel(c, ind, bcast_scaled) + bias).to(torch.bfloat16)
    sig = 1.0 / (1.0 + torch.exp(-xn))
    return (xn * sig).float()


def gn_vpu(c, ind, bcast_scaled, bias):
    t, h = c.shape
    size = h // PROBE_GROUPS
    var_g = (c * c).view(t, PROBE_GROUPS, size).sum(-1) * (1.0 / size)
    rs = torch.rsqrt(var_g + sk.GN_EPS).repeat_interleave(size, dim=1)
    return _silu_tanh(c * rs * CHANNEL_SCALE + bias)


def gn_bcast_vpu(c, ind, bcast_scaled, bias):
    size = c.shape[1] // PROBE_GROUPS
    rs = _rstd(c, ind)[:, :PROBE_GROUPS].repeat_interleave(size, dim=1)
    return _silu_tanh(c * rs * CHANNEL_SCALE + bias)


# each variant's GroupNorm + SiLU body, with `_gn_silu`'s arguments
EPILOGUES = {"full": sk._gn_silu, "no_silu": no_silu, "no_gn": no_gn, "dense_only": dense_only,
             "tanh_silu": sk._gn_silu, "bf16_silu": bf16_silu, "gn_vpu": gn_vpu,
             "gn_bcast_vpu": gn_bcast_vpu}


def _variant_index(variant: str) -> int:
    if variant not in PROBE_VARIANTS:
        raise ValueError(f"unknown probe variant {variant!r}: one of {PROBE_VARIANTS}")
    return PROBE_VARIANTS.index(variant)


def _check_groups(packed: sk.PackedScoreWeights) -> None:
    groups = packed.w_pre.shape[1] // packed.group_size
    if groups != PROBE_GROUPS:
        raise ValueError(f"the probe variants fix {PROBE_GROUPS} GroupNorm groups (as JAX's "
                         f"probe bodies do); these weights have {groups}")


def fused_score_forward_probe_reference(x: torch.Tensor, packed: sk.PackedScoreWeights,
                                        vecs: torch.Tensor, variant: str) -> torch.Tensor:
    """Plain PyTorch version of a probe variant: the plain fused forward
    (`score_kernel.fused_score_forward_reference`) with the variant's body in
    place of `_gn_silu`. x [B, C] f32 -> [B, C] f32."""
    _variant_index(variant)
    _check_groups(packed)
    return sk.fused_score_forward_reference(x, packed, vecs, EPILOGUES[variant])


_lib = None


def load_library() -> ctypes.CDLL:
    """The probes' library, built at first use. Raises when CUDA or nvcc is
    missing; there is no fallback."""
    global _lib
    if _lib is None:
        lib = build.load("score_mlp_probe")
        ptr, i32 = ctypes.c_void_p, ctypes.c_int
        lib.zedo_score_mlp_probe_forward.argtypes = [i32, ptr] + [i32] * 6 + [ptr] * 17
        lib.zedo_score_mlp_probe_variants.argtypes = []
        lib.zedo_score_mlp_probe_takes.argtypes = [i32] * 3
        lib.zedo_score_mlp_probe_blocks_per_sm.argtypes = [i32]
        for f in (lib.zedo_score_mlp_probe_forward, lib.zedo_score_mlp_probe_variants,
                  lib.zedo_score_mlp_probe_takes, lib.zedo_score_mlp_probe_blocks_per_sm):
            f.restype = i32
        if lib.zedo_score_mlp_probe_variants() != len(PROBE_VARIANTS):
            raise RuntimeError(f"libzedo_score_mlp_probe has "
                               f"{lib.zedo_score_mlp_probe_variants()} variants, the wrapper "
                               f"{len(PROBE_VARIANTS)}")
        _lib = lib
    return _lib


def fused_score_forward_probe(x: torch.Tensor, packed: sk.PackedScoreWeights,
                              vecs: torch.Tensor, variant: str) -> torch.Tensor:
    """One forward of kernel #1 with the variant's epilogue: x [B, C] f32
    (C <= io_pad) -> [B, C] f32.

    CPU tensors take the plain version; CUDA tensors launch the variant's
    kernel or raise."""
    index = _variant_index(variant)
    if x.device.type == "cpu":
        return fused_score_forward_probe_reference(x, packed, vecs, variant)
    if x.device.type != "cuda":
        raise ValueError(f"fused_score_forward_probe: unsupported device {x.device}")
    lib = load_library()
    sk.check_operands(x, packed, vecs)
    _check_groups(packed)
    bf16 = sk.gn_bf16(packed)
    io_pad, h = packed.w_pre.shape
    if not lib.zedo_score_mlp_probe_takes(h, packed.group_size, int(bf16)):
        raise ValueError(f"the probe kernels are built for hidden {PROBE_HIDDEN} in "
                         f"{PROBE_GROUPS} groups with bf16 GroupNorm statistics (JAX's probe "
                         f"shape); got hidden {h}, groups of {packed.group_size}, "
                         f"{'bf16' if bf16 else 'f32'} statistics")
    if packed.ind.shape != (h, sk.LANE) or not packed.ind.is_contiguous() \
            or packed.ind.device != x.device:
        raise ValueError(f"ind: want contiguous ({h}, {sk.LANE}) on {x.device}, got "
                         f"{tuple(packed.ind.shape)} on {packed.ind.device}")
    b, c = x.shape
    out = torch.empty((b, c), dtype=torch.float32, device=x.device)
    if b == 0:
        return out
    resid = torch.empty((b, h), dtype=torch.float32, device=x.device)
    act_h = torch.empty((b, h), dtype=torch.bfloat16, device=x.device)
    act_h1 = torch.empty((b, h), dtype=torch.bfloat16, device=x.device)
    x_pad = torch.empty((b, sk.padded_input_columns(c)), dtype=torch.bfloat16, device=x.device)
    err = lib.zedo_score_mlp_probe_forward(
        index, x.data_ptr(), b, c, io_pad, h, packed.group_size, int(bf16),
        packed.w_pre.data_ptr(), *(w.data_ptr() for w in packed.w_b),
        packed.w_post.data_ptr(), vecs.data_ptr(), packed.gn_scale.data_ptr(),
        packed.gn_bias.data_ptr(), packed.bias_post.data_ptr(), packed.ind.data_ptr(),
        out.data_ptr(), resid.data_ptr(), act_h.data_ptr(), act_h1.data_ptr(),
        x_pad.data_ptr(), torch.cuda.current_stream(x.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"probe kernel {variant!r} launch failed: CUDA error {err}")
    launch_counts[variant] += 1
    return out
