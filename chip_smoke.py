#!/usr/bin/env python3
"""Drive the zedo_tpu_torch port on one NVIDIA GPU and check it.

    python3 chip_smoke.py

Phases (any failure exits non-zero; nothing is caught and passed over):
  1. device: the card's name and power limit (nvidia-smi);
  2. build: both kernel libraries from zedo_tpu_torch/csrc, one nvcc each,
     started together; registers and spills of their kernels, kernel #1's
     resident blocks per SM, the HGMMA (wgmma) and UTMALDG (TMA load) opcodes
     in the SASS of both, and the instructions of each kernel (kernel #2's
     tile loop has to fit the instruction cache);
  3. kernel #1 (fused_score_forward): its wgmma product alone against
     torch.matmul; then against its plain version at the published width
     (hidden 1024, embed 512, bf16 weights) in both GroupNorm statistics
     modes, on 44,300 rows (the H36M 886 x 50 solve), a ragged row count, 1
     and 129 rows; at 36 input columns (SyRIP's 12 joints) on 10,000, 129
     and 1 rows, timed at 10,000 rows, and timed at 40,000 rows of 51
     columns (MINI-RGBD 2,000 x 20); at hidden 256 and 2048 (wgmma path,
     groups of 8 and 64 channels) and at 384 and 768 (wmma path, groups of
     12 and 24) in both modes; timed, with plain-version and bf16 torch.matmul-chain times, the
     wrapper's host time per forward (at 44,300 and at 129 rows), the
     roofline bound and the device-traffic floor of one launch per layer;
  4. kernel #2 (fused_score_forward_split): its address function against a
     TMA load under the 128-byte swizzle, its transposed product alone
     against torch.matmul, its rows and ring stages against the Python
     mirror; then against its plain version and against kernel #1 at hidden
     256, 512, 768 and 1024 in both modes on 44,300, 1,001, 47 and 1 rows;
     at hidden 128 (GroupNorm groups of 4 channels) on 44,300 rows against
     kernel #1 and, at the tolerance such groups need, against the plain
     version, beside the plain version's own distance from its sums in f64;
     timed at 44,300 x 1024 (chained and unchained, kernel #1 in the same
     turns), with its counted weight stream and the wrapper's host time;
  5. the main path: ZeDOEstimator.predict at the published width with random
     seeded weights and the full 500 IPO / 1000 OIL schedule on 886 poses x
     50 hypotheses, a few requests, with the kernel's launches checked
     against the OIL steps, its GroupNorm mode against the default (bf16,
     JAX's default) and its path against wgmma; IPO alone; a profiled
     request, from which the kernel's CUDA launches per forward are counted;
  6. the batch CLI, each run with the launch counts set to 0 before it and
     checked after it: run.opt_main --config h36m --hypo 50 --gt
     --strict_batch --dtype auto on a synthetic H36M workspace of 886 poses
     (published width, seeded weights, full schedule), with kernel #1 on
     every OIL forward, solve and evaluation seconds apart and a profiled
     run counting the kernel's CUDA launches; the trained fixture through the
     CLI in fp32 and bf16 against the JAX CLI's P1/P2; run.inference --eval
     on a wild custom_data.npz;
  7. the infant path, each run with the launch counts set to 0 before it
     and checked after it: run.opt_main_infant --dtype auto on synthetic
     workspaces at the published width with seeded weights and the full
     schedule: --config mini (2,000 validation frames of sequences 11 and
     12) and --config syrip (the 500 test images) at --hypo 20, kernel #1
     on every OIL forward (40,000 rows at 51 columns, 10,000 at 36);
     --control and --cond on the MINI-RGBD frames at --hypo 1 (the generic
     OIL path, no kernel), each finite with its reprojection trace; the
     trained fixture's poses as MINI-RGBD frames in fp32 and bf16 against
     the JAX CLI's MPJPE;
  8. accuracy on the committed trained fixture (hidden 256): fp32, bf16
     (kernel #1, GroupNorm bf16) and bf16 with gn_fp32, best-hypothesis
     MPJPE against the JAX package's value for the same scenes, schedule
     and mode;
  9. the kernel tooling path, each entry point with the launch counts set to
     0 before it and checked after it: tools.bench_kernel --split (the path
     of kernel #2), tools.validate_dtype, bench (the headline at 886 x 50)
     and bench --trained against the JAX package's values.

Prints a `kernels` JSON line and the card's name and power limit before the
last line, and as the last line
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}.
Imports torch, numpy and zedo_tpu_torch only.
"""
from __future__ import annotations

import dataclasses
import json
import math
import os
import pickle
import subprocess
import sys
import tempfile
import time

import numpy as np

REPO = os.path.dirname(os.path.abspath(__file__))

# Best-hypothesis MPJPE (mm, root-centred) of the JAX package on the CPU for
# the trained fixture: 24 held-out scenes (bench_trained.make_scenes seed
# 11), clusters h36m_cluster2.npy, 200 IPO / 300 OIL steps re-discretized
# (sde.n = 300). fp32: pipeline.solve at Precision.HIGHEST; bf16: bf16
# weights through the Pallas kernel in interpret mode with the default
# GroupNorm statistics (gn_fp32=False, bf16); bf16_gn_fp32: the same with
# gn_fp32=True. Recomputed and held against these values by
# tests/test_torch_pipeline.py::test_chip_smoke_reference_mpjpe.
JAX_FIXTURE_MPJPE_MM = {"fp32": 26.472286224365234, "bf16": 27.058399200439453,
                        "bf16_gn_fp32": 27.057533264160156}
FIXTURE_TOL_MM = 1.0
FIXTURE_SCENES, FIXTURE_IPO, FIXTURE_OIL = 24, 200, 300

# (P1, P2) in mm of the JAX package's batch CLI on the CPU for the trained
# fixture's 24 scenes (tests/fixtures/trained/data/h36m/h36m_test.pkl) with
# h36m_cluster2.npy at the full 500 IPO / 1000 OIL schedule: zedo_tpu.run.
# opt_main's build_dataset, run_pipeline and eval_multi on the h36m config
# with model.hidden_dim 256, embed_dim 128, ZeDO.sample 1, ZeDO.batch 24,
# --gt --strict_batch, --dtype fp32 and bf16 (on the CPU XLA's unfused bf16
# model). Recomputed and held against these values by
# `python -m pytest tests/test_torch_cli.py::test_chip_smoke_cli_reference`.
CLI_FIXTURE_HYPO = 2
JAX_CLI_FIXTURE_MM = {"fp32": (35.91820411384106, 8.938108881314596),
                      "bf16": (36.44946527977785, 8.888261237492165)}

# Mean MPJPE (mm) of the JAX package's infant CLI on the CPU for the trained
# fixture's 24 H36M test poses as MINI-RGBD frames
# (write_infant_fixture_workspace) at the full 500 IPO / 1000 OIL schedule:
# zedo_tpu.run.opt_main_infant.main on the mini config with model.hidden_dim
# 256, embed_dim 128, --hypo 1, --dtype fp32 and bf16 (on the CPU XLA's
# unfused bf16 model). Recomputed and held against these values by
# tests/test_torch_infant.py::test_chip_smoke_infant_reference.
INFANT_FIXTURE_HYPO = 1
JAX_INFANT_FIXTURE_MPJPE_MM = {"fp32": 101.74825042486191, "bf16": 101.87052935361862}
# the infant phase: MINI-RGBD's validation sequences 11 and 12 at 2,000
# frames and SyRIP's validate-500 split, 20 hypotheses each (40,000 and
# 10,000 rows; SyRIP's 12 joints give kernel #1 36 input columns)
MINI_FRAMES, SYRIP_IMAGES, INFANT_HYPO = 2000, 500, 20

# zedo_tpu/bench_trained.run_trained_bounds(n=16, s=50) on the CPU (full
# 500 IPO / 1000 OIL schedule; bf16 there is XLA's unfused bf16 model), the
# reference of `bench --trained --n 16 --s 50`. Recomputed and held against
# these values by tests/test_torch_tools.py::test_chip_smoke_trained_reference.
TRAINED_N, TRAINED_S = 16, 50
JAX_TRAINED_BOUNDS = {
    "fp32_mpjpe_mm": 22.325977325439453, "bf16_mpjpe_mm": 22.67214584350586,
    "bf16_delta_mm": 1.1695886850357056, "reuse2_mpjpe_mm": 22.653911590576172,
    "reuse2_delta_mm": 0.11225809156894684, "reuse4_mpjpe_mm": 22.65997314453125,
    "reuse4_delta_mm": 0.2376055270433426, "short_reuse2_mpjpe_mm": 22.902606964111328,
    "init_mm": 805.4117431640625}
TRAINED_TOL_MM = 1.0

# H100 SXM peaks (NVIDIA data sheet, dense): bf16 tensor cores and HBM3
PEAK_BF16_FLOPS = 989e12
PEAK_BYTES = 3.35e12

HEADLINE_N, HEADLINE_S = 886, 50
N_REQUESTS = 3
WILD_N = 64  # poses of the wild inference run
KERNEL_TOL = 2e-2  # max |kernel - plain|: same bf16 operands, f32 sums in another order
# max |wgmma product - torch.matmul| / max |product|: exact bf16 x bf16
# products, f32 sums in another order
PRODUCT_RTOL = 1e-5
WIDTH_ROWS = 4096  # rows of the width checks of kernel #1
WGMMA_WIDTHS, WMMA_WIDTHS = (256, 2048), (384, 768)
# (hidden, GroupNorm groups) of kernel #2's checks: 4, 8, 12 and 16 channel
# tiles a layer, groups of 8, 16, 32 (twice) and 64 channels (each group size
# is an instantiation of the kernel; groups of 4, hidden 128: check_groups_of_4)
SPLIT_WIDTHS = ((256, 32), (512, 32), (768, 24), (1024, 32), (1024, 16))
# max |kernel - plain| at GroupNorm groups of 4 channels on 44,300 rows: twice
# what the plain version differs by from its own function with the sums in
# f64 there (5.1e-2 on an H100, GroupNorm statistics in bf16; the kernels are
# as far from it and 6e-3 from each other): see check_groups_of_4
GROUPS_OF_4_TOL = 1e-1
BENCH_KERNEL_ITERS = 20
# Instructions of one kernel #2 instantiation. Its per-tile loop runs 80 times
# a block: with the loop unrolled eight times (0.8 MB of code a kernel) the
# forward ran at the pace of instruction fetch, 2.0 ms against 1.45 ms at some
# 2,400 instructions.
MAX_SPLIT_INSTRUCTIONS = 4000


def fail(msg: str) -> None:
    print(f"FAIL: {msg}", flush=True)
    sys.exit(1)


def log(msg: str) -> None:
    print(msg, flush=True)


def cuda_ms(torch, fn, reps, warmup=2):
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def to_bf16(torch, tree):
    return {k: to_bf16(torch, v) if isinstance(v, dict) else v.to(torch.bfloat16)
            for k, v in tree.items()}


def packed_weights(torch, sk, tsm, dev, hidden=1024, embed=512, groups=32, n_joints=17):
    """{gn mode: (packed, vecs)} of random seeded bf16 weights."""
    cfg = tsm.ScoreMLPConfig(n_joints=n_joints, hidden_dim=hidden, embed_dim=embed,
                             group_norm_groups=groups)
    params = to_bf16(torch, tsm.init_params(torch.Generator().manual_seed(0), cfg, device=dev))
    temb = tsm.time_embedding(params, cfg, torch.full((1,), 47.3, device=dev))[0]
    out = {}
    for gn, gn_dtype in (("bf16", None), ("f32", torch.float32)):
        packed = sk.pack_weights(params, cfg, dtype=torch.bfloat16, gn_dtype=gn_dtype)
        out[gn] = (packed, sk.step_vectors(packed, temb).contiguous())
    return out


def check(torch, name, got, want, rows, tol=KERNEL_TOL):
    torch.cuda.synchronize()
    if not torch.isfinite(got).all():
        fail(f"{name}: output not finite at {rows} rows")
    err = (got - want).abs().max().item()
    log(f"{name}, {rows} rows: max |diff| {err:.3e} (tolerance {tol}, "
        f"|reference| max {want.abs().max().item():.3f})")
    if not err <= tol:
        fail(f"{name} disagrees at {rows} rows: {err}")
    return err


def bound(x, packed, vecs, rows):
    """(bound ms, bound_by) of one forward on these inputs: the operations
    of the 51-wide function at the bf16 peak against the bytes of x, the
    weights and the output at the HBM rate."""
    io = x.shape[1]
    h = packed.w_pre.shape[1]
    flops = 2 * rows * (io * h + 4 * h * h + h * io)
    n_bytes = (x.numel() * 4 + rows * io * 4
               + sum(t.numel() * t.element_size() for t in
                     (packed.w_pre, *packed.w_b, packed.w_post, vecs, packed.gn_scale,
                      packed.gn_bias, packed.bias_post)))
    t_ops, t_bytes = flops / PEAK_BF16_FLOPS * 1e3, n_bytes / PEAK_BYTES * 1e3
    return max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes else "bytes"), flops


def layer_traffic_ms(sk, x, packed, vecs, rows):
    """Least time of the bytes a one-launch-per-layer design moves at the HBM
    rate: the bound's bytes, the bf16 copy of x written and read, and between
    layers the bf16 activation and the f32 residual. Per row and hidden
    channel: layer 0 writes 4 + 2 bytes, each plain GroupNorm layer reads 2
    and writes 2, the first residual layer reads 2 + 4 and writes 4 + 2, the
    second reads 2 + 4 and writes 2 (no layer reads its residual), the post
    layer reads 2."""
    io = x.shape[1]
    h = packed.w_pre.shape[1]
    between = rows * h * (6 + 2 * 4 + 12 + 8 + 2)
    ends = (rows * io * 8 + 2 * rows * sk.padded_input_columns(io) * 2
            + sum(t.numel() * t.element_size() for t in
                  (packed.w_pre, *packed.w_b, packed.w_post, vecs, packed.gn_scale,
                   packed.gn_bias, packed.bias_post)))
    return (between + ends) / PEAK_BYTES * 1e3


def host_us(torch, fn, reps=40):
    """Host time of one call of fn (which only enqueues), in microseconds:
    the stream is drained before, and the calls are few enough that the
    launch queue never fills and the host never waits for the device."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    t = time.perf_counter() - t0
    torch.cuda.synchronize()
    return t / reps * 1e6


def sass_counts(build, path):
    """Occurrences of the opcodes that matter in a library's SASS, examples
    of them, and the instructions of each kernel."""
    dump = build.sass(path)
    lines = dump.splitlines()
    counts = {op: sum(op in line for line in lines) for op in ("HGMMA", "UTMALDG", "HMMA")}
    examples = [next((" ".join(line.split())[:150] for line in lines if op in line), None)
                for op in ("HGMMA", "UTMALDG")]
    return counts, [e for e in examples if e], build.count_sass_instructions(dump)


def phase_build(torch, build, sk, split):
    """Build both libraries; their resources, occupancy and SASS."""
    libs = build.build()
    for name, lib in libs.items():
        log(f"build {name}: {lib.build_seconds:.1f} s -> {lib.path}")
        res = build.resources(lib.ptxas)
        if not res:
            log("ptxas: (library was already built)")
        for label in ("wgmma_layer", "dense_layer", "score_mlp_split"):
            regs = [v for k, v in res.items() if label in k]
            if regs:
                log(f"  {name} {label}: {len(regs)} kernels, registers "
                    f"{min(r for r, _ in regs)}-{max(r for r, _ in regs)}, spill bytes "
                    f"{sum(sp for _, sp in regs)}")
    blocks = sk.load_library().zedo_score_mlp_wgmma_blocks_per_sm()
    log(f"wgmma_layer: {blocks} resident blocks per SM")
    if blocks < 1:
        fail("the wgmma kernel does not fit an SM")
    lib2 = split.load_library()
    log(f"score_mlp_split at hidden 1024: {lib2.zedo_score_mlp_split_tile_rows(1024)} rows a "
        f"block, {lib2.zedo_score_mlp_split_stages(1024)} ring stages, "
        f"{lib2.zedo_score_mlp_split_smem_bytes(1024)} bytes of shared memory")
    for name in ("score_mlp", "score_mlp_split"):
        counts, examples, instructions = sass_counts(build, libs[name].path)
        log(f"SASS of libzedo_{name}.so: {counts['HGMMA']} HGMMA (wgmma), {counts['UTMALDG']} "
            f"UTMALDG (TMA load), {counts['HMMA']} HMMA (mma.sync of the wmma kernel, HGMMA "
            f"included)")
        for e in examples:
            log(f"  e.g. {e}")
        for label in ("wgmma_layer", "dense_layer", "score_mlp_split"):
            sizes = [n for k, n in instructions.items() if label in k]
            if sizes:
                log(f"  {label}: {len(sizes)} kernels of {min(sizes)}-{max(sizes)} instructions")
        largest = max((n for k, n in instructions.items() if "score_mlp_split" in k), default=0)
        if name == "score_mlp_split" and not 0 < largest <= MAX_SPLIT_INSTRUCTIONS:
            fail(f"a kernel of libzedo_{name}.so has {largest} instructions: its tile loop no "
                 f"longer fits the instruction cache (limit {MAX_SPLIT_INSTRUCTIONS})")
        for op in ("HGMMA", "UTMALDG"):
            if not counts[op]:
                fail(f"the SASS of libzedo_{name}.so holds no {op}")
    return blocks, max(lib.build_seconds for lib in libs.values())


def phase_kernel(torch, sk, tsm, library_forward, dev):
    """Kernel #1 against its plain version; returns its JSON entry (without
    launches) and the published-width inputs for kernel #2."""
    gen = torch.Generator().manual_seed(1)
    # the wgmma product alone: TMA boxes, swizzle and descriptors
    for m, k, n in ((64, 64, 128), (300, 1024, 256)):
        a = torch.randn(m, k, generator=gen).to(dev).to(torch.bfloat16)
        w = torch.randn(k, n, generator=gen).to(dev).to(torch.bfloat16)
        want = a.float() @ w.float()
        check(torch, f"wgmma product {m}x{k}x{n} vs torch.matmul", sk.wgmma_product(a, w), want,
              m, tol=PRODUCT_RTOL * want.abs().max().item())

    weights = packed_weights(torch, sk, tsm, dev)
    rows = HEADLINE_N * HEADLINE_S
    xs = {r: torch.randn(r, 51, generator=gen).to(dev) for r in (rows, 1001, 1, 129)}
    errs, errs_wmma, ms = [], [], {}
    for gn, (packed, vecs) in weights.items():
        for r, x in xs.items():
            want = sk.fused_score_forward_reference(x, packed, vecs)
            sk.reset_launch_counts()
            errs.append(check(torch, f"kernel #1 wgmma gn={gn} vs plain",
                              sk.fused_score_forward(x, packed, vecs), want, r))
            if sk.path_launches != {"wgmma": 1, "wmma": 0}:
                fail(f"hidden 1024: paths {sk.path_launches}, want one launch on wgmma")
    packed, vecs = weights["bf16"]
    x = xs[rows]
    small = xs[129]

    def forward():
        return sk.fused_score_forward(x, packed, vecs)

    def forward_small():
        return sk.fused_score_forward(small, packed, vecs)

    ms["bf16"] = cuda_ms(torch, forward, 20, 3)
    pf, vf = weights["f32"]
    ms["f32"] = cuda_ms(torch, lambda: sk.fused_score_forward(x, pf, vf), 20, 3)
    # the wrapper's host time, and at a small batch beside the device's time
    # from one forward to the next, chained
    host, small_host = host_us(torch, forward), host_us(torch, forward_small)
    small_ms = cuda_ms(torch, forward_small, 20, 3)
    plain_ms = cuda_ms(torch, lambda: sk.fused_score_forward_reference(x, packed, vecs), 3, 1)
    want = sk.fused_score_forward_reference(x, packed, vecs)
    check(torch, "library chain vs plain (yardstick)", library_forward(x, packed, vecs), want,
          rows, tol=math.inf)
    lib_ms = cuda_ms(torch, lambda: library_forward(x, packed, vecs), 10, 2)
    bound_ms, bound_by, flops = bound(x, packed, vecs, rows)
    traffic_ms = layer_traffic_ms(sk, x, packed, vecs, rows)
    for gn in ms:
        log(f"fused_score_forward (wgmma) gn={gn} {rows}x1024: kernel {ms[gn]:.4f} ms "
            f"({flops / ms[gn] / 1e9:.1f} TFLOP/s, {bound_ms / ms[gn]:.3f} of the {bound_by} "
            f"bound {bound_ms:.4f} ms, {traffic_ms / ms[gn]:.3f} of the per-layer traffic "
            f"floor {traffic_ms:.4f} ms)")
    log(f"plain version {plain_ms:.3f} ms, bf16 torch.matmul chain {lib_ms:.4f} ms; wrapper "
        f"host time per forward {host:.1f} us; at 129 rows {small_ms * 1e3:.1f} us from "
        f"forward to forward (device clock, chained calls), wrapper host time "
        f"{small_host:.1f} us")

    # the other widths JAX runs through Pallas, each on its path
    for hidden in sorted(WGMMA_WIDTHS + WMMA_WIDTHS):
        path = sk.kernel_path(hidden, hidden // 32)
        if path != ("wgmma" if hidden in WGMMA_WIDTHS else "wmma"):
            fail(f"hidden {hidden}: kernel_path says {path}")
        for gn, (p, v) in packed_weights(torch, sk, tsm, dev, hidden=hidden).items():
            xw = torch.randn(WIDTH_ROWS, 51, generator=gen).to(dev)
            sk.reset_launch_counts()
            err = check(torch, f"kernel #1 {path} hidden {hidden} (groups of {hidden // 32}) "
                        f"gn={gn} vs plain", sk.fused_score_forward(xw, p, v),
                        sk.fused_score_forward_reference(xw, p, v), WIDTH_ROWS)
            (errs if path == "wgmma" else errs_wmma).append(err)
            if sk.path_launches[path] != 1:
                fail(f"hidden {hidden}: paths {sk.path_launches}, want the {path} kernel")
    # SyRIP's 12 joints: x of 36 columns (padded to 64 for the first layer's
    # TMA loads, the post layer's first 36 of 128 columns written out)
    rows36 = SYRIP_IMAGES * INFANT_HYPO
    weights36, errs36 = packed_weights(torch, sk, tsm, dev, n_joints=12), []
    for gn, (p, v) in weights36.items():
        for r in (rows36, 129, 1):
            x36 = torch.randn(r, 36, generator=gen).to(dev)
            sk.reset_launch_counts()
            errs36.append(check(torch, f"kernel #1 wgmma 12 joints (36 columns) gn={gn} vs plain",
                                sk.fused_score_forward(x36, p, v),
                                sk.fused_score_forward_reference(x36, p, v), r))
            if sk.path_launches != {"wgmma": 1, "wmma": 0}:
                fail(f"36 columns: paths {sk.path_launches}, want one launch on wgmma")
    p36, v36 = weights36["bf16"]
    x36 = torch.randn(rows36, 36, generator=gen).to(dev)
    ms36 = cuda_ms(torch, lambda: sk.fused_score_forward(x36, p36, v36), 20, 3)
    plain36 = cuda_ms(torch, lambda: sk.fused_score_forward_reference(x36, p36, v36), 3, 1)
    lib36 = cuda_ms(torch, lambda: library_forward(x36, p36, v36), 10, 2)
    bound36, by36, _ = bound(x36, p36, v36, rows36)
    # MINI-RGBD's 2,000 frames x 20 hypotheses at 51 columns
    rows40 = MINI_FRAMES * INFANT_HYPO
    x40 = torch.randn(rows40, 51, generator=gen).to(dev)
    ms40 = cuda_ms(torch, lambda: sk.fused_score_forward(x40, packed, vecs), 20, 3)
    bound40, _, _ = bound(x40, packed, vecs, rows40)
    log(f"fused_score_forward at 36 columns, {rows36}x1024: kernel {ms36:.4f} ms (the "
        f"{by36} bound {bound36:.4f} ms), plain version {plain36:.3f} ms, bf16 torch.matmul "
        f"chain {lib36:.4f} ms; at 51 columns, {rows40} rows: {ms40:.4f} ms (bound "
        f"{bound40:.4f} ms)")
    entry = {
        "name": "fused_score_forward", "route": "cuda",
        "source": "zedo_tpu_torch/csrc/score_mlp.cu",
        "replaces": "zedo_tpu/ops/pallas/score_kernel.py:214",
        "launches": None, "max_abs_err": max(errs), "ms": ms["bf16"], "plain_ms": plain_ms,
        "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": lib_ms,
        "ms_gn_f32": ms["f32"], "rows": rows, "hidden": 1024, "path": "wgmma",
        "max_abs_err_wmma_widths": max(errs_wmma), "layer_traffic_floor_ms": traffic_ms,
        "host_us_per_forward": host, "ms_129_rows": small_ms,
        "host_us_per_forward_129_rows": small_host,
        "tflops": flops / ms["bf16"] / 1e9, "roofline_share": bound_ms / ms["bf16"],
        "c36": {"rows": rows36, "max_abs_err": max(errs36), "ms": ms36, "plain_ms": plain36,
                "library_ms": lib36, "bound_ms": bound36, "bound_by": by36},
        "rows_40000": {"rows": rows40, "ms": ms40, "bound_ms": bound40},
    }
    return entry, weights, x


def weight_stream_bytes(split, rows, hidden, io):
    """Bytes of weight tiles that one forward of kernel #2 asks of L2, by
    count (nothing reads a counter): every block takes in every 8 KB tile
    ([64 k, 64 channels]) of the layers (the first layer's 64 input rows and
    the post layer's 64 output columns that hold data)."""
    tiles = hidden // 64
    per_block = (2 * math.ceil(io / 64) * tiles + 4 * tiles * tiles) * split.TILE_BYTES
    blocks = split.grid_blocks(rows, split.tile_rows(hidden))
    return blocks * per_block, per_block, blocks


def plain_f64(torch, sk, x, packed, vecs):
    """The plain version's function with every sum in f64 (the products on
    the same bf16-rounded operands, the GroupNorm statistics rounded at the
    same points), and per row the smallest group variance that any of its
    GroupNorm layers saw."""
    groups = packed.w_pre.shape[1] // packed.group_size
    min_var = []

    def dense(a, w, vec):
        return a.to(w.dtype).double() @ w.double() + vec.double()[None]

    def gn(a, layer):
        ind, bcast = packed.ind, packed.bcast_scaled[layer]
        var = (a * a).to(ind.dtype).double() @ ind.double()
        min_var.append(var[:, :groups].min(1).values)
        rstd = torch.rsqrt(var + sk.GN_EPS).to(bcast.dtype).double() @ bcast.double()
        xn = a * rstd + packed.gn_bias[layer].double()[None]
        return xn * (0.5 * torch.tanh(0.5 * xn) + 0.5)

    c = x.shape[1]
    h = torch.nn.functional.pad(x.double(), (0, packed.w_pre.shape[0] - c))
    h = gn(dense(h, packed.w_pre, vecs[0]), 0)
    for blk in range(2):
        h1 = gn(dense(h, packed.w_b[2 * blk], vecs[1 + 2 * blk]), 1 + 2 * blk)
        h = h + gn(dense(h1, packed.w_b[2 * blk + 1], vecs[2 + 2 * blk]), 2 + 2 * blk)
    out = dense(h, packed.w_post, packed.bias_post)[:, :c]
    return out, torch.stack(min_var).min(0).values


def check_groups_of_4(torch, sk, split, tsm, weights, x):
    """Kernel #2 at hidden 128, GroupNorm groups of 4 channels, on the
    production row count. With 4 values a group some row in tens of
    thousands has a group whose variance is near GN_EPS, and 1 / sqrt(var +
    eps) then multiplies whatever the layer's input differs by: the order of
    an f32 sum flips a bf16 rounding of that input. So the plain version is
    as far from its own function with the sums in f64 as the kernels are from
    it, which this logs, beside the variance at the row of the largest
    difference and the same two distances at hidden 1024 (groups of 32). The
    kernel is held against kernel #1 at KERNEL_TOL and against the plain
    version at GROUPS_OF_4_TOL."""
    errs = []
    for hidden, by_gn in ((1024, weights),
                          (128, packed_weights(torch, sk, tsm, x.device, hidden=128))):
        for gn, (packed, vecs) in by_gn.items():
            plain = split.fused_score_forward_split_reference(x, packed, vecs)
            exact, min_var = plain_f64(torch, sk, x, packed, vecs)
            got = split.fused_score_forward_split(x, packed, vecs)
            one = sk.fused_score_forward(x, packed, vecs)
            torch.cuda.synchronize()
            row_err = (got - plain).abs().max(1).values
            worst = int(row_err.argmax())
            log(f"hidden {hidden} (groups of {packed.group_size}) gn={gn}, {x.shape[0]} rows: "
                f"max |plain - plain with f64 sums| {(plain - exact).abs().max().item():.3e}, "
                f"|kernel #2 - f64 sums| {(got - exact).abs().max().item():.3e}, "
                f"|kernel #2 - plain| {row_err[worst].item():.3e} at a row whose smallest "
                f"group variance is {min_var[worst].item():.3e} (median row "
                f"{min_var.median().item():.3e}, smallest of all rows {min_var.min().item():.3e})")
            if hidden == 128:
                name = f"kernel #2 hidden 128 (groups of 4) gn={gn}"
                errs.append(check(torch, f"{name} vs kernel #1", got, one, x.shape[0]))
                check(torch, f"{name} vs plain", got, plain, x.shape[0], tol=GROUPS_OF_4_TOL)
    return max(errs)


def phase_split(torch, sk, split, tsm, step_ms, library_forward, weights, x):
    """Kernel #2: its building blocks, then against its plain version and
    kernel #1; returns its JSON entry (without launches)."""
    dev = x.device
    gen = torch.Generator().manual_seed(2)
    lib = split.load_library()
    for hidden in range(64, 2049, 64):
        got = (lib.zedo_score_mlp_split_tile_rows(hidden), lib.zedo_score_mlp_split_stages(hidden))
        want = (split.tile_rows(hidden), split.ring_stages(hidden))
        if got[0] != want[0] or (got[0] and got != want):
            fail(f"row tile and ring stages at hidden {hidden}: library {got}, mirror {want}")
    log("kernel #2 (rows a block, ring stages), library = mirror: " + ", ".join(
        f"{h}: {(split.tile_rows(h), split.ring_stages(h) if split.tile_rows(h) else 0)}"
        for h in (256, 512, 768, 1024, 1152, 2048)))

    # the swizzle address function against a TMA load of the same matrix
    for r in (8, 64, 128):
        src = torch.randn(r, 64, generator=gen).to(dev).to(torch.bfloat16)
        by_tma, by_function = split.swizzle_images(src)
        torch.cuda.synchronize()
        if not torch.equal(by_tma, by_function) or torch.equal(by_tma, src.view(-1)):
            fail(f"swizzle128 and the TMA image differ at {r} rows (or nothing was swizzled)")
    log("kernel #2 swizzle128 = TMA image under the 128-byte swizzle at 8, 64 and 128 rows")
    # the transposed product alone: MN-major A from the ring, K-major B
    for m, k, n in ((64, 64, 128), (300, 1024, 256), (100, 512, 64), (57, 1024, 1024)):
        a = torch.randn(m, k, generator=gen).to(dev).to(torch.bfloat16)
        w = torch.randn(k, n, generator=gen).to(dev).to(torch.bfloat16)
        want = a.float() @ w.float()
        check(torch, f"kernel #2 product {m}x{k}x{n} vs torch.matmul",
              split.split_product(a, w), want, m, tol=PRODUCT_RTOL * want.abs().max().item())

    errs = []
    small = {r: torch.randn(r, 51, generator=gen).to(dev) for r in (1001, 47, 1)}
    for hidden, groups in SPLIT_WIDTHS:
        by_gn = weights if (hidden, groups) == (1024, 32) else packed_weights(
            torch, sk, tsm, dev, hidden=hidden, groups=groups)
        for gn, (packed, vecs) in by_gn.items():
            for xr in (x, *small.values()):
                r = xr.shape[0]
                want = split.fused_score_forward_split_reference(xr, packed, vecs)
                one = sk.fused_score_forward(xr, packed, vecs)
                name = f"kernel #2 hidden {hidden} (groups of {packed.group_size}) gn={gn}"
                got = split.fused_score_forward_split(xr, packed, vecs)
                errs.append(check(torch, f"{name} vs plain", got, want, r))
                errs.append(check(torch, f"{name} vs kernel #1", got, one, r))
    errs.append(check_groups_of_4(torch, sk, split, tsm, weights, x))

    # times at the published width: unchained launches on one input, kernel
    # #2 and kernel #1 in turns, then once more in reverse order
    rows = x.shape[0]
    ms, ms_two, ms_one = {}, [], []
    packed, vecs = weights["bf16"]
    for what in (2, 1, 1, 2):
        if what == 1:
            ms_one.append(cuda_ms(torch, lambda: sk.fused_score_forward(x, packed, vecs), 20, 3))
        else:
            ms_two.append(cuda_ms(
                torch, lambda: split.fused_score_forward_split(x, packed, vecs), 20, 3))
    log(f"in turns, ms: kernel #2 {ms_two[0]:.4f} / {ms_two[1]:.4f}, kernel #1 "
        f"{ms_one[0]:.4f} / {ms_one[1]:.4f}")
    ms["bf16"] = sum(ms_two) / 2
    pf, vf = weights["f32"]
    ms["f32"] = cuda_ms(torch, lambda: split.fused_score_forward_split(x, pf, vf), 20, 3)
    chained = {gn: step_ms(lambda h, p=p, v=v: split.fused_score_forward_split(h, p, v), x, 20)
               for gn, (p, v) in weights.items()}
    host = host_us(torch, lambda: split.fused_score_forward_split(x, packed, vecs))
    plain_ms = cuda_ms(torch, lambda: split.fused_score_forward_split_reference(x, packed, vecs),
                       3, 1)
    lib_ms = cuda_ms(torch, lambda: library_forward(x, packed, vecs), 10, 2)
    bound_ms, bound_by, flops = bound(x, packed, vecs, rows)
    for gn in ms:
        log(f"fused_score_forward_split gn={gn} {rows}x1024: kernel "
            f"{ms[gn]:.4f} ms unchained, {chained[gn]:.4f} ms chained "
            f"({flops / ms[gn] / 1e9:.1f} TFLOP/s, {bound_ms / ms[gn]:.3f} of the {bound_by} "
            f"bound {bound_ms:.4f} ms)")
    stream, per_block, blocks = weight_stream_bytes(split, rows, 1024, x.shape[1])
    log(f"  weight tiles asked of L2 a forward, by count: {blocks} blocks x {per_block} bytes = "
        f"{stream / 1e9:.3f} GB, {stream / ms['bf16'] / 1e9:.2f} TB/s at the measured time")
    log(f"split plain version {plain_ms:.3f} ms, bf16 torch.matmul chain {lib_ms:.4f} ms, "
        f"kernel #1 in the same turns {sum(ms_one) / 2:.4f} ms; wrapper host time per forward "
        f"{host:.1f} us")
    return {
        "name": "fused_score_forward_split", "route": "cuda",
        "source": "zedo_tpu_torch/csrc/score_mlp_split.cu",
        "replaces": "tools/bench_kernel.py:108",
        "launches": None, "max_abs_err": max(errs), "ms": ms["bf16"], "plain_ms": plain_ms,
        "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": lib_ms,
        "ms_gn_f32": ms["f32"], "ms_chained": chained["bf16"], "ms_chained_gn_f32": chained["f32"],
        "ms_kernel_1_same_turns": sum(ms_one) / 2, "host_us_per_forward": host,
        "rows": rows, "hidden": 1024, "tile_rows": split.tile_rows(1024),
        "tflops": flops / ms["bf16"] / 1e9, "roofline_share": bound_ms / ms["bf16"],
    }


def phase_main_path(torch, sk, tsm, presets, ZeDOEstimator, build_inputs, dev):
    """ZeDOEstimator.predict at the published width, full schedule."""
    preset = presets.h36m()
    cfg = preset.model_cfg
    params = to_bf16(torch, tsm.init_params(torch.Generator().manual_seed(0), cfg, device=dev))
    px, conf, k, clusters = build_inputs(HEADLINE_N, HEADLINE_S)
    est = ZeDOEstimator(params=params, model_cfg=cfg, sde=preset.sde, sampler=preset.sampler,
                        zcfg=preset.zcfg, clusters=clusters, device=dev, batch_bucket=2)
    per_request = math.ceil(est.zcfg.oil.iterations / est.zcfg.oil.score_reuse)
    log(f"main path: {HEADLINE_N} poses x {HEADLINE_S} hypotheses, hidden "
        f"{cfg.hidden_dim}, IPO {est.zcfg.ipo.iterations} / OIL {est.zcfg.oil.iterations}, "
        f"bf16 weights, default OILConfig (gn_fp32={est.zcfg.oil.gn_fp32})")
    sk.reset_launch_counts()
    walls = []
    for r in range(N_REQUESTS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = est.predict(px, k, confidence=conf)
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
        if out["poses"].shape != (HEADLINE_N, HEADLINE_S, 17, 3):
            fail(f"poses shape {out['poses'].shape}")
        if not np.isfinite(out["poses"]).all() or not np.isfinite(out["translations"]).all():
            fail("main path produced non-finite poses")
        if out["best"].min() < 0 or out["best"].max() >= HEADLINE_S:
            fail("best hypothesis index out of range")
        log(f"request {r}: {walls[-1]:.3f} s wall-clock, mean best reprojection "
            f"{out['reprojection_error'].min(1).mean():.2f} px")
    launches = sk.launch_counts["fused_score_forward"]
    by_mode = dict(sk.gn_mode_launches)
    if launches != N_REQUESTS * per_request:
        fail(f"kernel launched {launches} times in {N_REQUESTS} requests, "
             f"want {N_REQUESTS * per_request}")
    if by_mode["bf16"] != launches:
        fail(f"the default OILConfig launched the kernel in GroupNorm modes {by_mode}, "
             f"want all bf16 (JAX's default)")
    if sk.path_launches != {"wgmma": launches, "wmma": 0}:
        fail(f"the published width ran the kernel's paths {sk.path_launches}, want all wgmma")
    log(f"main path: {launches} kernel launches in {N_REQUESTS} requests "
        f"({per_request} per request), GroupNorm modes {by_mode}, paths {sk.path_launches}")

    # where a request's time goes: IPO alone on the same folded rows
    from zedo_tpu_torch.zeroshot.ipo import run_ipo

    s, n = clusters.shape[0], px.shape[0]
    cl = torch.from_numpy(clusters).to(dev)
    pose0 = (cl - cl[:, :1])[:, None].expand(s, n, 17, 3).reshape(s * n, 17, 3)
    kp = torch.from_numpy(px).to(dev).repeat(s, 1, 1)
    kk = torch.from_numpy(k).to(dev).repeat(s, 1, 1)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    run_ipo(pose0, kp, kk, est.zcfg.ipo, n_groups=s)
    torch.cuda.synchronize()
    ipo_s = time.perf_counter() - t0
    log(f"IPO alone ({est.zcfg.ipo.iterations} Adam steps on {s * n} rows): {ipo_s:.3f} s")

    # device busy time of one more request, by kernel (torch.profiler)
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        est.predict(px, k, confidence=conf)
        torch.cuda.synchronize()
    # device-side events only: the CPU ops that launched them carry the
    # same time again
    by_kernel = sorted(((e.self_device_time_total, e.count, e.key) for e in prof.key_averages()
                        if e.device_type == torch.autograd.DeviceType.CUDA), reverse=True)
    busy_s = sum(t for t, _, _ in by_kernel) / 1e6
    log(f"profiled request: device busy {busy_s:.3f} s = {busy_s / np.mean(walls):.3f} of "
        f"the unprofiled mean wall-clock; top kernels by device time:")
    for t, count, name in by_kernel[:8]:
        log(f"  {t / 1e3:10.1f} ms = {count} x {t / count:8.1f} us  {name[:90]}")
    # CUDA launches of the kernel's library in that request, per forward
    own = sum(count for _, count, name in by_kernel
              if any(k in name for k in ("wgmma_layer", "pad_input", "dense_layer")))
    if own == 0 or own % per_request:
        fail(f"profiled request: {own} launches of the kernel's library in {per_request} "
             f"forwards, want a whole number per forward")
    log(f"profiled request: {own} CUDA launches of kernel #1's library = {own // per_request} "
        f"per forward")
    return launches, walls, ipo_s, busy_s, own // per_request


def phase_accuracy(torch, sk, tbt, presets, ZeDOEstimator, dev):
    family = np.load(os.path.join(tbt.FIXTURE, "family.npz"))
    gt, k, px = tbt.make_scenes(family, FIXTURE_SCENES)
    preset = presets.h36m(hidden_dim=int(family["hidden"]), embed_dim=int(family["embed"]))
    for name, dtype, gn_fp32 in (("fp32", "fp32", False), ("bf16", "bf16", False),
                                 ("bf16_gn_fp32", "bf16", True)):
        est = ZeDOEstimator.from_torch_checkpoint(
            tbt.CHECKPOINT, tbt.CLUSTERS, preset=preset, dtype=dtype, batch_bucket=8,
            device=dev).with_schedule(FIXTURE_OIL, ipo_iterations=FIXTURE_IPO)
        est = dataclasses.replace(est, zcfg=dataclasses.replace(
            est.zcfg, oil=dataclasses.replace(est.zcfg.oil, gn_fp32=gn_fp32)))
        sk.reset_launch_counts()
        out = est.predict(px, k)
        used = dict(sk.gn_mode_launches)
        want = {"bf16": 0, "f32": 0}
        if dtype == "bf16":
            want["f32" if gn_fp32 else "bf16"] = FIXTURE_OIL
        if used != want:
            fail(f"trained fixture {name}: kernel launches by GroupNorm mode {used}, want {want}")
        mm = tbt.best_mpjpe(out["poses"], gt)
        ref = JAX_FIXTURE_MPJPE_MM[name]
        log(f"trained fixture {name}: best-hypothesis MPJPE {mm:.3f} mm "
            f"(JAX package on the CPU {ref:.3f} mm, tolerance {FIXTURE_TOL_MM} mm; "
            f"kernel launches by GroupNorm mode {used})")
        if not abs(mm - ref) <= FIXTURE_TOL_MM:
            fail(f"trained fixture {name}: MPJPE {mm} vs {ref}")


def save_pth(torch, params, path):
    """params as a reference checkpoint: the DataParallel-prefixed state
    dict in {epoch, model_state_dict, ema, step}."""

    def flat(tree, prefix=""):
        for key, v in tree.items():
            yield from flat(v, f"{prefix}{key}.") if isinstance(v, dict) else [(prefix + key, v)]

    torch.save({"epoch": 0, "model_state_dict": {"module." + key: v for key, v in flat(params)},
                "ema": None, "step": 0}, path)


def write_workspace(torch, tsm, root, n, s, n_wild):
    """A synthetic workspace in the layout of tests/test_cli_e2e.py::workdir:
    data/h36m/h36m_test.pkl (n poses over the H36M actions), data/wild/
    custom_data.npz (n_wild poses), clusters/h36m_cluster{s,1}.npy and
    checkpoint/checkpoint_full.pth (seeded weights at the published width,
    the reference's .pth layout). Returns the common CLI arguments."""
    rng = np.random.RandomState(0)
    fx, cx = 1145.0, 512.0

    def scenes(count):
        pose = rng.randn(count, 17, 3) * 250.0  # mm, root-relative
        pose -= pose[:, 0:1]
        cam = pose + np.array([200.0, 0.0, 4500.0])
        img = np.concatenate([cam[..., :2] / cam[..., 2:] * fx + cx, cam[..., 2:]], axis=-1)
        return cam, img

    cam, img = scenes(n)
    items = [{"joint_3d_camera": cam[i], "joint_3d_image": img[i],
              "camera_param": {"fx": np.array(fx), "fy": np.array(fx), "cx": np.array(cx),
                               "cy": np.array(cx)},
              "image_path": f"{i}.jpg", "action": 2 + i % 15} for i in range(n)]
    os.makedirs(os.path.join(root, "data", "h36m"))
    with open(os.path.join(root, "data", "h36m", "h36m_test.pkl"), "wb") as f:
        pickle.dump(items, f)
    cam, img = scenes(n_wild)
    k = np.zeros((n_wild, 3, 3), np.float32)
    k[:, 0, 0] = k[:, 1, 1] = fx
    k[:, 0, 2] = k[:, 1, 2] = cx
    k[:, 2, 2] = 1.0
    os.makedirs(os.path.join(root, "data", "wild"))
    np.savez(os.path.join(root, "data", "wild", "custom_data.npz"),
             keypoints_2d=np.concatenate([img[..., :2], np.ones((n_wild, 17, 1))], -1)
             .astype(np.float32),
             keypoints_3d=((cam - cam[:, :1]) / 1000.0).astype(np.float32), K=k)
    os.makedirs(os.path.join(root, "clusters"))
    clusters = (rng.randn(s, 17, 3) * 0.25).astype(np.float32)
    np.save(os.path.join(root, "clusters", f"h36m_cluster{s}.npy"), clusters)
    np.save(os.path.join(root, "clusters", "h36m_cluster1.npy"), clusters[:1])
    os.makedirs(os.path.join(root, "checkpoint"))
    params = tsm.init_params(torch.Generator().manual_seed(0), tsm.ScoreMLPConfig(),
                             device="cpu")
    save_pth(torch, params, os.path.join(root, "checkpoint", "checkpoint_full.pth"))
    return ["--ckpt_dir", os.path.join(root, "checkpoint"), "--ckpt_name",
            "checkpoint_full.pth", "--cluster_dir", os.path.join(root, "clusters"),
            "--data_dir", os.path.join(root, "data"), "--strict_batch"]


def infant_scenes(rng, count, n_joints, depth):
    """count poses [count, n_joints, 3] in camera coordinates (m): one random
    base pose (0.1 m a coordinate) with 1 cm of jitter a frame, its root at
    (0.05, 0.02, depth) with 2 cm of jitter."""
    pose = rng.randn(n_joints, 3) * 0.1 + rng.randn(count, n_joints, 3) * 0.01
    pose -= pose[:, :1]
    return (pose + np.array([0.05, 0.02, depth]) + rng.randn(count, 1, 3) * 0.02) \
        .astype(np.float32)


def pinhole(cam, k):
    """[..., 2] pixels of camera-frame points under intrinsics k [3, 3]."""
    return (cam[..., :2] / cam[..., 2:] * [k[0, 0], k[1, 1]] + [k[0, 2], k[1, 2]]) \
        .astype(np.float32)


def write_mini_workspace(root, rng, n_val, hypo=1, n_train=8, val_poses=None, cluster=None):
    """root/data/mini-rgbd/MINI-RGBD.npy in the layout of
    zedo_tpu/data/prep/mini_process.py: n_val validation frames over
    sequences 11 and 12 and n_train training frames of sequence 01, each an
    H36M-17 pose in the SMIL_TO_H36M slots of the SMIL-25 layout (the other
    slots at the pelvis) projected with MINI_K; and root/mini_cluster_{hypo}
    .npy with `cluster` [1, 17, 3] (default: the first frame's pose,
    root-relative) so placed, the only pose of the file the CLI reads."""
    from zedo_tpu_torch.data.mini_rgbd import SMIL_TO_H36M, mini_intrinsics

    def smil(p17):
        p25 = np.repeat(p17[:, :1], 25, axis=1)
        p25[:, SMIL_TO_H36M] = p17
        return p25

    k = mini_intrinsics()
    if val_poses is None:
        val_poses = infant_scenes(rng, n_val, 17, 1.0)
    if cluster is None:
        cluster = val_poses[:1] - val_poses[:1, :1]
    d = {"train": {}, "validate": {}}
    for split, seqs, poses in (("train", ("01",), infant_scenes(rng, n_train, 17, 1.0)),
                               ("validate", ("11", "12"), val_poses)):
        p25 = smil(poses)
        for i in range(len(p25)):
            seq = seqs[i * len(seqs) // len(p25)]
            d[split][f"{seq}_syn_{i:05d}.txt"] = {"pose_2d": pinhole(p25[i], k),
                                                  "pose_3d": p25[i]}
    os.makedirs(os.path.join(root, "data", "mini-rgbd"), exist_ok=True)
    np.save(os.path.join(root, "data", "mini-rgbd", "MINI-RGBD.npy"), d)
    np.save(os.path.join(root, f"mini_cluster_{hypo}.npy"), smil(cluster))


def write_syrip_workspace(root, rng, n_test, n_train=4, w=640, h=480):
    """root/data/syrip in the layout the SyRIP reader reads (the maps of
    zedo_tpu/data/prep/syrip_process.py): n_train training and n_test test
    images (the validate-500 split) of w x h, 12-joint poses at 3 m whose
    COCO keypoints and corrected 3D land, through the reader's CHANGE_2D and
    CHANGE_12 maps, on the pose and its projection with f = 2000."""
    from zedo_tpu_torch.data.syrip import CHANGE_2D, CHANGE_12, SYRIP_FOCAL

    n = n_train + n_test
    poses = infant_scenes(rng, n, 12, 3.0)
    px = pinhole(poses, np.array([[SYRIP_FOCAL, 0, w / 2], [0, SYRIP_FOCAL, h / 2], [0, 0, 1]]))
    order = np.array(CHANGE_12) % 12
    raw3d = np.zeros((n, 14, 3), np.float32)
    raw3d[:, order] = poses
    keypoints = np.zeros((n, 17, 3), np.float32)
    keypoints[:, np.array(CHANGE_2D)[order] % 17, :2] = px
    keypoints[..., 2] = 2
    names = [f"img{i:05d}.jpg" for i in range(n)]
    base = os.path.join(root, "data", "syrip")
    for sub in ("SyRIP_3d_pred", "SyRIP_3d_correction"):
        os.makedirs(os.path.join(base, sub), exist_ok=True)
    np.save(os.path.join(base, "SyRIP_3d_pred", "output_imgnames.npy"),
            np.array([f"syrip/images/{name}" for name in names]))
    np.save(os.path.join(base, "SyRIP_3d_correction", "correct_3D.npy"), raw3d)
    for split, ids in (("train", range(n_train)), ("test", range(n_train, n))):
        np.save(os.path.join(base, f"{split}_rysip.npy"), {names[i]: [names[i], i] for i in ids})
        np.save(os.path.join(base, f"{split}_pose2d.npy"),
                {names[i]: {"h": h, "w": w, "bbox": [0, 0, w, h], "keypoints": keypoints[i]}
                 for i in ids})


def write_infant_fixture_workspace(root, tbt):
    """The trained fixture's 24 H36M test poses as MINI-RGBD validation
    frames: root-relative (m), at (0, 0.1, 3.5); the first frame's pose as
    the cluster. The infant IPO (three rotation axes) is chaotic from a far
    cluster, where f32 rounding moves the MPJPE by millimetres; here it
    does not (tests/test_torch_infant.py::
    test_chip_smoke_infant_fixture_is_well_conditioned)."""
    with open(os.path.join(tbt.FIXTURE, "data", "h36m", "h36m_test.pkl"), "rb") as f:
        items = pickle.load(f)
    pose = np.array([item["joint_3d_camera"] for item in items], np.float64) / 1000.0
    cam = (pose - pose[:, :1] + np.array([0.0, 0.1, 3.5])).astype(np.float32)
    write_mini_workspace(root, np.random.RandomState(0), len(cam), hypo=INFANT_FIXTURE_HYPO,
                         val_poses=cam)


def cli_launches(sk, split, name, forwards, fn):
    """Run one CLI with every launch count set to 0 before it; fail unless
    kernel #1 ran `forwards` times, all on wgmma with GroupNorm bf16 (1000:
    every OIL forward of a bf16 solve on the fast path; 0: an fp32 solve or
    the generic path), and kernel #2 never. Returns the CLI's result."""
    out, counts = counted(sk, split, name, fn)
    out["kernel_1_launches"] = counts["fused_score_forward"]
    want = {"fused_score_forward": forwards, "fused_score_forward_split": 0}
    if counts != want or sk.path_launches != {"wgmma": forwards, "wmma": 0} \
            or sk.gn_mode_launches != {"bf16": forwards, "f32": 0}:
        fail(f"{name}: launches {counts}, paths {sk.path_launches}, GroupNorm modes "
             f"{sk.gn_mode_launches}; want {forwards} forwards of kernel #1 on wgmma, GN-bf16")
    return out


def phase_batch_cli(torch, sk, split, tsm, tbt, opt_main, inference, card):
    """The batch evaluation path: run.opt_main at 886 x 50 and the published
    width, the trained fixture through the CLI, run.inference --eval."""
    from torch.profiler import ProfilerActivity, profile

    with tempfile.TemporaryDirectory() as root:
        common = write_workspace(torch, tsm, root, HEADLINE_N, HEADLINE_S, WILD_N)
        argv = ["--config", "h36m", "--hypo", str(HEADLINE_S), "--gt", "--dtype", "auto",
                "--override", "ZeDO.sample=1", *common]
        save = os.path.join(root, "results.npy")
        name = (f"run.opt_main --config h36m --hypo {HEADLINE_S} --gt --strict_batch "
                f"--dtype auto ({HEADLINE_N} poses, hidden 1024)")
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = cli_launches(sk, split, name, 1000, lambda: opt_main.main(argv + ["--save", save]))
        wall = time.perf_counter() - t0
        poses = out["poses"]
        if tuple(poses.shape) != (HEADLINE_N, HEADLINE_S, 17, 3) or poses.device.type != "cuda":
            fail(f"batch CLI poses {tuple(poses.shape)} on {poses.device}")
        if not torch.isfinite(poses).all() or not np.isfinite(np.load(save)).all():
            fail("batch CLI produced non-finite poses")
        if not 0 < out["p2"] <= out["p1"]:
            fail(f"batch CLI: PA-MPJPE {out['p2']} not within (0, MPJPE {out['p1']}]")
        rate = HEADLINE_N * HEADLINE_S / out["solve_s"]
        log(f"batch CLI on {card}: solve {out['solve_s']:.3f} s (IPO {out['ipo_s']:.3f}, OIL "
            f"{out['oil_s']:.3f}; {rate:.1f} poses/s), evaluation {out['eval_s']:.3f} s "
            f"(both protocols), CLI wall-clock {wall:.3f} s; P1 {out['p1'] * 1000:.3f} mm, "
            f"P2 {out['p2'] * 1000:.3f} mm (random weights)")
        # the same run profiled: CUDA launches of kernel #1's library
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            opt_main.main(argv)
            torch.cuda.synchronize()
        own = sum(e.count for e in prof.key_averages()
                  if e.device_type == torch.autograd.DeviceType.CUDA
                  and any(k in e.key for k in ("wgmma_layer", "pad_input", "dense_layer")))
        if own != 7 * 1000:
            fail(f"profiled batch CLI: {own} CUDA launches of kernel #1's library, "
                 f"want 7 a forward x 1000 forwards")
        log(f"profiled batch CLI: {own} CUDA launches of kernel #1's library (7 a forward)")
        result = {"kernel_1_launches": out["kernel_1_launches"], "solve_s": out["solve_s"], "eval_s": out["eval_s"], "ipo_s": out["ipo_s"],
                  "oil_s": out["oil_s"], "wall_s": wall, "poses_per_s": rate,
                  "eval_share": out["eval_s"] / wall, "cuda_launches": own}

        # the trained fixture through the CLI, against the JAX CLI's values
        fixture = tbt.FIXTURE
        for dtype, (ref1, ref2) in JAX_CLI_FIXTURE_MM.items():
            fargv = ["--config", "h36m", "--hypo", str(CLI_FIXTURE_HYPO), "--gt",
                     "--strict_batch", "--dtype", dtype,
                     "--ckpt_dir", os.path.join(fixture, "checkpoint"),
                     "--ckpt_name", "checkpoint_trained.pth",
                     "--cluster_dir", os.path.join(fixture, "clusters"),
                     "--data_dir", os.path.join(fixture, "data")]
            for o in ("model.hidden_dim=256", "model.embed_dim=128", "ZeDO.sample=1",
                      "ZeDO.batch=24"):
                fargv += ["--override", o]
            fout = cli_launches(sk, split, f"run.opt_main trained fixture --dtype {dtype}",
                                1000 if dtype == "bf16" else 0, lambda: opt_main.main(fargv))
            p1, p2 = fout["p1"] * 1000, fout["p2"] * 1000
            log(f"trained fixture through the CLI, {dtype}: P1 {p1:.3f} mm, P2 {p2:.3f} mm "
                f"(JAX CLI on the CPU {ref1:.3f}, {ref2:.3f}; tolerance {FIXTURE_TOL_MM} mm)")
            if not (abs(p1 - ref1) <= FIXTURE_TOL_MM and abs(p2 - ref2) <= FIXTURE_TOL_MM):
                fail(f"trained fixture CLI {dtype}: P1/P2 {p1}, {p2} vs {ref1}, {ref2}")
            result[f"fixture_{dtype}_mm"] = [p1, p2]

        wsave = os.path.join(root, "wild_results.npy")
        wout = cli_launches(sk, split, "run.inference --config wild --eval", 1000,
                            lambda: inference.main(
                                ["--config", "wild", "--hypo", "1", "--eval", "--save", wsave,
                                 "--override", "ZeDO.sample=1", "--override",
                                 f"ZeDO.batch={WILD_N}", *common]))
        saved = np.load(wsave)
        if saved.shape != (WILD_N, 1, 17, 3) or not np.isfinite(saved).all():
            fail(f"inference saved {saved.shape}, finite {np.isfinite(saved).all()}")
        if not 0 < wout["p2"] <= wout["p1"]:
            fail(f"inference --eval: PA-MPJPE {wout['p2']} vs MPJPE {wout['p1']}")
        log(f"inference --eval on {WILD_N} wild poses: solve {wout['solve_s']:.3f} s, "
            f"P1 {wout['p1'] * 1000:.3f} mm, P2 {wout['p2'] * 1000:.3f} mm")
    return result


def infant_oil_inputs(torch, dev, rows, seed):
    """OIL's inputs for `rows` MINI-RGBD-like poses on `dev`: the
    root-relative pose, its translation, its pixels under MINI_K, K."""
    from zedo_tpu_torch.data.mini_rgbd import mini_intrinsics

    cam = infant_scenes(np.random.RandomState(seed), rows, 17, 1.0)
    k = mini_intrinsics()
    return [torch.from_numpy(np.ascontiguousarray(a, np.float32)).to(dev)
            for a in (cam - cam[:, :1], cam[:, :1], pinhole(cam, k),
                      np.broadcast_to(k, (rows, 3, 3)))]


def time_track_reproj(torch, tsm, dev, rows):
    """OIL alone at the mini configuration (1000 steps, bf16 weights, kernel
    #1) on `rows` rows of one hypothesis, without and with the reprojection
    trace, in turns (off, on, on, off); the seconds of each run by mode."""
    from zedo_tpu_torch import presets
    from zedo_tpu_torch.zeroshot import oil

    preset = presets.from_optim_config(presets.optim_config("mini"))
    params = to_bf16(torch, tsm.init_params(torch.Generator().manual_seed(0), preset.model_cfg,
                                            device=dev))
    x0, t0_, px, k = infant_oil_inputs(torch, dev, rows, 1)
    seconds = {False: [], True: []}
    for on in (False, True, True, False):
        cfg = dataclasses.replace(preset.zcfg.oil, track_reproj=on)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = oil.run_oil(params, preset.model_cfg, preset.sde, preset.sampler, x0, t0_, px, k,
                          None, cfg)
        torch.cuda.synchronize()
        seconds[on].append(time.perf_counter() - t0)
        if not torch.isfinite(res.pose).all():
            fail(f"OIL alone, track_reproj={on}: poses not finite")
    return seconds


def profile_generic(torch, tsm, dev, rows, steps=50):
    """The generic OIL path alone, the ControlNet adapter (published width,
    bf16 weights as under --dtype auto) on `rows` rows for `steps` steps
    under torch.profiler: (wall s, device busy s, CUDA launches a step)."""
    from torch.profiler import ProfilerActivity, profile

    from zedo_tpu_torch import presets
    from zedo_tpu_torch.models import control_mlp
    from zedo_tpu_torch.zeroshot import oil

    preset = presets.from_optim_config(presets.optim_config("mini"))
    params = to_bf16(torch, control_mlp.init_params(torch.Generator().manual_seed(0),
                                                    preset.model_cfg, device=dev))
    args = infant_oil_inputs(torch, dev, rows, 2)
    cfg = dataclasses.replace(preset.zcfg.oil, iterations=steps, track_reproj=True)

    def run():
        return oil.run_oil(params, preset.model_cfg, preset.sde, preset.sampler, *args, None,
                           cfg, model_apply=control_mlp.apply)

    run()  # warm-up
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    events = [e for e in prof.key_averages() if e.device_type == torch.autograd.DeviceType.CUDA]
    busy = sum(e.self_device_time_total for e in events) / 1e6
    return wall, busy, sum(e.count for e in events) / steps


def phase_infant(torch, sk, split, tsm, tbt, opt_main_infant, card):
    """The infant path, run.opt_main_infant from a synthetic workspace as its
    working directory: (a) the plain model on MINI-RGBD and (b) on SyRIP at
    the published width with --hypo 20 (kernel #1 on all 1000 OIL
    forwards, at 51 and 36 columns); (c) --control and --cond on (a)'s data
    at --hypo 1 (the generic path, no kernel); (d) the trained fixture as
    MINI-RGBD frames in fp32 and bf16 against the JAX CLI's MPJPE."""
    from zedo_tpu_torch.models import control_mlp, score_mlp_cond

    result = {}
    cwd = os.getcwd()
    with tempfile.TemporaryDirectory() as root:
        os.chdir(root)
        try:
            rng = np.random.RandomState(0)
            write_mini_workspace(root, rng, MINI_FRAMES, hypo=INFANT_HYPO)
            write_syrip_workspace(root, rng, SYRIP_IMAGES)
            os.makedirs("checkpoint")
            for name, module, n_joints in (("plain_mini", tsm, 17), ("plain_syrip", tsm, 12),
                                           ("control", control_mlp, 17),
                                           ("cond", score_mlp_cond, 17)):
                cfg = tsm.ScoreMLPConfig(n_joints=n_joints)
                save_pth(torch, module.init_params(torch.Generator().manual_seed(0), cfg,
                                                   device="cpu"),
                         os.path.join("checkpoint", f"{name}.pth"))
            runs = (("mini", "mini", "plain_mini", INFANT_HYPO, [], 1000, MINI_FRAMES),
                    ("syrip", "syrip", "plain_syrip", INFANT_HYPO, [], 1000, SYRIP_IMAGES),
                    ("mini_control", "mini", "control", 1, ["--control"], 0, MINI_FRAMES),
                    ("mini_cond", "mini", "cond", 1, ["--cond"], 0, MINI_FRAMES))
            for key, config, ckpt, hypo, flags, forwards, n in runs:
                argv = ["--config", config, "--hypo", str(hypo), "--dtype", "auto", *flags,
                        "--ckpt_dir", "checkpoint", "--ckpt_name", f"{ckpt}.pth"]
                if config == "mini":
                    argv += ["--cluster_path", f"mini_cluster_{INFANT_HYPO}.npy"]
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                name = f"run.opt_main_infant {' '.join(argv[:6 + len(flags)])}"
                out = cli_launches(sk, split, name, forwards,
                                   lambda: opt_main_infant.main(argv))
                wall = time.perf_counter() - t0
                poses, trace = out["poses"], out["reproj_px"]
                n_joints = 17 if config == "mini" else 12
                if tuple(poses.shape) != (n, hypo, n_joints, 3) or not torch.isfinite(poses).all():
                    fail(f"infant {key}: poses {tuple(poses.shape)}, finite "
                         f"{bool(torch.isfinite(poses).all())}")
                if trace.shape != (hypo, 1000) or not np.isfinite(trace).all() \
                        or not np.isfinite(out["mpjpe"]):
                    fail(f"infant {key}: trace {trace.shape} or MPJPE {out['mpjpe']} not finite")
                rate = n * hypo / out["solve_s"]
                log(f"infant {key} on {card}: {n} x {hypo} = {n * hypo} rows, solve "
                    f"{out['solve_s']:.3f} s (IPO {out['ipo_s']:.3f}, OIL {out['oil_s']:.3f}; "
                    f"{rate:.1f} poses/s), evaluation {out['eval_s']:.3f} s, CLI wall-clock "
                    f"{wall:.3f} s; kernel #1 launches {out['kernel_1_launches']}; trace "
                    f"{trace.mean(0)[0]:.2f} -> {trace.mean(0)[-1]:.2f} px (random weights)")
                result[key] = {"rows": n * hypo, "solve_s": out["solve_s"], "ipo_s": out["ipo_s"],
                               "oil_s": out["oil_s"], "eval_s": out["eval_s"], "wall_s": wall,
                               "poses_per_s": rate, "kernel_1_launches": out["kernel_1_launches"]}
        finally:
            os.chdir(cwd)
    rows = MINI_FRAMES * INFANT_HYPO
    seconds = time_track_reproj(torch, tsm, torch.device("cuda"), rows)
    off, on = np.mean(seconds[False]), np.mean(seconds[True])
    log(f"OIL alone at {rows} rows on {card}: {off:.3f} s without the reprojection trace, "
        f"{on:.3f} s with it (runs in turns: off {seconds[False]}, on {seconds[True]})")
    result["oil_s_track_reproj"] = {"off": seconds[False], "on": seconds[True], "rows": rows}
    wall, busy, per_step = profile_generic(torch, tsm, torch.device("cuda"), MINI_FRAMES)
    log(f"generic OIL path, ControlNet adapter, {MINI_FRAMES} rows, 50 steps profiled on "
        f"{card}: {wall:.3f} s wall-clock, device busy {busy:.3f} s ({busy / wall:.3f}), "
        f"{per_step:.0f} CUDA launches a step")
    result["generic_profile"] = {"wall_s": wall, "device_busy_s": busy,
                                 "cuda_launches_per_step": per_step, "rows": MINI_FRAMES}
    with tempfile.TemporaryDirectory() as root:
        os.chdir(root)
        try:
            write_infant_fixture_workspace(root, tbt)
            for dtype, ref in JAX_INFANT_FIXTURE_MPJPE_MM.items():
                argv = ["--config", "mini", "--hypo", str(INFANT_FIXTURE_HYPO), "--dtype", dtype,
                        "--ckpt_dir", os.path.join(tbt.FIXTURE, "checkpoint"),
                        "--ckpt_name", "checkpoint_trained.pth",
                        "--override", "model.hidden_dim=256", "--override", "model.embed_dim=128"]
                out = cli_launches(sk, split, f"infant trained fixture --dtype {dtype}",
                                   1000 if dtype == "bf16" else 0,
                                   lambda: opt_main_infant.main(argv))
                mm = out["mpjpe"] * 1000
                log(f"infant trained fixture {dtype}: MPJPE {mm:.3f} mm (JAX CLI on the CPU "
                    f"{ref:.3f} mm, tolerance {FIXTURE_TOL_MM} mm); solve {out['solve_s']:.3f} s")
                if not abs(mm - ref) <= FIXTURE_TOL_MM:
                    fail(f"infant trained fixture {dtype}: MPJPE {mm} vs {ref}")
                result[f"fixture_{dtype}_mm"] = mm
        finally:
            os.chdir(cwd)
    return result


def counted(sk, split, name, fn):
    """Run one entry point with every launch count set to 0 before it;
    return its result and the counts just after it."""
    sk.reset_launch_counts()
    split.reset_launch_counts()
    t0 = time.perf_counter()
    log(f"--- {name}")
    result = fn()
    counts = {**sk.launch_counts, **split.launch_counts}
    log(f"--- {name}: {time.perf_counter() - t0:.1f} s, launches {counts}, "
        f"kernel #1 by GroupNorm mode {sk.gn_mode_launches}")
    return result, counts


def phase_tooling(torch, sk, split, bench, bench_kernel, validate_dtype):
    """The kernel tooling entry points; returns the launches of kernel #2 on
    its path (bench_kernel --split) and the headline."""
    iters = BENCH_KERNEL_ITERS
    res, counts = counted(sk, split, "tools.bench_kernel --split", lambda: bench_kernel.main(
        ["--split", "--iters", str(iters)]))
    # each variant: one warm-up step and `iters` timed ones, per GroupNorm
    # mode; the split comparison adds one launch of each kernel
    want = {"fused_score_forward": 2 * (iters + 1) + 1,
            "fused_score_forward_split": 2 * (iters + 1) + 1}
    if counts != want:
        fail(f"bench_kernel --split launches {counts}, want {want}")
    if sk.path_launches != {"wgmma": 2 * (iters + 1) + 1, "wmma": 0}:
        fail(f"bench_kernel --split ran kernel #1's paths {sk.path_launches}")
    if not res["split_max_abs_diff"] <= KERNEL_TOL:
        fail(f"bench_kernel --split: split vs kernel {res['split_max_abs_diff']}")
    split_launches = counts["fused_score_forward_split"]

    res, counts = counted(sk, split, "tools.validate_dtype --n 886 --hypo 4",
                          lambda: validate_dtype.main(["--n", "886", "--hypo", "4"]))
    if counts != {"fused_score_forward": 1000, "fused_score_forward_split": 0}:
        fail(f"validate_dtype launches {counts}, want 1000 of kernel #1 (the bf16 solve)")
    if not (res["bounded"] > 0 and np.isfinite(res["mpjpe_bf16_mm"])):
        fail(f"validate_dtype: {res}")

    headline, counts = counted(sk, split, f"bench --n {HEADLINE_N} --s {HEADLINE_S}",
                               lambda: bench.main([]))
    if counts != {"fused_score_forward": 2000, "fused_score_forward_split": 0}:
        fail(f"bench launches {counts}, want 2000 of kernel #1 (two solves)")
    if headline["extras"]["device_kind"] != torch.cuda.get_device_name(0):
        fail(f"bench device_kind {headline['extras']['device_kind']}")

    res, counts = counted(sk, split, f"bench --trained --n {TRAINED_N} --s {TRAINED_S}",
                          lambda: bench.main(["--trained", "--n", str(TRAINED_N),
                                              "--s", str(TRAINED_S)]))
    # bf16, reuse 2, reuse 4 and the 200-step schedule with reuse 2
    if counts != {"fused_score_forward": 1000 + 500 + 250 + 100,
                  "fused_score_forward_split": 0}:
        fail(f"bench --trained launches {counts}, want 1850 of kernel #1")
    for key, ref in JAX_TRAINED_BOUNDS.items():
        got = res["extras"][key]
        log(f"bench --trained {key}: {got:.4f} (JAX package on the CPU {ref:.4f}, "
            f"tolerance {TRAINED_TOL_MM} mm)")
        if not abs(got - ref) <= TRAINED_TOL_MM:
            fail(f"bench --trained {key}: {got} vs {ref}")
    return split_launches, headline


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        fail("CUDA is not available")
    sys.path.insert(0, REPO)
    try:
        from zedo_tpu_torch import bench, presets
        from zedo_tpu_torch import bench_trained as tbt
        from zedo_tpu_torch.models import score_mlp as tsm
        from zedo_tpu_torch.run import inference, opt_main, opt_main_infant
        from zedo_tpu_torch.ops.kernels import build
        from zedo_tpu_torch.ops.kernels import score_kernel as sk
        from zedo_tpu_torch.ops.kernels import score_kernel_split as split
        from zedo_tpu_torch.serving import ZeDOEstimator
        from zedo_tpu_torch.tools import bench_kernel, validate_dtype
        from zedo_tpu_torch.utils.config import resolve_device
    except ImportError as e:
        fail(f"the zedo_tpu_torch package is not beside this script: {e}")

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         timeout=60)
    if smi.returncode != 0:
        fail(f"nvidia-smi failed: {smi.stderr}")
    card = smi.stdout.strip().splitlines()[0]
    dev = resolve_device("cuda")
    log(f"device: {torch.cuda.get_device_name(0)} ({card}); torch {torch.__version__}, "
        f"CUDA {torch.version.cuda}")

    blocks_per_sm, build_s = phase_build(torch, build, sk, split)

    t0 = time.perf_counter()
    entry, weights, x = phase_kernel(torch, sk, tsm, bench_kernel.library_forward, dev)
    log(f"phase kernel #1: {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    entry_split = phase_split(torch, sk, split, tsm, bench_kernel.step_ms,
                              bench_kernel.library_forward, weights, x)
    log(f"phase kernel #2: {time.perf_counter() - t0:.1f} s")
    del weights, x
    t0 = time.perf_counter()
    entry["launches"], walls, ipo_s, busy_s, per_forward = phase_main_path(
        torch, sk, tsm, presets, ZeDOEstimator, bench.build_inputs, dev)
    entry["cuda_launches_per_forward"] = per_forward
    log(f"phase main path: {time.perf_counter() - t0:.1f} s")
    kernel_share = entry["launches"] * entry["ms"] / 1e3 / sum(walls)
    log(f"request wall-clock {walls} s on {card}; kernel time (launches x kernel ms) "
        f"{kernel_share:.3f} of it, IPO {ipo_s * len(walls) / sum(walls):.3f}")
    t0 = time.perf_counter()
    batch_cli = phase_batch_cli(torch, sk, split, tsm, tbt, opt_main, inference, card)
    entry["launches_batch_cli"] = batch_cli["kernel_1_launches"]
    log(f"phase batch CLI: {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    infant = phase_infant(torch, sk, split, tsm, tbt, opt_main_infant, card)
    entry["launches_infant"] = {key: infant[key]["kernel_1_launches"] for key in ("mini", "syrip")}
    log(f"phase infant: {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    phase_accuracy(torch, sk, tbt, presets, ZeDOEstimator, dev)
    log(f"phase accuracy: {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    entry_split["launches"], headline = phase_tooling(torch, sk, split, bench, bench_kernel,
                                                      validate_dtype)
    log(f"phase tooling: {time.perf_counter() - t0:.1f} s")
    for e in (entry, entry_split):
        if not e["launches"]:
            fail(f"{e['name']} was not launched on its path")

    entry["resident_blocks_per_sm"] = blocks_per_sm
    print(json.dumps({"kernels": [entry, entry_split], "request_s": walls, "ipo_s": ipo_s,
                      "device_busy_s": busy_s, "headline_s": headline["value"],
                      "batch_cli": batch_cli, "infant": infant,
                      "build_s": build_s,
                      "poses": HEADLINE_N, "hypotheses": HEADLINE_S}), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
