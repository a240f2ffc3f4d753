#!/usr/bin/env python3
"""Drive the zedo_tpu_torch port on one NVIDIA GPU and check it.

    python3 chip_smoke.py

Phases (any failure exits non-zero; nothing is caught and passed over):
  1. device: the card's name and power limit (nvidia-smi);
  2. build: the five kernel libraries from zedo_tpu_torch/csrc (kernel #1,
     kernel #2, kernel #3, kernel #4, kernel #1's probe variants), one nvcc each,
     started together; registers and spills of their kernels, kernel #1's
     and kernel #3's resident blocks per SM, the HGMMA (wgmma) and UTMALDG
     (TMA load) opcodes in the SASS of kernels #1, #2 and #3, and the
     instructions of each kernel (kernel #2's tile loop has to fit the
     instruction cache);
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
 3a. kernel #3 (fused_control_forward, the ControlNet adapter): against its
     plain version on the same card inputs at the published width (hidden
     1024, embed 512, bf16 weights, the copy branch moved off the trunk)
     and SyRIP's 36 columns, in both GroupNorm statistics modes, on 10,000
     (500 x 20), 129 and 1 rows, one launch a forward; timed at 10,000 rows
     in both modes, with its plain version's and control_mlp.apply's in
     bf16 (the library) times and its roofline bound on the products it
     executes;
 3c. kernel #4 (ipo_step, one IPO Adam step of every row): against its
     plain version on the same card tensors, bit for bit, at the H36M solve
     (44,300 rows, 3 keys, z), SyRIP's (10,000 x 12 keys, xyz) and the
     low-latency serving bucket (160 x 3); timed alone a step beside its
     bytes bound and its plain version, and a compiled IPO run (500 steps,
     100 at the bucket) on it in turns with the same run on the autograd
     step graph it replaced (kernel, autograd, autograd, kernel); its
     launches counted in phase 5 (one a step of every request);
 3b. kernel #1's eight epilogue variants (phase_probe, score_kernel_probe:
     tools/bench_kernel.py --probe's full, no_silu, no_gn, dense_only,
     tanh_silu, bf16_silu, gn_vpu, gn_bcast_vpu), built from the repo's
     sources into their own library: resident blocks, SASS (wgmma, TMA,
     gn_bcast_vpu's mma.sync; the shipped library holds the full epilogue
     only, with the probe library's full of the same instruction counts);
     each against its plain version at 44,300 and 1,001 rows; each timed in
     turns beside full (full, variant, variant, full) at 44,300 rows with its
     bound share and full - variant; full within 5% of phase 3's kernel #1;
     tools.bench_kernel --probe with its launch counts. No other phase
     launches a probe kernel (their counts are held from here to the end);
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
     request, from which the kernel's CUDA launches per forward are counted
     (predict and every later entry point solve through the compiled solve:
     IPO and OIL steps replayed as CUDA graphs, kernel #1's forwards counted
     from the replays);
 5b. the compiled solve against the eager one (phase_compiled), at the
     published width: pipeline.solve_jit at 886 x 50 in turns with
     pipeline.solve (eager, first call, replay, eager) and bench through it,
     predict at the serving buckets (1,280 rows on the full schedule, 160 on
     the low-latency one; eager and compiled requests in turns), the infant
     solve at 2,000 x 20 on the plain prior and 2,000 x 1 on each adapter
     (the generic path, with a generator), solve_sharded at world size 1
     over NCCL: each bit-equal to the eager solve, with first-call (capture)
     and replay seconds, IPO and OIL apart, kernel #1's launches a solve,
     host dispatches a solve and the device's busy share (torch.profiler),
     request p50 at each bucket;
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
     --control and --cond on the MINI-RGBD frames at --hypo 1 (--control on
     kernel #3, 1000 forwards; --cond on the generic OIL path, no kernel),
     each finite with its reprojection trace; the
     trained fixture's poses as MINI-RGBD frames in fp32 and bf16 against
     the JAX CLI's MPJPE;
  8. accuracy on the committed trained fixture (hidden 256): fp32, bf16
     (kernel #1, GroupNorm bf16) and bf16 with gn_fp32, best-hypothesis
     MPJPE against the JAX package's value for the same scenes, schedule
     and mode;
  9. the kernel tooling path, each entry point with the launch counts set to
     0 before it and checked after it: tools.bench_kernel --split (the path
     of kernel #2), tools.validate_dtype, bench (the headline at 886 x 50)
     and bench --trained against the JAX package's values;
 10. the training path at the published width (dropout 0.1), each entry
     point with the launch counts set to 0 before it and checked after it
     (it launches neither kernel): run.train_pose_mini --config mini at its
     batch of 5,000 on a synthetic MINI-RGBD workspace of 20,000 training
     and 1,024 validation frames, 2 epochs in fp32 and in bf16 (finite
     losses, parameters and EMA moved, an eval epoch with its sampling,
     Mahalanobis and micro solve, a checkpoint), a resume from that
     checkpoint at its epoch and step, the checkpoint through run.sample
     and run.opt_main_infant (kernel #1 on all 1000 OIL forwards), --model
     control fine-tuned from it (the trunk bit-equal, the adapter leaves
     moved) and --model cond; tools.bench_train at 50,000 rows, fp32 and
     bf16, with the device's busy share of a step;
 11. the sampling surface on seeded hidden-1024 weights (h36m config, the
     full 1000-step schedule), no kernel: run.sample --task gen at 10,000
     rows, comp3d --jlist 14,15,16 (the known joints end at the
     condition's marginal mean at eps) and den on those samples, --sampler
     ode at 1,024 (its NFE), --guide sym and --guide match at 1,024;
 11b. the JAX package's remaining compiled programs against their eager
     oracles (phase_compiled_programs), in turns from the same state and
     seeds, each bit-equal: 20 + 20 train steps (diffusion/losses.py's
     step, one CUDA graph a step on the state's own tensors) at 5,000 and
     50,000 rows in fp32 and bf16 at the published width with dropout 0.1,
     and at make_trained_fixture's 512 rows of hidden 256; sample_loop_jit
     (a graph a step) for `gen` at 10,000 rows x 100 steps and at 1,024 rows
     x 1000 steps guided by `sym` and with comp3d imputation, the
     generator's state after it; ODESampler.sample_jit at 1,024 rows (chunks
     of masked RK45 steps, one host read a chunk; NFE equal);
     multi_hypothesis_eval's P1 and P2 at 886 x 50 (the SVD between two
     graphs); predict at the serving buckets against an eager
     rank-and-pack in the same turns, p50 beside SERVING_P50_BEFORE_MS.
     Ms a step, first calls, host dispatches (torch.profiler) and busy
     shares printed. Phases 6, 7 and 10-13 reach these programs through
     their entry points;
 12. multi-GPU on the one card (phase_multigpu), at the published width
     with seeded weights and the full schedule: world size 1 over NCCL
     (solve_sharded at 886 x 50 bit-identical to pipeline.solve, kernel #1
     on all 1000 OIL forwards), then two ranks spawned on cuda:0 over Gloo
     (this script with --multigpu-rank, torchrun's environment): the
     sharded solve at 886 x 50 with and without the reprojection trace and
     the sharded infant solve on 2,000 MINI-RGBD frames x 20, each rank's
     rows bit-identical to `solve` on its block and kernel #1 on all 1000
     OIL forwards of each rank, both ranks holding the same gathered
     result, the distance from the whole batch solved at once printed;
     ZeDOEstimator(mesh="dp2").predict on 64 poses against one device;
     run.train_pose_mini --mesh dp2 and --mesh dp1,tp2 (4 steps at the
     mini batch, the warmup off) against --mesh off: the loss and each
     leaf's update, dp2's replicas and tp's replicated leaves bit-identical
     on both ranks. Its
     seconds are two ranks sharing one card, not a scaling number;
 13. the rest of the surface, each entry point with the launch counts set
     to 0 before it and checked after it: kernels #1 and #2 against their
     plain versions at the serving shapes (the 256-pose bucket x 5
     hypotheses, 1,280 rows, and the low-latency bucket 32 x 5, 160 rows;
     hidden 1024, both GroupNorm modes), timed in turns with their host
     times, bound and library chain (nothing routes a request to kernel #2); tools.bench_serving --reps 3 (full schedule) and --oil 200 --ipo
     100 --bucket 32 --reps 3 (kernel #1 on every OIL forward of every
     request, at 1,280 and 160 rows as its wrapper records them, kernel #2
     never; p50/p95 per request size and score_reuse);
     examples.quickstart (fp32, against the JAX quickstart's MPJPE);
     tools.make_trained_fixture --out <tmp> (its loss check, the numpy-
     seeded files against the committed fixture byte for byte, the .pth
     through load_any_checkpoint with and without use_ema, the gate MPJPE
     of the prior the port trained); tools.make_clusters --dataset h36m on
     phase 6's synthetic H36M workspace. utils.visualize is not run: the
     card's machine has no matplotlib (the CPU tests draw with it);
 14. config files, read as JAX's CLIs and serving read them (presets.
     read_config_file, no ml_collections), each run with the launch counts
     set to 0 before it and checked after it: a wrapper of
     configs/optim/concat_pose_optimization_h36m.py setting ZeDO.sample=1
     in unlocked() through run.opt_main --hypo 50 --gt --strict_batch
     --dtype auto on phase 6's synthetic workspace, rebuilt from its seed
     (kernel #1 on all 1000 OIL forwards, on wgmma; the poses bit-equal to
     phase 6's --config h36m run); ZeDOEstimator.from_torch_checkpoint(
     config_path=examples/quickstart_config.py) on the trained fixture in
     bf16, its predict bit-equal to the preset estimator's, kernel #1's
     launches by rows; solve_one_hypothesis on the generic OIL path
     (Langevin corrector) with a generator (one seed twice bit-equal, two
     seeds apart) and a uniform reproj_weight against the unweighted trace.

Kernel #3's launches are counted in every phase that runs the ControlNet
adapter (5b, 7) and the script fails unless it ran on those paths; kernel
#4's in phase 5.

Prints a `kernels` JSON line and the card's name and power limit before the
last line, and as the last line
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}.
Imports torch, numpy and zedo_tpu_torch only.
"""
from __future__ import annotations

import contextlib
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

# Best-hypothesis MPJPE (mm, root-centred as bench_trained.best_mpjpe) of
# the JAX package's quickstart on the CPU: examples/quickstart.py's
# pipeline.solve_jit in fp32 (Precision.HIGHEST) on the trained fixture's
# 24 scenes x 2 hypotheses at 200 IPO / 300 OIL re-discretized steps, and
# ZeDOEstimator.low_latency() on the first 8 scenes. Recomputed and held
# against these values by
# tests/test_torch_rest.py::test_chip_smoke_quickstart_reference.
JAX_QUICKSTART_MM = {"solved": 32.176090240478516, "served": 16.888206481933594}
# tools.make_trained_fixture: the gate MPJPE (mm) of the committed prior the
# JAX tool trained (tests/fixtures/trained/family.npz), and how far the
# port's own training may land from it: within GATE_TOL_MM and below
# GATE_INIT_SHARE of the cluster init's error (stated before the first run)
GATE_TOL_MM, GATE_INIT_SHARE = 10.0, 0.15
# the serving buckets of tools.bench_serving: the default 256 and the
# low-latency 32, each x 5 hypotheses
SERVING_BUCKETS, SERVING_HYPO = (256, 32), 5
BENCH_SERVING_REPS = 3
CLUSTERS_S = 5  # clusters of the make_clusters run

# H100 SXM peaks (NVIDIA data sheet, dense): bf16 tensor cores and HBM3
PEAK_BF16_FLOPS = 989e12
PEAK_BYTES = 3.35e12

HEADLINE_N, HEADLINE_S = 886, 50
N_REQUESTS = 3
# phase_ipo_kernel: (rows, keypoint_list, rot_axes, hypotheses, IPO steps, max
# scale) of the H36M solve, the SyRIP solve and the low-latency bucket
IPO_SHAPES = {"h36m": (HEADLINE_N * HEADLINE_S, (0, 1, 4), "z", HEADLINE_S, 500, 2.0),
              "syrip": (500 * 20, tuple(range(12)), "xyz", 20, 500, 8.0),
              "serving": (32 * 5, (0, 1, 4), "z", 5, 100, 2.0)}
IPO_GRAPH_STEPS = 50  # kernel #4's steps in the graph that times it
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
# phase_probe: kernel #1's epilogue variants (score_kernel_probe), each held
# against its plain version at KERNEL_TOL (the same bf16 operands, f32 sums in
# another order), bf16_silu at twice that: it rounds to bf16 at three more
# places a layer (xn, the sigmoid's steps, the product), where a sum's last
# bit can flip a rounding; at the headline rows and a ragged 1,001; each
# variant timed in turns with `full` (full, variant, variant, full): over a
# second of back-to-back forwards the card's power rises (188 to 592 W on an
# H100 at a 700 W limit) and a forward slows by up to 5%. `full`'s first
# turn, timed as phase_kernel times kernel #1 (after the checks, 3 + 20
# forwards), must land within PROBE_FULL_SHARE of it in the same run
PROBE_ROWS = (HEADLINE_N * HEADLINE_S, 1001)
PROBE_BF16_SILU_TOL = 2 * KERNEL_TOL
PROBE_FULL_SHARE = 0.05
PROBE_BENCH_ITERS = 50
# Instructions of one kernel #2 instantiation. Its per-tile loop runs 80 times
# a block: with the loop unrolled eight times (0.8 MB of code a kernel) the
# forward ran at the pace of instruction fetch, 2.0 ms against 1.45 ms at some
# 2,400 instructions.
MAX_SPLIT_INSTRUCTIONS = 4000
# phase_compiled: requests of each mode at each serving bucket, and the host
# calls that dispatch device work (kernel launches and graph launches)
COMPILED_REPS = 3
HOST_DISPATCHES = ("cudaLaunchKernel", "cudaLaunchKernelExC", "cuLaunchKernel",
                   "cuLaunchKernelEx", "cudaGraphLaunch")


def fail(msg: str) -> None:
    """Print the failure on standard output, beside the log, and on standard
    error too, so that a run whose error stream alone is kept still says
    why it failed; exit 1."""
    print(f"FAIL: {msg}", flush=True)
    print(f"FAIL: {msg}", file=sys.stderr, flush=True)
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


def gpu_clocks() -> str:
    """The card's SM clock, power draw and temperature (nvidia-smi)."""
    smi = subprocess.run(["nvidia-smi", "--query-gpu=clocks.sm,power.draw,temperature.gpu",
                          "--format=csv,noheader"], capture_output=True, text=True, timeout=60)
    return smi.stdout.strip()


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


def phase_build(torch, build, sk, split, ck):
    """Build the libraries; their resources, occupancy and the SASS of
    kernels #1 and #2 (the probe library's: phase_probe)."""
    libs = build.build()
    for name, lib in libs.items():
        log(f"build {name}: {lib.build_seconds:.1f} s -> {lib.path}")
        res = build.resources(lib.ptxas)
        if not res:
            log("ptxas: (library was already built)")
        for label in ("wgmma_layer", "dense_layer", "score_mlp_split", "control_layer",
                      "ipo_step"):
            regs = [v for k, v in res.items() if label in k]
            if regs:
                log(f"  {name} {label}: {len(regs)} kernels, registers "
                    f"{min(r for r, _ in regs)}-{max(r for r, _ in regs)}, spill bytes "
                    f"{sum(sp for _, sp in regs)}")
    blocks = sk.load_library().zedo_score_mlp_wgmma_blocks_per_sm()
    log(f"wgmma_layer: {blocks} resident blocks per SM")
    if blocks < 1:
        fail("the wgmma kernel does not fit an SM")
    blocks3 = ck.load_library().zedo_control_blocks_per_sm()
    log(f"control_layer: {blocks3} resident blocks per SM")
    if blocks3 < 1:
        fail("the control kernel does not fit an SM")
    lib2 = split.load_library()
    log(f"score_mlp_split at hidden 1024: {lib2.zedo_score_mlp_split_tile_rows(1024)} rows a "
        f"block, {lib2.zedo_score_mlp_split_stages(1024)} ring stages, "
        f"{lib2.zedo_score_mlp_split_smem_bytes(1024)} bytes of shared memory")
    for name in ("score_mlp", "score_mlp_split", "score_mlp_control"):
        counts, examples, instructions = sass_counts(build, libs[name].path)
        log(f"SASS of libzedo_{name}.so: {counts['HGMMA']} HGMMA (wgmma), {counts['UTMALDG']} "
            f"UTMALDG (TMA load), {counts['HMMA']} HMMA (mma.sync of the wmma kernel, HGMMA "
            f"included)")
        for e in examples:
            log(f"  e.g. {e}")
        for label in ("wgmma_layer", "dense_layer", "score_mlp_split", "control_layer"):
            sizes = [n for k, n in instructions.items() if label in k]
            if sizes:
                log(f"  {label}: {len(sizes)} kernels of {min(sizes)}-{max(sizes)} instructions")
        log(f"  libzedo_{name}.so: {sum(instructions.values())} instructions in "
            f"{len(instructions)} kernels")
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


def control_weights(torch, ck, control_mlp, dev, n_joints=12):
    """(cfg, bf16 params, {gn mode: (packed, step vectors)}) of a seeded
    ControlNet adapter at the published width, every leaf of its copy
    branch scaled elementwise by U(0.5, 1.5) off the trunk it starts as, so
    that a fault in the control stream cannot hide behind the trunk."""
    from zedo_tpu_torch.models import nn

    cfg = control_mlp.ScoreMLPConfig(n_joints=n_joints)
    gen = torch.Generator().manual_seed(3)
    params = control_mlp.init_params(gen, cfg, device="cpu")
    for name in [k for k in params if k.endswith("_copy")]:
        params[name] = {k: v * (0.5 + torch.rand(v.shape, generator=gen))
                        for k, v in params[name].items()}
    params = to_bf16(torch, nn.tree_map(lambda a: a.to(dev), params))
    temb = control_mlp.time_embedding(params, cfg, torch.full((1,), 47.3, device=dev))[0]
    vecs = ck.step_vectors(params, cfg, temb).contiguous()
    return cfg, params, {gn: (ck.pack_weights(params, cfg, gn_dtype=gn_dtype), vecs)
                         for gn, gn_dtype in (("bf16", None), ("f32", torch.float32))}


def control_bound(x, packed, vecs, rows):
    """(bound ms, bound_by, operations) of one kernel #3 forward: the
    products it executes (3*C*H + 6*H*H multiply-adds a row: layer 0 for
    both streams, each block's [h | c] and second layers, the post layer) at
    the bf16 peak against x, its weights and the output at the HBM rate."""
    io = x.shape[1]
    h = packed.w_pre.shape[1] // 2
    flops = 2 * rows * (3 * io * h + 6 * h * h)
    n_bytes = (x.numel() * 4 + rows * io * 4
               + sum(t.numel() * t.element_size() for t in
                     (packed.w_pre, *packed.w_d1, *packed.w_d2, packed.w_post, vecs,
                      packed.gn_scale, packed.gn_bias, packed.bias_post)))
    t_ops, t_bytes = flops / PEAK_BF16_FLOPS * 1e3, n_bytes / PEAK_BYTES * 1e3
    return max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes else "bytes"), flops


def phase_control_kernel(torch, ck, dev):
    """Kernel #3 against its plain version on the same card inputs, timed;
    returns its JSON entry (without the main path's launches)."""
    from zedo_tpu_torch.models import control_mlp

    cfg, params, weights = control_weights(torch, ck, control_mlp, dev)
    rows = SYRIP_IMAGES * INFANT_HYPO
    gen = torch.Generator().manual_seed(4)
    xs = {r: torch.randn(r, 36, generator=gen).to(dev) for r in (rows, 129, 1)}
    errs, ms = [], {}
    for gn, (packed, vecs) in weights.items():
        for r, x in xs.items():
            want = ck.fused_control_forward_reference(x, packed, vecs)
            ck.reset_launch_counts()
            errs.append(check(torch, f"kernel #3 gn={gn} vs plain",
                              ck.fused_control_forward(x, packed, vecs), want, r))
            if ck.launch_counts["fused_control_forward"] != 1:
                fail(f"kernel #3: {ck.launch_counts}, want one forward")
        ms[gn] = cuda_ms(torch, lambda: ck.fused_control_forward(xs[rows], packed, vecs), 20, 3)
    packed, vecs = weights["bf16"]
    x = xs[rows]
    plain_ms = cuda_ms(torch, lambda: ck.fused_control_forward_reference(x, packed, vecs), 3, 1)
    xb = x.to(torch.bfloat16)
    labels = torch.full((rows,), 47.3, device=dev, dtype=torch.bfloat16)
    lib_ms = cuda_ms(torch, lambda: control_mlp.apply(params, cfg, xb, labels), 10, 2)
    bound_ms, bound_by, flops = control_bound(x, packed, vecs, rows)
    published = 2 * rows * (3 * 36 * 1024 + 9 * 1024 * 1024)
    for gn in ms:
        log(f"fused_control_forward gn={gn} {rows}x36, hidden 1024: kernel {ms[gn]:.4f} ms "
            f"({flops / ms[gn] / 1e9:.1f} TFLOP/s executed, {published / ms[gn] / 1e9:.1f} on "
            f"the published dataflow; {bound_ms / ms[gn]:.3f} of the {bound_by} bound "
            f"{bound_ms:.4f} ms)")
    log(f"kernel #3: plain version {plain_ms:.3f} ms, control_mlp.apply in bf16 "
        f"{lib_ms:.4f} ms")
    ck.reset_launch_counts()
    return {"name": "fused_control_forward", "route": "cuda",
            "source": "zedo_tpu_torch/csrc/score_mlp_control.cu", "replaces": None,
            "launches": None, "max_abs_err": max(errs), "ms": ms["bf16"], "ms_gn_f32": ms["f32"],
            "plain_ms": plain_ms, "library_ms": lib_ms, "bound_ms": bound_ms,
            "bound_by": bound_by, "rows": rows, "columns": 36, "hidden": 1024,
            "tflops": flops / ms["bf16"] / 1e9, "roofline_share": bound_ms / ms["bf16"]}


def ipo_scene(torch, dev, rows, seed=0):
    """rows root-relative poses of 17 joints, their keypoints under a random
    rotation about z with pixel noise, and intrinsics, on the card."""
    rng = np.random.RandomState(seed)
    pose = rng.randn(rows, 17, 3).astype(np.float32) * 0.25
    pose -= pose[:, :1]
    angle = rng.uniform(-0.5, 0.5, rows)
    cos, sin = np.cos(angle), np.sin(angle)
    rotated = np.stack([cos[:, None] * pose[..., 0] - sin[:, None] * pose[..., 1],
                        sin[:, None] * pose[..., 0] + cos[:, None] * pose[..., 1],
                        pose[..., 2]], -1)
    k = np.zeros((rows, 3, 3), np.float32)
    k[:, 0, 0] = k[:, 1, 1] = 1145.0
    k[:, :2, 2] = 512.0
    k[:, 2, 2] = 1.0
    cam = np.einsum("nij,nkj->nki", k, rotated + np.array([0.1, -0.2, 4.5], np.float32))
    px = cam[..., :2] / cam[..., 2:] + rng.randn(rows, 17, 2).astype(np.float32) * 2

    def put(a):
        return torch.from_numpy(np.ascontiguousarray(a, np.float32)).to(dev)

    return put(pose), put(px), put(k)


def ipo_step_bytes(rows, keys, axes):
    """Bytes one IPO step must move: its constants read, each learned leaf's
    value and two moments read and written, the row's loss written."""
    return 4 * rows * ((5 * keys + 12) + 6 * (2 + len(axes)) + 1)


def phase_ipo_kernel(torch, ik, dev):
    """Kernel #4 against its plain version on the same card tensors, timed
    alone and as compiled IPO runs in turns with the autograd step graph it
    replaced; returns its JSON entry (without the main path's launches)."""
    from zedo_tpu_torch.zeroshot import ipo

    shapes = {}
    for name, (rows, keys, axes, s, steps, hi) in IPO_SHAPES.items():
        pose, px, k = ipo_scene(torch, dev, rows)
        kl = list(keys)
        t = ipo.init_translation(px, k, 3.0)
        consts = ik.pack(pose[:, kl], px[:, kl], t, k)
        corrections = ipo.adam_corrections(steps, torch.float32, dev)
        counter = torch.tensor([steps // 2], device=dev)
        scalars = dict(weight=1.0 / (rows // s * len(keys) * 2), lr=0.1, lo=0.5, hi=hi,
                       b1=ipo.B1, b2=ipo.B2, eps=ipo.EPS)
        gen = torch.Generator().manual_seed(5)
        params = {"rot_vect": 1 + 0.2 * torch.randn(rows, 1, generator=gen),
                  "scale": 1.2 + 0.6 * torch.randn(rows, 1, 1, generator=gen)}
        for a in axes:
            params[f"rot_vect_{a}"] = 0.2 * torch.randn(rows, 1, generator=gen)
        state = {"params": params,
                 "mu": {n: 0.05 * torch.randn(p.shape, generator=gen) for n, p in params.items()},
                 "nu": {n: 0.01 * torch.randn(p.shape, generator=gen).abs()
                        for n, p in params.items()},
                 "loss": torch.zeros(rows)}

        def copy(tree):
            if isinstance(tree, dict):
                return {n: copy(v) for n, v in tree.items()}
            return tree.to(dev, copy=True)

        got, want = copy(state), copy(state)
        ik.reset_launch_counts()
        ik.ipo_step(consts, got, corrections, counter, **scalars)
        torch.cuda.synchronize()
        if ik.launch_counts["ipo_step"] != 1:
            fail(f"kernel #4: {ik.launch_counts}, want one step")
        ik.ipo_step_reference(consts, want, corrections, counter, **scalars)
        for part in ("params", "mu", "nu"):
            for leaf in got[part]:
                if not torch.equal(got[part][leaf], want[part][leaf]):
                    diff = (got[part][leaf] - want[part][leaf]).abs().max().item()
                    fail(f"kernel #4 at {name}: {part}[{leaf}] differs from its plain version "
                         f"by up to {diff}")
        if not torch.equal(got["loss"], want["loss"]):
            fail(f"kernel #4 at {name}: the rows' L1 sums differ from its plain version")
        # the kernel's pace as the solve replays it: a graph of back-to-back
        # steps (an eager call's wrapper takes longer on the host than the step)
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            for _ in range(IPO_GRAPH_STEPS):
                ik.ipo_step(consts, got, corrections, counter, **scalars)
        step_ms = cuda_ms(torch, graph.replay, 10, 2) / IPO_GRAPH_STEPS
        wrapper_us = host_us(torch, lambda: ik.ipo_step(consts, got, corrections, counter,
                                                        **scalars))
        plain_ms = cuda_ms(torch, lambda: ik.ipo_step_reference(consts, want, corrections,
                                                                counter, **scalars), 5, 1)
        bound_ms = ipo_step_bytes(rows, len(keys), axes) / PEAK_BYTES * 1e3

        # a whole compiled IPO run on each step body, in turns
        cfg = ipo.IPOConfig(iterations=steps, keypoint_list=keys, rot_axes=axes, max_scale_t=hi)
        real_path = ipo.step_path

        def run(path):
            ipo.step_path = lambda device, dtype: path
            try:
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                res = ipo.run_ipo(pose, px, k, cfg, n_groups=s, compiled=True)
                torch.cuda.synchronize()
                return time.perf_counter() - t0, res
            finally:
                ipo.step_path = real_path

        for path in ("kernel", "autograd"):  # captures
            run(path)
        walls = {"kernel": [], "autograd": []}
        for path in ("kernel", "autograd", "autograd", "kernel"):
            wall, res = run(path)
            walls[path].append(wall * 1e3)
            if not torch.isfinite(res.quaternion).all():
                fail(f"IPO at {name} on the {path} step: non-finite quaternions")
        shapes[name] = {"rows": rows, "keys": len(keys), "axes": axes, "hypotheses": s,
                        "step_ms": step_ms, "wrapper_host_us": wrapper_us,
                        "plain_ms": plain_ms, "bound_ms": bound_ms,
                        "roofline_share": bound_ms / step_ms, "steps": steps,
                        "run_ms": float(np.mean(walls["kernel"])),
                        "autograd_run_ms": float(np.mean(walls["autograd"]))}
        log(f"ipo_step {name} ({rows} rows x {len(keys)} keys, {axes}): kernel "
            f"{step_ms * 1e3:.2f} us a step in a graph ({bound_ms * 1e3:.2f} us bytes bound, "
            f"{bound_ms / step_ms:.3f} of it; the wrapper {wrapper_us:.1f} us on the host), "
            f"plain version {plain_ms:.3f} ms; compiled IPO of "
            f"{steps} steps {walls['kernel'][0]:.2f} / {walls['kernel'][1]:.2f} ms on the kernel, "
            f"{walls['autograd'][0]:.2f} / {walls['autograd'][1]:.2f} ms on the autograd step "
            f"graph")
    ik.reset_launch_counts()
    return {"name": "ipo_step", "route": "cuda", "source": "zedo_tpu_torch/csrc/ipo_step.cu",
            "replaces": None, "launches": None, "shapes": shapes,
            "ms": shapes["h36m"]["step_ms"], "bound_ms": shapes["h36m"]["bound_ms"],
            "plain_ms": shapes["h36m"]["plain_ms"], "bound_by": "bytes"}


def operand_stream_bytes(sk, rows, hidden, io):
    """Bytes of operand tiles that one forward of kernel #1's wgmma path
    asks of L2, by count (nothing reads a counter): each 128 x 128 output
    tile of a layer takes in the whole [128, K] row panel of A and [K, 128]
    column panel of B, bf16. Layers (K, N): the bf16 copy of x (64 columns)
    to hidden, four hidden to hidden, hidden to the 128 padded columns."""
    row_tiles = math.ceil(rows / 128)
    layers = [(sk.padded_input_columns(io), hidden)] + [(hidden, hidden)] * 4 + [(hidden, 128)]
    return sum(row_tiles * (n // 128) * 2 * (128 * k * 2) for k, n in layers)


def probe_sass(build, sk_path, probe_path):
    """Instructions of each wgmma_layer instantiation of the shipped and the
    probe library, by template arguments (MODE, GN, G, EPI)."""
    import re

    out = []
    for path in (sk_path, probe_path):
        by_args = {}
        for name, n in build.count_sass_instructions(build.sass(path)).items():
            m = re.search(r"wgmma_layerILi(\d+)ELi(\d+)ELi(\d+)ELi(\d+)EE", name)
            if m:
                by_args[tuple(int(g) for g in m.groups())] = n
        out.append(by_args)
    return out


def phase_probe(torch, build, sk, probe, split, bench_kernel, weights, x, kernel_ms):
    """Kernel #1's eight epilogue variants (csrc/score_mlp_probe.cu): built
    from the repo's sources, each against its plain version at 44,300 and
    1,001 rows, timed at 44,300 beside the bound; `full` against phase_kernel's
    kernel #1; then tools.bench_kernel --probe with its launch counts.
    Returns the `probe` entry of kernel #1's JSON."""
    if any(probe.launch_counts.values()):
        fail(f"a phase before phase_probe launched a probe kernel: {probe.launch_counts}")
    libs = build.build(("score_mlp", "score_mlp_probe"))
    lib = libs["score_mlp_probe"]
    log(f"build score_mlp_probe: {lib.build_seconds:.1f} s (built beside the other libraries "
        f"in phase 2, one nvcc each) -> {lib.path}")
    res = build.resources(lib.ptxas)
    regs = [v for k, v in res.items() if "wgmma_layer" in k]
    if regs:
        log(f"  score_mlp_probe wgmma_layer: {len(regs)} kernels, registers "
            f"{min(r for r, _ in regs)}-{max(r for r, _ in regs)}, spill bytes "
            f"{sum(sp for _, sp in regs)}")
    plib = probe.load_library()
    blocks = {v: plib.zedo_score_mlp_probe_blocks_per_sm(i)
              for i, v in enumerate(probe.PROBE_VARIANTS)}
    log(f"probe kernels' resident blocks per SM (residual layer): {blocks}")
    if min(blocks.values()) < 1:
        fail(f"a probe kernel does not fit an SM: {blocks}")
    counts, _, _ = sass_counts(build, lib.path)
    shipped, probed = probe_sass(build, libs["score_mlp"].path, lib.path)
    log(f"SASS of libzedo_score_mlp_probe.so: {counts['HGMMA']} HGMMA, {counts['UTMALDG']} "
        f"UTMALDG, {counts['HMMA']} HMMA (gn_bcast_vpu's mma.sync among them); "
        f"{len(probed)} wgmma_layer kernels, instructions by (mode, GN, G, variant): {probed}")
    if not counts["HGMMA"] or not counts["UTMALDG"] or not counts["HMMA"]:
        fail(f"the probe library's SASS lacks wgmma, TMA or mma.sync: {counts}")
    # the shipped library instantiates the FULL epilogue only, and the probe
    # library's FULL is the same code: the same instructions
    if not shipped or any(args[3] != 0 for args in shipped):
        fail(f"libzedo_score_mlp.so's wgmma_layer kernels by (mode, GN, G, variant): {shipped}")
    same = {args: (n, shipped.get(args)) for args, n in probed.items() if args[3] == 0}
    log(f"FULL in the probe library against the shipped kernel, instructions: {same}")
    if not same or any(a != b for a, b in same.values()):
        fail(f"the probe library's FULL differs from the shipped kernel: {same}")

    packed, vecs = weights["bf16"]
    sk.reset_launch_counts()
    split.reset_launch_counts()
    gen = torch.Generator().manual_seed(12)
    xs = {rows: x if rows == x.shape[0] else torch.randn(rows, x.shape[1], generator=gen)
          .to(x.device) for rows in PROBE_ROWS}
    out = {}
    for name in probe.PROBE_VARIANTS:
        tol = PROBE_BF16_SILU_TOL if name == "bf16_silu" else KERNEL_TOL
        errs = []
        for rows, xr in xs.items():
            want = probe.fused_score_forward_probe_reference(xr, packed, vecs, name)
            errs.append(check(torch, f"probe {name} vs plain", probe.fused_score_forward_probe(
                xr, packed, vecs, name), want, rows, tol=tol))
        out[name] = {"max_abs_err": max(errs), "tol": tol, "ms_turns": []}
    rows = x.shape[0]

    def timed(name):
        return cuda_ms(torch, lambda: probe.fused_score_forward_probe(x, packed, vecs, name), 20, 3)

    clocks = [gpu_clocks()]
    for name in probe.PROBE_VARIANTS[1:]:
        turns = [timed(v) for v in ("full", name, name, "full")]
        out["full"]["ms_turns"] += [turns[0], turns[3]]
        out[name]["ms_turns"] = turns[1:3]
        out[name]["full_minus_ms"] = (turns[0] + turns[3] - turns[1] - turns[2]) / 2
    clocks.append(gpu_clocks())
    for name in probe.PROBE_VARIANTS:
        out[name]["plain_ms"] = cuda_ms(
            torch, lambda v=name: probe.fused_score_forward_probe_reference(x, packed, vecs, v),
            3, 1)
    if sk.launch_counts["fused_score_forward"] or split.launch_counts["fused_score_forward_split"]:
        fail("the probe kernels' launches reached kernel #1's or kernel #2's counters")
    bound_ms, bound_by, _ = bound(x, packed, vecs, rows)
    traffic_ms = layer_traffic_ms(sk, x, packed, vecs, rows)
    out["full"]["full_minus_ms"] = 0.0
    for name in probe.PROBE_VARIANTS:
        e = out[name]
        e["ms"] = sum(e["ms_turns"]) / len(e["ms_turns"])
        e.update(bound_share=bound_ms / e["ms"], traffic_floor_share=traffic_ms / e["ms"])
        log(f"probe {name} {rows}x1024: {e['ms']:.4f} ms (turns "
            f"{' / '.join(f'{t:.4f}' for t in e['ms_turns'])}), {e['bound_share']:.3f} of the "
            f"{bound_by} bound {bound_ms:.4f} ms, {e['traffic_floor_share']:.3f} of the "
            f"per-layer traffic floor {traffic_ms:.4f} ms; full - {name} = "
            f"{e['full_minus_ms']:+.4f} ms (beside it in the same turns); plain version "
            f"{e['plain_ms']:.3f} ms")
    log(f"clocks.sm, power.draw, temperature.gpu before and after the timed turns: {clocks}")
    first = out["full"]["ms_turns"][0]
    log(f"probe full, first turn {first:.4f} ms (mean of its turns {out['full']['ms']:.4f}) "
        f"against phase_kernel's kernel #1 {kernel_ms:.4f} ms ({first / kernel_ms - 1:+.2%}; "
        f"limit {PROBE_FULL_SHARE:.0%})")
    if not abs(first / kernel_ms - 1) <= PROBE_FULL_SHARE:
        fail(f"probe full {first} ms is not within {PROBE_FULL_SHARE:.0%} of kernel #1's "
             f"{kernel_ms} ms")
    stream = operand_stream_bytes(sk, rows, packed.w_pre.shape[1], x.shape[1])
    log(f"operand tiles kernel #1 asks of L2 a forward, by count: {stream / 1e9:.3f} GB, "
        f"{stream / out['full']['ms'] / 1e9:.2f} TB/s at full's mean time, "
        f"{stream / out['dense_only']['ms'] / 1e9:.2f} TB/s at dense_only's")

    iters = PROBE_BENCH_ITERS
    probe.reset_launch_counts()
    res, counts = counted(sk, split, f"tools.bench_kernel --probe --iters {iters}",
                          lambda: bench_kernel.main(["--probe", "--iters", str(iters)]))
    # the kernel in both GroupNorm modes, then each variant: one warm-up step
    # and `iters` timed ones
    want = {"fused_score_forward": 2 * (iters + 1), "fused_score_forward_split": 0}
    want_probe = {name: iters + 1 for name in probe.PROBE_VARIANTS}
    log(f"tools.bench_kernel --probe: launches of the probe kernels {probe.launch_counts}")
    if counts != want or probe.launch_counts != want_probe:
        fail(f"bench_kernel --probe launches {counts}, {probe.launch_counts}; want {want}, "
             f"{want_probe}")
    if sk.path_launches != {"wgmma": 2 * (iters + 1), "wmma": 0}:
        fail(f"bench_kernel --probe ran kernel #1's paths {sk.path_launches}")
    for name in probe.PROBE_VARIANTS:
        out[name]["launches"] = probe.launch_counts[name]
        out[name]["bench_kernel_ms"] = res[f"probe {name}"]
    return {"variants": out, "bound_ms": bound_ms, "bound_by": bound_by,
            "layer_traffic_floor_ms": traffic_ms, "rows": rows, "build_s": lib.build_seconds,
            "blocks_per_sm": blocks, "sass_instructions": {str(k): v for k, v in probed.items()},
            "kernel_1_ms_same_run": kernel_ms, "full_first_turn_ms": first,
            "launch_counts": dict(probe.launch_counts), "clocks": clocks,
            "operand_stream_bytes": stream}


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

    # where a request's time goes: IPO alone on the same folded rows, as the
    # requests ran it (its compiled scan, captured by the first request)
    from zedo_tpu_torch.zeroshot.ipo import run_ipo

    s, n = clusters.shape[0], px.shape[0]
    cl = torch.from_numpy(clusters).to(dev)
    pose0 = (cl - cl[:, :1])[:, None].expand(s, n, 17, 3).reshape(s * n, 17, 3)
    kp = torch.from_numpy(px).to(dev).repeat(s, 1, 1)
    kk = torch.from_numpy(k).to(dev).repeat(s, 1, 1)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    run_ipo(pose0, kp, kk, est.zcfg.ipo, n_groups=s, compiled=True)
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


def timed(torch, fn):
    """(fn(), host seconds from a synchronized start to the end of the
    device's work)."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def profiled(torch, fn):
    """fn() under torch.profiler: (wall s, device busy s, host dispatches by
    call): the kernel launches (cudaLaunchKernel, cuLaunchKernel and their
    Ex forms) and graph launches that the host made."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        _, wall = timed(torch, fn)
    events = prof.key_averages()
    busy = sum(e.self_device_time_total for e in events
               if e.device_type == torch.autograd.DeviceType.CUDA) / 1e6
    return wall, busy, {e.key: e.count for e in events if e.key in HOST_DISPATCHES}


@contextlib.contextmanager
def eager_solves():
    """The entry points' compiled solves swapped for their eager oracles
    (pipeline.solve_jit -> solve, infant.solve_infant_jit -> solve_infant):
    an entry point's eager run, to hold its compiled run to."""
    from zedo_tpu_torch.zeroshot import infant, pipeline

    saved = pipeline.solve_jit, infant.solve_infant_jit
    pipeline.solve_jit, infant.solve_infant_jit = pipeline.solve, infant.solve_infant
    try:
        yield
    finally:
        pipeline.solve_jit, infant.solve_infant_jit = saved


def same_solve(torch, got, want) -> bool:
    """Two SolveResults bit for bit (the trace too, where there is one)."""
    if (got.reproj_px is None) != (want.reproj_px is None):
        return False
    return (torch.equal(got.poses, want.poses) and torch.equal(got.translations,
                                                               want.translations)
            and (got.reproj_px is None or torch.equal(got.reproj_px, want.reproj_px)))


def dispatch_line(wall, busy, dispatches) -> str:
    return (f"{sum(dispatches.values())} host dispatches ({dispatches}), device busy "
            f"{busy:.3f} s of {wall:.3f} s = {busy / wall:.3f}")


def phase_compiled(torch, sk, split, tsm, presets, bench, ZeDOEstimator, card, dev):
    """The compiled solve (pipeline.solve_jit, infant.solve_infant_jit: the
    IPO and OIL steps captured as CUDA graphs and replayed) against the eager
    solve that runs the same scan bodies in a Python loop, at the published
    width with seeded weights: (a) 886 x 50 through pipeline, in turns
    (eager, first call, replay, eager), each bit-equal to the first eager
    run, then the compiled solve profiled; (b) bench (its first call
    captures anew), its poses' checksum equal to the eager solve's; (c)
    predict at the serving buckets (256 x 5 = 1,280 rows on the full
    schedule, 32 x 5 = 160 on the low-latency one), eager and compiled
    requests in turns, bit-equal, p50 of each, the compiled requests and the
    low-latency eager one profiled; (d) the infant solve on MINI-RGBD-like
    frames, 2,000 x 20 on the plain prior (kernel #1) and 2,000 x 1 on each
    adapter (the ControlNet adapter on kernel #3, the conditional model on
    the generic path, its draws from the caller's generator, which stands
    after the compiled solve where the eager one leaves it); (e)
    solve_sharded at world size 1 over NCCL against (a)'s eager poses.
    Kernel #1's and kernel #3's launches are counted from the replays: 1000
    a solve on each kernel's path, 0 elsewhere."""
    from zedo_tpu_torch.data.base import normalize_data
    from zedo_tpu_torch.models import control_mlp, score_mlp_cond
    from zedo_tpu_torch.ops.kernels import control_kernel as ck
    from zedo_tpu_torch.utils import compiled
    from zedo_tpu_torch.utils.profiling import Stopwatch
    from zedo_tpu_torch.zeroshot import infant, pipeline

    parts = {}  # seconds of each part of the phase
    t_part = time.perf_counter()
    result = {"card": card, "part_s": parts}
    preset = presets.h36m()
    cfg = preset.model_cfg
    params = to_bf16(torch, tsm.init_params(torch.Generator().manual_seed(0), cfg, device=dev))
    px, conf, k, clusters = bench.build_inputs(HEADLINE_N, HEADLINE_S)
    inputs = [torch.from_numpy(a).to(dev) for a in (clusters, px, conf, k)]
    compiled.clear_cache()

    def solve(fn, forwards, call, *args, control=0, **kw):
        """(result, seconds, IPO s, OIL s) of one solve; its kernel #1
        forwards and its kernel #3 forwards (`control`) checked."""
        sw = Stopwatch()
        sk.reset_launch_counts()
        ck.reset_launch_counts()
        with torch.no_grad():
            out, secs = timed(torch, lambda: call(fn, *args, stopwatch=sw, **kw))
        if sk.launch_counts["fused_score_forward"] != forwards:
            fail(f"compiled phase: {fn.__name__} launched kernel #1 "
                 f"{sk.launch_counts['fused_score_forward']} times, want {forwards}")
        if ck.launch_counts["fused_control_forward"] != control:
            fail(f"compiled phase: {fn.__name__} launched kernel #3 "
                 f"{ck.launch_counts['fused_control_forward']} times, want {control}")
        return out, {"s": secs, "ipo_s": sw.totals["ipo"], "oil_s": sw.totals["oil"]}

    def adult(fn, **kw):
        return fn(params, cfg, preset.sde, preset.sampler, preset.zcfg, *inputs, **kw)

    # (a) 886 x 50 in turns
    runs = {"eager": [], "first": [], "replay": []}
    outs = []
    for mode in ("eager", "first", "replay", "eager"):
        fn = pipeline.solve if mode == "eager" else pipeline.solve_jit
        out, t = solve(fn, 1000, lambda f, **kw: adult(f, **kw))
        runs[mode].append(t)
        outs.append((mode, out))
    want = outs[0][1]
    for mode, out in outs[1:]:
        if not same_solve(torch, out, want):
            fail(f"compiled phase, {HEADLINE_N} x {HEADLINE_S}: the {mode} run is not "
                 f"bit-equal to the eager solve (max |diff| "
                 f"{(out.poses - want.poses).abs().max().item()})")
    # the compiled solve profiled; the eager solve's dispatches are (c)'s
    # low-latency eager request's at 5x its steps (a trace of its ~200,000
    # events takes a minute to read)
    with torch.no_grad():
        prof = {"compiled": profiled(torch, lambda: adult(pipeline.solve_jit))}

    def fmt(t):
        return f"{t['s']:.3f} s (IPO {t['ipo_s']:.3f}, OIL {t['oil_s']:.3f})"

    log(f"compiled solve {HEADLINE_N} x {HEADLINE_S} on {card}: eager "
        f"{', '.join(fmt(t) for t in runs['eager'])}; solve_jit first call (warm-up and "
        f"capture) {fmt(runs['first'][0])}, replay {fmt(runs['replay'][0])}; kernel #1 "
        f"1000 forwards a solve, counted from the replays; bit-equal to the eager solve")
    for mode, p in prof.items():
        log(f"  profiled {mode} solve: {dispatch_line(*p)}")
    result["h36m"] = {**runs, "bitwise": True,
                      **{f"{mode}_profile": {"wall_s": p[0], "busy_s": p[1],
                                             "dispatches": sum(p[2].values()),
                                             "by_call": p[2]} for mode, p in prof.items()}}
    parts["h36m"] = time.perf_counter() - t_part
    t_part = time.perf_counter()

    # (b) bench, its first call capturing anew
    compiled.clear_cache()
    headline, counts = counted(sk, split, f"bench --n {HEADLINE_N} --s {HEADLINE_S}",
                               lambda: bench.main([]))
    checksum = float(want.poses.cpu().sum())
    extras = headline["extras"]
    if counts != {"fused_score_forward": 2000, "fused_score_forward_split": 0} \
            or extras["poses_checksum"] != checksum:
        fail(f"bench through solve_jit: launches {counts}, poses checksum "
             f"{extras['poses_checksum']} against the eager solve's {checksum}")
    log(f"bench {HEADLINE_N} x {HEADLINE_S} through solve_jit on {card}: first call (warm-up "
        f"and capture) {extras['compile_plus_first_run_s']} s, replay {headline['value']} s "
        f"(IPO {extras['ipo_s']}, OIL {extras['oil_s']}); poses checksum {checksum!r} equal to "
        f"the eager solve's")
    result["bench"] = {"first_s": extras["compile_plus_first_run_s"], "replay_s": headline["value"],
                       "ipo_s": extras["ipo_s"], "oil_s": extras["oil_s"]}
    parts["bench"] = time.perf_counter() - t_part
    t_part = time.perf_counter()

    # (c) the serving buckets
    result["serving"] = {}
    for bucket, schedule in zip(SERVING_BUCKETS, ("full", "low_latency")):
        est = ZeDOEstimator(params=params, model_cfg=cfg, sde=preset.sde, sampler=preset.sampler,
                            zcfg=preset.zcfg, clusters=clusters[:SERVING_HYPO], device=dev,
                            batch_bucket=bucket)
        if schedule == "low_latency":
            est = est.low_latency()
        forwards = est.zcfg.oil.iterations

        def predict():
            return est.predict(px[:bucket], k[:bucket], confidence=conf[:bucket])

        def request(eager):
            sk.reset_launch_counts()
            with contextlib.ExitStack() as stack:
                if eager:
                    stack.enter_context(eager_solves())
                out, secs = timed(torch, predict)
            if sk.launch_counts["fused_score_forward"] != forwards:
                fail(f"serving bucket {bucket}: kernel #1 launched "
                     f"{sk.launch_counts['fused_score_forward']} times, want {forwards}")
            return out, secs

        got, first = request(False)
        eager_s, jit_s = [], []
        for _ in range(COMPILED_REPS):
            want_r, secs = request(True)
            eager_s.append(secs)
            got_r, secs = request(False)
            jit_s.append(secs)
            for key, value in want_r.items():
                if not (np.array_equal(got[key], value) and np.array_equal(got_r[key], value)):
                    fail(f"serving bucket {bucket} ({schedule}): compiled {key} not bit-equal "
                         f"to the eager request's")
        if schedule == "low_latency":
            # the full schedule's eager request dispatches what (a)'s eager
            # solve does; its profile alone takes a minute to read
            with eager_solves():
                prof_e = profiled(torch, predict)
        prof_j = profiled(torch, predict)
        rows = bucket * SERVING_HYPO
        log(f"serving bucket {bucket} x {SERVING_HYPO} = {rows} rows, {schedule} schedule, on "
            f"{card}: request p50 eager {np.median(eager_s) * 1e3:.1f} ms {eager_s}, compiled "
            f"{np.median(jit_s) * 1e3:.1f} ms {jit_s} (first call, with capture, {first:.3f} "
            f"s); bit-equal; kernel #1 {forwards} forwards a request")
        if schedule == "low_latency":
            log(f"  profiled eager request: {dispatch_line(*prof_e)}")
        log(f"  profiled compiled request: {dispatch_line(*prof_j)}")
        result["serving"][rows] = {
            "schedule": schedule, "eager_s": eager_s, "compiled_s": jit_s, "first_s": first,
            "p50_eager_s": float(np.median(eager_s)), "p50_compiled_s": float(np.median(jit_s)),
            "compiled_dispatches": sum(prof_j[2].values()), "compiled_busy": prof_j[1] / prof_j[0]}
        if schedule == "low_latency":
            result["serving"][rows].update(eager_dispatches=sum(prof_e[2].values()),
                                           eager_busy=prof_e[1] / prof_e[0])
        parts[f"serving_{rows}"] = time.perf_counter() - t_part
        t_part = time.perf_counter()

    # (d) the infant solve: the plain prior and both adapters
    mini = presets.from_optim_config(presets.optim_config("mini"))
    mcfg = mini.model_cfg
    zcfg = dataclasses.replace(mini.zcfg, oil=dataclasses.replace(mini.zcfg.oil,
                                                                   track_reproj=True))
    _, _, ipx, ik = infant_oil_inputs(torch, dev, MINI_FRAMES, 4)
    cam = infant_scenes(np.random.RandomState(5), INFANT_HYPO, 17, 1.0)
    iclusters = torch.from_numpy(cam - cam[:, :1]).to(dev)
    condition = torch.from_numpy(normalize_data(ipx.cpu().numpy())).to(dev)
    result["infant"] = {}
    for name, module, hypo, cond, forwards, forwards3 in (
            ("plain", tsm, INFANT_HYPO, None, 1000, 0), ("control", control_mlp, 1, None, 0, 1000),
            ("cond", score_mlp_cond, 1, condition, 0, 0)):
        # the adapters' replays (~450,000 kernels) are profiled for one
        # adapter: reading the trace takes half a minute
        iparams = to_bf16(torch, module.init_params(torch.Generator().manual_seed(0), mcfg,
                                                    device=dev))

        def infant_solve(fn, generator, **kw):
            return fn(iparams, module.apply, mcfg, mini.sde, mini.sampler, zcfg,
                      iclusters[:hypo], ipx, ik, pelvis_mode="joint0", refine_t_from=950,
                      generator=generator, condition=cond, **kw)

        times, states, outs = {}, [], []
        for mode, fn in (("eager", infant.solve_infant), ("first", infant.solve_infant_jit),
                         ("replay", infant.solve_infant_jit)):
            gen = torch.Generator(dev).manual_seed(0)
            out, times[mode] = solve(fn, forwards, infant_solve, gen, control=forwards3)
            outs.append(out)
            states.append(gen.get_state())
        same = all(same_solve(torch, o, outs[0]) for o in outs[1:])
        same_gen = all(torch.equal(s, states[0]) for s in states[1:])
        if not (same and same_gen):
            fail(f"compiled infant solve ({name}): bit-equal {same}, generator after the "
                 f"call where eager leaves it {same_gen}")
        log(f"compiled infant solve, {name}, {MINI_FRAMES} x {hypo} on {card}: eager "
            f"{fmt(times['eager'])}, first call {fmt(times['first'])}, replay "
            f"{fmt(times['replay'])}; kernel #1 {forwards} and kernel #3 {forwards3} forwards a "
            f"solve; bit-equal, the generator where eager leaves it")
        result["infant"][name] = {**times, "rows": MINI_FRAMES * hypo,
                                  "kernel_3_forwards": forwards3}
        if name != "cond":
            with torch.no_grad():
                prof_j = profiled(torch, lambda: infant_solve(
                    infant.solve_infant_jit, torch.Generator(dev).manual_seed(0)))
            log(f"  profiled replay: {dispatch_line(*prof_j)}")
            result["infant"][name].update(compiled_dispatches=sum(prof_j[2].values()),
                                          compiled_busy=prof_j[1] / prof_j[0])
        parts[f"infant_{name}"] = time.perf_counter() - t_part
        t_part = time.perf_counter()

    # (e) solve_sharded at world size 1 over NCCL
    import torch.distributed as dist

    from zedo_tpu_torch.parallel import mesh as mesh_lib
    from zedo_tpu_torch.parallel import multiprocess_check

    mesh_lib.init_distributed(backend="nccl", rank=0, world_size=1, device="cuda:0",
                              init_method=f"tcp://localhost:{multiprocess_check.free_port()}")
    try:
        mesh = mesh_lib.default_mesh(device=dev)
        secs = []
        for _ in range(2):
            out, t = solve(pipeline.solve_sharded, 1000, lambda f, **kw: f(
                mesh, params, cfg, preset.sde, preset.sampler, preset.zcfg, inputs[0], px,
                conf, k, **kw))
            secs.append(t)
            if not same_solve(torch, out, want):
                fail("solve_sharded at world size 1 over NCCL is not bit-equal to the eager "
                     "solve")
    finally:
        dist.destroy_process_group()
    log(f"solve_sharded {HEADLINE_N} x {HEADLINE_S} at world size 1 over NCCL on {card}: "
        f"{', '.join(fmt(t) for t in secs)}; bit-equal to the eager solve")
    result["sharded_world_1"] = secs
    parts["sharded"] = time.perf_counter() - t_part
    log(f"phase compiled solve, seconds by part: {parts}")
    compiled.clear_cache()
    return result


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
    return result, poses


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
    bf16 weights as under --dtype auto, kept off kernel #3 by use_kernel=False)
    on `rows` rows for `steps` steps under torch.profiler: (wall s, device busy
    s, CUDA launches a step)."""
    from torch.profiler import ProfilerActivity, profile

    from zedo_tpu_torch import presets
    from zedo_tpu_torch.models import control_mlp
    from zedo_tpu_torch.zeroshot import oil

    preset = presets.from_optim_config(presets.optim_config("mini"))
    params = to_bf16(torch, control_mlp.init_params(torch.Generator().manual_seed(0),
                                                    preset.model_cfg, device=dev))
    args = infant_oil_inputs(torch, dev, rows, 2)
    cfg = dataclasses.replace(preset.zcfg.oil, iterations=steps, track_reproj=True,
                              use_kernel=False)

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
    at --hypo 1 (kernel #3 and the generic path, no kernel #1); (d) the trained fixture as
    MINI-RGBD frames in fp32 and bf16 against the JAX CLI's MPJPE. Kernel
    #3's launches are counted in each CLI run: 1000 under --control."""
    from zedo_tpu_torch.models import control_mlp, score_mlp_cond
    from zedo_tpu_torch.ops.kernels import control_kernel as ck

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
                forwards3 = 1000 if flags == ["--control"] else 0
                argv = ["--config", config, "--hypo", str(hypo), "--dtype", "auto", *flags,
                        "--ckpt_dir", "checkpoint", "--ckpt_name", f"{ckpt}.pth"]
                if config == "mini":
                    argv += ["--cluster_path", f"mini_cluster_{INFANT_HYPO}.npy"]
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                name = f"run.opt_main_infant {' '.join(argv[:6 + len(flags)])}"
                ck.reset_launch_counts()
                out = cli_launches(sk, split, name, forwards,
                                   lambda: opt_main_infant.main(argv))
                wall = time.perf_counter() - t0
                launches3 = ck.launch_counts["fused_control_forward"]
                if launches3 != forwards3:
                    fail(f"{name}: kernel #3 launched {launches3} times, want {forwards3}")
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
                    f"{wall:.3f} s; kernel #1 launches {out['kernel_1_launches']}, kernel #3 "
                    f"{launches3}; trace "
                    f"{trace.mean(0)[0]:.2f} -> {trace.mean(0)[-1]:.2f} px (random weights)")
                result[key] = {"rows": n * hypo, "solve_s": out["solve_s"], "ipo_s": out["ipo_s"],
                               "oil_s": out["oil_s"], "eval_s": out["eval_s"], "wall_s": wall,
                               "poses_per_s": rate, "kernel_1_launches": out["kernel_1_launches"],
                               "kernel_3_launches": launches3}
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


# the training phase: MINI-RGBD at the mini config's own batch of 5,000 rows,
# 20,000 training frames (4 steps an epoch) and 1,024 validation frames (the
# eval metrics' cap); the sampling phase at H36M's eval batch of 10,000 rows
TRAIN_FRAMES, TRAIN_VAL_FRAMES, TRAIN_BATCH = 20000, 1024, 5000
SAMPLE_GEN, SAMPLE_ODE, SAMPLE_GUIDE = 10000, 1024, 1024
BENCH_TRAIN_ROWS, BENCH_TRAIN_STEPS = 50000, 20


def flat_params(tree):
    """{state_dict name: leaf} of a params dict, detached."""
    from zedo_tpu_torch.models.nn import tree_to_flat

    return {k: v.detach() for k, v in tree_to_flat(tree).items()}


def phase_training(torch, sk, split, tsm, card):
    """The training path at the published width (hidden 1024, embed 512, 2
    blocks, dropout 0.1), each entry point with the launch counts set to 0
    before it and checked after it (the training path launches neither
    kernel): run.train_pose_mini --config mini on a synthetic MINI-RGBD
    workspace for 2 epochs in fp32 and in bf16 (finite losses, parameters
    and EMA moved, an eval epoch with sampling and the micro solve), a
    resume from the fp32 run's checkpoint at its epoch and step, the
    checkpoint through run.sample and run.opt_main_infant (kernel #1 on
    every OIL forward), --model control fine-tuned from it (trunk and frozen
    leaves bit-equal, adapter leaves moved), --model cond; then
    tools.bench_train at 50,000 rows."""
    from zedo_tpu_torch.models import control_mlp
    from zedo_tpu_torch.run import opt_main_infant, sample, train_pose_mini
    from zedo_tpu_torch.tools import bench_train
    from zedo_tpu_torch.utils.checkpoint import load_torch_checkpoint

    result = {}
    cwd = os.getcwd()
    with tempfile.TemporaryDirectory() as root:
        os.chdir(root)
        try:
            write_mini_workspace(root, np.random.RandomState(3), TRAIN_VAL_FRAMES,
                                 n_train=TRAIN_FRAMES)
            cfg = tsm.ScoreMLPConfig(dropout=0.1)
            init = flat_params(tsm.init_params(torch.Generator().manual_seed(42), cfg,
                                               device="cpu"))

            def train(name, *flags):
                argv = ["--config", "mini", "--epochs", "2", "--log_name", name, "--override",
                        f"OUTPUT_DIR={root}/output", *flags]
                t0 = time.perf_counter()
                out, counts = counted(sk, split, f"run.train_pose_mini {' '.join(flags)}",
                                      lambda: train_pose_mini.main(argv))
                wall = time.perf_counter() - t0
                if any(counts.values()):
                    fail(f"train {name}: kernel launches {counts} on the training path")
                hist = np.asarray(out["history"])
                if not np.isfinite(hist).all():
                    fail(f"train {name}: losses {hist}")
                log(f"train {name} on {card}: {out['state'].step} steps of {TRAIN_BATCH} rows, "
                    f"losses by epoch {hist.tolist()}, eval {out['eval_history']}, CLI "
                    f"wall-clock {wall:.3f} s")
                result[name] = {"steps": out["state"].step, "losses": hist.tolist(),
                                "eval": out["eval_history"], "wall_s": wall}
                return out

            runs = {}
            for dtype in ("fp32", "bf16"):
                out = runs[dtype] = train(dtype, "--compute_dtype", dtype)
                if out["state"].step != 2 * TRAIN_FRAMES // TRAIN_BATCH:
                    fail(f"train {dtype}: {out['state'].step} steps")
                ev = out["eval_history"][0]
                if not (np.isfinite(ev["prior_mahalanobis"])
                        and np.isfinite(ev["zeroshot_mpjpe_mm"])):
                    fail(f"train {dtype}: eval {ev}")
                for label, tree in (("params", out["state"].params),
                                    ("EMA", out["state"].ema.shadow_params)):
                    now = flat_params(tree)
                    if all(torch.equal(now[k].cpu(), init[k]) for k in init if k != "sigmas"):
                        fail(f"train {dtype}: the {label} did not move")
            ckpt_dir = runs["fp32"]["output_dir"]
            ckpt = os.path.join(ckpt_dir, "checkpoint_0.pth")
            if not os.path.exists(ckpt):
                fail(f"no checkpoint {ckpt}")
            resumed = train("resumed", "--restore_dir", ckpt)
            full = runs["fp32"]["state"]
            if resumed["state"].step != full.step or len(resumed["history"]) != 1:
                fail(f"resume: step {resumed['state'].step}, epochs {len(resumed['history'])}")
            a, b = flat_params(resumed["state"].params), flat_params(full.params)
            diff = max((a[k] - b[k]).abs().max().item() for k in b)
            log(f"resume from {ckpt} at epoch 1, step {full.step // 2}: its final parameters "
                f"{diff:.3g} from the uninterrupted run's (max abs)")
            if not diff <= 1e-4:
                fail(f"resume: parameters {diff} from the uninterrupted run's")
            result["resume_max_abs_diff"] = diff

            out, counts = counted(sk, split, "run.sample on the trained checkpoint", lambda: (
                sample.main(["--config", "mini", "--ckpt_dir", ckpt_dir, "--ckpt_name",
                             "checkpoint_0.pth", "--num", str(SAMPLE_ODE), "--ema",
                             "--save", "trained_samples.npy"])))
            if any(counts.values()) or not torch.isfinite(out["samples"]).all():
                fail(f"run.sample on the trained checkpoint: launches {counts}")
            out = cli_launches(sk, split, "run.opt_main_infant on the trained checkpoint", 1000,
                               lambda: opt_main_infant.main(["--config", "mini", "--ckpt_dir",
                                                             ckpt_dir, "--ckpt_name",
                                                             "checkpoint_0.pth", "--hypo", "1"]))
            if not np.isfinite(out["mpjpe"]):
                fail(f"run.opt_main_infant on the trained checkpoint: MPJPE {out['mpjpe']}")
            log(f"trained checkpoint through run.opt_main_infant: MPJPE {out['mpjpe'] * 1000:.3f} "
                f"mm on {TRAIN_VAL_FRAMES} frames, solve {out['solve_s']:.3f} s")

            control = train("control", "--model", "control", "--fine_tune", "--fine_tune_ckpt",
                            ckpt, "--epochs", "1")
            trunk = flat_params(load_torch_checkpoint(ckpt, cfg)["params"])
            tuned = flat_params(control["state"].params)
            cinit = flat_params(control_mlp.init_params(torch.Generator().manual_seed(42), cfg,
                                                        device="cpu"))
            moved, frozen = [], 0
            for name, value in tuned.items():
                if not ("copy" in name or "zc" in name or name == "infant_cond"):
                    if not torch.equal(value, trunk[name]):
                        fail(f"control: frozen leaf {name} moved")
                    frozen += 1
                    continue
                # a copy leaf starts as its trunk leaf, the others as drawn
                start = trunk[name.replace("_copy", "")] if "_copy" in name \
                    else cinit[name].to(value.device)
                if not torch.equal(value, start):
                    moved.append(name)
            log(f"control: {frozen} frozen leaves bit-equal to the checkpoint's trunk, "
                f"{len(moved)} of {len(tuned) - frozen} adapter leaves moved (dense2_copy and "
                f"the last block's gnorm2_copy feed no output)")
            must = [n for n in tuned if n.startswith("zc") or n == "infant_cond"
                    or n.startswith("pre_dense_copy")]
            if not set(must) <= set(moved):
                fail(f"control: adapter leaves {sorted(set(must) - set(moved))} did not move")
            result["control"].update(frozen_bit_equal=frozen, adapter_moved=len(moved))
            train("cond", "--model", "cond", "--epochs", "1")
        finally:
            os.chdir(cwd)
    records, counts = counted(sk, split, f"tools.bench_train --rows {BENCH_TRAIN_ROWS}",
                              lambda: bench_train.main(["--rows", str(BENCH_TRAIN_ROWS),
                                                        "--steps", str(BENCH_TRAIN_STEPS)]))
    if any(counts.values()):
        fail(f"bench_train: kernel launches {counts}")
    for r in records:
        busy = r["device_busy_share"]
        log(f"bench_train {r['dtype']} on {card}: {r['ms_per_step']:.3f} ms a step of "
            f"{r['rows']} rows, {r['rows_per_s']:.0f} rows/s, device busy "
            f"{'not measured' if busy is None else f'{busy:.3f}'} of a step")
    result["bench_train"] = records
    return result


def phase_sampling(torch, sk, split, tsm, card):
    """run.sample on seeded hidden-1024 weights (the h36m config, full
    1000-step schedule), each run with the launch counts set to 0 before it
    and checked after it (no kernel): --task gen at the config's
    eval.batch_size of 10,000; comp3d --jlist 14,15,16 on those samples (the
    known joints end at the condition's marginal mean at eps) and den;
    --sampler ode at 1,024 (its NFE); --guide sym and --guide match."""
    from zedo_tpu_torch.run import sample

    result = {}
    with tempfile.TemporaryDirectory() as root:
        save_pth(torch, tsm.init_params(torch.Generator().manual_seed(0), tsm.ScoreMLPConfig(),
                                        device="cpu"), os.path.join(root, "seeded.pth"))

        def run(name, n, *flags):
            argv = ["--config", "h36m", "--ckpt_dir", root, "--ckpt_name", "seeded.pth",
                    "--save", os.path.join(root, f"{name}.npy"), *flags]
            out, counts = counted(sk, split, f"run.sample {' '.join(flags)}",
                                  lambda: sample.main(argv))
            samples = out["samples"]
            if any(counts.values()) or tuple(samples.shape) != (n, 17, 3) \
                    or not torch.isfinite(samples).all():
                fail(f"run.sample {name}: launches {counts}, shape {tuple(samples.shape)}")
            log(f"run.sample {name} on {card}: {n} samples in {out['seconds']:.3f} s "
                f"({n / out['seconds']:.1f} samples/s)"
                + (f", nfe {out['nfe']}" if out["nfe"] is not None else ""))
            result[name] = {"n": n, "s": out["seconds"], "samples_per_s": n / out["seconds"],
                            "nfe": out["nfe"]}
            return samples

        gen = run("gen", SAMPLE_GEN, "--task", "gen", "--num", str(SAMPLE_GEN))
        poses = gen.cpu().numpy()
        np.save(os.path.join(root, "poses.npy"), poses)
        comp = run("comp3d", SAMPLE_GEN, "--task", "comp3d", "--jlist", "14,15,16", "--input",
                   os.path.join(root, "poses.npy")).cpu().numpy()
        # the known joints end at the condition's sub-VP marginal mean at
        # t = eps = 1e-3: the condition times exp(-(eps^2 (20 - 0.1) / 4 + eps 0.1 / 2))
        known = [j for j in range(17) if j not in (14, 15, 16)]
        want = poses[:, known] * np.exp(-(0.25 * 1e-6 * 19.9 + 0.5 * 1e-3 * 0.1))
        err = np.abs(comp[:, known] - want).max() / max(1.0, np.abs(want).max())
        log(f"comp3d: the known joints end {err:.3g} from the condition's marginal mean at "
            f"eps (max abs, relative to the largest coordinate)")
        if not err <= 1e-5:
            fail(f"comp3d: known joints {err} from the condition's marginal mean")
        result["comp3d"]["known_rel_err"] = float(err)
        run("den", SAMPLE_GEN, "--task", "den", "--input", os.path.join(root, "poses.npy"))
        run("ode", SAMPLE_ODE, "--sampler", "ode", "--num", str(SAMPLE_ODE))
        run("guide_sym", SAMPLE_GUIDE, "--num", str(SAMPLE_GUIDE), "--guide", "sym")
        np.save(os.path.join(root, "targets.npy"), poses[:SAMPLE_GUIDE, :, :2])
        run("guide_match", SAMPLE_GUIDE, "--num", str(SAMPLE_GUIDE), "--guide", "match",
            "--guide_input", os.path.join(root, "targets.npy"))
    return result


# phase_compiled_programs: K train steps of each mode at the mini config's
# batch and bench_train's (published width, dropout 0.1), in fp32 and bf16,
# and at make_trained_fixture's shape (hidden 256, embed 128, positional
# embedding, no dropout, 512 rows); the sampler's shortened `gen`, then the
# full schedule guided and with comp3d imputation; the ODE; the evaluation
# at 886 x 50; predict at the serving buckets
PROGRAM_TRAIN = ((5000, "fp32", 1024), (5000, "bf16", 1024), (50000, "fp32", 1024),
                 (50000, "bf16", 1024), (512, "fp32", 256))
PROGRAM_TRAIN_STEPS = 20
PROGRAM_GEN_STEPS, PROGRAM_FULL_STEPS = 100, 1000
# predict's p50 (ms) at the serving buckets on an H100 at 700 W with the
# solve compiled and the rank-and-pack eager (phase 5b of an earlier run)
SERVING_P50_BEFORE_MS = {1280: 214.5, 160: 49.7}


@contextlib.contextmanager
def eager_programs():
    """The compiled programs of this phase's entry points swapped for their
    eager oracles: the evaluation's hypothesis errors and serving's
    rank-and-pack (the solve stays compiled)."""
    from zedo_tpu_torch import serving
    from zedo_tpu_torch.data import evaluation

    saved = evaluation._hypothesis_errors_jit, serving._rank_and_pack_jit
    evaluation._hypothesis_errors_jit = evaluation._hypothesis_errors
    serving._rank_and_pack_jit = serving._rank_and_pack
    try:
        yield
    finally:
        evaluation._hypothesis_errors_jit, serving._rank_and_pack_jit = saved


def same_train_state(torch, a, b) -> bool:
    """Params, EMA (shadows and count), Adam's moments and step counts and the
    host step, bit for bit."""
    if a.step != b.step or not torch.equal(a.ema.num_updates, b.ema.num_updates):
        return False
    for tree_a, tree_b in ((a.params, b.params), (a.ema.shadow_params, b.ema.shadow_params)):
        fa, fb = flat_params(tree_a), flat_params(tree_b)
        if any(not torch.equal(fa[k], fb[k]) for k in fa):
            return False
    for (_, pa), (_, pb) in zip(a.leaves(), b.leaves()):
        sa, sb = a.opt_state.state.get(pa, {}), b.opt_state.state.get(pb, {})
        if sa.keys() != sb.keys() or any(not torch.equal(sa[k], sb[k]) for k in sa):
            return False
    return True


def phase_compiled_programs(torch, sk, split, tsm, card, dev):
    """The JAX package's remaining compiled programs (diffusion/losses.py's
    train step, PCSampler.sample_loop_jit, ODESampler.sample_jit, the
    evaluation's _hypothesis_errors_jit, serving's _rank_and_pack_jit: CUDA
    graphs of utils/compiled.py) against their eager oracles, in turns from
    the same state and seeds, each bit-equal: (a) PROGRAM_TRAIN_STEPS train
    steps at 5,000 and 50,000 rows in fp32 and bf16 and at the fixture
    tool's 512 rows of hidden 256, then as many again in the other order,
    ms a step, the compiled first call, host dispatches and busy share of a
    step; (b) sample_loop: `gen` at 10,000 rows for 100 steps, then at 1,024
    rows the full 1000 steps with --guide sym and with comp3d imputation, ms
    a step, host dispatches and busy share of a call; (c) the probability
    flow ODE at 1,024 rows, samples and NFE, seconds and host reads a call;
    (d) multi_hypothesis_eval at 886 x 50, P1 and P2; (e) predict at the
    serving buckets, its packed outputs against an eager rank-and-pack, p50
    beside SERVING_P50_BEFORE_MS. No kernel is launched but by (e)'s solves."""
    from zedo_tpu_torch import presets
    from zedo_tpu_torch.data import evaluation
    from zedo_tpu_torch.diffusion import losses as losses_lib
    from zedo_tpu_torch.diffusion.guidance import get_sym_gradient_fn
    from zedo_tpu_torch.diffusion.ode import ODESampler
    from zedo_tpu_torch.diffusion.sampling import PCSampler, make_task_mask
    from zedo_tpu_torch.diffusion.score import get_score_fn
    from zedo_tpu_torch.diffusion.sde import build_sde
    from zedo_tpu_torch.serving import ZeDOEstimator
    from zedo_tpu_torch.presets import Config
    from zedo_tpu_torch.utils import compiled

    result = {"card": card, "train": {}, "sampling": {}}
    parts = {}
    t_part = time.perf_counter()
    sk.reset_launch_counts()
    split.reset_launch_counts()

    # (a) the train step
    optimizer = losses_lib.get_optimizer(Config(optim=Config(
        optimizer="Adam", lr=2e-4, beta1=0.9, eps=1e-8, warmup=5000, grad_clip=1.0,
        weight_decay=0)))
    sde = build_sde("subvpsde", n=1000, t_max=1.0)
    for rows, dtype, hidden in PROGRAM_TRAIN:
        if hidden == 1024:
            cfg = tsm.ScoreMLPConfig(dropout=0.1)
        else:
            cfg = tsm.ScoreMLPConfig(hidden_dim=256, embed_dim=128, embedding_type="positional",
                                     dropout=0.0)

        def model(p, x, labels, cond, msk, train=False, generator=None, cfg=cfg):
            return tsm.apply(p, cfg, x, labels, cond, msk, train=train, generator=generator)

        apply = losses_lib.mixed_precision_apply(model) if dtype == "bf16" else model
        steps = {mode: losses_lib.get_step_fn(sde, apply, optimizer, train=True, reduce_mean=True,
                                              compiled=mode == "compiled")
                 for mode in ("eager", "compiled")}
        params = tsm.init_params(torch.Generator().manual_seed(0), cfg, device=dev)
        states = {mode: losses_lib.init_train_state(params, optimizer, 0.9999)
                  for mode in steps}
        batch = torch.from_numpy(np.random.RandomState(rows).randn(rows, 17, 3).astype(
            np.float32) * 0.3).to(dev)
        done = {"eager": 0, "compiled": 0}
        losses = {"eager": [], "compiled": []}

        def run(mode, k):
            for _ in range(k):
                gen = torch.Generator(dev).manual_seed(1000 + done[mode])
                _, loss = steps[mode](states[mode], gen, batch)
                losses[mode].append(loss)
                done[mode] += 1

        compiled.clear_cache()
        _, first = timed(torch, lambda: run("compiled", 1))
        run("eager", 1)
        ms = {"eager": [], "compiled": []}
        for mode in ("eager", "compiled", "compiled", "eager"):
            _, secs = timed(torch, lambda: run(mode, PROGRAM_TRAIN_STEPS))
            ms[mode].append(secs / PROGRAM_TRAIN_STEPS * 1e3)
        same_losses = all(torch.equal(a, b) for a, b in zip(losses["eager"], losses["compiled"]))
        if not (same_losses and same_train_state(torch, states["eager"], states["compiled"])):
            fail(f"compiled train step {rows} rows {dtype} hidden {hidden}: not bit-equal to the "
                 f"eager step after {done['eager']} steps (losses equal {same_losses})")
        prof = {mode: profiled(torch, lambda mode=mode: run(mode, 3)) for mode in steps}
        key = f"{rows}_{dtype}_h{hidden}"
        result["train"][key] = {
            "ms_eager": ms["eager"], "ms_compiled": ms["compiled"], "first_call_s": first,
            "steps": done["compiled"], "loss": float(losses["compiled"][-1]),
            **{f"{mode}_dispatches_per_step": sum(p[2].values()) / 3 for mode, p in prof.items()},
            **{f"{mode}_busy": p[1] / p[0] for mode, p in prof.items()}}
        r = result["train"][key]
        log(f"compiled train step, {rows} rows {dtype} hidden {hidden}, on {card}: "
            f"{done['compiled']} steps each way, bit-equal (losses, params, Adam, EMA); ms a "
            f"step eager {ms['eager']}, compiled {ms['compiled']} (first call, with capture, "
            f"{first:.3f} s); host dispatches a step {r['eager_dispatches_per_step']:.0f} eager, "
            f"{r['compiled_dispatches_per_step']:.0f} compiled; busy {r['eager_busy']:.3f} "
            f"eager, {r['compiled_busy']:.3f} compiled")
        del states, steps
        compiled.clear_cache()
        torch.cuda.empty_cache()
    parts["train"] = time.perf_counter() - t_part
    t_part = time.perf_counter()

    # (b) sample_loop and (c) the ODE, on seeded published-width weights
    config = presets.optim_config("h36m")
    cfg = tsm.ScoreMLPConfig()
    params = tsm.init_params(torch.Generator().manual_seed(0), cfg, device=dev)
    full_sde = build_sde(config.training.sde, n=config.model.num_scales, t_max=1.0)

    def score_for(sde):
        """The eager oracles' score: get_score_fn over the same weights."""
        return get_score_fn(sde, lambda x, l, c, m: tsm.apply(params, cfg, x, l, c, m),
                            continuous=True)

    def sampler_for(n):
        s = config.sampling
        return PCSampler(sde=dataclasses.replace(full_sde, n=n), predictor=s.predictor.lower(),
                         corrector=s.corrector.lower(), snr=s.snr, n_steps=s.n_steps_each,
                         probability_flow=False, continuous=True, denoise=s.noise_removal,
                         eps=1e-3)

    rs = np.random.RandomState(11)
    cond = torch.from_numpy(rs.randn(SAMPLE_GUIDE, 17, 3).astype(np.float32) * 0.3).to(dev)
    mask = torch.from_numpy(make_task_mask("comp3d", (SAMPLE_GUIDE, 17, 3),
                                           jlist="14,15,16")).to(dev)
    cases = (("gen", SAMPLE_GEN, PROGRAM_GEN_STEPS, {}),
             ("guide_sym", SAMPLE_GUIDE, PROGRAM_FULL_STEPS,
              {"guidance_fn": get_sym_gradient_fn(1.0)}),
             ("comp3d", SAMPLE_GUIDE, PROGRAM_FULL_STEPS, {"condition": cond, "mask": mask}))
    for name, rows, n, kw in cases:
        sampler = sampler_for(n)
        shape = (rows, 17, 3)

        def sample(mode, sampler=sampler, shape=shape, kw=kw):
            gen = torch.Generator(dev).manual_seed(21)
            with torch.no_grad():
                if mode == "eager":
                    out = sampler.sample_loop(score_for(sampler.sde), gen, shape, **kw)
                else:
                    out = sampler.sample_loop_jit(tsm.apply, params, cfg, gen, shape, **kw)
            return out, gen.get_state()

        compiled.clear_cache()
        (got, state), first = timed(torch, lambda: sample("compiled"))
        secs = {"eager": [], "compiled": []}
        # the full schedule's eager loop takes 4-8 s: one turn each way there
        turns = (("eager", "compiled", "compiled", "eager") if n == PROGRAM_GEN_STEPS
                 else ("eager", "compiled"))
        for mode in turns:
            (out, out_state), s = timed(torch, lambda mode=mode: sample(mode))
            secs[mode].append(s)
            if not (torch.equal(out, got) and torch.equal(out_state, state)):
                fail(f"compiled sample_loop {name}: the {mode} run is not bit-equal to the first "
                     f"compiled call (or leaves the generator elsewhere)")
        if not torch.isfinite(got).all():
            fail(f"compiled sample_loop {name}: non-finite samples")
        # the eager loop's trace at 1000 guided steps (~10^5 events) takes a
        # minute to read: the eager dispatches are profiled at `gen` only
        prof = {"compiled": profiled(torch, lambda: sample("compiled"))}
        if name == "gen":
            prof["eager"] = profiled(torch, lambda: sample("eager"))
        r = result["sampling"][name] = {
            "rows": rows, "steps": n, "first_call_s": first,
            **{f"ms_per_step_{mode}": [s / n * 1e3 for s in v] for mode, v in secs.items()},
            **{f"{mode}_dispatches": sum(p[2].values()) for mode, p in prof.items()},
            **{f"{mode}_busy": p[1] / p[0] for mode, p in prof.items()}}
        log(f"compiled sample_loop {name}, {rows} rows x {n} steps, on {card}: bit-equal, the "
            f"generator where eager leaves it; ms a step eager "
            f"{[round(v, 4) for v in r['ms_per_step_eager']]}, compiled "
            f"{[round(v, 4) for v in r['ms_per_step_compiled']]} (first call {first:.3f} s); "
            + "; ".join(f"profiled {mode} call: {dispatch_line(*p)}" for mode, p in prof.items()))
    parts["sampling"] = time.perf_counter() - t_part
    t_part = time.perf_counter()

    ode = ODESampler(sde=full_sde, shape=(SAMPLE_ODE, 17, 3), denoise=True, eps=1e-3)
    z = torch.randn(ode.shape, generator=torch.Generator(dev).manual_seed(31), device=dev)

    def integrate(mode):
        before = compiled.host_reads()
        with torch.no_grad():
            if mode == "eager":
                out = ode.sample(score_for(full_sde), z=z)
            else:
                out = ode.sample_jit(tsm.apply, params, cfg, z=z)
        return out, compiled.host_reads() - before

    compiled.clear_cache()
    ((want, nfe), _), first = timed(torch, lambda: integrate("compiled"))
    secs, reads = {"eager": [], "compiled": []}, {}
    for mode in ("eager", "compiled"):
        ((x, x_nfe), reads[mode]), s = timed(torch, lambda mode=mode: integrate(mode))
        secs[mode].append(s)
        if not (torch.equal(x, want) and x_nfe == nfe):
            fail(f"compiled ODE: the {mode} run is not bit-equal (NFE {x_nfe} against {nfe})")
    result["ode"] = {"rows": SAMPLE_ODE, "nfe": nfe, "first_call_s": first, "s": secs,
                     "condition_reads": reads, "host_reads_per_call": reads["compiled"] + 1}
    log(f"compiled ODE, {SAMPLE_ODE} rows, on {card}: NFE {nfe} each way, bit-equal; s eager "
        f"{secs['eager']}, compiled {secs['compiled']} (first call {first:.3f} s); host reads a "
        f"call {reads['eager'] + 1} eager, {reads['compiled'] + 1} compiled (one a chunk of "
        f"steps, and the NFE; the eager loop before this slice read one a step: "
        f"{(nfe - 1) // 7})")
    parts["ode"] = time.perf_counter() - t_part
    t_part = time.perf_counter()

    # (d) the evaluation at 886 x 50
    rs = np.random.RandomState(41)
    gt = (rs.randn(HEADLINE_N, 17, 3) * 0.3).astype(np.float32)
    gt -= gt[:, :1]
    preds = torch.from_numpy((gt[:, None] + rs.randn(HEADLINE_N, HEADLINE_S, 17, 3) * 0.05)
                             .astype(np.float32)).to(dev)
    actions = np.arange(HEADLINE_N) % 15 + 2
    reports = {}
    secs = {"eager": [], "compiled": []}
    for mode in ("compiled", "eager", "compiled", "compiled", "eager"):
        with contextlib.ExitStack() as stack:
            if mode == "eager":
                stack.enter_context(eager_programs())
            out, s = timed(torch, lambda: [evaluation.multi_hypothesis_eval(
                preds, gt, protocol2=p2, actions=actions) for p2 in (False, True)])
        secs[mode].append(s)
        reports.setdefault(mode, out)
        for a, b in zip(out, reports["compiled"]):
            if not (a.error == b.error and np.array_equal(a.per_sample_min, b.per_sample_min)
                    and np.array_equal(a.min_hypothesis, b.min_hypothesis)):
                fail(f"compiled evaluation at {HEADLINE_N} x {HEADLINE_S}: the {mode} run's "
                     f"P1/P2 are not bit-equal")
    p1, p2 = (r.error for r in reports["compiled"])
    result["evaluation"] = {"s_eager": secs["eager"], "s_compiled": secs["compiled"][1:],
                            "first_call_s": secs["compiled"][0], "p1": p1, "p2": p2}
    log(f"compiled evaluation, {HEADLINE_N} x {HEADLINE_S}, on {card}: P1 {p1 * 1000:.4f} mm, "
        f"P2 {p2 * 1000:.4f} mm, bit-equal each way (the SVD between the two graphs); s (P1 and "
        f"P2) eager {secs['eager']}, compiled {secs['compiled'][1:]} (first call "
        f"{secs['compiled'][0]:.3f} s)")
    if any(sk.launch_counts.values()) or any(split.launch_counts.values()):
        fail(f"phase compiled programs: kernels launched before predict: {sk.launch_counts}, "
             f"{split.launch_counts}")
    parts["evaluation"] = time.perf_counter() - t_part
    t_part = time.perf_counter()

    # (e) predict at the serving buckets
    from zedo_tpu_torch import bench as bench_lib

    preset = presets.h36m()
    bparams = to_bf16(torch, params)
    px, conf, k, clusters = bench_lib.build_inputs(SERVING_BUCKETS[0], SERVING_HYPO)
    result["serving"] = {}
    for bucket, schedule in zip(SERVING_BUCKETS, ("full", "low_latency")):
        est = ZeDOEstimator(params=bparams, model_cfg=cfg, sde=preset.sde, sampler=preset.sampler,
                            zcfg=preset.zcfg, clusters=clusters, device=dev,
                            batch_bucket=bucket)
        if schedule == "low_latency":
            est = est.low_latency()

        def predict(est=est, bucket=bucket):
            return est.predict(px[:bucket], k[:bucket], confidence=conf[:bucket])

        want, first = timed(torch, predict)
        secs = {"eager": [], "compiled": []}
        for _ in range(COMPILED_REPS):
            for mode in ("eager", "compiled"):
                with contextlib.ExitStack() as stack:
                    if mode == "eager":
                        stack.enter_context(eager_programs())
                    out, s = timed(torch, predict)
                secs[mode].append(s)
                for key, value in want.items():
                    if not np.array_equal(out[key], value):
                        fail(f"predict at bucket {bucket}: the {mode} rank-and-pack's {key} is "
                             f"not bit-equal")
        rows = bucket * SERVING_HYPO
        p50 = {mode: float(np.median(v)) * 1e3 for mode, v in secs.items()}
        result["serving"][rows] = {"schedule": schedule, "s": secs, "first_s": first,
                                   "p50_ms": p50, "p50_before_ms": SERVING_P50_BEFORE_MS[rows]}
        log(f"predict at {bucket} x {SERVING_HYPO} = {rows} rows ({schedule}) on {card}: packed "
            f"outputs bit-equal to an eager rank-and-pack; p50 {p50['compiled']:.1f} ms compiled "
            f"rank-and-pack, {p50['eager']:.1f} ms eager (before: "
            f"{SERVING_P50_BEFORE_MS[rows]} ms)")
    compiled.clear_cache()
    parts["serving"] = time.perf_counter() - t_part
    result["part_s"] = parts
    log(f"phase compiled programs, seconds by part: {parts}")
    return result


# the multi-GPU phase: two ranks share the one card over Gloo
MULTI_RANKS = 2
SERVE_POSES = 64
MULTI_TIMEOUT_S = 600
# max |mesh - one device| (m) of the trained fixture's predict (bf16, kernel
# #1 at hidden 256): the sharded solve differs from the whole batch's only
# in IPO's loss, a mean over each rank's own rows (as in JAX's shard_map),
# which puts Adam's eps at another weight. With random weights at full width
# the solve is chaotic (a random prior throws poses metres away): there the
# distance is printed, each rank's rows held bit-identical to `solve` on its
# block instead.
WHOLE_BATCH_TOL_M = 1e-3
# the mesh's training against one device, with the learning rate's warmup
# off so that 4 steps move the parameters (the mini config's warmup of 5,000
# steps keeps them within ~2e-7): the epoch's mean loss at f32 rounding, and
# each leaf's update (its change from the seeded initial value) within 1e-2
# of --mesh off's, in L2 norm. The norm and not the largest element: Adam's
# m / sqrt(v) turns the rounding of a gradient that cancels to ~eps into a
# fraction of the learning rate on the few elements where it does. An
# unchanged state scores 1 on every leaf.
TRAIN_LOSS_RTOL, TRAIN_UPDATE_RTOL = 1e-4, 1e-2
TRAIN_OVERRIDES = ("optim.warmup=0",)
MULTI_TRAIN_SPECS = ("dp2", "dp1,tp2")


def train_overrides(root: str) -> list:
    return [a for o in (f"OUTPUT_DIR={root}/output", *TRAIN_OVERRIDES) for a in ("--override", o)]


def train_initial_params(torch, overrides=TRAIN_OVERRIDES):
    """{name: leaf} on the CPU of the seeded state run.train_pose_mini
    --config mini with these overrides starts from (train.trainer.train_loop's
    init)."""
    from zedo_tpu_torch.models import score_mlp
    from zedo_tpu_torch.models.registry import make_mlp_config
    from zedo_tpu_torch.run import train_pose_mini
    from zedo_tpu_torch.utils.config import apply_overrides

    config = apply_overrides(train_pose_mini.load_config("mini", train_pose_mini.PRESETS),
                             list(overrides))
    cfg = make_mlp_config(config, n_joints=config.DATASET.NUM_JOINT)
    return flat_params(score_mlp.init_params(torch.Generator().manual_seed(config.seed), cfg,
                                             device="cpu"))


def train_update_errors(init: dict, got: dict, want: dict) -> dict:
    """{leaf: ||(got - init) - (want - init)|| / ||want - init||} (L2 norms;
    0 where both updates are 0, inf where only `got`'s is)."""
    errs = {}
    for name, w0 in init.items():
        d_want = want[name].float() - w0.float()
        miss = float((got[name].float() - w0.float() - d_want).double().norm())
        ref = float(d_want.double().norm())
        errs[name] = miss / ref if ref > 0 else (0.0 if miss == 0 else float("inf"))
    return errs


def multigpu_inputs():
    """(adult request, infant request) of the multi-GPU phase: the 886 x 50
    H36M-scale request and 2,000 MINI-RGBD-like frames x 20 hypotheses."""
    from zedo_tpu_torch import bench
    from zedo_tpu_torch.data.mini_rgbd import mini_intrinsics

    rng = np.random.RandomState(0)
    cam = infant_scenes(rng, MINI_FRAMES, 17, 1.0)
    k = mini_intrinsics()
    rel = cam[0] - cam[0, :1]
    clusters = (rel[None] + rng.randn(INFANT_HYPO, 17, 3) * 0.01).astype(np.float32)
    infant = (pinhole(cam, k), np.tile(k, (MINI_FRAMES, 1, 1)).astype(np.float32), clusters)
    return bench.build_inputs(HEADLINE_N, HEADLINE_S), infant


def multigpu_weights(torch, tsm, dev):
    return to_bf16(torch, tsm.init_params(torch.Generator().manual_seed(0), tsm.ScoreMLPConfig(),
                                          device=dev))


def fixture_estimator(tbt, presets, ZeDOEstimator, dev, mesh=None):
    """phase_accuracy's bf16 estimator of the trained fixture, on `mesh`."""
    family = np.load(os.path.join(tbt.FIXTURE, "family.npz"))
    preset = presets.h36m(hidden_dim=int(family["hidden"]), embed_dim=int(family["embed"]))
    return ZeDOEstimator.from_torch_checkpoint(
        tbt.CHECKPOINT, tbt.CLUSTERS, preset=preset, dtype="bf16", batch_bucket=8, device=dev,
        mesh=mesh).with_schedule(FIXTURE_OIL, ipo_iterations=FIXTURE_IPO)


def multigpu_rank(root: str) -> int:
    """One rank of the two-rank run on cuda:0 over Gloo (started by
    phase_multigpu with torchrun's environment): the sharded solves, the
    serving mesh and the training CLI on meshes; each solve's rows against
    `solve` on the rank's block alone, bit for bit. Writes rank<r>.npz and
    rank<r>.json under root."""
    import dataclasses as dc

    import torch
    import torch.distributed as dist

    sys.path.insert(0, REPO)
    from zedo_tpu_torch import bench_trained as tbt
    from zedo_tpu_torch import presets
    from zedo_tpu_torch.models import score_mlp as tsm
    from zedo_tpu_torch.ops.kernels import score_kernel as sk
    from zedo_tpu_torch.parallel import mesh as mesh_lib
    from zedo_tpu_torch.parallel import tensor_parallel as tp_lib
    from zedo_tpu_torch.run import train_pose_mini
    from zedo_tpu_torch.serving import ZeDOEstimator
    from zedo_tpu_torch.zeroshot import infant, pipeline

    dev = mesh_lib.init_distributed(backend="gloo", device="cuda:0")
    rank = dist.get_rank()
    mesh = mesh_lib.default_mesh(device=dev)
    arrays, rec = {}, {}
    preset = presets.h36m()
    cfg = preset.model_cfg
    params = multigpu_weights(torch, tsm, dev)
    (px, conf, k, clusters), (ipx, ik, iclusters) = multigpu_inputs()

    def put(a):
        return torch.from_numpy(a).to(dev)

    with torch.no_grad():
        rows = mesh.row_slice(HEADLINE_N)
        for tag, track in (("solve", False), ("trace", True)):
            zcfg = dc.replace(preset.zcfg, oil=dc.replace(preset.zcfg.oil, track_reproj=track))
            sk.reset_launch_counts()
            res, secs = timed(torch, lambda: pipeline.solve_sharded(
                mesh, params, cfg, preset.sde, preset.sampler, zcfg, put(clusters), px, conf, k))
            launches = sk.launch_counts["fused_score_forward"]
            alone = pipeline.solve(params, cfg, preset.sde, preset.sampler, zcfg, put(clusters),
                                   put(px[rows]), put(conf[rows]), put(k[rows]))
            rec[tag] = {"s": secs, "launches": launches,
                        "bitwise": bool(torch.equal(res.poses[rows], alone.poses)
                                        and torch.equal(res.translations[rows],
                                                        alone.translations))}
            arrays[f"{tag}_poses"] = res.poses.cpu().numpy()
            if track:
                arrays["trace"] = res.reproj_px.cpu().numpy()
                arrays["trace_alone"] = alone.reproj_px.cpu().numpy()

        mini = presets.from_optim_config(presets.optim_config("mini"))
        izcfg = dc.replace(mini.zcfg, oil=dc.replace(mini.zcfg.oil, track_reproj=True))
        rows = mesh.row_slice(MINI_FRAMES)
        sk.reset_launch_counts()
        res, secs = timed(torch, lambda: infant.solve_infant_sharded(
            mesh, params, tsm.apply, mini.model_cfg, mini.sde, mini.sampler, izcfg,
            put(iclusters), ipx, ik))
        launches = sk.launch_counts["fused_score_forward"]
        alone = infant.solve_infant(params, tsm.apply, mini.model_cfg, mini.sde, mini.sampler,
                                    izcfg, put(iclusters), put(ipx[rows]), put(ik[rows]))
        rec["infant"] = {"s": secs, "launches": launches,
                         "bitwise": bool(torch.equal(res.poses[rows], alone.poses))}
        arrays["infant_poses"] = res.poses.cpu().numpy()

        est = ZeDOEstimator(params=params, model_cfg=cfg, sde=preset.sde, sampler=preset.sampler,
                            zcfg=preset.zcfg, clusters=clusters, device=dev, batch_bucket=2,
                            mesh="dp2")
        sk.reset_launch_counts()
        out, secs = timed(torch, lambda: est.predict(px[:SERVE_POSES], k[:SERVE_POSES],
                                              confidence=conf[:SERVE_POSES]))
        rec["serve"] = {"s": secs, "launches": sk.launch_counts["fused_score_forward"]}
        arrays["serve_poses"], arrays["serve_best"] = out["poses"], out["best"]
        _, fk, fpx = tbt.make_scenes(np.load(os.path.join(tbt.FIXTURE, "family.npz")),
                                     FIXTURE_SCENES)
        arrays["fixture_poses"] = fixture_estimator(tbt, presets, ZeDOEstimator, dev,
                                                    "dp2").predict(fpx, fk)["poses"]

    for spec in MULTI_TRAIN_SPECS:
        argv = ["--config", "mini", "--epochs", "1", "--log_name", f"mesh_{spec}",
                *train_overrides(root), "--mesh", spec, "--device", "cuda:0"]
        out, secs = timed(torch, lambda: train_pose_mini.main(argv))
        rec[f"train_{spec}"] = {"s": secs, "steps": out["state"].step,
                                "losses": list(out["history"]), "output_dir": out["output_dir"]}
        # each rank's own leaves that both ranks must hold bit for bit: dp2's
        # whole replicas, and under tp the replicated leaves
        for name, leaf in flat_params(out["state"].params).items():
            if spec == "dp2" or tp_lib.expected_rule(name) == "replicated":
                arrays[f"train_{spec}/{name}"] = leaf.cpu().numpy()
    np.savez(os.path.join(root, f"rank{rank}.npz"), **arrays)
    with open(os.path.join(root, f"rank{rank}.json"), "w") as f:
        json.dump(rec, f)
    dist.destroy_process_group()
    return 0


def phase_multigpu(torch, sk, tsm, card):
    """The multi-GPU path on the one card, at the published width with seeded
    weights and the full schedule: (a) world size 1 over NCCL, in this
    process: pipeline.solve_sharded at 886 x 50, bit-identical to
    pipeline.solve, kernel #1 on all 1000 OIL forwards; (b) two ranks
    spawned on cuda:0 over Gloo (torchrun's environment, multigpu_rank):
    solve_sharded at 886 x 50 without and with the reprojection trace,
    solve_infant_sharded on 2,000 MINI-RGBD frames x 20, each rank's rows
    bit-identical to `solve` on its block and kernel #1 on all 1000 OIL
    forwards of each rank; ZeDOEstimator(mesh="dp2").predict on a 64-pose
    request against one device; run.train_pose_mini --config mini --mesh
    dp2 and --mesh dp1,tp2, 4 steps at the mini batch of 5,000 with the
    warmup off, against --mesh off (the loss, each leaf's update from the
    seeded start; dp2's replicas and tp's replicated leaves bit-identical
    on both ranks). The
    seconds of each run are two ranks sharing one card, not a scaling
    number."""
    import torch.distributed as dist

    from zedo_tpu_torch import presets
    from zedo_tpu_torch.parallel import mesh as mesh_lib
    from zedo_tpu_torch.parallel import multiprocess_check
    from zedo_tpu_torch.run import train_pose_mini
    from zedo_tpu_torch.serving import ZeDOEstimator
    from zedo_tpu_torch.utils.checkpoint import restore_native
    from zedo_tpu_torch.zeroshot import pipeline

    result = {"note": "two ranks sharing one card: not a scaling number", "card": card}
    preset = presets.h36m()
    cfg = preset.model_cfg
    (px, conf, k, clusters), (ipx, ik, iclusters) = multigpu_inputs()
    dev = mesh_lib.init_distributed(backend="nccl", rank=0, world_size=1, device="cuda:0",
                                    init_method=f"tcp://localhost:{multiprocess_check.free_port()}")
    params = multigpu_weights(torch, tsm, dev)

    def put(a):
        return torch.from_numpy(a).to(dev)

    try:
        mesh = mesh_lib.default_mesh(device=dev)
        with torch.no_grad():
            sk.reset_launch_counts()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            res = pipeline.solve_sharded(mesh, params, cfg, preset.sde, preset.sampler,
                                         preset.zcfg, put(clusters), px, conf, k)
            torch.cuda.synchronize()
            secs = time.perf_counter() - t0
            launches = sk.launch_counts["fused_score_forward"]
            whole = pipeline.solve(params, cfg, preset.sde, preset.sampler, preset.zcfg,
                                   put(clusters), put(px), put(conf), put(k))
    finally:
        dist.destroy_process_group()
    same = torch.equal(res.poses, whole.poses) and torch.equal(res.translations,
                                                               whole.translations)
    log(f"multi-GPU, world size 1 over NCCL on {card}: solve_sharded {HEADLINE_N} x "
        f"{HEADLINE_S} in {secs:.3f} s, kernel #1 launches {launches}, bit-identical to "
        f"pipeline.solve: {same}")
    if launches != 1000 or not same:
        fail(f"world size 1 over NCCL: launches {launches}, bit-identical {same}")
    result["nccl_world_1"] = {"s": secs, "launches": launches, "bitwise": same}
    whole_poses = whole.poses.cpu().numpy()

    with tempfile.TemporaryDirectory() as root:
        write_mini_workspace(root, np.random.RandomState(3), TRAIN_VAL_FRAMES,
                             n_train=TRAIN_FRAMES)
        t0 = time.perf_counter()
        multiprocess_check.run_ranks([os.path.abspath(__file__), "--multigpu-rank", root],
                                     MULTI_RANKS, timeout=MULTI_TIMEOUT_S, cwd=root)
        wall = time.perf_counter() - t0
        arrays = [dict(np.load(os.path.join(root, f"rank{r}.npz"))) for r in range(MULTI_RANKS)]
        recs = []
        for r in range(MULTI_RANKS):
            with open(os.path.join(root, f"rank{r}.json")) as f:
                recs.append(json.load(f))
        log(f"multi-GPU, {MULTI_RANKS} ranks on cuda:0 over Gloo (sharing one card) on {card}: "
            f"{wall:.1f} s for the ranks' run, processes included")
        for key in arrays[0]:
            if key != "trace_alone" and not np.array_equal(arrays[0][key], arrays[1][key]):
                fail(f"multi-GPU: the ranks hold different {key}")
        for tag, n in (("solve", 1000), ("trace", 1000), ("infant", 1000)):
            for r, rec in enumerate(recs):
                log(f"  rank {r} {tag}: {rec[tag]['s']:.3f} s (two ranks sharing one card), "
                    f"kernel #1 launches {rec[tag]['launches']}, rows bit-identical to "
                    f"solve on its block: {rec[tag]['bitwise']}")
                if rec[tag]["launches"] != n or not rec[tag]["bitwise"]:
                    fail(f"multi-GPU {tag} rank {r}: {rec[tag]}")
        per_pose = np.abs(arrays[0]["solve_poses"] - whole_poses).max(axis=(2, 3))
        diff = float(per_pose.max())
        log(f"  solve_sharded on 2 ranks against the whole batch solved at once (random "
            f"weights, chaotic): max |diff| {diff:.3g} m, median {np.median(per_pose):.3g} m, "
            f"{(per_pose <= 1e-3).mean():.3f} of the poses within 1 mm")
        trace_err = float(np.abs(arrays[0]["trace"] - (arrays[0]["trace_alone"]
                                                       + arrays[1]["trace_alone"]) / 2).max())
        log(f"  trace: max |mean over ranks - mean of the blocks' traces solved alone| "
            f"{trace_err:.3g} px (of {float(np.abs(arrays[0]['trace']).max()):.3g})")
        if not trace_err <= 1e-5 * max(1.0, float(np.abs(arrays[0]["trace"]).max())):
            fail(f"multi-GPU trace: {trace_err}")
        if arrays[0]["infant_poses"].shape != (MINI_FRAMES, INFANT_HYPO, 17, 3) \
                or not np.isfinite(arrays[0]["infant_poses"]).all():
            fail(f"multi-GPU infant poses {arrays[0]['infant_poses'].shape}")

        with torch.no_grad():
            est = ZeDOEstimator(params=params, model_cfg=cfg, sde=preset.sde,
                                sampler=preset.sampler, zcfg=preset.zcfg, clusters=clusters,
                                device=dev, batch_bucket=2)
            single = est.predict(px[:SERVE_POSES], k[:SERVE_POSES],
                                 confidence=conf[:SERVE_POSES])
        serve_diff = float(np.abs(arrays[0]["serve_poses"] - single["poses"]).max())
        best_same = float((arrays[0]["serve_best"] == single["best"]).mean())
        log(f"  ZeDOEstimator(mesh='dp2').predict, {SERVE_POSES} poses x {HEADLINE_S}: "
            f"{recs[0]['serve']['s']:.3f} s (two ranks sharing one card), kernel #1 launches "
            f"{[r['serve']['launches'] for r in recs]}, max |diff| {serve_diff:.3g} m from one "
            f"device (random weights), same best hypothesis for {best_same:.3f} of the poses")
        if any(r["serve"]["launches"] != 1000 for r in recs) \
                or not np.isfinite(arrays[0]["serve_poses"]).all():
            fail(f"multi-GPU serving: {[r['serve'] for r in recs]}")
        from zedo_tpu_torch import bench_trained as tbt

        gt, fk, fpx = tbt.make_scenes(np.load(os.path.join(tbt.FIXTURE, "family.npz")),
                                      FIXTURE_SCENES)
        one = fixture_estimator(tbt, presets, ZeDOEstimator, dev).predict(fpx, fk)["poses"]
        fixture_diff = float(np.abs(arrays[0]["fixture_poses"] - one).max())
        mm = tbt.best_mpjpe(arrays[0]["fixture_poses"], gt)
        ref = JAX_FIXTURE_MPJPE_MM["bf16"]
        log(f"  trained fixture through ZeDOEstimator(mesh='dp2') (bf16, kernel #1): max "
            f"|diff| {fixture_diff:.3g} m from one device (tolerance {WHOLE_BATCH_TOL_M}), "
            f"best-hypothesis MPJPE {mm:.3f} mm (JAX package {ref:.3f}, tolerance "
            f"{FIXTURE_TOL_MM})")
        if not fixture_diff <= WHOLE_BATCH_TOL_M or not abs(mm - ref) <= FIXTURE_TOL_MM:
            fail(f"multi-GPU trained fixture: {fixture_diff} m, {mm} mm")

        cwd = os.getcwd()
        os.chdir(root)
        try:
            argv = ["--config", "mini", "--epochs", "1", "--log_name", "single",
                    *train_overrides(root), "--mesh", "off"]
            t0 = time.perf_counter()
            single = train_pose_mini.main(argv)
            single_s = time.perf_counter() - t0
        finally:
            os.chdir(cwd)
        want = flat_params(restore_native(os.path.join(single["output_dir"], "checkpoint_0.pth"),
                                          "cpu")["params"])
        init = train_initial_params(torch)
        unchanged = max(train_update_errors(init, init, want).values())
        d_max = max(float((want[n] - init[n]).abs().max()) for n in init)
        log(f"  run.train_pose_mini --mesh off ({', '.join(TRAIN_OVERRIDES)}): "
            f"{single['state'].step} steps, losses {single['history']}, {single_s:.3f} s, "
            f"largest update {d_max:.3g}; an unchanged state's update error {unchanged:.3g} "
            f"(tolerance {TRAIN_UPDATE_RTOL})")
        if not unchanged > TRAIN_UPDATE_RTOL:
            fail(f"multi-GPU training: the update check passes an unchanged state ({unchanged})")
        for spec in MULTI_TRAIN_SPECS:
            rec = recs[0][f"train_{spec}"]
            got = flat_params(restore_native(os.path.join(rec["output_dir"], "checkpoint_0.pth"),
                                             "cpu")["params"])
            errs = train_update_errors(init, got, want)
            worst_leaf = max(errs, key=errs.get)
            elem = max(float(((got[n] - init[n]) - (want[n] - init[n])).abs().max())
                       for n in init)
            loss_err = abs(rec["losses"][0] - single["history"][0]) / abs(single["history"][0])
            log(f"  run.train_pose_mini --mesh {spec}: {rec['steps']} steps of {TRAIN_BATCH} "
                f"rows in {rec['s']:.3f} s (two ranks sharing one card), loss "
                f"{rec['losses']} ({loss_err:.3g} relative from --mesh off), update error "
                f"{errs[worst_leaf]:.3g} at most ({worst_leaf}; tolerance {TRAIN_UPDATE_RTOL}), "
                f"largest element's update {elem:.3g} from --mesh off's")
            if rec["steps"] != TRAIN_FRAMES // TRAIN_BATCH or not loss_err <= TRAIN_LOSS_RTOL \
                    or not errs[worst_leaf] <= TRAIN_UPDATE_RTOL:
                fail(f"multi-GPU training --mesh {spec}: {rec}, update error {errs}")
            result[f"train_{spec}"] = {"s": rec["s"], "losses": rec["losses"],
                                       "loss_rel_err": loss_err,
                                       "update_err": errs[worst_leaf],
                                       "update_max_abs_diff": elem}
        result.update(train_single_s=single_s, train_single_losses=list(single["history"]),
                      train_largest_update=d_max, train_unchanged_update_err=unchanged)
        for spec in MULTI_TRAIN_SPECS:
            if not any(k.startswith(f"train_{spec}/") for k in arrays[0]):
                fail(f"multi-GPU training --mesh {spec}: no replicated leaves saved")
    for tag in ("solve", "trace", "infant", "serve"):
        result[tag] = [r[tag] for r in recs]
    result.update(ranks_wall_s=wall, whole_batch_max_diff_m=diff, trace_err_px=trace_err,
                  serve_max_diff_m=serve_diff, serve_best_same=best_same,
                  fixture_max_diff_m=fixture_diff, fixture_mpjpe_mm=mm)
    return result


def kernel_at_serving_shapes(torch, sk, split, tsm, library_forward, dev):
    """Kernels #1 and #2 against their plain versions at the rows of a
    serving bucket, both GroupNorm modes; timed in the default mode, in
    turns (kernel #1, #2, #2, #1). Nothing routes a request to kernel #2:
    its times here say whether one launch would pay at these rows."""
    weights = packed_weights(torch, sk, tsm, dev)
    packed, vecs = weights["bf16"]
    gen = torch.Generator().manual_seed(13)
    out = {}
    for bucket in SERVING_BUCKETS:
        rows = bucket * SERVING_HYPO
        x = torch.randn(rows, 51, generator=gen).to(dev)
        errs, errs_split = [], []
        for gn, (p, v) in weights.items():
            sk.reset_launch_counts()
            errs.append(check(torch, f"kernel #1 gn={gn} at the serving bucket {bucket} x "
                              f"{SERVING_HYPO} vs plain", sk.fused_score_forward(x, p, v),
                              sk.fused_score_forward_reference(x, p, v), rows))
            if sk.path_launches != {"wgmma": 1, "wmma": 0}:
                fail(f"{rows} rows: paths {sk.path_launches}, want one launch on wgmma")
            errs_split.append(check(
                torch, f"kernel #2 gn={gn} at the serving bucket {bucket} x {SERVING_HYPO} vs "
                f"plain", split.fused_score_forward_split(x, p, v),
                split.fused_score_forward_split_reference(x, p, v), rows))

        def forward():
            return sk.fused_score_forward(x, packed, vecs)

        def forward_split():
            return split.fused_score_forward_split(x, packed, vecs)

        turns = [cuda_ms(torch, fn, 50, 5) for fn in (forward, forward_split, forward_split,
                                                      forward)]
        ms, ms_split = (turns[0] + turns[3]) / 2, (turns[1] + turns[2]) / 2
        plain_ms = cuda_ms(torch, lambda: sk.fused_score_forward_reference(x, packed, vecs), 10, 2)
        plain_split = cuda_ms(
            torch, lambda: split.fused_score_forward_split_reference(x, packed, vecs), 10, 2)
        lib_ms = cuda_ms(torch, lambda: library_forward(x, packed, vecs), 20, 3)
        bound_ms, bound_by, _ = bound(x, packed, vecs, rows)
        host = host_us(torch, forward)
        host_split = host_us(torch, forward_split)
        log(f"fused_score_forward at {rows} rows x 1024: kernel {ms:.4f} ms ({bound_ms / ms:.3f} "
            f"of the {bound_by} bound {bound_ms:.4f} ms), wrapper host time {host:.1f} us a "
            f"forward, plain version {plain_ms:.3f} ms, bf16 torch.matmul chain {lib_ms:.4f} ms")
        log(f"fused_score_forward_split at {rows} rows x 1024: kernel {ms_split:.4f} ms "
            f"({bound_ms / ms_split:.3f} of the bound; in turns, ms: kernel #1 {turns[0]:.4f} / "
            f"{turns[3]:.4f}, kernel #2 {turns[1]:.4f} / {turns[2]:.4f}), wrapper host time "
            f"{host_split:.1f} us a forward, plain version {plain_split:.3f} ms")
        out[f"rows_{rows}"] = {"rows": rows, "max_abs_err": max(errs), "ms": ms,
                               "plain_ms": plain_ms, "library_ms": lib_ms, "bound_ms": bound_ms,
                               "bound_by": bound_by, "host_us_per_forward": host,
                               "kernel_2": {"max_abs_err": max(errs_split), "ms": ms_split,
                                            "ms_turns": turns[1:3], "plain_ms": plain_split,
                                            "bound_ms": bound_ms, "bound_by": bound_by,
                                            "library_ms": lib_ms,
                                            "host_us_per_forward": host_split}}
    return out


def phase_rest(torch, sk, split, tsm, tbt, card, dev):
    """Phase 13: the serving latency tool, the quickstart, the fixture
    regeneration and make_clusters on the card, and kernel #1 at the
    serving shapes."""
    from zedo_tpu_torch.examples import quickstart
    from zedo_tpu_torch.tools import (bench_kernel, bench_serving, make_clusters,
                                      make_trained_fixture)
    from zedo_tpu_torch.utils.checkpoint import load_any_checkpoint

    result = {"kernel": kernel_at_serving_shapes(torch, sk, split, tsm,
                                                 bench_kernel.library_forward, dev)}
    launches = 0
    for bucket, extra in ((SERVING_BUCKETS[0], []),
                          (SERVING_BUCKETS[1], ["--oil", "200", "--ipo", "100"])):
        argv = ["--hypo", str(SERVING_HYPO), "--reps", str(BENCH_SERVING_REPS),
                "--bucket", str(bucket), *extra]
        rows, counts = counted(sk, split, "tools.bench_serving " + " ".join(argv),
                               lambda: bench_serving.main(argv))
        oil = 200 if extra else 1000
        want = (BENCH_SERVING_REPS + 1) * len(bench_serving.request_sizes(bucket)) * sum(
            math.ceil(oil / reuse) for reuse in bench_serving.REUSES)
        if counts != {"fused_score_forward": want, "fused_score_forward_split": 0}:
            fail(f"bench_serving --bucket {bucket}: launches {counts}, want {want} of kernel #1 "
                 f"(every OIL forward of every request) and none of kernel #2")
        if sk.path_launches != {"wgmma": want, "wmma": 0}:
            fail(f"bench_serving --bucket {bucket}: kernel #1's paths {sk.path_launches}")
        # the rows kernel #1 was given, as its wrapper recorded them
        if sk.row_launches != {bucket * SERVING_HYPO: want}:
            fail(f"bench_serving --bucket {bucket}: kernel #1's launches by rows "
                 f"{sk.row_launches}, want {want} at {bucket * SERVING_HYPO}")
        for r in rows:
            log(f"bench_serving on {card}: bucket {bucket}, reuse={r['reuse']} N={r['n']} "
                f"S={r['s']}: p50 {r['p50_ms']:.3f} ms, p95 {r['p95_ms']:.3f} ms, "
                f"{r['poses_per_s']:.1f} poses/s ({r['ipo_iterations']} IPO / "
                f"{r['oil_iterations']} OIL steps)")
        log(f"bench_serving --bucket {bucket}: kernel #1's launches by rows, as its wrapper "
            f"recorded them: {sk.row_launches}")
        result[f"bench_serving_bucket_{bucket}"] = rows
        result[f"row_launches_bucket_{bucket}"] = dict(sk.row_launches)
        launches += counts["fused_score_forward"]
    result["launches"] = launches

    qs, counts = counted(sk, split, "examples.quickstart", lambda: quickstart.main([]))
    for key, name in (("solved_mm", "solved"), ("serve_mm", "served")):
        ref = JAX_QUICKSTART_MM[name]
        log(f"quickstart {name} MPJPE {qs[key]:.3f} mm (JAX quickstart on the CPU {ref:.3f} mm, "
            f"tolerance {FIXTURE_TOL_MM} mm)")
        if not abs(qs[key] - ref) <= FIXTURE_TOL_MM:
            fail(f"quickstart {name} MPJPE {qs[key]} vs {ref}")
    result["quickstart"] = {**qs, "launches": counts}

    with tempfile.TemporaryDirectory() as root:
        out = os.path.join(root, "fixture")
        t0 = time.perf_counter()
        gate, counts = counted(sk, split, f"tools.make_trained_fixture --out {out}",
                               lambda: make_trained_fixture.main(["--out", out]))
        gate["wall_s"] = time.perf_counter() - t0
        fixture = tbt.FIXTURE
        for name in ("data/h36m/h36m_test.pkl", "clusters/h36m_cluster1.npy",
                     "clusters/h36m_cluster2.npy"):
            with open(os.path.join(fixture, name), "rb") as a, \
                    open(os.path.join(out, name), "rb") as b:
                if a.read() != b.read():
                    fail(f"make_trained_fixture: {name} differs from the committed file")
        committed = np.load(os.path.join(fixture, "family.npz"))
        ours = np.load(os.path.join(out, "family.npz"))
        for key in ("mu", "u", "gt"):
            if committed[key].tobytes() != ours[key].tobytes():
                fail(f"make_trained_fixture: family.npz's {key} differs from the committed one")
        cfg = make_trained_fixture.model_config()
        path = os.path.join(out, "checkpoint", "checkpoint_trained.pth")
        raw, step = load_any_checkpoint(path, cfg, device=dev)
        ema, _ = load_any_checkpoint(path, cfg, use_ema=True, device=dev)
        moved = max((raw[k]["weight"] - ema[k]["weight"]).abs().max().item()
                    for k in ("pre_dense", "post_dense"))
        if step != make_trained_fixture.TRAIN_STEPS or not moved > 0:
            fail(f"make_trained_fixture: the .pth gave step {step}, EMA distance {moved}")
        ref = float(committed["mpjpe_mm"])
        log(f"make_trained_fixture on {card}: gate MPJPE {gate['mpjpe_mm']:.3f} mm from "
            f"{gate['init_mm']:.3f} mm (the committed JAX prior {ref:.3f} mm; tolerance "
            f"{GATE_TOL_MM} mm and below {GATE_INIT_SHARE} of the init); loss "
            f"{gate['loss_first_100']:.4f} -> {gate['loss_last_100']:.4f}; training "
            f"{gate['train_s']:.1f} s, gate solve {gate['gate_s']:.1f} s, launches {counts}")
        if not (abs(gate["mpjpe_mm"] - ref) <= GATE_TOL_MM
                and gate["mpjpe_mm"] < GATE_INIT_SHARE * gate["init_mm"]):
            fail(f"make_trained_fixture: gate MPJPE {gate['mpjpe_mm']} vs {ref}")
        result["trained_fixture"] = gate

        ws = os.path.join(root, "ws")
        write_workspace(torch, tsm, ws, HEADLINE_N, HEADLINE_S, WILD_N)
        h36m = os.path.join(ws, "data", "h36m")
        os.link(os.path.join(h36m, "h36m_test.pkl"), os.path.join(h36m, "h36m_train.pkl"))
        dest = os.path.join(root, f"h36m_cluster{CLUSTERS_S}.npy")
        clusters, counts = counted(sk, split, "tools.make_clusters --dataset h36m", lambda: (
            make_clusters.main(["--dataset", "h36m", "--data_dir", os.path.join(ws, "data"),
                                dest, str(CLUSTERS_S)])))
        saved = np.load(dest)
        if saved.shape != (CLUSTERS_S, 17, 3) or not np.isfinite(saved).all() \
                or np.abs(saved[:, 0]).max() != 0:
            fail(f"make_clusters: {saved.shape}, root {np.abs(saved[:, 0]).max()}")
        log(f"make_clusters: {saved.shape} from {HEADLINE_N} poses, root joint 0")
    return result


# phase 14's wrapper config: the stock H36M file with what phase 6 passes
# as --override, set inside unlocked() as a user's wrapper does
WRAPPER_CONFIG = """import configs.optim.concat_pose_optimization_h36m as base


def get_config():
    config = base.get_config()
    with config.unlocked():
        config.ZeDO.sample = 1
    return config
"""
QUICKSTART_CONFIG = os.path.join(REPO, "examples", "quickstart_config.py")
# the generic OIL path of phase 14: the fixture's first scenes, a short
# schedule, the Langevin corrector (no fast path)
GENERIC_N, GENERIC_IPO, GENERIC_OIL = 24, 40, 50
TRACE_RTOL = 1e-5  # uniform reproj_weight against the unweighted trace


def phase_config_files(torch, sk, split, tsm, tbt, presets, ZeDOEstimator, opt_main,
                       batch_cli_poses, card, dev):
    """Phase 14: config files read as JAX's CLIs and serving read them. A
    wrapper of the stock H36M file through run.opt_main at 886 x 50 against
    phase 6's --config h36m run; the fixture's estimator from
    examples/quickstart_config.py against the preset's; the generic OIL
    path's generator and reproj_weight through solve_one_hypothesis."""
    from zedo_tpu_torch.diffusion.sampling import PCSampler
    from zedo_tpu_torch.zeroshot import pipeline

    result = {}
    with tempfile.TemporaryDirectory() as root:
        common = write_workspace(torch, tsm, os.path.join(root, "ws"), HEADLINE_N, HEADLINE_S,
                                 WILD_N)
        wrapper = os.path.join(root, "h36m_sample1.py")
        with open(wrapper, "w") as f:
            f.write(WRAPPER_CONFIG)
        argv = ["--config", wrapper, "--hypo", str(HEADLINE_S), "--gt", "--dtype", "auto",
                *common]
        out = cli_launches(sk, split, f"run.opt_main --config <wrapper of the h36m file> --hypo "
                           f"{HEADLINE_S} --gt --strict_batch --dtype auto ({HEADLINE_N} poses, "
                           "hidden 1024)", 1000, lambda: opt_main.main(argv))
    poses = out["poses"]
    diff = float((poses - batch_cli_poses).abs().max())
    log(f"config file through the batch CLI on {card}: solve {out['solve_s']:.3f} s (IPO "
        f"{out['ipo_s']:.3f}, OIL {out['oil_s']:.3f}), P1 {out['p1'] * 1000:.3f} mm; poses "
        f"bit-equal to phase 6's --config h36m run: {torch.equal(poses, batch_cli_poses)} "
        f"(max |diff| {diff:.3g} m)")
    if not torch.equal(poses, batch_cli_poses):
        fail(f"config-file CLI: poses differ from phase 6's by up to {diff} m")
    result["cli"] = {key: out[key] for key in ("kernel_1_launches", "solve_s", "ipo_s", "oil_s",
                                               "eval_s", "p1", "p2")}

    family = np.load(os.path.join(tbt.FIXTURE, "family.npz"))
    gt, k, px = tbt.make_scenes(family, FIXTURE_SCENES)
    by_preset = ZeDOEstimator.from_torch_checkpoint(
        tbt.CHECKPOINT, tbt.CLUSTERS, preset=presets.h36m(hidden_dim=256, embed_dim=128),
        dtype="bf16", batch_bucket=32, device=dev)
    by_file = ZeDOEstimator.from_torch_checkpoint(
        tbt.CHECKPOINT, tbt.CLUSTERS, config_path=QUICKSTART_CONFIG, dtype="bf16",
        batch_bucket=32, device=dev)
    if (by_file.model_cfg, by_file.zcfg) != (by_preset.model_cfg, by_preset.zcfg):
        fail(f"config_path estimator: {by_file.model_cfg}, {by_file.zcfg} against the preset's "
             f"{by_preset.model_cfg}, {by_preset.zcfg}")
    want = by_preset.predict(px, k)
    got, counts = counted(sk, split, "ZeDOEstimator(config_path=examples/quickstart_config.py)"
                          ".predict", lambda: by_file.predict(px, k))
    rows = 32 * len(by_file.clusters)
    same = all(np.array_equal(got[key], want[key]) for key in want)
    mm = tbt.best_mpjpe(got["poses"][np.arange(FIXTURE_SCENES), got["best"]][:, None], gt)
    log(f"config_path estimator (hidden {by_file.model_cfg.hidden_dim}, embed "
        f"{by_file.model_cfg.embed_dim}, {by_file.zcfg.oil.iterations} OIL steps): kernel #1's "
        f"launches by rows {sk.row_launches}; every output bit-equal to the preset estimator's: "
        f"{same}; served MPJPE {mm:.3f} mm")
    if counts != {"fused_score_forward": 1000, "fused_score_forward_split": 0} \
            or sk.row_launches != {rows: 1000} or not same:
        fail(f"config_path estimator: launches {counts}, rows {sk.row_launches}, equal {same}")
    result["serving"] = {"launches": counts["fused_score_forward"],
                         "row_launches": dict(sk.row_launches), "mpjpe_mm": mm}

    cfg, params, _ = tbt.load_fixture(dev)
    est = by_preset.with_schedule(GENERIC_OIL, ipo_iterations=GENERIC_IPO)
    sampler = PCSampler(sde=est.sde, corrector="langevin", probability_flow=True,
                        eps=est.sampler.eps)
    zcfg = dataclasses.replace(est.zcfg, oil=dataclasses.replace(est.zcfg.oil,
                                                                 track_reproj=True))
    cond2d = torch.as_tensor(px[:GENERIC_N], device=dev)
    kk = torch.as_tensor(k[:GENERIC_N], device=dev)
    cluster = torch.as_tensor(by_preset.clusters[0], device=dev)

    def solve(seed, weight=None):
        return pipeline.solve_one_hypothesis(
            params, cfg, est.sde, sampler, zcfg, cluster, cond2d, None, kk,
            generator=torch.Generator(dev).manual_seed(seed), reproj_weight=weight)

    with torch.no_grad():
        (a, b, c), counts = counted(sk, split, "solve_one_hypothesis, Langevin corrector",
                                    lambda: (solve(1), solve(1), solve(2)))
        uniform = solve(1, torch.full((GENERIC_N,), 1.0 / GENERIC_N, device=dev))
    seeds_differ = float((a.pose - c.pose).abs().max())
    trace_err = float((uniform.reproj_px - a.reproj_px).abs().max())
    scale = max(1.0, float(a.reproj_px.abs().max()))
    log(f"generic OIL path ({GENERIC_N} poses, {GENERIC_IPO} IPO / {GENERIC_OIL} OIL steps, "
        f"Langevin): seed 1 twice bit-equal: {torch.equal(a.pose, b.pose)}; seeds 1 and 2 "
        f"differ by up to {seeds_differ:.3g} m; uniform reproj_weight against the unweighted "
        f"trace {trace_err:.3g} px (trace {float(a.reproj_px[0, 0]):.3f} -> "
        f"{float(a.reproj_px[0, -1]):.3f} px; tolerance {TRACE_RTOL} x {scale:.3g}); launches "
        f"{counts}")
    if not torch.equal(a.pose, b.pose) or not seeds_differ > 0 \
            or not trace_err <= TRACE_RTOL * scale or any(counts.values()) \
            or not torch.isfinite(a.pose).all():
        fail(f"generic path: same seed equal {torch.equal(a.pose, b.pose)}, seeds differ by "
             f"{seeds_differ}, trace {trace_err}, launches {counts}")
    result["generic"] = {"seeds_max_diff_m": seeds_differ, "uniform_weight_trace_err_px":
                         trace_err}
    return result


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
        from zedo_tpu_torch.ops.kernels import control_kernel as ck
        from zedo_tpu_torch.ops.kernels import ipo_kernel as ik
        from zedo_tpu_torch.ops.kernels import score_kernel as sk
        from zedo_tpu_torch.ops.kernels import score_kernel_probe as probe
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

    blocks_per_sm, build_s = phase_build(torch, build, sk, split, ck)

    t0 = time.perf_counter()
    entry, weights, x = phase_kernel(torch, sk, tsm, bench_kernel.library_forward, dev)
    log(f"phase kernel #1: {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    entry_control = phase_control_kernel(torch, ck, dev)
    log(f"phase kernel #3: {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    entry_ipo = phase_ipo_kernel(torch, ik, dev)
    log(f"phase kernel #4: {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    entry["probe"] = phase_probe(torch, build, sk, probe, split, bench_kernel, weights, x,
                                 entry["ms"])
    # no later phase may launch a probe kernel: these counts stay to the end
    probe_launches = dict(probe.launch_counts)
    log(f"phase probe: {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    entry_split = phase_split(torch, sk, split, tsm, bench_kernel.step_ms,
                              bench_kernel.library_forward, weights, x)
    log(f"phase kernel #2: {time.perf_counter() - t0:.1f} s")
    del weights, x
    t0 = time.perf_counter()
    ik.reset_launch_counts()
    entry["launches"], walls, ipo_s, busy_s, per_forward = phase_main_path(
        torch, sk, tsm, presets, ZeDOEstimator, bench.build_inputs, dev)
    entry["cuda_launches_per_forward"] = per_forward
    # N_REQUESTS requests, IPO alone and the profiled request, a step each
    entry_ipo["launches"] = ik.launch_counts["ipo_step"]
    want = (N_REQUESTS + 2) * presets.h36m().zcfg.ipo.iterations
    if entry_ipo["launches"] != want:
        fail(f"kernel #4 took {entry_ipo['launches']} steps in phase 5, want {want}")
    log(f"phase main path: {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    compiled = phase_compiled(torch, sk, split, tsm, presets, bench, ZeDOEstimator, card, dev)
    compiled["seconds"] = time.perf_counter() - t0
    log(f"phase compiled solve: {compiled['seconds']:.1f} s")
    kernel_share = entry["launches"] * entry["ms"] / 1e3 / sum(walls)
    log(f"request wall-clock {walls} s on {card}; kernel time (launches x kernel ms) "
        f"{kernel_share:.3f} of it, IPO {ipo_s * len(walls) / sum(walls):.3f}")
    t0 = time.perf_counter()
    batch_cli, batch_cli_poses = phase_batch_cli(torch, sk, split, tsm, tbt, opt_main,
                                                 inference, card)
    entry["launches_batch_cli"] = batch_cli["kernel_1_launches"]
    log(f"phase batch CLI: {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    infant = phase_infant(torch, sk, split, tsm, tbt, opt_main_infant, card)
    entry["launches_infant"] = {key: infant[key]["kernel_1_launches"] for key in ("mini", "syrip")}
    entry_control["launches"] = infant["mini_control"]["kernel_3_launches"]
    entry_control["launches_compiled"] = compiled["infant"]["control"]["kernel_3_forwards"]
    log(f"phase infant: {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    phase_accuracy(torch, sk, tbt, presets, ZeDOEstimator, dev)
    log(f"phase accuracy: {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    entry_split["launches"], headline = phase_tooling(torch, sk, split, bench, bench_kernel,
                                                      validate_dtype)
    log(f"phase tooling: {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    training = phase_training(torch, sk, split, tsm, card)
    log(f"phase training: {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    sampling = phase_sampling(torch, sk, split, tsm, card)
    log(f"phase sampling: {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    programs = phase_compiled_programs(torch, sk, split, tsm, card, dev)
    programs["seconds"] = time.perf_counter() - t0
    log(f"phase compiled programs: {programs['seconds']:.1f} s")
    t0 = time.perf_counter()
    multigpu = phase_multigpu(torch, sk, tsm, card)
    entry["launches_multigpu"] = {
        "nccl_world_1": multigpu["nccl_world_1"]["launches"],
        **{f"gloo_rank_{r}_{tag}": multigpu[tag][r]["launches"]
           for tag in ("solve", "trace", "infant", "serve") for r in range(MULTI_RANKS)}}
    log(f"phase multi-GPU: {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    rest = phase_rest(torch, sk, split, tsm, tbt, card, dev)
    entry["launches_serving"] = rest["launches"]
    entry["serving_shapes"] = rest.pop("kernel")
    rest["seconds"] = time.perf_counter() - t0
    log(f"phase rest of the surface: {rest['seconds']:.1f} s")
    t0 = time.perf_counter()
    config_files = phase_config_files(torch, sk, split, tsm, tbt, presets, ZeDOEstimator,
                                      opt_main, batch_cli_poses, card, dev)
    entry["launches_config_files"] = {"cli": config_files["cli"]["kernel_1_launches"],
                                      "serving": config_files["serving"]["launches"]}
    config_files["seconds"] = time.perf_counter() - t0
    log(f"phase config files: {config_files['seconds']:.1f} s")
    for e in (entry, entry_split, entry_control, entry_ipo):
        if not e["launches"]:
            fail(f"{e['name']} was not launched on its path")
    if probe.launch_counts != probe_launches:
        fail(f"a phase after phase_probe launched a probe kernel: {probe.launch_counts}, "
             f"{probe_launches} after phase_probe")

    entry["resident_blocks_per_sm"] = blocks_per_sm
    print(json.dumps({"kernels": [entry, entry_split, entry_control, entry_ipo], "request_s": walls, "ipo_s": ipo_s,
                      "device_busy_s": busy_s, "headline_s": headline["value"],
                      "batch_cli": batch_cli, "infant": infant, "training": training,
                      "sampling": sampling, "multigpu": multigpu, "rest": rest,
                      "config_files": config_files, "compiled": compiled,
                      "compiled_programs": programs,
                      "build_s": build_s,
                      "poses": HEADLINE_N, "hypotheses": HEADLINE_S}), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    if sys.argv[1:2] == ["--multigpu-rank"]:  # one rank of phase_multigpu's run
        sys.exit(multigpu_rank(sys.argv[2]))
    sys.exit(main())
