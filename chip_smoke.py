#!/usr/bin/env python3
"""Drive the zedo_tpu_torch port on one NVIDIA GPU and check it.

    python3 chip_smoke.py

Phases (any failure exits non-zero; nothing is caught and passed over):
  1. device: the card's name and power limit (nvidia-smi);
  2. build: both kernel libraries from zedo_tpu_torch/csrc, one nvcc each,
     started together;
  3. kernel #1 (fused_score_forward) against its plain version at the
     published width (hidden 1024, embed 512, bf16 weights) in both
     GroupNorm statistics modes, on 44,300 rows (the H36M 886 x 50 solve)
     and on a ragged row count, with kernel, plain-version and bf16
     torch.matmul-chain times and the roofline bound; and at hidden 384,
     768 and 2048 (GroupNorm groups of 12, 24 and 64 channels) in both
     modes;
  4. kernel #2 (fused_score_forward_split) against its plain version and
     against kernel #1 at 44,300 and 1,001 rows in both modes, with its
     times beside the same yardsticks;
  5. the main path: ZeDOEstimator.predict at the published width with random
     seeded weights and the full 500 IPO / 1000 OIL schedule on 886 poses x
     50 hypotheses, a few requests, with the kernel's launches checked
     against the OIL steps and its GroupNorm mode against the default
     (bf16, JAX's default); IPO alone; a profiled request;
  6. accuracy on the committed trained fixture (hidden 256): fp32, bf16
     (kernel #1, GroupNorm bf16) and bf16 with gn_fp32, best-hypothesis
     MPJPE against the JAX package's value for the same scenes, schedule
     and mode;
  7. the kernel tooling path, each entry point with the launch counts set to
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
import subprocess
import sys
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
KERNEL_TOL = 2e-2  # max |kernel - plain|: same bf16 operands, f32 sums in another order
WIDTH_ROWS = 4096  # rows of the width checks of kernel #1
BENCH_KERNEL_ITERS = 20


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


def packed_weights(torch, sk, tsm, dev, hidden=1024, embed=512):
    """{gn mode: (packed, vecs)} of random seeded bf16 weights."""
    cfg = tsm.ScoreMLPConfig(hidden_dim=hidden, embed_dim=embed)
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


def phase_kernel(torch, sk, tsm, library_forward, dev):
    """Kernel #1 against its plain version; returns its JSON entry (without
    launches) and the published-width inputs for kernel #2."""
    weights = packed_weights(torch, sk, tsm, dev)
    gen = torch.Generator().manual_seed(1)
    rows = HEADLINE_N * HEADLINE_S
    xs = {r: torch.randn(r, 51, generator=gen).to(dev) for r in (rows, 1001)}
    errs, ms = [], {}
    for gn, (packed, vecs) in weights.items():
        for r, x in xs.items():
            errs.append(check(torch, f"kernel #1 gn={gn} vs plain",
                              sk.fused_score_forward(x, packed, vecs),
                              sk.fused_score_forward_reference(x, packed, vecs), r))
        ms[gn] = cuda_ms(torch, lambda: sk.fused_score_forward(xs[rows], packed, vecs), 20, 3)
    packed, vecs = weights["bf16"]
    x = xs[rows]
    plain_ms = cuda_ms(torch, lambda: sk.fused_score_forward_reference(x, packed, vecs), 3, 1)
    want = sk.fused_score_forward_reference(x, packed, vecs)
    check(torch, "library chain vs plain (yardstick)", library_forward(x, packed, vecs), want,
          rows, tol=math.inf)
    lib_ms = cuda_ms(torch, lambda: library_forward(x, packed, vecs), 10, 2)
    bound_ms, bound_by, flops = bound(x, packed, vecs, rows)
    for gn in ms:
        log(f"fused_score_forward gn={gn} {rows}x1024: kernel {ms[gn]:.4f} ms "
            f"({flops / ms[gn] / 1e9:.1f} TFLOP/s, {bound_ms / ms[gn]:.3f} of the {bound_by} "
            f"bound {bound_ms:.4f} ms)")
    log(f"plain version {plain_ms:.3f} ms, bf16 torch.matmul chain {lib_ms:.4f} ms")

    # every width JAX runs through Pallas: groups that are no power of two
    # and groups wider than a warp reduce through shared memory
    for hidden in (384, 768, 2048):
        for gn, (p, v) in packed_weights(torch, sk, tsm, dev, hidden=hidden).items():
            xw = torch.randn(WIDTH_ROWS, 51, generator=gen).to(dev)
            errs.append(check(torch, f"kernel #1 hidden {hidden} (groups of {hidden // 32}) "
                              f"gn={gn} vs plain", sk.fused_score_forward(xw, p, v),
                              sk.fused_score_forward_reference(xw, p, v), WIDTH_ROWS))
    entry = {
        "name": "fused_score_forward", "route": "cuda",
        "source": "zedo_tpu_torch/csrc/score_mlp.cu",
        "replaces": "zedo_tpu/ops/pallas/score_kernel.py:214",
        "launches": None, "max_abs_err": max(errs), "ms": ms["bf16"], "plain_ms": plain_ms,
        "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": lib_ms,
        "ms_gn_f32": ms["f32"], "rows": rows, "hidden": 1024,
        "tflops": flops / ms["bf16"] / 1e9, "roofline_share": bound_ms / ms["bf16"],
    }
    return entry, weights, x


def phase_split(torch, sk, split, library_forward, weights, x):
    """Kernel #2 against its plain version and kernel #1; returns its JSON
    entry (without launches)."""
    gen = torch.Generator().manual_seed(2)
    errs, ms = [], {}
    for gn, (packed, vecs) in weights.items():
        for xr in (x, torch.randn(1001, 51, generator=gen).to(x.device)):
            got = split.fused_score_forward_split(xr, packed, vecs)
            errs.append(check(torch, f"kernel #2 gn={gn} vs plain", got,
                              split.fused_score_forward_split_reference(xr, packed, vecs),
                              xr.shape[0]))
            errs.append(check(torch, f"kernel #2 gn={gn} vs kernel #1", got,
                              sk.fused_score_forward(xr, packed, vecs), xr.shape[0]))
        ms[gn] = cuda_ms(torch, lambda: split.fused_score_forward_split(x, packed, vecs), 20, 3)
    packed, vecs = weights["bf16"]
    plain_ms = cuda_ms(torch, lambda: split.fused_score_forward_split_reference(x, packed, vecs),
                       3, 1)
    lib_ms = cuda_ms(torch, lambda: library_forward(x, packed, vecs), 10, 2)
    rows = x.shape[0]
    bound_ms, bound_by, flops = bound(x, packed, vecs, rows)
    for gn in ms:
        log(f"fused_score_forward_split gn={gn} {rows}x1024: kernel {ms[gn]:.4f} ms "
            f"({flops / ms[gn] / 1e9:.1f} TFLOP/s, {bound_ms / ms[gn]:.3f} of the {bound_by} "
            f"bound {bound_ms:.4f} ms)")
    log(f"split plain version {plain_ms:.3f} ms, bf16 torch.matmul chain {lib_ms:.4f} ms")
    return {
        "name": "fused_score_forward_split", "route": "cuda",
        "source": "zedo_tpu_torch/csrc/score_mlp_split.cu",
        "replaces": "tools/bench_kernel.py:108",
        "launches": None, "max_abs_err": max(errs), "ms": ms["bf16"], "plain_ms": plain_ms,
        "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": lib_ms,
        "ms_gn_f32": ms["f32"], "rows": rows, "hidden": 1024,
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
    log(f"main path: {launches} kernel launches in {N_REQUESTS} requests "
        f"({per_request} per request), GroupNorm modes {by_mode}")

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
    by_kernel = sorted(((e.self_device_time_total, e.key) for e in prof.key_averages()
                        if e.device_type == torch.autograd.DeviceType.CUDA), reverse=True)
    busy_s = sum(t for t, _ in by_kernel) / 1e6
    log(f"profiled request: device busy {busy_s:.3f} s = {busy_s / np.mean(walls):.3f} of "
        f"the unprofiled mean wall-clock; top kernels by device time:")
    for t, name in by_kernel[:6]:
        log(f"  {t / 1e3:10.1f} ms  {name[:90]}")
    return launches, walls, ipo_s, busy_s


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
    # mode; the split comparison adds one launch of each
    want = 2 * (iters + 1) + 1
    if counts != {"fused_score_forward": want, "fused_score_forward_split": want}:
        fail(f"bench_kernel --split launches {counts}, want {want} of each kernel")
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

    for name, lib in build.build().items():
        log(f"build {name}: {lib.build_seconds:.1f} s -> {lib.path}")
        log(lib.ptxas or "ptxas: (library was already built)")

    t0 = time.perf_counter()
    entry, weights, x = phase_kernel(torch, sk, tsm, bench_kernel.library_forward, dev)
    log(f"phase kernel #1: {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    entry_split = phase_split(torch, sk, split, bench_kernel.library_forward, weights, x)
    log(f"phase kernel #2: {time.perf_counter() - t0:.1f} s")
    del weights, x
    t0 = time.perf_counter()
    entry["launches"], walls, ipo_s, busy_s = phase_main_path(
        torch, sk, tsm, presets, ZeDOEstimator, bench.build_inputs, dev)
    log(f"phase main path: {time.perf_counter() - t0:.1f} s")
    kernel_share = entry["launches"] * entry["ms"] / 1e3 / sum(walls)
    log(f"request wall-clock {walls} s on {card}; kernel time (launches x kernel ms) "
        f"{kernel_share:.3f} of it, IPO {ipo_s * len(walls) / sum(walls):.3f}")
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

    print(json.dumps({"kernels": [entry, entry_split], "request_s": walls, "ipo_s": ipo_s,
                      "device_busy_s": busy_s, "headline_s": headline["value"],
                      "poses": HEADLINE_N, "hypotheses": HEADLINE_S}), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
