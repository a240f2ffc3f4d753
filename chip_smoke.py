#!/usr/bin/env python3
"""Drive the zedo_tpu_torch port on one NVIDIA GPU and check it.

    python3 chip_smoke.py

Phases (any failure exits non-zero; nothing is caught and passed over):
  1. device: the card's name and power limit (nvidia-smi);
  2. build: the fused ScoreMLP kernel from zedo_tpu_torch/csrc with nvcc;
  3. kernel vs plain version at the published width (hidden 1024, embed
     512, bf16 weights, f32 GroupNorm statistics) on 44,300 rows (the H36M
     886 x 50 solve) and on a ragged row count, with kernel, plain-version
     and bf16 torch.matmul-chain times and the roofline bound;
  4. the main path: ZeDOEstimator.predict at the published width with random
     seeded weights and the full 500 IPO / 1000 OIL schedule on 886 poses x
     50 hypotheses, a few requests, with the kernel's launch count checked
     against the OIL steps;
  5. accuracy on the committed trained fixture (hidden 256) in fp32 and
     bf16 (the kernel), best-hypothesis MPJPE against the JAX package's
     value for the same scenes and schedule.

Prints a `kernels` JSON line and the card's name and power limit before the
last line, and as the last line
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}.
Imports torch, numpy and zedo_tpu_torch only.
"""
from __future__ import annotations

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
# weights through the Pallas kernel in interpret mode with gn_fp32=True,
# the function the CUDA kernel computes. Recomputed and held against these
# values by tests/test_torch_pipeline.py::test_chip_smoke_reference_mpjpe.
JAX_FIXTURE_MPJPE_MM = {"fp32": 26.472286224365234, "bf16": 27.057533264160156}
FIXTURE_TOL_MM = 1.0
FIXTURE_SCENES, FIXTURE_IPO, FIXTURE_OIL = 24, 200, 300

# H100 SXM peaks (NVIDIA data sheet, dense): bf16 tensor cores and HBM3
PEAK_BF16_FLOPS = 989e12
PEAK_BYTES = 3.35e12

HEADLINE_N, HEADLINE_S = 886, 50
N_REQUESTS = 3
KERNEL_TOL = 2e-2  # max |kernel - plain|: same bf16 operands, f32 sums in another order


def fail(msg: str) -> None:
    print(f"FAIL: {msg}", flush=True)
    sys.exit(1)


def log(msg: str) -> None:
    print(msg, flush=True)


def build_inputs(n, s, j=17, seed=0):
    """The synthetic H36M-scale request of the JAX package's bench.py."""
    rng = np.random.RandomState(seed)
    k = np.zeros((n, 3, 3), np.float32)
    k[:, 0, 0] = k[:, 1, 1] = 1145.0
    k[:, 0, 2] = k[:, 1, 2] = 512.0
    k[:, 2, 2] = 1.0
    pose = rng.randn(n, j, 3).astype(np.float32) * 0.25
    pose -= pose[:, 0:1]
    t = np.zeros((n, 1, 3), np.float32)
    t[..., 2] = 4.5
    px = np.einsum("bij,bnj->bni", k, pose + t)
    px = (px[..., :2] / px[..., 2:]).astype(np.float32)
    conf = np.clip(rng.rand(n, j).astype(np.float32) + 0.3, 0, 1)
    clusters = (rng.randn(s, j, 3) * 0.25).astype(np.float32)
    return px, conf, k, clusters


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


def library_forward(torch, x, packed, vecs):
    """Yardstick: the same function as a chain of bf16 torch.matmul calls
    with GroupNorm and SiLU as torch ops. Timed here, never used by the port."""
    b, c = x.shape
    io_pad, h = packed.w_pre.shape
    g = h // packed.group_size
    bf = torch.bfloat16

    def gn_silu(v, row):
        vg = v.view(b, g, packed.group_size)
        xn = (vg * torch.rsqrt(vg.pow(2).mean(-1, keepdim=True) + 1e-5)).view(b, h)
        return torch.nn.functional.silu(xn * packed.gn_scale[row] + packed.gn_bias[row])

    def dense(a, w, row):
        return torch.matmul(a.to(bf), w).float() + vecs[row]

    hcur = gn_silu(dense(torch.nn.functional.pad(x, (0, io_pad - c)), packed.w_pre, 0), 0)
    for blk in range(2):
        h1 = gn_silu(dense(hcur, packed.w_b[2 * blk], 1 + 2 * blk), 1 + 2 * blk)
        hcur = hcur + gn_silu(dense(h1, packed.w_b[2 * blk + 1], 2 + 2 * blk), 2 + 2 * blk)
    return (torch.matmul(hcur.to(bf), packed.w_post).float() + packed.bias_post)[:, :c]


def to_bf16(torch, tree):
    return {k: to_bf16(torch, v) if isinstance(v, dict) else v.to(torch.bfloat16)
            for k, v in tree.items()}


def phase_kernel(torch, sk, tsm, dev):
    """Kernel vs plain version at the published width; returns the kernel's
    JSON entry (without launches)."""
    cfg = tsm.ScoreMLPConfig()
    params = to_bf16(torch, tsm.init_params(torch.Generator().manual_seed(0), cfg, device=dev))
    packed = sk.pack_weights(params, cfg, dtype=torch.bfloat16, gn_dtype=torch.float32)
    temb = tsm.time_embedding(params, cfg, torch.full((1,), 47.3, device=dev))[0]
    vecs = sk.step_vectors(packed, temb).contiguous()
    gen = torch.Generator().manual_seed(1)
    h, io = cfg.hidden_dim, cfg.n_joints * cfg.joint_dim
    entry = None
    for rows in (HEADLINE_N * HEADLINE_S, 1001):
        x = torch.randn(rows, io, generator=gen).to(dev)
        got = sk.fused_score_forward(x, packed, vecs)
        torch.cuda.synchronize()
        want = sk.fused_score_forward_reference(x, packed, vecs)
        if not torch.isfinite(got).all():
            fail(f"kernel output not finite at {rows} rows")
        err = (got - want).abs().max().item()
        log(f"kernel vs plain, {rows} rows: max |diff| {err:.3e} (tolerance {KERNEL_TOL}, "
            f"|plain| max {want.abs().max().item():.3f})")
        if not err <= KERNEL_TOL:
            fail(f"kernel disagrees with its plain version at {rows} rows: {err}")
        if entry is not None:
            continue
        ms = cuda_ms(torch, lambda: sk.fused_score_forward(x, packed, vecs), 20, warmup=3)
        plain_ms = cuda_ms(torch, lambda: sk.fused_score_forward_reference(x, packed, vecs), 3, 1)
        lib_out = library_forward(torch, x, packed, vecs)
        lib_ms = cuda_ms(torch, lambda: library_forward(torch, x, packed, vecs), 10, 2)
        log(f"library chain vs plain: max |diff| {(lib_out - want).abs().max().item():.3e}")
        flops = 2 * rows * (io * h + 4 * h * h + h * io)
        n_bytes = (x.numel() * 4 + rows * io * 4  # x in, out
                   + sum(t.numel() * t.element_size() for t in
                         (packed.w_pre, *packed.w_b, packed.w_post, vecs, packed.gn_scale,
                          packed.gn_bias, packed.bias_post)))
        t_ops, t_bytes = flops / PEAK_BF16_FLOPS * 1e3, n_bytes / PEAK_BYTES * 1e3
        bound_ms = max(t_ops, t_bytes)
        entry = {
            "name": "fused_score_forward", "route": "cuda",
            "source": "zedo_tpu_torch/csrc/score_mlp.cu",
            "replaces": "zedo_tpu/ops/pallas/score_kernel.py:214",
            "launches": None, "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bound_ms, "bound_by": "operations" if t_ops >= t_bytes else "bytes",
            "library_ms": lib_ms, "rows": rows, "hidden": h,
            "tflops": flops / ms / 1e9, "roofline_share": bound_ms / ms,
        }
        log(f"fused_score_forward {rows}x{h}: kernel {ms:.4f} ms "
            f"({flops / ms / 1e9:.1f} TFLOP/s, {bound_ms / ms:.3f} of the "
            f"{entry['bound_by']} bound {bound_ms:.4f} ms), plain {plain_ms:.3f} ms, "
            f"bf16 torch.matmul chain {lib_ms:.4f} ms")
    return entry


def phase_main_path(torch, sk, tsm, presets, ZeDOEstimator, dev):
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
        f"bf16 weights")
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
    if launches != N_REQUESTS * per_request:
        fail(f"kernel launched {launches} times in {N_REQUESTS} requests, "
             f"want {N_REQUESTS * per_request}")
    log(f"main path: {launches} kernel launches in {N_REQUESTS} requests "
        f"({per_request} per request)")

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
    for dtype in ("fp32", "bf16"):
        est = ZeDOEstimator.from_torch_checkpoint(
            tbt.CHECKPOINT, tbt.CLUSTERS, preset=preset, dtype=dtype, batch_bucket=8,
            device=dev).with_schedule(FIXTURE_OIL, ipo_iterations=FIXTURE_IPO)
        before = sk.launch_counts["fused_score_forward"]
        out = est.predict(px, k)
        used = sk.launch_counts["fused_score_forward"] - before
        if used != (FIXTURE_OIL if dtype == "bf16" else 0):
            fail(f"trained fixture {dtype}: {used} kernel launches")
        mm = tbt.best_mpjpe(out["poses"], gt)
        ref = JAX_FIXTURE_MPJPE_MM[dtype]
        log(f"trained fixture {dtype}: best-hypothesis MPJPE {mm:.3f} mm "
            f"(JAX package on the CPU {ref:.3f} mm, tolerance {FIXTURE_TOL_MM} mm; "
            f"{used} kernel launches)")
        if not abs(mm - ref) <= FIXTURE_TOL_MM:
            fail(f"trained fixture {dtype}: MPJPE {mm} vs {ref}")


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        fail("CUDA is not available")
    sys.path.insert(0, REPO)
    try:
        from zedo_tpu_torch import bench_trained as tbt
        from zedo_tpu_torch import presets
        from zedo_tpu_torch.models import score_mlp as tsm
        from zedo_tpu_torch.ops.kernels import score_kernel as sk
        from zedo_tpu_torch.serving import ZeDOEstimator
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

    lib = sk.load_library()
    log(f"build: {lib.build_seconds:.1f} s -> {lib.path}")
    log(lib.ptxas or "ptxas: (library was already built)")

    t0 = time.perf_counter()
    entry = phase_kernel(torch, sk, tsm, dev)
    log(f"phase kernel: {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    entry["launches"], walls, ipo_s, busy_s = phase_main_path(torch, sk, tsm, presets, ZeDOEstimator, dev)
    log(f"phase main path: {time.perf_counter() - t0:.1f} s")
    kernel_share = entry["launches"] * entry["ms"] / 1e3 / sum(walls)
    log(f"request wall-clock {walls} s on {card}; kernel time (launches x kernel ms) "
        f"{kernel_share:.3f} of it, IPO {ipo_s * len(walls) / sum(walls):.3f}")
    t0 = time.perf_counter()
    phase_accuracy(torch, sk, tbt, presets, ZeDOEstimator, dev)
    log(f"phase accuracy: {time.perf_counter() - t0:.1f} s")

    print(json.dumps({"kernels": [entry], "request_s": walls, "ipo_s": ipo_s,
                      "device_busy_s": busy_s,
                      "poses": HEADLINE_N, "hypotheses": HEADLINE_S}), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
