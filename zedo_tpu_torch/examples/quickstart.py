"""zedo_tpu_torch quickstart: zero-shot 3D pose lifting in three acts.

Runs on the committed demo artifact (tests/fixtures/trained: a small
diffusion prior, hidden 256, trained on a synthetic pose family and shipped
in the reference's .pth layout), so it needs no dataset:

  1. library solve: load the checkpoint, lift 2D keypoints to 3D with
     IPO + OIL (pipeline.solve_jit) in fp32, score against the ground truth;
  2. serving: ZeDOEstimator, loaded once, with the re-discretized
     low-latency schedule (OIL 200 / IPO 100), one request of 8 poses;
  3. the same solve through the port's batch CLI (the command is printed).

    python -m zedo_tpu_torch.examples.quickstart [--full] [--device cuda|cpu]

The default schedule is 200 IPO / 300 OIL steps, re-discretized (the SDE's
step count set to the OIL steps); --full runs the published 500 / 1000.
MPJPE is the best hypothesis's, root-centred (bench_trained.best_mpjpe).
Port of examples/quickstart.py: the estimator reads the same wrapper
config, examples/quickstart_config.py (the stock H36M file at the
fixture's widths), as JAX's quickstart does.
"""
from __future__ import annotations

import argparse
import os
import sys
import time

import numpy as np
import torch

from zedo_tpu_torch import bench_trained
from zedo_tpu_torch.diffusion.sampling import PCSampler
from zedo_tpu_torch.diffusion.sde import SubVPSDE
from zedo_tpu_torch.serving import ZeDOEstimator
from zedo_tpu_torch.utils.config import resolve_device
from zedo_tpu_torch.zeroshot import ipo as ipo_lib
from zedo_tpu_torch.zeroshot import oil as oil_lib
from zedo_tpu_torch.zeroshot import pipeline

N_SCENES, HYPO, SERVE_POSES = 24, 2, 8
REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
CONFIG = os.path.join(REPO, "examples", "quickstart_config.py")


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--full", action="store_true", help="the published 500 / 1000 schedule")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    if REPO not in sys.path:  # the config file imports the repository's configs
        sys.path.insert(0, REPO)
    dev = resolve_device(args.device)
    ipo_iters, oil_iters = (500, 1000) if args.full else (200, 300)
    name = torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"
    print(f"device: {dev} ({name})\n", flush=True)

    # ---- 1. library solve ----------------------------------------------
    # a trained prior + 2D detections + camera intrinsics -> 3D poses
    cfg, params, family = bench_trained.load_fixture(dev)
    gt, k, px = bench_trained.make_scenes(family, N_SCENES)  # held-out draws
    clusters = bench_trained.make_hypothesis_clusters(family, s=HYPO)
    # a short schedule RE-DISCRETIZES the annealing (sde.n = OIL steps, as
    # ZeDOEstimator.with_schedule does); truncating the 1000-step schedule
    # would integrate only part of it
    sde = SubVPSDE(beta_min=0.1, beta_max=20.0, n=oil_iters, t_max=0.1)
    sampler = PCSampler(sde=sde, predictor="euler_maruyama", corrector="none",
                        probability_flow=True, denoise=True, eps=0.01)
    zcfg = pipeline.ZeDOConfig(
        ipo=ipo_lib.IPOConfig(iterations=ipo_iters, keypoint_list=(0, 1, 4), rot_axes="z",
                              t_norm=3.0),
        oil=oil_lib.OILConfig(iterations=oil_iters, sampling_eps=0.01))
    t0 = time.perf_counter()
    with torch.no_grad():
        res = pipeline.solve_jit(params, cfg, sde, sampler, zcfg,
                                 *(torch.as_tensor(a, device=dev) for a in (clusters, px)),
                                 None, torch.as_tensor(k, device=dev),
                                 generator=torch.Generator(dev).manual_seed(0))
    pred = res.poses.cpu().numpy()  # [N, S, 17, 3]
    solve_s = time.perf_counter() - t0
    init_mm = bench_trained.best_mpjpe(np.broadcast_to(clusters[None], pred.shape), gt)
    solved_mm = bench_trained.best_mpjpe(pred, gt)
    print(f"1. pipeline.solve_jit: {N_SCENES} scenes x {HYPO} hypotheses, {ipo_iters} IPO + "
          f"{oil_iters} OIL steps in {solve_s:.1f}s (first call)")
    print(f"   cluster-init error {init_mm:.0f} mm -> solved MPJPE {solved_mm:.1f} mm\n",
          flush=True)

    # ---- 2. serving ----------------------------------------------------
    # load once, predict many times
    est = ZeDOEstimator.from_torch_checkpoint(
        bench_trained.CHECKPOINT, bench_trained.CLUSTERS, config_path=CONFIG,
        dtype="fp32", batch_bucket=32, device=dev)
    fast = est.low_latency()  # OIL 200 (re-discretized) / IPO 100
    t0 = time.perf_counter()
    out = fast.predict(px[:SERVE_POSES], k[:SERVE_POSES])
    serve_s = time.perf_counter() - t0
    best = out["poses"][np.arange(SERVE_POSES), out["best"]]  # [8, 17, 3]
    serve_mm = bench_trained.best_mpjpe(best[:, None], gt[:SERVE_POSES])
    print(f"2. ZeDOEstimator.low_latency(): {SERVE_POSES}-pose request in {serve_s:.2f}s "
          f"(first request)")
    print(f"   best hypothesis (by reprojection error) MPJPE {serve_mm:.1f} mm\n", flush=True)

    # ---- 3. the CLI ----------------------------------------------------
    device_flag = "" if dev.type == "cuda" else f" --device {dev.type}"
    print("3. the same solve through the port's batch CLI:\n"
          "   python -m zedo_tpu_torch.run.opt_main --config examples/quickstart_config.py"
          f"{device_flag} \\\n"
          "     --ckpt_dir tests/fixtures/trained/checkpoint "
          "--ckpt_name checkpoint_trained.pth \\\n"
          "     --cluster_dir tests/fixtures/trained/clusters "
          "--data_dir tests/fixtures/trained/data --gt --hypo 2 \\\n"
          "     --override ZeDO.sample=1 --override ZeDO.batch=24\n"
          "   (training: python -m zedo_tpu_torch.run.train_pose_mini --help; "
          "benchmark: python -m zedo_tpu_torch.bench)", flush=True)

    if not solved_mm < 0.15 * init_mm:
        raise RuntimeError(f"the trained prior should beat the init: {solved_mm:.1f} mm "
                           f"against {init_mm:.1f} mm")
    return {"init_mm": init_mm, "solved_mm": solved_mm, "serve_mm": serve_mm,
            "solve_s": solve_s, "serve_s": serve_s, "ipo": ipo_iters, "oil": oil_iters}


if __name__ == "__main__":
    main()
