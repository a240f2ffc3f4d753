"""ZeDO-i infant evaluation CLI: solve a MINI-RGBD or SyRIP validation split
for S hypotheses and print the per-step reprojection trace, the final poses'
longest bone and the mean MPJPE.

    python -m zedo_tpu_torch.run.opt_main_infant --config mini \
        --ckpt_dir checkpoint/ --ckpt_name infant.pth --hypo 1 [--control | --cond]

Port of zedo_tpu/run/opt_main_infant.py, with the same flags plus
`--device` (default cuda; `--device cpu` runs on the CPU).
Launched as N ranks (`torchrun --nproc-per-node N -m
zedo_tpu_torch.run.opt_main_infant ...`) it pads the frames to a multiple
of N and solves them on a data mesh of the ranks
(infant.solve_infant_sharded; the trace averaged over the real frames),
as the JAX CLI does on its device mesh; rank 0 prints and saves.
Otherwise it solves on one device. `--config`
takes a preset (mini, syrip) or the path of any config file the JAX CLI
takes (e.g. configs/optim/concat_pose_optimization_mini.py). The data stay
relative to the working directory (data/mini-rgbd, data/syrip), as in the
JAX CLI. `--control` runs the ControlNet adapter and `--cond` the
conditional model, conditioned on the normalized 2D keypoints; both take
the generic OIL path. The plain model takes the fast path, where `--dtype
auto` (bf16 on the card) runs every OIL forward through the hand-written
CUDA score kernel.
"""
from __future__ import annotations

import argparse
import dataclasses
import os

import numpy as np
import torch

from zedo_tpu_torch import presets
from zedo_tpu_torch.data.base import normalize_data
from zedo_tpu_torch.data.sharding import pad_batch
from zedo_tpu_torch.data.mini_rgbd import SMIL_TO_H36M, mini_intrinsics, mini_rgbd
from zedo_tpu_torch.data.syrip import syrip
from zedo_tpu_torch.models import control_mlp, score_mlp, score_mlp_cond
from zedo_tpu_torch.parallel.mesh import say
from zedo_tpu_torch.presets import load_config
from zedo_tpu_torch.run.opt_main import add_device_args, cli_mesh
from zedo_tpu_torch.models.nn import tree_map
from zedo_tpu_torch.utils import profiling
from zedo_tpu_torch.utils.checkpoint import load_any_checkpoint
from zedo_tpu_torch.utils.config import apply_overrides, resolve_device, resolve_dtype
from zedo_tpu_torch.zeroshot import infant

JOINT_DIM = 3
PRESETS = ("mini", "syrip")


def parse_args(argv=None):
    parser = argparse.ArgumentParser(description="valid score model")
    parser.add_argument("--config", required=True,
                        help="a preset (mini, syrip) or the path of a config file, "
                             "e.g. configs/optim/concat_pose_optimization_mini.py")
    parser.add_argument("--ckpt_dir", type=str)
    parser.add_argument("--ckpt_name", type=str)
    parser.add_argument("--gt", action="store_true", default=False,
                        help="parsed and inert, as in the reference (the infant sets "
                             "ship no detected 2D)")
    parser.add_argument("--hypo", type=int, default=1)
    parser.add_argument("--control", default=False, action="store_true")
    parser.add_argument("--cond", default=False, action="store_true")
    parser.add_argument("--dtype", type=str, default="auto", choices=["auto", "fp32", "bf16"],
                        help="auto = bf16 on CUDA (the hand-written score kernel on the "
                             "plain model), fp32 on the CPU")
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--cluster_path", type=str, default=None,
                        help="cluster npy (default mini_cluster_{hypo}.npy)")
    parser.add_argument("--save", type=str, default=None)
    parser.add_argument("--override", action="append", default=[],
                        help="config override, e.g. --override ZeDO.OIL_iterations=500")
    add_device_args(parser)
    return parser.parse_args(argv)


def get_datasets(config):
    if config.data.dataset == "mini":
        kw = dict(gt2d=True, read_confidence=False, sample_interval=1, num_joint=17)
        return mini_rgbd("train", **kw), mini_rgbd("validate", **kw)
    if config.data.dataset == "syrip":
        kw = dict(gt2d=True, read_confidence=False, sample_interval=1, num_joint=12)
        return syrip("train", **kw), syrip("validate", **kw)
    raise ValueError(config.data.dataset)


def main(argv=None) -> dict:
    """Run the CLI; returns {poses [N, S, j, 3] on the device, reproj_px
    [S, steps], mpjpe (m), solve_s, ipo_s, oil_s, eval_s} for in-process
    callers (on a mesh, mpjpe and eval_s on the first rank only, None on
    the others)."""
    args = parse_args(argv)
    mesh = cli_mesh(args)
    dev = mesh.device if mesh is not None else resolve_device(args.device)
    log = say(mesh)
    config = apply_overrides(load_config(args.config, PRESETS), args.override)
    n_joints = config.DATASET.NUM_JOINT
    train_dataset, test_dataset = get_datasets(config)
    preset = presets.from_optim_config(config)
    if args.control:
        model_apply = control_mlp.apply
    elif args.cond:
        model_apply = score_mlp_cond.apply
    else:
        model_apply = score_mlp.apply

    ckpt_path = os.path.join(args.ckpt_dir, args.ckpt_name)
    log(f"loading model from {ckpt_path}")
    params, step = load_any_checkpoint(ckpt_path, preset.model_cfg, device=dev)
    log(f"=> loaded checkpoint '{ckpt_path}' (step {step})")

    cond2d = np.asarray(test_dataset.db_2d[:, :, :2], np.float32)
    if config.data.dataset == "mini":
        k = np.broadcast_to(mini_intrinsics(), (len(cond2d), 3, 3))
        pelvis_mode = "joint0"
        # the first pose of mini_cluster_{S}.npy, remapped to H36M joints
        sample_poses = np.load(args.cluster_path or f"mini_cluster_{args.hypo}.npy")
        sample_poses = sample_poses[0][SMIL_TO_H36M].reshape(-1, 17, 3)
    else:
        k = np.asarray(test_dataset.K, np.float32)
        pelvis_mode = "mean03"
        sample_poses = train_dataset.db_3d[0:1]  # the first train pose
    sample_poses = np.asarray(sample_poses, np.float32)
    if len(sample_poses) < args.hypo:
        # the reference reruns the same single cluster for every hypothesis
        log(f"note: cluster source has {len(sample_poses)} pose(s); "
            f"tiling to {args.hypo} identical hypotheses")
        sample_poses = np.tile(sample_poses, (-(-args.hypo // len(sample_poses)), 1, 1))

    dtype = resolve_dtype(args.dtype, dev)
    if dtype != args.dtype:
        log(f"--dtype auto -> {dtype} on {dev.type}")
    if dtype == "bf16":
        params = tree_map(lambda x: x.to(torch.bfloat16), params)
    # the reference logs the reprojection error of every OIL step
    zcfg = dataclasses.replace(preset.zcfg, oil=dataclasses.replace(preset.zcfg.oil,
                                                                       track_reproj=True))

    def put(a):
        return torch.from_numpy(np.ascontiguousarray(a, np.float32)).to(dev)

    # --cond conditions the model on the actual normalized 2D keypoints at
    # every OIL step, the normalization its training uses
    condition = normalize_data(cond2d) if args.cond else None
    sw = profiling.Stopwatch()
    n = len(cond2d)
    generator = torch.Generator(device=dev).manual_seed(args.seed)
    with torch.no_grad(), sw.phase("solve"):
        clusters = put(sample_poses[:args.hypo])
        if mesh is None:
            result = infant.solve_infant_jit(
                params, model_apply, preset.model_cfg, preset.sde, preset.sampler, zcfg,
                clusters, put(cond2d), put(k), pelvis_mode=pelvis_mode, refine_t_from=950,
                generator=generator, condition=None if condition is None else put(condition),
                stopwatch=sw)
        else:
            padded, mask = pad_batch({"cond2d": cond2d, "k": k, "condition": condition},
                                     mesh.shape["data"])
            result = infant.solve_infant_sharded(
                mesh, params, model_apply, preset.model_cfg, preset.sde, preset.sampler, zcfg,
                clusters, padded["cond2d"], padded["k"], pelvis_mode=pelvis_mode,
                refine_t_from=950, generator=generator, condition=padded["condition"],
                row_mask=mask, stopwatch=sw)
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
    elapsed = sw.totals["solve"]
    log(f"solved {n} poses x {args.hypo} hypotheses x {zcfg.oil.iterations} OIL steps on "
        f"{1 if mesh is None else mesh.size} device(s) in {elapsed:.2f}s "
        f"({n * args.hypo / elapsed:.1f} poses/s)")
    poses = result.poses[:n]
    reproj = result.reproj_px.cpu().numpy()  # [S, steps]
    n_steps = reproj.shape[1]
    marks = sorted({0, n_steps // 4, n_steps // 2, 3 * n_steps // 4, n_steps - 1})
    trace = "  ".join(f"step {i}: {reproj[:, i].mean():.2f}px" for i in marks)
    log(f"reprojection error (mean over {reproj.shape[0]} hypothesis(es)): {trace}")
    mbl = infant.max_bone_length(poses.reshape(-1, n_joints, JOINT_DIM)).cpu().numpy()
    log(f"max bone length (final poses): mean {mbl.mean():.4f}m, max {mbl.max():.4f}m")
    out = {"poses": poses, "reproj_px": reproj, "mpjpe": None, "eval_s": None,
           **{f"{name}_s": sw.totals[name] for name in ("solve", "ipo", "oil")}}
    if mesh is not None and not mesh.is_main:
        return out
    if args.save:
        np.save(args.save, poses.cpu().numpy())

    log("eval...")
    with sw.phase("eval"):
        out["mpjpe"] = test_dataset.eval_multi(poses, protocol2=False, print_verbose=False)
    out["eval_s"] = sw.totals["eval"]
    return out


if __name__ == "__main__":
    main()
