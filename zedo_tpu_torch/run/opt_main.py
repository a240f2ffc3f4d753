"""Main zero-shot evaluation CLI: solve a dataset's poses for S hypotheses
and print MPJPE (protocol 1) and PA-MPJPE (protocol 2) by action.

    python -m zedo_tpu_torch.run.opt_main --config h36m \
        --ckpt_dir checkpoint/ --ckpt_name checkpoint_1500.pth --gt --hypo 50

Port of zedo_tpu/run/opt_main.py, with the same flags plus `--device`
(default cuda; `--device cpu` runs on the CPU). Launched as
N ranks (`torchrun --nproc-per-node N -m zedo_tpu_torch.run.opt_main ...`)
it pads the poses to a multiple of N, solves them on a data mesh of the N
ranks (pipeline.solve_sharded, rank r on cuda:r unless --device names a
card) and unpads, as the JAX CLI does on its device mesh; rank 0 prints the
tables and writes --save. Otherwise it solves on one device. `--config` takes
a preset name (h36m, 3dhp, 3dpw, ski, wild) or the path of any config file
the JAX CLI takes (configs/optim/*.py, or a file wrapping one), which it
runs for its get_config() (presets.read_config_file); `--override
key.path=value` changes one key. `--dtype auto` is bf16 on the card, where
every OIL forward runs the hand-written CUDA score kernel, and fp32 on the
CPU. The evaluation runs in f32 on the solve's device. `--profile DIR`
writes a torch.profiler trace of the solve to DIR/trace.json.
"""
from __future__ import annotations

import argparse
import contextlib
import os
from pathlib import Path

import numpy as np
import torch

from zedo_tpu_torch import presets
from zedo_tpu_torch.presets import EVAL_PRESETS, load_config
from zedo_tpu_torch.data import DATASETS
from zedo_tpu_torch.data.sharding import pad_batch
from zedo_tpu_torch.models.nn import tree_map
from zedo_tpu_torch.parallel.mesh import default_mesh, init_from_env, say
from zedo_tpu_torch.utils import profiling
from zedo_tpu_torch.utils.checkpoint import convert_cluster_file, load_any_checkpoint
from zedo_tpu_torch.utils.config import apply_overrides, resolve_device, resolve_dtype
from zedo_tpu_torch.zeroshot import pipeline

N_JOINTS = 17
JOINT_DIM = 3

CLUSTER_FILES = {
    "h36m": "h36m_cluster{s}.npy",
    "3dhp": "3dhp_cluster{s}.npy",
    "3dpw": "h36m_cluster{s}.npy",
    "ski": "h36m_sitting_cluster{s}.npy",
    "wild": "h36m_cluster{s}.npy",
}



def add_common_args(parser: argparse.ArgumentParser) -> None:
    """The flags opt_main and inference share."""
    parser.add_argument("--config", required=True,
                        help=f"a preset ({', '.join(EVAL_PRESETS)}) or the path of a config "
                             "file, e.g. configs/optim/concat_pose_optimization_h36m.py")
    parser.add_argument("--ckpt_dir", type=str)
    parser.add_argument("--ckpt_name", type=str)
    parser.add_argument("--gt", action="store_true", default=False,
                        help="use gt2d as condition")
    parser.add_argument("--hypo", type=int, default=1, help="number of hypotheses")
    parser.add_argument("--ema", action="store_true", default=False,
                        help="apply EMA weights (reference loads-but-ignores them)")
    parser.add_argument("--dtype", type=str, default="auto", choices=["auto", "fp32", "bf16"],
                        help="auto = bf16 on CUDA (the hand-written score kernel), "
                             "fp32 on the CPU")
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--cluster_dir", type=str, default="clusters")
    parser.add_argument("--data_dir", type=str, default="data")
    parser.add_argument("--strict_batch", action="store_true", default=False,
                        help="enforce config.ZeDO.batch == len(dataset)")
    parser.add_argument("--override", action="append", default=[],
                        help="config override, e.g. --override ZeDO.OIL_iterations=500")
    add_device_args(parser)


def add_device_args(parser: argparse.ArgumentParser) -> None:
    """--device, the flag of every CLI that runs on a mesh."""
    parser.add_argument("--device", type=str, default="cuda",
                        help="cuda, cuda:k or cpu; under torchrun 'cuda' is each rank's own card")


def parse_args(argv=None):
    parser = argparse.ArgumentParser(description="valid score model")
    add_common_args(parser)
    parser.add_argument("--save", type=str, default=None, help="save results .npy")
    parser.add_argument("--profile", type=str, default=None, metavar="DIR",
                        help="write a torch.profiler trace of the solve to DIR/trace.json")
    return parser.parse_args(argv)


def load_clusters(cluster_dir: str, dataset: str, hypo: int) -> np.ndarray:
    name = CLUSTER_FILES[dataset].format(s=hypo)
    path = os.path.join(cluster_dir, name)
    if not os.path.exists(path) and os.path.exists(path.replace(".npy", ".pkl")):
        path = path.replace(".npy", ".pkl")  # the reference's README ships .pkl names
    return convert_cluster_file(path)


def build_dataset(config, args):
    ds_name = config.data.dataset
    if ds_name not in DATASETS:
        raise SystemExit(f"dataset {ds_name!r} has no reader in the port "
                         f"(readers: {', '.join(DATASETS)})")
    cls = DATASETS[ds_name]
    if ds_name == "wild":
        return cls(Path(args.data_dir, "wild"), sample_interval=config.ZeDO.sample)
    return cls(Path(args.data_dir, ds_name), subset="test", gt2d=args.gt, abs_coord=True,
               sample_interval=config.ZeDO.sample)


def cli_mesh(args):
    """The data mesh of the torchrun world when WORLD_SIZE > 1, else None."""
    device = getattr(args, "device", "cuda")
    if not init_from_env(device):
        return None
    return default_mesh(device=device)


def run_pipeline(config, args, dataset, logger_print=print, stopwatch=None,
                 mesh=None) -> torch.Tensor:
    """Shared solve path of opt_main and inference: [N, S, j, 3] poses on
    the device. logger_print: where the loading, dtype, trace and summary
    lines go (on a mesh, from the first rank only). stopwatch: an optional
    utils.profiling.Stopwatch that times the phases "ipo", "oil" and
    "solve", each to the end of the device's work. mesh: a data mesh
    (cli_mesh) to solve on; every rank gets all N poses."""
    dev = mesh.device if mesh is not None else resolve_device(getattr(args, "device", "cuda"))
    log = say(mesh, logger_print)
    preset = presets.from_optim_config(config)
    sample_poses = load_clusters(args.cluster_dir, config.data.dataset, args.hypo)

    ckpt_path = os.path.join(args.ckpt_dir, args.ckpt_name)
    log(f"loading model from {ckpt_path}")
    params, step = load_any_checkpoint(ckpt_path, preset.model_cfg, use_ema=args.ema,
                                       log=log, device=dev)
    log(f"=> loaded checkpoint '{ckpt_path}' (step {step})")
    dtype = resolve_dtype(args.dtype, dev)
    if dtype != args.dtype:
        log(f"--dtype auto -> {dtype} on {dev.type}")
    if dtype == "bf16":
        params = tree_map(lambda x: x.to(torch.bfloat16), params)

    cond2d, conf, k = dataset.arrays()
    n = len(cond2d)
    if args.strict_batch and config.ZeDO.batch != n:
        raise AssertionError(f"batch: {config.ZeDO.batch}, dataset len: {n}")
    sample_poses = np.asarray(sample_poses, np.float32).reshape(-1, N_JOINTS, JOINT_DIM)
    if len(sample_poses) < args.hypo:
        raise ValueError(
            f"cluster file provides {len(sample_poses)} poses but --hypo={args.hypo}")

    def put(a):
        return None if a is None else torch.from_numpy(np.ascontiguousarray(a)).to(dev)

    torch.manual_seed(args.seed)
    if stopwatch is None:
        stopwatch = profiling.Stopwatch()
    profile_dir = getattr(args, "profile", None) if mesh is None or mesh.is_main else None
    with contextlib.ExitStack() as stack:
        if profile_dir:
            stack.enter_context(profiling.trace(profile_dir))
        with torch.no_grad(), stopwatch.phase("solve"):
            clusters = put(sample_poses[:args.hypo])
            if mesh is None:
                poses = pipeline.solve(params, preset.model_cfg, preset.sde, preset.sampler,
                                       preset.zcfg, clusters, put(cond2d), put(conf), put(k),
                                       stopwatch=stopwatch).poses
            else:
                padded, mask = pad_batch({"cond2d": cond2d, "conf": conf, "k": k},
                                         mesh.shape["data"])
                poses = pipeline.solve_sharded(
                    mesh, params, preset.model_cfg, preset.sde, preset.sampler, preset.zcfg,
                    clusters, padded["cond2d"], padded["conf"], padded["k"], row_mask=mask,
                    stopwatch=stopwatch).poses[:n]
            if dev.type == "cuda":
                torch.cuda.synchronize(dev)
    elapsed = stopwatch.totals["solve"]
    if profile_dir:
        log(f"device trace written to {profile_dir}")
    log(f"solved {n} poses x {args.hypo} hypotheses x {preset.zcfg.oil.iterations} OIL steps "
        f"on {1 if mesh is None else mesh.size} device(s) in {elapsed:.2f}s "
        f"({n * args.hypo / elapsed:.1f} poses/s)")
    return poses


def evaluate(dataset, poses, stopwatch) -> tuple[float, float]:
    """Both protocols' tables; (protocol-1, protocol-2) errors in meters."""
    with stopwatch.phase("eval"):
        e1 = dataset.eval_multi(poses, protocol2=False, print_verbose=True)
        e2 = dataset.eval_multi(poses, protocol2=True, print_verbose=True)
    return e1, e2


def main(argv=None) -> dict:
    """Run the CLI; returns {poses [N, S, j, 3] on the device, p1, p2 (m),
    solve_s, eval_s, ipo_s, oil_s} for in-process callers (on a mesh, p1,
    p2 and eval_s on the first rank only, None on the others)."""
    args = parse_args(argv)
    mesh = cli_mesh(args)
    if mesh is None:
        resolve_device(args.device)
    config = apply_overrides(load_config(args.config), args.override)
    dataset = build_dataset(config, args)
    sw = profiling.Stopwatch()
    poses = run_pipeline(config, args, dataset, stopwatch=sw, mesh=mesh)
    out = {"poses": poses, "p1": None, "p2": None, "eval_s": None,
           **{f"{name}_s": sw.totals[name] for name in ("solve", "ipo", "oil")}}
    if mesh is None or mesh.is_main:
        if args.save:
            np.save(args.save, poses.cpu().numpy())
        print("eval...")
        out["p1"], out["p2"] = evaluate(dataset, poses, sw)
        out["eval_s"] = sw.totals["eval"]
    return out


if __name__ == "__main__":
    main()
