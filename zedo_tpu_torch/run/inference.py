"""In-the-wild inference CLI: solve a `wild` dataset (data/custom.py),
save the hypotheses and, with --eval, score them against the file's 3D.

    python -m zedo_tpu_torch.run.inference --config wild \
        --ckpt_dir checkpoint/ --ckpt_name checkpoint_1500.pth --hypo 1 --eval

Port of zedo_tpu/run/inference.py: the pipeline of run.opt_main, results
saved to --save (results.npy), the evaluation gated on --eval. Under
torchrun it solves on a data mesh of the ranks, as run.opt_main does, and
rank 0 saves and evaluates.
"""
from __future__ import annotations

import argparse

import numpy as np

from zedo_tpu_torch.run.opt_main import (
    add_common_args, build_dataset, cli_mesh, evaluate, run_pipeline,
)
from zedo_tpu_torch.presets import load_config
from zedo_tpu_torch.utils import profiling
from zedo_tpu_torch.utils.config import apply_overrides, resolve_device


def parse_args(argv=None):
    parser = argparse.ArgumentParser(description="in-the-wild inference")
    add_common_args(parser)
    parser.add_argument("--eval", action="store_true", default=False,
                        help="evaluate against provided GT 3D")
    parser.add_argument("--save", type=str, default="results.npy")
    return parser.parse_args(argv)


def main(argv=None) -> dict:
    """Run the CLI; returns {poses on the device, solve_s, and with --eval
    p1, p2 (m) and eval_s}."""
    args = parse_args(argv)
    mesh = cli_mesh(args)
    if mesh is None:
        resolve_device(args.device)
    config = apply_overrides(load_config(args.config), args.override)
    dataset = build_dataset(config, args)
    sw = profiling.Stopwatch()
    poses = run_pipeline(config, args, dataset, stopwatch=sw, mesh=mesh)
    out = {"poses": poses, "solve_s": sw.totals["solve"]}
    if mesh is not None and not mesh.is_main:
        return out
    np.save(args.save, poses.cpu().numpy())
    print(f"saved results to {args.save}")
    if args.eval:
        out["p1"], out["p2"] = evaluate(dataset, poses, sw)
        out["eval_s"] = sw.totals["eval"]
    return out


if __name__ == "__main__":
    main()
