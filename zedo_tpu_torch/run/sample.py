"""Prior sampling, completion and denoising CLI: the legacy GFPose-style task
surface (pose generation `gen`, 3D estimation `est`, 2D/3D completion
`comp2d`/`comp3d`, denoising `den`) over the full-loop samplers.

    python -m zedo_tpu_torch.run.sample --config h36m --ckpt_dir ... \
        --ckpt_name ... --task gen --num 64 --save out.npy
    ... --task comp3d --input poses.npy --jlist 14,15,16
    ... --task den --input noisy.npy
    ... --sampler ode --num 1024
    ... --guide sym | --guide match --guide_input targets.npy

Port of zedo_tpu/run/sample.py on one device, with the same flags plus
`--device` (default cuda; `--device cpu` runs on the CPU). `--config` takes
a preset (h36m, 3dhp, 3dpw, ski, wild, mini, syrip) or the path of any
config file the JAX CLI takes. Samples are written as [N, j, 3] .npy.
Both samplers run compiled, as JAX's jit them (`PCSampler.sample_loop_jit`,
`ODESampler.sample_jit`: CUDA graphs on the card).
"""
from __future__ import annotations

import argparse
import os
import time

import numpy as np
import torch

from zedo_tpu_torch.diffusion.guidance import get_match_grad_fn, get_sym_gradient_fn
from zedo_tpu_torch.diffusion.ode import ODESampler
from zedo_tpu_torch.diffusion.sampling import PCSampler, make_task_mask
from zedo_tpu_torch.diffusion.sde import build_sde
from zedo_tpu_torch.models import score_mlp
from zedo_tpu_torch.models.registry import make_mlp_config
from zedo_tpu_torch.presets import OPTIM_PRESETS, load_config
from zedo_tpu_torch.utils.checkpoint import load_any_checkpoint
from zedo_tpu_torch.utils.config import apply_overrides, resolve_device

ODE_MAX_NFE = 20000 * 7  # the RK45 step budget


def parse_args(argv=None):
    parser = argparse.ArgumentParser(description="sample the pose prior")
    parser.add_argument("--config", required=True,
                        help="a preset or the path of a config file, "
                             "e.g. configs/optim/concat_pose_optimization_h36m.py")
    parser.add_argument("--ckpt_dir", type=str)
    parser.add_argument("--ckpt_name", type=str)
    parser.add_argument("--task", type=str, default="gen",
                        choices=["gen", "den", "est", "comp2d", "comp3d"])
    parser.add_argument("--num", type=int, default=64, help="samples (gen)")
    parser.add_argument("--input", type=str, default=None,
                        help="npy with [N, j, 3] inputs (den/est/comp*)")
    parser.add_argument("--jlist", type=str, default=None,
                        help="comma-separated joints to impute (comp*)")
    parser.add_argument("--randj", type=int, default=None,
                        help="random limb joints to impute (comp*)")
    parser.add_argument("--sampler", type=str, default=None, choices=[None, "pc", "ode"],
                        help="override config")
    parser.add_argument("--warm_start_steps", type=int, default=0,
                        help="the first k steps at t = sde.T (the legacy sampler used 50)")
    parser.add_argument("--guide", type=str, default=None, choices=[None, "match", "sym"],
                        help="guidance objective descended each step: 'match' pulls x-y "
                             "toward --guide_input 2D targets; 'sym' penalizes "
                             "left/right limb-length asymmetry")
    parser.add_argument("--guide_weight", type=float, default=1.0)
    parser.add_argument("--guide_input", type=str, default=None,
                        help="npy with [N, j, 2] 2D targets (--guide match)")
    parser.add_argument("--ema", action="store_true", default=False)
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--save", type=str, default="samples.npy")
    parser.add_argument("--override", action="append", default=[],
                        help="config override, e.g. --override model.num_scales=500")
    parser.add_argument("--device", type=str, default="cuda")
    return parser.parse_args(argv)


def main(argv=None) -> dict:
    """Run the CLI; returns {samples [N, j, 3] on the device, seconds (the
    sampler's, to the end of the device's work), nfe (ode only)}."""
    args = parse_args(argv)
    dev = resolve_device(args.device)
    config = apply_overrides(load_config(args.config, OPTIM_PRESETS), args.override)
    n_joints = config.DATASET.get("NUM_JOINT", 17)
    model_cfg = make_mlp_config(config, n_joints=n_joints)
    params, _step = load_any_checkpoint(os.path.join(args.ckpt_dir, args.ckpt_name), model_cfg,
                                        use_ema=args.ema, device=dev)
    m = config.model
    sde = build_sde(config.training.sde, beta_min=m.beta_min, beta_max=m.beta_max,
                    sigma_min=m.sigma_min, sigma_max=m.sigma_max, n=m.num_scales,
                    t_max=1.0)  # full-range sampling
    continuous = config.training.continuous
    gen = torch.Generator(device=dev).manual_seed(args.seed)

    if args.input is not None:
        data = torch.as_tensor(np.load(args.input).astype(np.float32), device=dev)
        n = len(data)
    else:
        if args.task != "gen":
            raise SystemExit(f"--input required for task {args.task}")
        data, n = None, args.num
    shape = (n, n_joints, 3)

    method = args.sampler or config.sampling.method.lower()
    nfe = None
    t0 = time.perf_counter()
    with torch.no_grad():
        if method == "ode":
            if args.task != "gen":
                raise SystemExit(f"--task {args.task} requires the pc sampler (the task masks "
                                 "impute between pc steps); drop --sampler ode")
            if args.guide:
                raise SystemExit("--guide requires the pc sampler (guidance steps between "
                                 "predictor updates); drop --sampler ode or the config's "
                                 "method=ode")
            sampler = ODESampler(sde=sde, shape=shape, denoise=config.sampling.noise_removal,
                                 eps=1e-3)
            samples, nfe = sampler.sample_jit(score_mlp.apply, params, model_cfg, gen,
                                              continuous=continuous)
            print(f"ODE sampler finished, nfe={nfe}")
            if nfe >= ODE_MAX_NFE:
                print("WARNING: ODE step budget exhausted: integration may not have reached "
                      "t_eps; samples may be unconverged")
        else:
            sampler = PCSampler(
                sde=sde, predictor=config.sampling.predictor.lower(),
                corrector=config.sampling.corrector.lower(), snr=config.sampling.snr,
                n_steps=config.sampling.n_steps_each, probability_flow=False,
                continuous=continuous, denoise=config.sampling.noise_removal, eps=1e-3)
            mask = condition = x_init = None
            if args.task != "gen":
                mask = torch.as_tensor(make_task_mask(args.task, shape, jlist=args.jlist,
                                                      randj=args.randj, seed=args.seed),
                                       device=dev)
                condition = data
                if args.task == "den":
                    x_init, mask = data, None
            guidance_fn = guidance_condition = None
            if args.guide == "match":
                if args.guide_input is None:
                    raise SystemExit("--guide match requires --guide_input "
                                     "(npy with [N, j, 2] 2D targets)")
                guidance_condition = torch.as_tensor(
                    np.load(args.guide_input).astype(np.float32), device=dev)
                guidance_fn = get_match_grad_fn(args.guide_weight)
            elif args.guide == "sym":
                guidance_fn = get_sym_gradient_fn(args.guide_weight)
            samples = sampler.sample_loop_jit(
                score_mlp.apply, params, model_cfg, gen, shape, condition=condition, mask=mask,
                x_init=x_init, warm_start_steps=args.warm_start_steps, guidance_fn=guidance_fn,
                guidance_condition=guidance_condition)
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
    seconds = time.perf_counter() - t0
    print(f"sampled {n} poses ({method}, task {args.task}) in {seconds:.3f} s "
          f"({n / seconds:.1f} samples/s)")
    np.save(args.save, samples.cpu().numpy())
    print(f"saved {tuple(samples.shape)} samples to {args.save}")
    return {"samples": samples, "seconds": seconds, "nfe": nfe}


if __name__ == "__main__":
    main()
