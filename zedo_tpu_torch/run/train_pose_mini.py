"""Pose-prior training CLI: train the score prior (or a ZeDO-i adapter) on
MINI-RGBD, SyRIP, both, or Human3.6M.

    python -m zedo_tpu_torch.run.train_pose_mini --config mini --epochs 2 \
        [--model score|control|cond] [--compute_dtype bf16] [--aug] [--rotflip] \
        [--fine_tune --fine_tune_ckpt adult.pth] [--restore_dir out/checkpoint_0.pth]

Port of zedo_tpu/run/train_pose_mini.py, with the same flags plus
`--device` (default cuda; `--device cpu` runs on the CPU).
`--mesh` takes JAX's grammar over the torchrun world: auto (data-parallel
over all ranks when there are more than one), off, dp[N] or dp[N],tpM
(e.g. `torchrun --nproc-per-node 4 -m zedo_tpu_torch.run.train_pose_mini
--mesh dp2,tp2 ...`): the batch is sharded over the data axis and, with
tp, the ScoreMLP's hidden dim over the model axis (train.trainer); rank 0
logs and writes the checkpoints. `--config`
takes a preset (mini, syrip, h36m) or the path of any config file the JAX
CLI takes (e.g. configs/optim/concat_pose_optimization_mini.py); `--override
data.dataset=concate` trains on MINI-RGBD and SyRIP together. The data stay
relative to the working directory (data/mini-rgbd, data/syrip, data/h36m),
the output under config.OUTPUT_DIR. Checkpoints are .pth files in the
reference's layout (utils/checkpoint.save_native); `--restore_dir` takes
one. JAX's `--prng` chooses between JAX's random number generators and has
no counterpart here.
"""
from __future__ import annotations

import argparse
import functools
import pprint
import time
from pathlib import Path

import numpy as np

from zedo_tpu_torch.data import H36MDataset3D, mini_rgbd, syrip
from zedo_tpu_torch.data.base import normalize_data
from zedo_tpu_torch.data.concat import ConcatDataset
from zedo_tpu_torch.models import control_mlp, score_mlp_cond
from zedo_tpu_torch.models.registry import make_mlp_config
from zedo_tpu_torch.parallel import collectives
from zedo_tpu_torch.parallel.mesh import init_from_env, mesh_from_spec
from zedo_tpu_torch.presets import load_config
from zedo_tpu_torch.run.opt_main import add_device_args
from zedo_tpu_torch.train import trainer
from zedo_tpu_torch.utils.checkpoint import load_torch_checkpoint
from zedo_tpu_torch.utils.config import apply_overrides, resolve_device
from zedo_tpu_torch.utils.generic import create_logger, quiet_logger

PRESETS = ("h36m", "mini", "syrip")


def parse_args(argv=None):
    parser = argparse.ArgumentParser(description="train score model")
    parser.add_argument("--config", required=True,
                        help="a preset (mini, syrip, h36m) or the path of a config file, "
                             "e.g. configs/optim/concat_pose_optimization_mini.py")
    parser.add_argument("--restore_dir", "--restore-dir", type=str, default=None,
                        help="a training checkpoint (.pth) to resume from")
    parser.add_argument("--sample", type=int, help="sample trainset to reduce data")
    parser.add_argument("--flip", default=False, action="store_true",
                        help="parsed and inert, as in the reference (flip follows --rotflip)")
    parser.add_argument("--rotflip", default=False, action="store_true")
    parser.add_argument("--fine_tune", default=False, action="store_true")
    parser.add_argument("--fine_tune_ckpt", type=str, default=None,
                        help=".pth checkpoint to fine-tune from")
    parser.add_argument("--name", type=str, default="")
    parser.add_argument("--log_name", type=str)
    parser.add_argument("--aug", default=False, action="store_true")
    parser.add_argument("--scaled", default=False, action="store_true",
                        help="parsed and inert, as in the reference")
    parser.add_argument("--epochs", type=int, default=None)
    parser.add_argument("--compute_dtype", type=str, default="fp32", choices=["fp32", "bf16"],
                        help="bf16 = mixed-precision train step (bf16 weights and input "
                             "as in the JAX package; f32 loss/grads/Adam/master weights)")
    parser.add_argument("--model", type=str, default="score", choices=["score", "control", "cond"],
                        help="'control' trains the ControlNet adapter with the trunk frozen "
                             "(combine with --fine_tune to seed the trunk); 'cond' trains "
                             "the conditional prior on the dataset's normalized 2D keypoints")
    parser.add_argument("--mesh", type=str, default="auto",
                        help="process mesh over the torchrun ranks: auto (data-parallel over "
                             "all ranks when >1), off, dp[N], or dp[N],tpM (e.g. dp4,tp2). The "
                             "batch is sharded over the data axis; with tp the ScoreMLP hidden "
                             "dim is sharded over the model axis")
    parser.add_argument("--override", action="append", default=[],
                        help="config override, e.g. --override training.batch_size=256")
    add_device_args(parser)
    return parser.parse_args(argv)


def build_train_dataset(config, args):
    name = config.data.dataset
    nj = config.DATASET.NUM_JOINT
    kwargs = dict(gt2d=True, read_confidence=False, sample_interval=args.sample or 1,
                  flip=args.rotflip, rot=args.rotflip, aug=args.aug)
    if name == "h36m":
        if args.aug:
            raise SystemExit("--aug is an infant-data option (mini/syrip prior rows); the "
                             "h36m reader has no augmentation source")
        return H36MDataset3D(Path("data", "h36m"), "train", gt2d=True,
                             sample_interval=args.sample or 1, flip=args.rotflip,
                             rot=args.rotflip)
    if name == "mini":
        return mini_rgbd("train", num_joint=17, **kwargs)
    if name == "syrip":
        return syrip("train", num_joint=nj, **kwargs)
    if name in ("syrip_concat", "concate"):
        return ConcatDataset([mini_rgbd("train", num_joint=nj, **kwargs),
                              syrip("train", num_joint=nj, **kwargs)])
    raise ValueError(name)


def build_eval_dataset(config, args):
    """The held-out split of the eval epochs' metrics, or None when its files
    are missing."""
    name = config.data.dataset
    nj = config.DATASET.NUM_JOINT
    kwargs = dict(gt2d=True, read_confidence=False, sample_interval=1)
    try:
        if name == "h36m":
            # stride 64: the metrics read at most 1024 rows
            return H36MDataset3D(Path("data", "h36m"), "test", gt2d=True, sample_interval=64)
        if name == "mini":
            return mini_rgbd("validate", num_joint=17, **kwargs)
        if name == "syrip":
            return syrip("validate", num_joint=nj, **kwargs)
        if name in ("syrip_concat", "concate"):
            return mini_rgbd("validate", num_joint=nj, **kwargs)
    except (FileNotFoundError, NotADirectoryError) as e:
        print(f"note: no held-out split for validation metrics ({e})")
    return None


def main(argv=None) -> dict:
    """Run the CLI; returns {state, history, eval_history, output_dir} for
    in-process callers."""
    args = parse_args(argv)
    init_from_env(args.device)
    mesh = mesh_from_spec(args.mesh, device=args.device)
    dev = mesh.device if mesh is not None else resolve_device(args.device)
    main_rank = mesh is None or mesh.is_main
    config = apply_overrides(load_config(args.config, PRESETS), args.override)
    if mesh is not None and mesh.size > 1 and not args.log_name:
        # one output directory for all ranks: the first rank's time stamp
        args.log_name = collectives.broadcast_object(time.strftime("%Y-%m-%d-%H-%M"), mesh)
    if main_rank:
        logger, final_output_dir, tb_log_dir = create_logger(
            config, "train", folder_name=args.name, log_name=args.log_name)
    else:
        logger, final_output_dir, tb_log_dir = quiet_logger(
            config, folder_name=args.name, log_name=args.log_name)
    logger.info(pprint.pformat(config))
    logger.info(pprint.pformat(vars(args)))
    logger.info(f"training device: {dev}")
    logger.info(f"training mesh: {mesh.shape}" if mesh is not None
                else "training mesh: single-device")
    writer = None
    if main_rank:
        try:
            from torch.utils.tensorboard import SummaryWriter

            writer = SummaryWriter(tb_log_dir)
        except Exception:  # TensorBoard is optional
            writer = None

    if args.model == "cond" and args.aug:
        raise SystemExit("--model cond is incompatible with --aug: augmentation rows carry "
                         "no 2D keypoints to condition on")

    dataset = build_train_dataset(config, args)
    logger.info(f"total train samples: {len(dataset.db_3d)}")
    model_cfg = make_mlp_config(config, n_joints=config.DATASET.NUM_JOINT)

    extra = {}
    if args.model == "control":
        extra = dict(model_apply_raw=control_mlp.apply, model_init=control_mlp.init_params,
                     post_init_fn=lambda p: control_mlp.init_control_params(p, model_cfg),
                     freeze_fn=control_mlp.trainable_mask)
        logger.info("ControlNet adapter training: trunk frozen, copy/zc/infant_cond trainable")
    elif args.model == "cond":
        mask_cfg = score_mlp_cond.CondMaskConfig(
            pose_mask_prob=float(config.training.get("cond_pose_mask_prob", 0.0)),
            part_mask_prob=float(config.training.get("cond_part_mask_prob", 0.0)),
            joint_mask_prob=float(config.training.get("cond_joint_mask_prob", 0.0)))
        condition_data = normalize_data(np.asarray(dataset.db_2d, np.float32)[..., :2])
        extra = dict(model_apply_raw=functools.partial(score_mlp_cond.apply, mask_cfg=mask_cfg),
                     model_init=score_mlp_cond.init_params, condition_data=condition_data)
        logger.info(f"conditional-prior training: condition = normalized 2D keypoints "
                    f"{condition_data.shape}, mask_cfg={mask_cfg}")

    fine_tune_params = None
    if args.fine_tune:
        if not args.fine_tune_ckpt:
            raise ValueError("--fine_tune requires --fine_tune_ckpt")
        if not args.fine_tune_ckpt.endswith(".pth"):
            raise NotImplementedError(
                f"{args.fine_tune_ckpt}: the port reads .pth checkpoints only")
        fine_tune_params = load_torch_checkpoint(args.fine_tune_ckpt, model_cfg, dev)["params"]

    tcfg = trainer.TrainerConfig(
        n_epochs=args.epochs or trainer.N_EPOCHES, data_scale=config.training.data_scale,
        seed=config.seed,
        preemption_ckpt_freq=int(config.training.get("snapshot_freq_for_preemption", 0) or 0),
        compute_dtype=args.compute_dtype)
    try:
        state, history, eval_history = trainer.train_loop(
            config, dataset, test_dataset=build_eval_dataset(config, args),
            output_dir=final_output_dir, model_cfg=model_cfg, trainer_cfg=tcfg,
            fine_tune_params=fine_tune_params, restore_dir=args.restore_dir or None,
            writer=writer, logger=logger, device=dev, mesh=mesh, **extra)
    finally:
        if writer is not None:
            writer.close()
        logger.info(f"End. Final output dir: {final_output_dir}")
    return {"state": state, "history": history, "eval_history": eval_history,
            "output_dir": final_output_dir}


if __name__ == "__main__":
    main()
