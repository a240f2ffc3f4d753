"""Score-prior training loop (port of zedo_tpu/train/trainer.py, the
reference's run/train_pose_mini.py), on one device or on a mesh of ranks.

Each epoch shuffles the in-memory poses with RandomState([seed, epoch]) and
augments each batch with RandomState([seed, epoch, i]) (numpy, so the same
batches as the JAX package); the step's (t, z) and dropout draws come from a
generator seeded from (seed, epoch, i), so a resumed run draws what an
uninterrupted one would. The losses stay on the device until the epoch
ends. An eval epoch samples the EMA prior with the full PC loop, scores the
samples against the held-out poses (identity-covariance Mahalanobis to
their mean) and solves a micro zero-shot scene with the EMA weights (IPO +
OIL through `pipeline.solve_jit`), then writes a checkpoint
(utils/checkpoint.save_native).

On a mesh (`train_loop(mesh=...)`, `make_sharded_train_step`) each rank
takes its rows of every batch and the step keeps the global batch's
semantics, as JAX's GSPMD-partitioned step does: every rank draws the
global batch's times, noise and dropout masks and keeps its own
(utils.rng); the gradients and the loss are averaged over the data
axis before the clip and Adam, so the replicas stay bit-identical. With a
model axis the ScoreMLP is tensor-parallel (parallel.tensor_parallel): the
leaves, their Adam moments and EMA shadows live as this rank's blocks, the
gradient norm of the clip is the global one, and checkpoints are gathered
to the full reference layout, so a run saved under one mesh resumes under
another. Only the mesh's first rank writes checkpoints, samples and
TensorBoard scalars and logs.
"""
from __future__ import annotations

import dataclasses
import os
from typing import Optional

import numpy as np
import torch

from zedo_tpu_torch.data import evaluation
from zedo_tpu_torch.diffusion import ema as ema_lib
from zedo_tpu_torch.diffusion import losses as losses_lib
from zedo_tpu_torch.diffusion.sampling import PCSampler
from zedo_tpu_torch.diffusion.sde import build_sde
from zedo_tpu_torch.models import score_mlp
from zedo_tpu_torch.models.nn import tree_to_flat
from zedo_tpu_torch.ops import metrics as metrics_lib
from zedo_tpu_torch.parallel import collectives
from zedo_tpu_torch.parallel import tensor_parallel as tp_lib
from zedo_tpu_torch.utils import rng
from zedo_tpu_torch.utils import checkpoint as ckpt_lib
from zedo_tpu_torch.utils.config import resolve_device

N_EPOCHES = 8000  # the reference's epoch count
EVAL_FREQ = 500


def dataset_eval(preds, dataset, protocol2=False, print_verbose=False,
                 sample_interval=None, concate=False):
    """Action-wise MPJPE over a (possibly concatenated) dataset's gt items
    (actions 2..21, empty actions skipped); sample_interval strides the
    predictions and the GT together."""
    print("eval...")
    if concate:
        gt_items = [g for d in dataset.datasets for g in d.gt_dataset]
    else:
        gt_items = dataset.gt_dataset
    assert len(preds) == len(gt_items)
    if sample_interval is not None:
        preds = preds[::sample_interval]
        gt_items = list(gt_items)[::sample_interval]
    report = evaluation.single_eval(
        np.asarray(preds), evaluation.gt_from_items(gt_items), protocol2=protocol2,
        actions=evaluation.actions_from_items(gt_items), action_order=list(range(2, 22)))
    return report.error


class AverageMeter:
    def __init__(self):
        self.reset()

    def reset(self):
        self.val = 0.0
        self.avg = 0.0
        self.sum = 0.0
        self.count = 0

    def update(self, val, n=1):
        self.val = val
        self.sum += val * n
        self.count += n
        self.avg = self.sum / self.count if self.count != 0 else 0


@dataclasses.dataclass
class TrainerConfig:
    n_epochs: int = N_EPOCHES
    eval_freq: int = EVAL_FREQ
    data_scale: float = 1.0
    sampling_eps: float = 1e-3
    seed: int = 42
    # an overwrite-in-place checkpoint every k optimizer steps, for
    # preemption recovery with restore_dir; 0 = off
    preemption_ckpt_freq: int = 0
    # the per-eval micro zero-shot solve on a fixed synthetic scene built
    # from held-out poses: the prior's downstream use
    micro_solve: bool = True
    micro_solve_poses: int = 16
    micro_solve_iters: int = 100
    # 'bf16' casts the weights and the input of the train forward to bf16
    # while the loss, gradients, Adam moments and master weights stay f32
    # (losses.mixed_precision_apply); eval sampling and the metrics stay f32
    compute_dtype: str = "fp32"


def _build_micro_scene(gt: np.ndarray, data_scale: float, n_scene: int, seed: int):
    """Fixed synthetic zero-shot scene: held-out poses at z = 4.5 m before a
    pinhole camera, projected to 2D, in the model's scaled units."""
    rs = np.random.RandomState(seed)
    idx = rs.choice(len(gt), size=min(n_scene, len(gt)), replace=False)
    pose = (gt[idx] - gt[idx, 0:1]) * data_scale
    t = np.zeros((len(pose), 1, 3), np.float32)
    t[..., 2] = 4.5 * data_scale
    k = np.zeros((len(pose), 3, 3), np.float32)
    k[:, 0, 0] = k[:, 1, 1] = 1100.0
    k[:, 0, 2] = k[:, 1, 2] = 512.0
    k[:, 2, 2] = 1.0
    cam = pose + t
    px = np.einsum("bij,bnj->bni", k, cam)
    px = (px[..., :2] / px[..., 2:]).astype(np.float32)
    cluster = np.mean(pose, axis=0, keepdims=True).astype(np.float32)
    return dict(gt=pose.astype(np.float32), px=px, k=k, cluster=cluster)


def _bound_apply(model_apply_raw, model_cfg, compute_dtype: str = "fp32"):
    def model_apply(p, x, labels, cond, msk, train=False, generator=None):
        return model_apply_raw(p, model_cfg, x, labels, cond, msk, train=train,
                               generator=generator)

    if compute_dtype == "bf16":
        return losses_lib.mixed_precision_apply(model_apply, torch.bfloat16)
    if compute_dtype != "fp32":
        raise ValueError(f"compute_dtype {compute_dtype!r}: fp32 or bf16")
    return model_apply


def make_train_step(sde, model_apply_raw, model_cfg, optimizer, reduce_mean=False,
                    continuous=True, likelihood_weighting=False, compute_dtype: str = "fp32",
                    grad_mask=None):
    """The TrainState step for a score_mlp.apply-style model, compiled (JAX's
    jax.jit(step_fn)): one CUDA graph a step on the card, replayed on the
    state's tensors (diffusion/losses.py)."""
    return losses_lib.get_step_fn(
        sde, _bound_apply(model_apply_raw, model_cfg, compute_dtype), optimizer, train=True,
        reduce_mean=reduce_mean, continuous=continuous,
        likelihood_weighting=likelihood_weighting, grad_mask=grad_mask, compiled=True)


class MeshSync:
    """The reductions of a train step on a mesh (losses.get_step_fn's
    `sync`): the global batch's draws sliced to this rank, the replicated
    leaves' gradients summed over the model axis (tensor parallelism), every
    gradient and the loss averaged over the data axis, and under tensor
    parallelism the global gradient norm."""

    def __init__(self, mesh, data_axis: str = "data", model_axis: str = "model",
                 rules: Optional[dict] = None, hidden: Optional[int] = None):
        self.mesh, self.data_axis, self.model_axis = mesh, data_axis, model_axis
        self.rules, self.hidden = rules, hidden  # rules: {leaf name: tp rule} or None
        # the tensor-parallel forward gathers and sums between its layers
        self.forward_collectives = rules is not None

    def generator(self, gen, batch) -> rng.ShardedGenerator:
        b, m = batch.shape[0], self.mesh
        i = m.index(self.data_axis)
        cols = None
        if self.rules is not None:
            w = self.hidden // m.axis_size(self.model_axis)
            cols = slice(m.index(self.model_axis) * w, (m.index(self.model_axis) + 1) * w)
        return rng.ShardedGenerator(gen, slice(i * b, (i + 1) * b),
                                      b * m.axis_size(self.data_axis), cols, self.hidden)

    def _all_reduce(self, tensors: list, axis: str, mean: bool) -> list:
        flat = torch.cat([t.reshape(-1).float() for t in tensors])
        flat = (collectives.pmean if mean else collectives.psum)(flat, self.mesh, axis)
        return [piece.view_as(t).to(t.dtype)
                for piece, t in zip(flat.split([t.numel() for t in tensors]), tensors)]

    def reduce(self, names, grads: list, loss: torch.Tensor):
        grads = list(grads)
        if self.rules is not None:
            repl = [i for i, n in enumerate(names) if self.rules[n] == "replicated"]
            for i, g in zip(repl, self._all_reduce([grads[i] for i in repl], self.model_axis,
                                                   mean=False)):
                grads[i] = g
        *grads, loss = self._all_reduce(grads + [loss.detach()], self.data_axis, mean=True)
        return grads, loss

    def grad_norm(self, names):
        """None (the gradients are whole and equal on every rank) or the
        global norm of tensor-parallel shards."""
        if self.rules is None:
            return None
        sharded = [self.rules[n] != "replicated" for n in names]

        def norm(grads):
            sq = [torch.linalg.vector_norm(g.float()) ** 2 for g in grads]
            zero = sq[0].new_zeros(())
            part = sum((s for s, sh in zip(sq, sharded) if sh), zero)
            whole = sum((s for s, sh in zip(sq, sharded) if not sh), zero)
            return torch.sqrt(collectives.psum(part, self.mesh, self.model_axis) + whole)

        return norm


def make_sharded_train_step(mesh, sde, model_apply_raw, model_cfg, optimizer,
                            data_axis: str = "data", reduce_mean=False,
                            compute_dtype: str = "fp32", continuous=True,
                            likelihood_weighting=False, grad_mask=None, tp_rules=None,
                            model_axis: str = "model"):
    """The train step on a mesh: each rank passes its rows of the global
    batch (`rows(n)` is this rank's slice of a batch of n rows). tp_rules:
    the flat tensor_parallel rules of a state sharded over `model_axis`
    (score_mlp.apply only), else None. Returns (step_fn, rows). The step is
    compiled as two calls, the loss and gradients, then the clip, Adam and
    the EMA; the mesh's reductions (and under tensor parallelism the global
    gradient norm's) run between them, outside the graphs: Gloo's
    collectives cannot be captured, and NCCL's are kept out with them, one
    path for both. Under tensor parallelism the forward and backward run
    collectives between their layers, so the first call runs eagerly and
    only the clip, Adam and the EMA are compiled."""
    if tp_rules is not None:
        if model_apply_raw is not score_mlp.apply:
            raise ValueError("tensor parallelism takes the plain ScoreMLP (score_mlp.apply) "
                             "only; train adapters with a data-parallel mesh")
        model_apply_raw = tp_lib.make_apply(mesh, model_axis)
    sync = MeshSync(mesh, data_axis, model_axis, tp_rules, model_cfg.hidden_dim)
    step = losses_lib.get_step_fn(
        sde, _bound_apply(model_apply_raw, model_cfg, compute_dtype), optimizer, train=True,
        reduce_mean=reduce_mean, continuous=continuous,
        likelihood_weighting=likelihood_weighting, grad_mask=grad_mask, sync=sync,
        compiled=True)
    return step, lambda n: mesh.row_slice(n, data_axis)


def step_seed(*keys: int) -> int:
    """A 63-bit seed derived from integer keys (seed, epoch, step)."""
    return int(np.random.SeedSequence(list(keys)).generate_state(1, np.uint64)[0] >> 1)


def _map_adam(opt_state: dict, names: list, fn) -> dict:
    """An Adam state_dict with each leaf's moments replaced by fn(moment,
    leaf name); leaf i of the state is names[i]."""
    state = {i: {k: fn(v, names[i]) if k in ("exp_avg", "exp_avg_sq") else v
                 for k, v in s.items()} for i, s in opt_state["state"].items()}
    return {"state": state, "param_groups": opt_state["param_groups"]}


def _save(path, epoch, state, model_cfg, mesh=None, rules=None):
    """A checkpoint of the full state, written by the mesh's first rank (the
    tensor-parallel blocks gathered first; every rank takes part)."""
    params, ema, opt_state = state.params, state.ema, state.opt_state.state_dict()
    # the learning rate as a number, whatever device's Adam wrote it
    opt_state["param_groups"] = [{**g, "lr": float(g["lr"])} for g in opt_state["param_groups"]]
    if rules is not None:
        names = [n for n, _ in state.leaves()]
        params = tp_lib.gather_tree(params, rules, mesh)
        ema = dataclasses.replace(ema, shadow_params=tp_lib.gather_tree(ema.shadow_params,
                                                                        rules, mesh))
        opt_state = _map_adam(opt_state, names,
                              lambda v, n: tp_lib.gather_leaf(v, rules[n], mesh))
    if mesh is None or mesh.is_main:
        ckpt_lib.save_native(path, epoch, state.step, params, ema, opt_state, model_cfg)
    if mesh is not None:
        collectives.barrier(mesh)  # the file is whole before any rank reads it


def _wants(ds, attr: str) -> bool:
    return bool(getattr(ds, attr, False)) or any(_wants(m, attr)
                                                 for m in getattr(ds, "datasets", []))


def train_loop(config, dataset, test_dataset=None, *, output_dir: str = "./output/train",
               model_apply_raw=score_mlp.apply, model_init=score_mlp.init_params,
               model_cfg: Optional[score_mlp.ScoreMLPConfig] = None,
               trainer_cfg: TrainerConfig = TrainerConfig(),
               fine_tune_params: Optional[dict] = None, restore_dir: Optional[str] = None,
               writer=None, logger=None, mesh=None, post_init_fn=None, freeze_fn=None,
               condition_data=None, device="cuda"):
    """The epoch loop. Returns (state, per-epoch mean losses, eval records).

    `dataset` supplies db_3d [N, j, 3]; batches are shuffled slices of it.
    post_init_fn(params) -> params runs after the fine-tune merge (e.g.
    control_mlp.init_control_params); freeze_fn(params) -> bool dict marks
    the trainable leaves; condition_data: optional [N, j, c] conditions
    aligned with db_3d (conditional-prior training). restore_dir: a
    checkpoint of `save_native` to resume from (epoch, step, params, EMA,
    Adam), skipping the batches of a partly trained epoch.
    mesh: a parallel.mesh.Mesh with a 'data' axis (and optionally 'model',
    tensor parallelism of the plain ScoreMLP); the ranks compute on
    mesh.device (`device` is then unused) and return this rank's state, its
    blocks of the leaves under tensor parallelism."""
    main = mesh is None or mesh.is_main
    if mesh is not None:
        mesh.require_member()
        if "data" not in mesh.shape:
            raise ValueError(f"training mesh needs a 'data' axis, got {mesh.axis_names}")
    dev = mesh.device if mesh is not None else resolve_device(device)
    log = (logger.info if logger else print) if main else (lambda *a, **k: None)
    writer = writer if main else None
    os.makedirs(output_dir, exist_ok=True)

    if model_cfg is None:
        from zedo_tpu_torch.models.registry import make_mlp_config

        model_cfg = make_mlp_config(config, n_joints=config.DATASET.NUM_JOINT)

    params = model_init(torch.Generator().manual_seed(trainer_cfg.seed), model_cfg, device=dev)
    if fine_tune_params is not None:
        # strict=False: the checkpoint's matching leaves
        params = ckpt_lib._merge(params, fine_tune_params)
    if post_init_fn is not None:
        params = post_init_fn(params)
    grad_mask = freeze_fn(params) if freeze_fn is not None else None
    if grad_mask is not None:
        flags = list(tree_to_flat(grad_mask).values())
        log(f"freeze: {len(flags) - sum(map(bool, flags))}/{len(flags)} param leaves frozen "
            f"({sum(map(bool, flags))} trainable)")

    rules = None
    if mesh is not None and mesh.axis_size("model") > 1:
        rules = tp_lib.check(params, model_cfg, mesh)
        log(f"tensor parallelism: the ScoreMLP's hidden dim over {mesh.shape['model']} ranks")

    def place(tree):
        return tp_lib.shard_tree(tree, rules, mesh) if rules is not None else tree

    optimizer = losses_lib.get_optimizer(config)
    state = losses_lib.init_train_state(place(params), optimizer, config.model.ema_rate)

    start_epoch = 0
    if restore_dir:
        restored = ckpt_lib.restore_native(restore_dir, dev)
        state = losses_lib.init_train_state(place(restored["params"]), optimizer,
                                            config.model.ema_rate)
        state.step = restored["step"]
        opt_state = restored["opt_state"]
        if rules is not None:
            names = [n for n, _ in state.leaves()]
            opt_state = _map_adam(opt_state, names,
                                  lambda v, n: tp_lib.shard_leaf(v, rules[n], mesh))
        optimizer.load_state(state.opt_state, opt_state)
        ema = restored["ema"]
        state.ema = ema_lib.EMAState(decay=ema["decay"], num_updates=ema["num_updates"],
                                     shadow_params=place(ema["shadow_params"]))
        start_epoch = restored["epoch"]
        log(f"resumed from {restore_dir} at epoch {start_epoch}, step {state.step}")

    sde = build_sde(config.training.sde, beta_min=config.model.beta_min,
                    beta_max=config.model.beta_max, sigma_min=config.model.sigma_min,
                    sigma_max=config.model.sigma_max, n=config.model.num_scales)
    step_kw = dict(reduce_mean=config.training.reduce_mean,
                   continuous=config.training.continuous,
                   likelihood_weighting=config.training.likelihood_weighting,
                   compute_dtype=trainer_cfg.compute_dtype, grad_mask=grad_mask)
    if mesh is not None:
        train_step, rows = make_sharded_train_step(mesh, sde, model_apply_raw, model_cfg,
                                                   optimizer, tp_rules=rules, **step_kw)
    else:
        train_step = make_train_step(sde, model_apply_raw, model_cfg, optimizer, **step_kw)

    # eval-time sampler: the full PC loop, without the probability flow
    sampling = config.sampling
    eval_sampler = PCSampler(
        sde=sde, predictor=sampling.predictor.lower(), corrector=sampling.corrector.lower(),
        snr=sampling.snr, n_steps=sampling.n_steps_each, probability_flow=False,
        continuous=config.training.continuous, denoise=sampling.noise_removal,
        eps=trainer_cfg.sampling_eps)

    data_3d = np.asarray(dataset.db_3d, np.float32) * trainer_cfg.data_scale
    n = len(data_3d)
    augment = getattr(dataset, "augment_batch", None)
    if augment is not None and not (_wants(dataset, "flip") or _wants(dataset, "rot")):
        augment = None
    augment_cond = None
    if condition_data is not None:
        condition_data = np.asarray(condition_data, np.float32)
        if len(condition_data) != n:
            raise ValueError(
                f"condition_data has {len(condition_data)} rows but db_3d has {n}: "
                f"conditions must align 1:1 with the training poses")
        if augment is not None:
            # the 2D condition is flipped together with the pose; the 3D
            # rotation has no 2D counterpart and is skipped
            augment_cond = getattr(dataset, "augment_batch_cond", None)
            if augment_cond is None:
                raise ValueError(
                    "conditional training with augmentation requires the dataset to "
                    "provide augment_batch_cond (joint pose + condition flip)")
            if _wants(dataset, "rot"):
                log("conditional training: the 3D-rotation aug has no 2D counterpart; only "
                    "the flip aug is applied (jointly to pose and condition)")
            augment = None
    batch_size = min(config.training.batch_size, n)
    if mesh is not None:
        # each rank takes an equal block of rows: keep the batch divisible
        # by the data-axis size (round down, never below one row a rank)
        n_data = mesh.shape["data"]
        if n < n_data:
            raise ValueError(f"dataset has {n} rows < data-axis size {n_data}; "
                             f"use --mesh off or a smaller dp")
        rounded = max(n_data, (batch_size // n_data) * n_data)
        if rounded != batch_size:
            log(f"batch_size {batch_size} -> {rounded} (multiple of data-axis size {n_data})")
        batch_size = rounded
    own = rows(batch_size) if mesh is not None else slice(None)
    steps_per_epoch = max(1, n // batch_size)

    # a preemption checkpoint records the current epoch and the global step:
    # skip the batches already trained
    resume_skip = 0
    if restore_dir:
        resume_skip = state.step - start_epoch * steps_per_epoch
        if not 0 <= resume_skip < steps_per_epoch:
            resume_skip = 0
        if resume_skip:
            log(f"mid-epoch resume: skipping the first {resume_skip} already-trained "
                f"batches of epoch {start_epoch}")

    on_cuda = dev.type == "cuda"

    def upload(a: np.ndarray) -> torch.Tensor:
        t = torch.from_numpy(np.ascontiguousarray(a))
        # a copy from pinned memory does not hold the host
        return t.pin_memory().to(dev, non_blocking=True) if on_cuda else t.to(dev)

    data_dev = upload(data_3d) if augment is None and augment_cond is None else None
    cond_dev = (upload(condition_data) if condition_data is not None and data_dev is not None
                else None)

    eval_gt, micro_scene, micro_solver = None, None, None
    if test_dataset is not None:
        gt_items = getattr(test_dataset, "gt_dataset", None)
        if gt_items:
            eval_gt = np.asarray(evaluation.gt_from_items(list(gt_items)), np.float32)
        else:
            eval_gt = np.asarray(test_dataset.db_3d, np.float32)
        eval_gt = eval_gt - eval_gt[:, 0:1]
        if trainer_cfg.micro_solve:
            micro_scene = _build_micro_scene(eval_gt, trainer_cfg.data_scale,
                                             trainer_cfg.micro_solve_poses, trainer_cfg.seed)
            micro_solver = _micro_solver(micro_scene, model_apply_raw, model_cfg, sde,
                                         trainer_cfg, dev)

    history, eval_history = [], []
    lr_schedule_fn = losses_lib.lr_schedule(config)
    gen = torch.Generator(device=dev)
    for epoch in range(start_epoch, trainer_cfg.n_epochs):
        perm = np.random.RandomState([trainer_cfg.seed, epoch]).permutation(n)
        perm_dev = upload(perm) if data_dev is not None else None
        step_losses = []
        for i in range(steps_per_epoch):
            if epoch == start_epoch and i < resume_skip:
                continue
            gen.manual_seed(step_seed(trainer_cfg.seed, epoch, i))
            if data_dev is not None:
                idx = perm_dev[i * batch_size:(i + 1) * batch_size][own]
                batch = data_dev[idx]
                cond = cond_dev[idx] if cond_dev is not None else None
            else:
                idx = perm[i * batch_size:(i + 1) * batch_size]
                batch_np = data_3d[idx]
                cond_np = condition_data[idx] if condition_data is not None else None
                aug_rng = np.random.RandomState([trainer_cfg.seed, epoch, i])
                if augment is not None:
                    batch_np = augment(batch_np, aug_rng)
                elif augment_cond is not None:
                    batch_np, cond_np = augment_cond(batch_np, cond_np, aug_rng)
                batch = upload(batch_np[own])
                cond = upload(cond_np[own]) if cond_np is not None else None
            state, loss = train_step(state, gen, batch, cond, None)
            step_losses.append((i, loss))
            if (trainer_cfg.preemption_ckpt_freq
                    and state.step % trainer_cfg.preemption_ckpt_freq == 0):
                _save(os.path.join(output_dir, "checkpoint_preempt.pth"), epoch, state,
                      model_cfg, mesh, rules)
        meter = AverageMeter()
        if step_losses:
            values = torch.stack([loss for _, loss in step_losses]).cpu().tolist()
            for (i, _), loss in zip(step_losses, values):
                meter.update(loss)
                if writer is not None:
                    writer.add_scalar("train_loss", loss, i + epoch * steps_per_epoch)
        log(f"EPOCH: [{epoch}/{trainer_cfg.n_epochs}], Loss: {meter.avg}")
        if writer is not None:
            writer.add_scalar("Loss/train", meter.avg, epoch)
            # the lr of the epoch's last step, from the pre-increment counter
            writer.add_scalar("opt_LR_1", float(lr_schedule_fn(max(state.step - 1, 0))), epoch)
        history.append(meter.avg)

        if epoch % trainer_cfg.eval_freq == 0:
            # every rank samples and scores the same full EMA weights
            ema_params = ema_lib.params_of(state.ema)
            if rules is not None:
                ema_params = tp_lib.gather_tree(ema_params, rules, mesh)

            gen.manual_seed(step_seed(trainer_cfg.seed, epoch, 1 << 30))
            with torch.no_grad():
                # compiled, keyed by the shapes: a new EMA captures nothing anew
                results = eval_sampler.sample_loop_jit(
                    model_apply_raw, ema_params, model_cfg, gen,
                    (min(config.eval.batch_size, n), model_cfg.n_joints, model_cfg.joint_dim),
                    continuous=True)
            results = results.cpu().numpy() / trainer_cfg.data_scale
            if main:
                np.save(os.path.join(output_dir, f"results_{epoch}.npy"), results)

            if eval_gt is not None:
                # identity-covariance Mahalanobis: squared distance to the
                # held-out mean, both populations capped at 1024 rows
                gt_c = eval_gt[:1024]
                pred_c = results[:1024] - results[:1024, 0:1]
                m_gt, cov = metrics_lib.mean_cov(gt_c)
                prior_dist = float(np.mean(metrics_lib.mahalanobis(m=m_gt, cov=cov,
                                                                   x=pred_c[None])))
                gt_self = float(np.mean(metrics_lib.mahalanobis(m=m_gt, cov=cov,
                                                                x=gt_c[None])))
                log(f"EPOCH: [{epoch}] eval prior mahalanobis (samples vs held-out mean): "
                    f"{prior_dist:.4f} (held-out self-distance {gt_self:.4f})")
                epoch_eval = {"prior_mahalanobis": prior_dist}
                if writer is not None:
                    writer.add_scalar("Eval/prior_mahalanobis", prior_dist, epoch)
                if micro_solver is not None:
                    zs_err = micro_solver(ema_params)
                    epoch_eval["zeroshot_mpjpe_mm"] = zs_err
                    log(f"EPOCH: [{epoch}] eval zero-shot MPJPE (micro synthetic scene): "
                        f"{zs_err:.2f} mm")
                    if writer is not None:
                        writer.add_scalar("Eval/zeroshot_mpjpe_mm", zs_err, epoch)
                eval_history.append(epoch_eval)

            # epoch complete: a resume starts at the next one
            _save(os.path.join(output_dir, f"checkpoint_{epoch}.pth"), epoch + 1, state,
                  model_cfg, mesh, rules)
            log(f"Save checkpoint to {output_dir}")

    return state, history, eval_history


def _micro_solver(scene, model_apply_raw, model_cfg, sde, trainer_cfg, dev):
    """The micro zero-shot solve of `scene` with given weights -> MPJPE (mm).
    The plain ScoreMLP takes the fast OIL path (its f32 EMA weights keep it
    off the bf16 kernel), the adapters the generic path."""
    from zedo_tpu_torch.zeroshot import pipeline
    from zedo_tpu_torch.zeroshot.ipo import IPOConfig
    from zedo_tpu_torch.zeroshot.oil import OILConfig

    zcfg = pipeline.ZeDOConfig(
        ipo=IPOConfig(iterations=trainer_cfg.micro_solve_iters,
                      t_norm=3.0 * trainer_cfg.data_scale),
        oil=OILConfig(iterations=trainer_cfg.micro_solve_iters))
    sampler = PCSampler(sde=sde, predictor="euler_maruyama", corrector="none",
                        probability_flow=True, denoise=True, eps=0.01)
    model_apply = None if model_apply_raw is score_mlp.apply else model_apply_raw

    def put(a):
        return torch.as_tensor(a, device=dev)

    def solve(params):
        with torch.no_grad():
            res = pipeline.solve_jit(params, model_cfg, sde, sampler, zcfg,
                                     put(scene["cluster"]), put(scene["px"]), None,
                                     put(scene["k"]), model_apply=model_apply,
                                     generator=torch.Generator(device=dev).manual_seed(0))
        pred = res.poses[:, 0].cpu().numpy()
        pred = pred - pred[:, 0:1]
        err = np.linalg.norm(pred - scene["gt"], axis=-1).mean()
        return float(err / trainer_cfg.data_scale * 1000.0)

    return solve
