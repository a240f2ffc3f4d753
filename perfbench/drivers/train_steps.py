"""Training the prior, as `run.train_pose_mini` trains it: the compiled train
step (`train.trainer.make_train_step`, one CUDA graph a step) on batches of
mix["batch"] rows of a device-resident set of mix["rows"] seeded poses.

Each epoch the trainer's shuffle (RandomState([seed, epoch])) is copied to
the card, each step's batch is gathered there and its generator seeded from
(seed, epoch, step), as `train.trainer.train_loop` does; the losses stay on
the card until the epoch ends, and then come to the host in one read. The
loop's evaluation and checkpoints are left out.

Set-up builds the train state and drives it from the seed through its first
mix["check"]["steps"] steps through the window's own call and feed, on rows
that all differ; the window continues from there with the same object. The
reference follows those first steps: each step's loss, the first step's
gradient as Adam holds it after one step, and the weights' and the EMA's
change after the last of them.
"""
from __future__ import annotations

import numpy as np
import torch

from perfbench import harness, loop, program, roofline, scenes, weights
from perfbench.reference import zedo as ref


def run(run: harness.Run) -> harness.Outcome:
    from zedo_tpu_torch.diffusion import losses
    from zedo_tpu_torch.diffusion.sde import SubVPSDE
    from zedo_tpu_torch.models import score_mlp
    from zedo_tpu_torch.train import trainer

    cfg, mix, dev = run.config, run.mix, run.device
    tr, opt = {**cfg["sde"], **cfg["training"]}, cfg["optim"]
    model_cfg = program.model_config(cfg)
    optimizer = losses.Optimizer(grad_clip=opt["grad_clip"], weight_decay=opt["weight_decay"],
                                 beta1=opt["beta1"], eps=opt["eps"], lr=opt["lr"],
                                 warmup=opt["warmup"])
    state = losses.init_train_state(program.params(run.seed, cfg, dev, tr["precision"]),
                                    optimizer, cfg["ema_rate"])
    sde = SubVPSDE(beta_min=tr["beta_min"], beta_max=tr["beta_max"], n=cfg["model"]["num_scales"],
                   t_max=tr["T"])
    step_fn = trainer.make_train_step(sde, score_mlp.apply, model_cfg, optimizer,
                                      reduce_mean=tr["reduce_mean"], continuous=tr["continuous"],
                                      likelihood_weighting=tr["likelihood_weighting"],
                                      compute_dtype=tr["precision"])
    rows, batch = mix["rows"], mix["batch"]
    per_epoch = rows // batch
    data = scenes.train_poses(run.seed, rows, cfg["model"]["n_joints"], dev)
    gen = torch.Generator(device=dev)
    feed = {"perm": None, "losses": []}

    def end_epoch():
        if feed["losses"]:
            values = torch.stack(feed["losses"]).cpu().numpy()
            run.failed += int((~np.isfinite(values)).sum())
            feed["losses"] = []

    def step(k: int):
        epoch, i = divmod(k, per_epoch)
        if i == 0:
            end_epoch()
            perm = torch.from_numpy(scenes.epoch_permutation(run.seed, epoch, rows))
            feed["perm"] = perm.pin_memory().to(dev, non_blocking=True) \
                if dev.type == "cuda" else perm
        gen.manual_seed(scenes.step_seed(run.seed, epoch, i))
        x = data[feed["perm"][i * batch:(i + 1) * batch]]
        _, loss = step_fn(state, gen, x, None, None)
        feed["losses"].append(loss)
        return loss

    # set-up: the first steps, read for the check
    first = mix["check"]["steps"]
    snap = {"losses": []}
    for k in range(first):
        snap["losses"].append(float(step(k)))
        if k == 0:
            flat = weights.flatten(state.params)
            adam = state.opt_state.state
            snap["grads"] = {n: (adam[p]["exp_avg"] / (1 - opt["beta1"])).cpu()
                             for n, p in flat.items() if p in adam}
    snap["params"] = {n: p.detach().cpu().clone() for n, p in weights.flatten(state.params).items()}
    snap["ema"] = {n: p.detach().cpu().clone()
                   for n, p in weights.flatten(state.ema.shadow_params).items()}
    flops = roofline.train_step_flops(batch, cfg["model"])
    run.peak = tr["precision"]

    def unit(i: int):
        loss = step(first + i)
        run.unit_work.append(batch)
        run.unit_flops.append(flops)
        return loss

    loop.measure(run, unit, finish=end_epoch)
    peak = loop.memory_peak(dev)
    del state, data
    program.free(dev)
    return harness.Outcome(check=lambda: check(run, snap, "f32"), memory_peak_bytes=peak,
                           controls={"control": lambda: check(run, snap, "tf32"),
                                     "half_batch": lambda: check(run, snap, "half_batch")})


def leaf_gaps(got: dict, want: dict, names) -> dict:
    """Per leaf, |norm(got) - norm(want)| over the larger of norm(want) and
    the median leaf's norm(want)."""
    norms = {n: float(want[n].detach().double().norm()) for n in names}
    median = float(np.median(list(norms.values())))
    return {n: abs(float(got[n].detach().double().norm()) - norms[n]) / max(norms[n], median)
            for n in names}


def check(run, snap: dict, precision: str) -> dict:
    """The numbers of `correct`, the program's first steps against the
    reference's (precision "f32"), or the control's (the reference with
    TF32 products) in the program's place ("tf32"), or the reference with
    half of each batch left out in its place ("half_batch")."""
    cfg, mix, dev = run.config, run.mix, run.device
    tr, opt, batch = {**cfg["sde"], **cfg["training"]}, cfg["optim"], mix["batch"]
    steps = mix["check"]["steps"]
    p0 = program.reference_params(run.seed, cfg, dev, tr["precision"])
    data = scenes.train_poses(run.seed, mix["rows"], cfg["model"]["n_joints"], dev)
    perm = torch.from_numpy(scenes.epoch_permutation(run.seed, 0, mix["rows"])).to(dev)
    batches = [data[perm[i * batch:(i + 1) * batch]] for i in range(steps)]
    seeds = [scenes.step_seed(run.seed, 0, i) for i in range(steps)]
    args = (p0, cfg["model"], tr, opt, cfg["ema_rate"], batches, seeds)
    want = ref.train_steps(*args, precision="f32")
    if precision == "half_batch":
        # a planted fault: half of each batch left out, the mean over the rest
        got = ref.train_steps(*args[:5], [b[:batch // 2] for b in batches], seeds)
    elif precision != "f32":
        got = ref.train_steps(*args, precision=precision)
    else:
        got = snap
    if precision != "f32":
        got = {**got, "params": {n: v.cpu() for n, v in got["params"].items()},
               "ema": {n: v.cpu() for n, v in got["ema"].items()},
               "grads": {n: v.cpu() for n, v in got["first_grads"].items()}}
    names = list(want["first_grads"])
    grads = {n: want["first_grads"][n].cpu() for n in names}
    grad_gap = leaf_gaps(got["grads"], grads, names)
    # leaves whose gradient is nought to rounding move by round-off alone
    norms = {n: float(grads[n].double().norm()) for n in names}
    floor = 1e-3 * float(np.median(list(norms.values())))
    moved = [n for n in names if norms[n] >= floor]
    p0 = {n: v.cpu() for n, v in p0.items()}

    def change(d):
        return {n: d[n].cpu().double() - p0[n].double() for n in moved}

    loss_gap = max(abs(a - b) / abs(b) for a, b in zip(got["losses"], want["losses"]))
    return {"loss_gap.max": loss_gap,
            "grad_norm_gap.worst_leaf": max(grad_gap.values()),
            "weight_change_gap.worst_leaf": max(leaf_gaps(change(got["params"]),
                                                          change(want["params"]),
                                                          moved).values()),
            "ema_change_gap.worst_leaf": max(leaf_gaps(change(got["ema"]), change(want["ema"]),
                                                       moved).values())}
