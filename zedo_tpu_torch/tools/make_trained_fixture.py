"""Regenerate a trained-prior fixture like tests/fixtures/trained, with the
port's training step.

    python -m zedo_tpu_torch.tools.make_trained_fixture --out DIR [--device cuda]

Port of tools/make_trained_fixture.py: the small diffusion prior (hidden
256, embed 128, 2 blocks) trained for TRAIN_STEPS steps of BATCH rows on the
synthetic low-rank pose family, a family whose depth structure 2D
observations cannot recover, so accuracy below the geometry-only error comes
from the learned score. Written under DIR:

  checkpoint/checkpoint_trained.pth   the reference's .pth layout (the
                                      `module.`-prefixed state dict and the
                                      positional EMA shadow list)
  data/h36m/h36m_test.pkl             N_EVAL held-out family scenes in the
                                      H36M pickle schema, mm units
  clusters/h36m_cluster1.npy          the family mean, root-centred [1, 17, 3]
  clusters/h36m_cluster2.npy          a 2-hypothesis variant [2, 17, 3]
  family.npz                          mu, u, gt poses, the gate's numbers

The orbax copy of the JAX tool is not written: it is the JAX package's own
format. Everything drawn from numpy seeds (the family, the scenes, the
clusters) equals the committed fixture's; the weights come from the port's
torch generators, so the gate's MPJPE is the port's own. DIR is required:
the committed fixture is the JAX tool's, read by both packages, and is
never overwritten unasked.
"""
from __future__ import annotations

import argparse
import os
import pickle
import time

import numpy as np
import torch

from zedo_tpu_torch import bench_trained
from zedo_tpu_torch.diffusion import losses as losses_lib
from zedo_tpu_torch.diffusion.sampling import PCSampler
from zedo_tpu_torch.diffusion.sde import SubVPSDE
from zedo_tpu_torch.models import score_mlp
from zedo_tpu_torch.presets import Config
from zedo_tpu_torch.utils.checkpoint import save_native
from zedo_tpu_torch.utils.config import resolve_device
from zedo_tpu_torch.zeroshot import ipo as ipo_lib
from zedo_tpu_torch.zeroshot import oil as oil_lib
from zedo_tpu_torch.zeroshot import pipeline

J = 17
RANK = 6
SCALE = 0.25
HIDDEN, EMBED, BLOCKS = 256, 128, 2
TRAIN_STEPS = 3000
BATCH = 512
N_EVAL = 24
# the committed scenes' camera (an H36M-like IPO_T=3 config reaches 1.5-6 m
# through the 0.5-2x translation scale search)
FX = 1000.0
CX = 500.0
T_VEC = np.array([0.15, 0.0, 3.5], np.float32)  # meters
# the training loss's mean over the last 100 steps against the first 100
LOSS_DROP = 0.5


def pose_family(seed=0, n=4096):
    """(training poses root-centred [n, J, 3], mu [J, 3], u [RANK, J, 3])."""
    rng = np.random.RandomState(seed)
    mu = rng.randn(J, 3).astype(np.float32) * SCALE
    u = rng.randn(RANK, J, 3).astype(np.float32) * SCALE / 2
    z = rng.randn(n, RANK).astype(np.float32)
    poses = mu[None] + np.einsum("nr,rjd->njd", z, u)
    return (poses - poses[:, 0:1]).astype(np.float32), mu, u


def family_scenes(mu, u, seed, n):
    """Held-out draws -> (gt root-centred [n, J, 3] m, K [n, 3, 3], px [n, J, 2]),
    by bench_trained.make_scenes, the one implementation of the fixture's
    scene and camera convention."""
    family = {"mu": mu, "u": u, "fx": FX, "cx": CX, "t_vec": T_VEC}
    return bench_trained.make_scenes(family, n, seed=seed)


def model_config() -> score_mlp.ScoreMLPConfig:
    return score_mlp.ScoreMLPConfig(n_joints=J, joint_dim=3, hidden_dim=HIDDEN, embed_dim=EMBED,
                                    n_blocks=BLOCKS, embedding_type="positional", dropout=0.0)


def train_prior(dev: torch.device):
    """(cfg, params, EMA state, mu, u, losses [TRAIN_STEPS]) of the prior
    trained with the port's SDE loss step."""
    train_poses, mu, u = pose_family()
    cfg = model_config()
    params = score_mlp.init_params(torch.Generator().manual_seed(0), cfg, device=dev)
    optim = Config(optimizer="Adam", lr=1e-3, beta1=0.9, eps=1e-8, warmup=100, grad_clip=1.0)
    optimizer = losses_lib.get_optimizer(Config(optim=optim))
    state = losses_lib.init_train_state(params, optimizer, ema_decay=0.999)
    sde = SubVPSDE(beta_min=0.1, beta_max=20.0, n=1000, t_max=1.0)

    def model_apply(p, x, labels, cond, msk, train=False, generator=None):
        return score_mlp.apply(p, cfg, x, labels, cond, msk, train=train, generator=generator)

    step_fn = losses_lib.get_step_fn(sde, model_apply, optimizer, train=True, reduce_mean=True)
    gen = torch.Generator(dev).manual_seed(1)
    data = torch.as_tensor(train_poses, device=dev)
    losses = []
    for i in range(TRAIN_STEPS):
        idx = torch.randint(0, len(data), (BATCH,), generator=gen, device=dev)
        state, loss = step_fn(state, gen, data[idx])
        losses.append(loss)
        if i % 500 == 0 or i == TRAIN_STEPS - 1:
            print(f"step {i}: loss {float(loss):.4f}", flush=True)
    losses = torch.stack(losses).cpu().numpy()
    first, last = float(losses[:100].mean()), float(losses[-100:].mean())
    if not last < LOSS_DROP * first:
        raise RuntimeError(f"no training: the loss went from {first:.4f} to {last:.4f} "
                           f"(the last 100 steps' mean must be below {LOSS_DROP} of the first's)")
    return cfg, state.params, state.ema, mu, u, losses


def write_scenes(out: str, mu, u) -> np.ndarray:
    """The held-out scenes as an H36M test pickle and the two cluster files;
    returns the scenes' root-centred poses."""
    gt, k, px = family_scenes(mu, u, seed=7, n=N_EVAL)
    data_dir = os.path.join(out, "data", "h36m")
    os.makedirs(data_dir, exist_ok=True)
    items = []
    for i in range(N_EVAL):
        cam_mm = (gt[i] + T_VEC[None]) * 1000.0  # h36m pickles are mm
        img = np.zeros((J, 3))
        img[:, :2] = px[i]
        items.append({
            "joint_3d_camera": cam_mm.astype(np.float64),
            "joint_3d_image": img,
            "camera_param": {"fx": np.array(FX), "fy": np.array(FX),
                             "cx": np.array(CX), "cy": np.array(CX)},
            "image_path": f"synthetic_{i}.jpg",
            "action": 2 + (i % 3),
        })
    with open(os.path.join(data_dir, "h36m_test.pkl"), "wb") as f:
        pickle.dump(items, f)

    cl_dir = os.path.join(out, "clusters")
    os.makedirs(cl_dir, exist_ok=True)
    rng = np.random.RandomState(3)
    c1 = (mu - mu[0:1])[None]  # the family mean, root-centred
    c2 = np.concatenate([c1, c1 + rng.randn(1, J, 3).astype(np.float32) * 0.1])
    np.save(os.path.join(cl_dir, "h36m_cluster1.npy"), c1.astype(np.float32))
    np.save(os.path.join(cl_dir, "h36m_cluster2.npy"), c2.astype(np.float32))
    print("scenes and clusters written", flush=True)
    return gt


def gate_numbers(cfg, params, mu, u, gt, dev: torch.device):
    """(MPJPE mm of the f32 solve of the scenes from the family-mean
    cluster at the H36M config's full schedule, MPJPE mm of that init)."""
    _, k, px = family_scenes(mu, u, seed=7, n=N_EVAL)
    sde = SubVPSDE(beta_min=0.1, beta_max=20.0, n=1000, t_max=0.1)
    sampler = PCSampler(sde=sde, predictor="euler_maruyama", corrector="none",
                        probability_flow=True, denoise=True, eps=0.01)
    # the h36m config's ZeDO settings: IPO 500 / OIL 1000, its keypoints, IPO_T=3
    zcfg = pipeline.ZeDOConfig(
        ipo=ipo_lib.IPOConfig(iterations=500, keypoint_list=(0, 1, 4), rot_axes="z",
                              t_norm=3.0),
        oil=oil_lib.OILConfig(iterations=1000, sampling_eps=0.01))
    clusters = (mu - mu[0:1])[None].astype(np.float32)
    with torch.no_grad():
        res = pipeline.solve(params, cfg, sde, sampler, zcfg,
                             *(torch.as_tensor(a, device=dev) for a in (clusters, px)),
                             None, torch.as_tensor(k, device=dev))
    pred = res.poses[:, 0].cpu().numpy()
    pred = pred - pred[:, 0:1]
    mpjpe_mm = float(np.sqrt(((pred - gt) ** 2).sum(-1)).mean() * 1000)
    init_mm = float(np.sqrt(
        ((np.broadcast_to(clusters[0], gt.shape) - gt) ** 2).sum(-1)).mean() * 1000)
    print(f"regeneration gate: trained MPJPE {mpjpe_mm:.1f}mm "
          f"(cluster init {init_mm:.1f}mm)", flush=True)
    return mpjpe_mm, init_mm


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--out", required=True, help="directory to write the fixture into")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    t0 = time.perf_counter()
    cfg, params, ema, mu, u, losses = train_prior(dev)
    train_s = time.perf_counter() - t0
    ckpt_dir = os.path.join(args.out, "checkpoint")
    os.makedirs(ckpt_dir, exist_ok=True)
    # the trainer's writer: the reference's .pth layout, read by both packages
    path = os.path.join(ckpt_dir, "checkpoint_trained.pth")
    save_native(path, 1, TRAIN_STEPS, params, ema, None, cfg)
    print("checkpoint written:", path, flush=True)
    gt = write_scenes(args.out, mu, u)
    t1 = time.perf_counter()
    mpjpe_mm, init_mm = gate_numbers(cfg, params, mu, u, gt, dev)
    gate_s = time.perf_counter() - t1
    np.savez(os.path.join(args.out, "family.npz"),
             mu=mu, u=u, gt=gt, mpjpe_mm=mpjpe_mm, init_mm=init_mm,
             hidden=HIDDEN, embed=EMBED, n_blocks=BLOCKS, fx=FX, cx=CX, t_vec=T_VEC)
    print("fixture complete:", args.out, flush=True)
    return {"mpjpe_mm": mpjpe_mm, "init_mm": init_mm, "train_s": train_s, "gate_s": gate_s,
            "loss_first_100": float(losses[:100].mean()),
            "loss_last_100": float(losses[-100:].mean()), "steps": TRAIN_STEPS}


if __name__ == "__main__":
    main()
