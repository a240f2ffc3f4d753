"""The plain reference against the port at small sizes on the CPU, in f32,
and the yardstick's arithmetic against hand-worked values."""
from __future__ import annotations

import ast
import pathlib

import numpy as np
import pytest
import torch

from perfbench import roofline, scenes, trace, weights
from perfbench.drivers import train_steps
from perfbench.reference import zedo as ref

HERE = pathlib.Path(__file__).resolve().parents[1]
CFG = {"n_joints": 17, "joint_dim": 3, "hidden_dim": 64, "embed_dim": 32, "n_blocks": 2,
       "embedding_type": "positional", "group_norm_groups": 8, "dropout": 0.1,
       "scale_by_sigma": False, "sigma_min": 0.01, "sigma_max": 50, "num_scales": 1000}
PUBLISHED = {**CFG, "hidden_dim": 1024, "embed_dim": 512, "group_norm_groups": 32}


def port_config(cfg=CFG):
    from zedo_tpu_torch.models.score_mlp import ScoreMLPConfig

    return ScoreMLPConfig(n_joints=cfg["n_joints"], hidden_dim=cfg["hidden_dim"],
                          embed_dim=cfg["embed_dim"], dropout=cfg["dropout"],
                          group_norm_groups=cfg["group_norm_groups"])


def test_reference_imports_nothing_of_the_port_or_jax():
    for path in (HERE / "reference").glob("*.py"):
        tree = ast.parse(path.read_text())
        names = [a.name for node in ast.walk(tree) if isinstance(node, ast.Import)
                 for a in node.names]
        names += [node.module for node in ast.walk(tree) if isinstance(node, ast.ImportFrom)]
        assert {n.split(".")[0] for n in names} <= {"__future__", "contextlib", "math",
                                                     "numpy", "torch"}, (path, names)


@pytest.mark.parametrize("train", [False, True])
def test_score_network_matches_the_port(train):
    from zedo_tpu_torch.models import score_mlp

    flat = weights.make(3, CFG, "cpu")
    x = torch.randn(24, 17, 3, generator=torch.Generator().manual_seed(1))
    labels = torch.rand(24, generator=torch.Generator().manual_seed(2)) * 999
    got = score_mlp.apply(weights.nested(flat), port_config(), x, labels, train=train,
                          generator=torch.Generator().manual_seed(5))
    want = ref.score_mlp(flat, CFG, x.reshape(24, -1), labels,
                         dropout=CFG["dropout"] if train else 0.0,
                         generator=torch.Generator().manual_seed(5))
    torch.testing.assert_close(got.reshape(24, -1), want, rtol=1e-4, atol=1e-5)


def test_ipo_matches_the_port():
    from zedo_tpu_torch.zeroshot.ipo import IPOConfig, run_ipo

    sc = scenes.h36m(9, 0, 6)
    pose0 = torch.as_tensor(np.repeat(scenes.clusters(9, 1), 6, 0))
    pose0 = pose0 - pose0[:, :1]
    px, k = torch.as_tensor(sc["px"]), torch.as_tensor(sc["k"])
    zedo = {"IPO_iterations": 40, "IPO_keylist": [0, 1, 4], "RotAxes": "z", "IPO_T": 3.0,
            "IPO_minScaleT": 0.5, "IPO_maxScaleT": 2.0, "IPO_lr": 0.1}
    got = run_ipo(pose0, px, k, IPOConfig(iterations=40), n_groups=1)
    t0 = ref.pelvis_translation(px, k, 3.0, "joint0")
    rot, trans = ref.ipo(pose0, px, k, t0, zedo, group_rows=6)
    torch.testing.assert_close(got.rot_mat, rot, rtol=1e-4, atol=1e-4)
    torch.testing.assert_close(got.translation, trans, rtol=1e-4, atol=1e-4)


def test_oil_matches_the_port():
    from zedo_tpu_torch.diffusion.sampling import PCSampler
    from zedo_tpu_torch.diffusion.sde import SubVPSDE
    from zedo_tpu_torch.zeroshot.oil import OILConfig, run_oil

    flat = weights.make(4, CFG, "cpu")
    sc = scenes.h36m(4, 0, 8)
    px, k, conf = (torch.as_tensor(sc[key]) for key in ("px", "k", "conf"))
    x0 = torch.as_tensor(sc["gt"]) * 0.9
    t0 = torch.tensor([[[0.0, 0.0, 4.4]]]).repeat(8, 1, 1)
    sde = SubVPSDE(beta_min=0.1, beta_max=20.0, n=12, t_max=0.1)
    sampler = PCSampler(sde=sde, predictor="euler_maruyama", corrector="none",
                        probability_flow=True, denoise=True, eps=0.01)
    got = run_oil(weights.nested(flat), port_config(), sde, sampler, x0, t0, px, k, conf,
                  OILConfig(iterations=12))
    x, t, _ = ref.oil(flat, CFG, {"beta_min": 0.1, "beta_max": 20.0, "T": 0.1, "eps": 0.01},
                      x0, t0, px, k, conf, iterations=12, fixed_steps=12 // 5)
    torch.testing.assert_close(got.pose, x, rtol=1e-4, atol=1e-5)
    torch.testing.assert_close(got.translation, t, rtol=1e-4, atol=1e-5)


def test_train_steps_match_the_port():
    from zedo_tpu_torch.diffusion import losses
    from zedo_tpu_torch.diffusion.sde import SubVPSDE
    from zedo_tpu_torch.models import score_mlp
    from zedo_tpu_torch.train import trainer

    flat = weights.make(6, CFG, "cpu")
    optim = {"lr": 2e-4, "beta1": 0.9, "eps": 1e-8, "warmup": 2, "grad_clip": 1.0}
    optimizer = losses.Optimizer(grad_clip=1.0, weight_decay=0.0, beta1=0.9, eps=1e-8,
                                 lr=2e-4, warmup=2)
    state = losses.init_train_state(weights.nested(flat), optimizer, 0.9999)
    step = trainer.make_train_step(SubVPSDE(beta_min=0.1, beta_max=20.0, n=1000, t_max=1.0),
                                   score_mlp.apply, port_config(), optimizer, reduce_mean=True)
    data = scenes.train_poses(6, 96, 17, "cpu")
    batches, seeds = [data[:32], data[32:64], data[64:]], [11, 12, 13]
    got = [float(step(state, torch.Generator().manual_seed(s), b)[1])
           for b, s in zip(batches, seeds)]
    want = ref.train_steps(flat, CFG, {"beta_min": 0.1, "beta_max": 20.0, "T": 1.0}, optim,
                           0.9999, batches, seeds)
    np.testing.assert_allclose(got, want["losses"], rtol=1e-5)
    # Adam moves a leaf by about lr an element whatever its gradient, so the
    # weights are compared by each leaf's change, as `correct` compares them
    start = {n: v for n, v in flat.items() if n != "sigmas"}
    for mine, theirs in ((state.params, want["params"]),
                         (state.ema.shadow_params, want["ema"])):
        mine = weights.flatten(mine)
        gaps = train_steps.leaf_gaps({n: mine[n] - start[n] for n in start},
                                     {n: theirs[n] - start[n] for n in start}, list(start))
        assert max(gaps.values()) < 1e-3, gaps


@pytest.mark.parametrize("protocol2", [False, True])
def test_evaluation_matches_the_port(protocol2):
    from zedo_tpu_torch.data import evaluation

    r = np.random.default_rng(0)
    preds = (r.standard_normal((20, 4, 17, 3)) * 0.3).astype(np.float32)
    gt = (r.standard_normal((20, 17, 3)) * 0.3).astype(np.float32)
    got = evaluation.multi_hypothesis_eval(preds, gt, protocol2=protocol2).per_sample_min
    np.testing.assert_allclose(got, ref.sample_errors(preds, gt, protocol2), rtol=0, atol=1e-6)


def test_ranking_matches_the_port():
    from zedo_tpu_torch import serving

    r = np.random.default_rng(1)
    poses = (r.standard_normal((6, 5, 17, 3)) * 0.3).astype(np.float32)
    trans = np.zeros((6, 5, 1, 3), np.float32)
    trans[..., 2] = 4.5
    sc = scenes.h36m(1, 0, 6)
    packed = serving._rank_and_pack(*(torch.as_tensor(a) for a in
                                      (poses, trans, sc["px"], sc["k"]))).numpy()
    np.testing.assert_allclose(packed[:, -5:],
                               ref.reprojection_errors(poses, trans, sc["px"], sc["k"]),
                               rtol=1e-5)


def test_roofline_counts_by_hand():
    # 2 x (51 x 1024 + 4 x 1024^2 + 1024 x 51) a row
    assert roofline.trunk_flops(1, PUBLISHED) == 8_597_504
    # 2 x (512^2 + 5 x 512 x 1024) a distinct time
    assert roofline.time_flops(1, PUBLISHED) == 5_767_168
    assert roofline.trunk_weights(PUBLISHED) == 4_303_923
    # x and out f32 at 160 rows, bf16 weights, 15 f32 vectors of 1024
    assert roofline.kernel_bytes(160, PUBLISHED) == 65_280 + 8_607_846 + 61_440
    seconds, bound = roofline.kernel_bound_s(44_300, PUBLISHED)
    assert bound == "operations" and seconds == pytest.approx(44_300 * 8_597_504 / 989e12)
    seconds, bound = roofline.kernel_bound_s(160, PUBLISHED)
    assert bound == "bytes" and seconds == pytest.approx(8_734_566 / 3.35e12)
    assert roofline.train_step_flops(50_000, PUBLISHED) == 3 * 50_000 * (8_597_504 + 5_767_168)
    infant = {**PUBLISHED, "n_joints": 12}
    assert roofline.trunk_flops(1, infant) == 2 * (36 * 1024 + 4 * 1024 ** 2 + 1024 * 36)


def test_trace_reduction_by_hand():
    device = [(0.0, 1.0, "wgmma_layer<1>"), (0.5, 2.0, "add"), (3.0, 4.0, "wgmma_layer<2>")]
    host = [(0.0, 5.0, "solve"), (2.1, 2.9, "cudaGraphLaunch"), (0.1, 0.2, "cudaLaunchKernel")]
    t = trace.summarize(device, host, wall=5.0, units=2)
    assert t.busy_s == 3.0 and t.dispatches == 2
    assert t.device_seconds("wgmma_layer") == 2.0
    # the gap 2.0-3.0 lies under the graph launch, the innermost event
    assert t.idle_gaps == {"cudaGraphLaunch": 1.0}
    assert t.breakdown()["device_ops"][0] == ["add", 1.5]
