"""zedo_tpu_torch against the reference's committed goldens that no other
port test reads: the per-layer activations of the score model, the EMA
shadow order, the gradient field, quaternion_to_matrix, the frame
transforms and Procrustes alignment, the flip/normalize helpers, the eval
sampler, the IPO and OIL trajectories, score_reuse's deviation and the
end-to-end solve.

Each test draws its inputs exactly as its JAX counterpart in
tests/test_reference_parity.py does (the same np.random.RandomState(0)
draws in the same order, from conftest's `rng` fixture; the reference's
torch-initialized weights from the golden), and holds the port at that
test's tolerance."""
import os

import numpy as np
import pytest
import torch
from golden_store import GOLDEN_DIR, _unflatten

from zedo_tpu_torch.data import base as tbase
from zedo_tpu_torch.data import sharding as tsharding
from zedo_tpu_torch.diffusion.sampling import PCSampler
from zedo_tpu_torch.diffusion.sde import SubVPSDE
from zedo_tpu_torch.models import score_mlp
from zedo_tpu_torch.ops import camera as tcam
from zedo_tpu_torch.ops import gradient_field as tgf
from zedo_tpu_torch.ops import procrustes as tpro
from zedo_tpu_torch.ops.rotations import quaternion_to_matrix
from zedo_tpu_torch.utils import checkpoint as tckpt
from zedo_tpu_torch.zeroshot import ipo as tipo
from zedo_tpu_torch.zeroshot import oil as toil
from zedo_tpu_torch.zeroshot import pipeline as tpipe


def golden(name, key):
    with np.load(os.path.join(GOLDEN_DIR, name + ".npz"), allow_pickle=False) as z:
        return _unflatten({k: z[k] for k in z.files}, key)


def _t(a):
    return torch.tensor(np.asarray(a))


def make_pair(name, embedding_type="positional", scale_by_sigma=False, hidden=128, embed=64):
    """The reference model's weights from golden `name` as the port's params."""
    cfg = score_mlp.ScoreMLPConfig(n_joints=17, joint_dim=3, hidden_dim=hidden,
                                   embed_dim=embed, n_blocks=2, embedding_type=embedding_type,
                                   scale_by_sigma=scale_by_sigma)
    params = tckpt.params_from_torch_state_dict(golden(name, "pair_sd"), cfg, device="cpu")
    return cfg, params


# ------------------------------------------------------------------ the model
@pytest.mark.parametrize("embedding_type,scale_by_sigma", [
    ("positional", False), ("fourier", False), ("fourier", True)])
def test_score_model_per_layer_activations(rng, embedding_type, scale_by_sigma):
    name = (f"test_score_model_per_layer_activation_parity__{embedding_type}-"
            f"{scale_by_sigma}")
    cfg, params = make_pair(name, embedding_type, scale_by_sigma, hidden=256, embed=128)
    b = 16
    x = rng.randn(b, 17, 3).astype(np.float32)
    if embedding_type == "positional":
        labels = (rng.rand(b).astype(np.float32) * 0.099 + 0.001) * 999.0
    else:
        labels = np.exp(rng.rand(b).astype(np.float32) * (np.log(50.0) - np.log(0.01))
                        + np.log(0.01)).astype(np.float32)
    ref = golden(name, "ref")
    acts = {}
    with torch.no_grad():
        got = score_mlp.apply(params, cfg, _t(x), _t(labels), intermediates=acts)
    assert set(ref["acts"]) <= set(acts)
    for layer, want in ref["acts"].items():
        np.testing.assert_allclose(acts[layer].numpy(), want, atol=1e-4, rtol=1e-4,
                                   err_msg=f"layer {layer}")
    np.testing.assert_allclose(got.numpy(), ref["out"], atol=1e-4, rtol=1e-4)


def test_ema_shadow_order():
    name = "test_ema_shadow_order_matches_reference_parameters"
    cfg, _ = make_pair(name)
    ro = golden(name, "ref_order")
    got = tckpt.ema_shadow_to_params([_t(a) for a in ro["shadow"]], cfg, device="cpu")
    want = tckpt.params_from_torch_state_dict(ro["sd_plus1"], cfg, device="cpu")
    want.pop("sigmas", None)
    got.pop("sigmas", None)
    flat_got, flat_want = tckpt.tree_to_flat(got), tckpt.tree_to_flat(want)
    assert flat_got.keys() == flat_want.keys()
    for key, value in flat_got.items():
        np.testing.assert_allclose(value.numpy(), flat_want[key].numpy(), err_msg=key)


# ---------------------------------------------------------- geometry, helpers
def test_gradient_field(rng):
    b = 7
    key3d = rng.randn(b, 17, 3).astype(np.float32) * 0.3
    key3d[:, :, 2] += 0.1
    k = np.zeros((b, 3, 3), np.float32)
    k[:, 0, 0] = k[:, 1, 1] = 1100.0
    k[:, 0, 2] = k[:, 1, 2] = 480.0
    k[:, 2, 2] = 1.0
    key2d = rng.rand(b, 17, 2).astype(np.float32) * 1000.0
    conf = (rng.rand(b, 17).astype(np.float32) * 1.3)
    t_fix = np.array([[[0.2, -0.1, 3.5]]], np.float32).repeat(b, axis=0)
    want = golden("test_gradient_field_parity", "ref")
    got_g, got_t = tgf.gradient_field(_t(key2d), _t(key3d), _t(k), conf=_t(conf))
    np.testing.assert_allclose(got_t.numpy(), want["t"], atol=1e-4, rtol=1e-4)
    np.testing.assert_allclose(got_g.numpy(), want["g"], atol=1e-5, rtol=1e-4)
    got_g2, _ = tgf.gradient_field(_t(key2d), _t(key3d), _t(k), t=_t(t_fix))
    np.testing.assert_allclose(got_g2.numpy(), want["g2"], atol=1e-5, rtol=1e-4)


def test_quaternion_to_matrix(rng):
    q = rng.randn(64, 4).astype(np.float32)
    got = quaternion_to_matrix(_t(q)).numpy()
    np.testing.assert_allclose(got, golden("test_quaternion_to_matrix_parity", "want"),
                               atol=1e-5, rtol=1e-5)


def test_transforms(rng):
    """Procrustes alignment and the three frame transforms; the JAX test
    runs them in f32 (x64 off), the port on the same f32 values."""
    f32 = np.float32
    pose = (rng.randn(17, 3) * 0.3).astype(f32)
    gt = (rng.randn(17, 3) * 0.3).astype(f32)
    rot = quaternion_to_matrix(_t(rng.randn(1, 4).astype(f32)))[0]
    t = rng.randn(3, 1).astype(f32)
    p = rng.randn(10, 3).astype(f32)
    box = np.array([100.0, 120.0, 420.0, 480.0], f32)
    camera = dict(fx=1100.0, fy=1105.0, cx=512.0, cy=500.0)
    pose3d_image = (rng.rand(17, 3) * np.array([200, 200, 50]) + np.array([400, 400, 4000])
                    ).astype(f32)
    want = golden("test_transforms_parity", "ref")
    np.testing.assert_allclose(tpro.align_to_gt(_t(pose), _t(gt)).numpy(), want["align"],
                               atol=1e-5, rtol=1e-5)
    np.testing.assert_allclose(tcam.world_to_camera_frame(_t(p), rot, _t(t)).numpy(),
                               want["w2c"], atol=1e-6)
    np.testing.assert_allclose(tcam.camera_to_world_frame(_t(p), rot, _t(t)).numpy(),
                               want["c2w"], atol=1e-6)
    got_c = tcam.image_to_camera_frame(_t(pose3d_image), _t(box), root_depth=4000.0, **camera)
    np.testing.assert_allclose(got_c.numpy(), want["i2c"], rtol=1e-4)


def test_flip_normalize_helpers(rng):
    data = rng.randn(6, 17, 3).astype(np.float32) * 100 + 500
    want = golden("test_flip_normalize_helpers_parity", "ref")
    np.testing.assert_allclose(tbase.flip_data(data), want["flip"], atol=1e-6)
    np.testing.assert_allclose(tbase.unflip_data(tbase.flip_data(data)), want["unflip_flip"],
                               atol=1e-5)
    np.testing.assert_allclose(tbase.normalize_data(data.copy()), want["normalize"], atol=1e-6)


class _DS:
    def __init__(self, n):
        self.n = n

    def __len__(self):
        return self.n


def test_distributed_eval_sampler():
    ref_idx = golden("test_distributed_eval_sampler_parity", "ref")
    for n, world in [(10, 4), (17, 3), (8, 8), (5, 2)]:
        chunks = tsharding.contiguous_chunks(n, world)
        for rank in range(world):
            want = list(np.asarray(ref_idx[f"{n}x{world}r{rank}"]))
            got = list(tsharding.DistributedEvalSampler(_DS(n), num_replicas=world, rank=rank))
            assert got == want, (n, world, rank)
            assert list(chunks[rank]) == want, (n, world, rank)


# ----------------------------------------------------------- the trajectories
def _scene(rng, n=4, j=17):
    k = np.zeros((n, 3, 3), np.float32)
    k[:, 0, 0] = k[:, 1, 1] = 1000.0
    k[:, 0, 2] = k[:, 1, 2] = 500.0
    k[:, 2, 2] = 1.0
    pose = rng.randn(n, j, 3).astype(np.float32) * 0.25
    pose -= pose[:, 0:1]
    t = np.zeros((n, 1, 3), np.float32)
    t[..., 2] = 4.0
    t[..., 0] = 0.3
    px = tcam.project(_t(pose + t), _t(k)).numpy()
    return k, pose, t, px


def _sampler():
    sde = SubVPSDE(beta_min=0.1, beta_max=20.0, n=1000, t_max=0.1)
    return sde, PCSampler(sde=sde, predictor="euler_maruyama", corrector="none",
                          probability_flow=True, denoise=True, eps=0.01)


@pytest.mark.parametrize("iterations", [5, 60])
def test_ipo_trajectory(rng, iterations):
    k, pose, _, px = _scene(rng, n=4)
    want = golden(f"test_ipo_trajectory_parity__{iterations}", "ref")
    cfg = tipo.IPOConfig(iterations=iterations, keypoint_list=(0, 1, 4), rot_axes="z",
                         t_norm=3.0)
    got = tipo.run_ipo(_t(pose), _t(px), _t(k), cfg)
    np.testing.assert_allclose(got.rot_mat.detach().numpy(), want["rot"], atol=2e-4, rtol=1e-3)
    np.testing.assert_allclose(got.translation.detach().numpy(), want["t"], atol=2e-4,
                               rtol=1e-3)


def _run_oil(params, cfg_m, x0, t0, px, k, conf, iters, reuse=1):
    sde, sampler = _sampler()
    with torch.no_grad():
        res = toil.run_oil(params, cfg_m, sde, sampler, _t(x0), _t(t0), _t(px), _t(k),
                           None if conf is None else _t(conf),
                           toil.OILConfig(iterations=iters, sampling_eps=0.01,
                                          score_reuse=reuse))
    return res.pose.numpy()


@pytest.mark.parametrize("with_conf", [False, True])
def test_oil_trajectory(rng, with_conf):
    name = f"test_oil_trajectory_parity__{with_conf}"
    cfg_m, params = make_pair(name)
    k, pose, t_true, px = _scene(rng, n=4)
    conf = (rng.rand(4, 17).astype(np.float32) * 1.2) if with_conf else None
    x0 = pose + rng.randn(*pose.shape).astype(np.float32) * 0.05
    got = _run_oil(params, cfg_m, x0, t_true, px, k, conf, 20)
    np.testing.assert_allclose(got, golden(name, "want"), atol=2e-4, rtol=1e-3)


def test_oil_score_reuse_deviation(rng):
    name = "test_oil_score_reuse_deviation_vs_reference"
    cfg_m, params = make_pair(name)
    k, pose, t_true, px = _scene(rng, n=4)
    x0 = pose + rng.randn(*pose.shape).astype(np.float32) * 0.05
    want = golden(name, "want")
    exact = _run_oil(params, cfg_m, x0, t_true, px, k, None, 40)
    reused = _run_oil(params, cfg_m, x0, t_true, px, k, None, 40, reuse=2)
    np.testing.assert_allclose(exact, want, atol=2e-4, rtol=1e-3)
    dev = np.linalg.norm(reused - want, axis=-1)
    assert dev.max() < 5e-3, f"reuse=2 deviates {dev.max() * 1000:.2f}mm"
    assert dev.mean() < 2e-3, f"reuse=2 mean dev {dev.mean() * 1000:.2f}mm"


def test_end_to_end_solve_metric(rng):
    name = "test_end_to_end_solve_metric_parity"
    cfg_m, params = make_pair(name)
    k, pose_gt, _, px = _scene(rng, n=5)
    cluster = pose_gt[0] + rng.randn(17, 3).astype(np.float32) * 0.08
    want = golden(name, "want")
    sde, sampler = _sampler()
    zcfg = tpipe.ZeDOConfig(
        ipo=tipo.IPOConfig(iterations=60, keypoint_list=(0, 1, 4), rot_axes="z", t_norm=3.0),
        oil=toil.OILConfig(iterations=25, sampling_eps=0.01))
    with torch.no_grad():
        res = tpipe.solve(params, cfg_m, sde, sampler, zcfg, _t(cluster[None]), _t(px), None,
                          _t(k))
    got = res.poses[:, 0].numpy()
    np.testing.assert_allclose(got, want, atol=1e-4, rtol=1e-3)
    mpjpe_ref = np.linalg.norm(want - pose_gt, axis=-1).mean()
    mpjpe_got = np.linalg.norm(got - pose_gt, axis=-1).mean()
    assert abs(mpjpe_ref - mpjpe_got) < 1e-4  # 0.1 mm in metres
