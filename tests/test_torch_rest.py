"""The rest of the JAX package in zedo_tpu_torch, each against its JAX
function on numpy-seeded inputs: the rotation suite, the camera frame
transforms, the full gradient field, the small helpers, serving's seed /
hypo / use_ema / config, and the tools and example (make_clusters,
make_trained_fixture, bench_serving, the quickstart, visualize)."""
import importlib.util
import os
import pickle
import re
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from zedo_tpu import serving as jserving
from zedo_tpu.data import sharding as jsharding
from zedo_tpu.models import nn as jnn
from zedo_tpu.models import score_mlp as jscore_mlp
from zedo_tpu.ops import camera as jcam
from zedo_tpu.ops import gradient_field as jgf
from zedo_tpu.ops import rotations as jrot
from zedo_tpu.utils import checkpoint as jckpt
from zedo_tpu_torch import bench_trained as tbt
from zedo_tpu_torch import presets
from zedo_tpu_torch.data import sharding as tsharding
from zedo_tpu_torch.examples import quickstart
from zedo_tpu_torch.models import nn as tnn
from zedo_tpu_torch.ops import camera as tcam
from zedo_tpu_torch.ops import gradient_field as tgf
from zedo_tpu_torch.ops import rotations as trot
from zedo_tpu_torch.serving import ZeDOEstimator
from zedo_tpu_torch.tools import bench_serving, make_clusters, make_trained_fixture
from zedo_tpu_torch.utils import checkpoint as tckpt
from zedo_tpu_torch.utils import visualize
from zedo_tpu_torch.zeroshot import pipeline as tpipeline

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROT_ATOL = 1e-5
CONVENTIONS = ("XYZ", "ZYX", "XZY", "ZXZ", "YXY", "XYX")


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """One torch thread (restored after): the tests run beside other test
    workers, and torch's default threads would oversubscribe the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _env():
    """The environment of a subprocess: the repo on the path, one thread."""
    return dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="1")


def _t(a):
    return torch.tensor(np.asarray(a))


def _close(got, want, atol=ROT_ATOL, rtol=1e-5):
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=atol, rtol=rtol)


def _jax_tool(name):
    spec = importlib.util.spec_from_file_location(f"jax_{name}",
                                                  os.path.join(REPO, "tools", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke", os.path.join(REPO, "chip_smoke.py"))
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    return smoke


def _rotations(seed, n=32):
    q = np.random.RandomState(seed).randn(n, 4).astype(np.float32)
    return q, np.asarray(jrot.quaternion_to_matrix(jnp.asarray(q)))


# ---------------------------------------------------------------- rotations
@pytest.mark.parametrize("seed", [0, 1])
def test_quaternion_matrix_conversions_match_jax(seed):
    q, m = _rotations(seed)
    _close(trot.matrix_to_quaternion(_t(m)), jrot.matrix_to_quaternion(jnp.asarray(m)))
    _close(trot.standardize_quaternion(_t(q)), jrot.standardize_quaternion(jnp.asarray(q)))
    # each best-conditioned branch is taken: rotations by pi about each axis
    flips = np.stack([np.diag(d) for d in ([1, 1, 1], [1, -1, -1], [-1, 1, -1],
                                            [-1, -1, 1])]).astype(np.float32)
    _close(trot.matrix_to_quaternion(_t(flips)), jrot.matrix_to_quaternion(jnp.asarray(flips)))
    # a round trip gives the rotation back
    _close(trot.quaternion_to_matrix(trot.matrix_to_quaternion(_t(m))), m)
    with pytest.raises(ValueError, match="Invalid rotation matrix shape"):
        trot.matrix_to_quaternion(torch.zeros(2, 3, 4))


@pytest.mark.parametrize("convention", CONVENTIONS)
def test_euler_angles_match_jax(convention):
    angles = np.random.RandomState(2).uniform(-1.4, 1.4, (16, 3)).astype(np.float32)
    if convention[0] == convention[2]:  # proper Euler: the middle angle in (0, pi)
        angles[:, 1] = np.abs(angles[:, 1]) + 0.1
    m_t = trot.euler_angles_to_matrix(_t(angles), convention)
    _close(m_t, jrot.euler_angles_to_matrix(jnp.asarray(angles), convention))
    _, m = _rotations(3)
    _close(trot.matrix_to_euler_angles(_t(m), convention),
           jrot.matrix_to_euler_angles(jnp.asarray(m), convention), atol=1e-4)
    _close(trot.matrix_to_euler_angles(m_t, convention), angles, atol=1e-4)


def test_euler_conventions_are_checked():
    for bad in ("XY", "XXY", "XYW"):
        for fn in (trot.euler_angles_to_matrix, trot.matrix_to_euler_angles):
            arg = torch.zeros(3) if fn is trot.euler_angles_to_matrix else torch.eye(3)
            with pytest.raises(ValueError):
                fn(arg, bad)
    with pytest.raises(ValueError, match="Invalid input euler angles"):
        trot.euler_angles_to_matrix(torch.zeros(4), "XYZ")
    with pytest.raises(ValueError, match="letter must be"):
        trot._axis_angle_rotation("W", torch.zeros(2))


@pytest.mark.parametrize("seed", [0, 1])
def test_axis_angle_and_6d_match_jax(seed):
    rs = np.random.RandomState(seed)
    aa = rs.randn(24, 3).astype(np.float32)
    aa[:4] *= 1e-8  # the small-angle Taylor branch
    _close(trot.axis_angle_to_quaternion(_t(aa)), jrot.axis_angle_to_quaternion(jnp.asarray(aa)))
    _close(trot.axis_angle_to_matrix(_t(aa)), jrot.axis_angle_to_matrix(jnp.asarray(aa)))
    q, m = _rotations(seed + 4)
    q = q / np.linalg.norm(q, axis=-1, keepdims=True)
    q[:3, 1:] *= 1e-8
    _close(trot.quaternion_to_axis_angle(_t(q)), jrot.quaternion_to_axis_angle(jnp.asarray(q)))
    _close(trot.matrix_to_axis_angle(_t(m)), jrot.matrix_to_axis_angle(jnp.asarray(m)),
           atol=1e-4)
    d6 = rs.randn(24, 6).astype(np.float32)
    _close(trot.rotation_6d_to_matrix(_t(d6)), jrot.rotation_6d_to_matrix(jnp.asarray(d6)))
    _close(trot.matrix_to_rotation_6d(_t(m)), jrot.matrix_to_rotation_6d(jnp.asarray(m)))


def test_gradients_at_zero_stay_defined():
    """_sqrt_positive_part's zero subgradient and the axis-angle Taylor
    branch keep the gradients finite where the plain formulas give NaN."""
    x = torch.tensor([0.0, -1.0, 4.0], requires_grad=True)
    trot._sqrt_positive_part(x).sum().backward()
    assert torch.equal(x.grad, torch.tensor([0.0, 0.0, 0.25]))
    aa = torch.zeros(2, 3, requires_grad=True)
    trot.axis_angle_to_matrix(aa).sum().backward()
    assert torch.isfinite(aa.grad).all()
    m = torch.eye(3).expand(2, 3, 3).clone().requires_grad_(True)
    trot.matrix_to_quaternion(m).sum().backward()
    assert torch.isfinite(m.grad).all()
    _close(trot._copysign(_t([1.0, -2.0, 3.0]), _t([-1.0, -1.0, 1.0])), [-1.0, -2.0, 3.0])


def test_random_rotations_are_rotations():
    gen = torch.Generator().manual_seed(0)
    q = trot.random_quaternions(gen, 256)
    assert q.shape == (256, 4) and (q[:, 0] >= 0).all()
    np.testing.assert_allclose(torch.linalg.vector_norm(q, dim=-1).numpy(), 1.0, atol=1e-6)
    r = trot.random_rotations(torch.Generator().manual_seed(1), 256, dtype=torch.float64)
    assert r.dtype == torch.float64
    np.testing.assert_allclose((r @ r.transpose(1, 2)).numpy(), np.eye(3)[None].repeat(256, 0),
                               atol=1e-12)
    np.testing.assert_allclose(torch.linalg.det(r).numpy(), 1.0, atol=1e-12)
    # seeded: the same generator state gives the same draws
    assert torch.equal(trot.random_quaternions(torch.Generator().manual_seed(0), 256), q)


# ------------------------------------------------------------------ camera
def _close_rel(got, want, rtol=1e-6):
    """Within rtol of the compared array's largest magnitude: a component
    near 0 carries the rounding of its larger terms."""
    want = np.asarray(want)
    _close(got, want, atol=rtol * np.abs(want).max(), rtol=rtol)


def test_frame_transforms_match_jax():
    rs = np.random.RandomState(7)
    p = rs.randn(10, 3).astype(np.float32)
    r = _rotations(8, n=1)[1][0]
    t = rs.randn(3, 1).astype(np.float32)
    for name in ("world_to_camera_frame", "camera_to_world_frame"):
        got = getattr(tcam, name)(_t(p), _t(r), _t(t))
        want = getattr(jcam, name)(jnp.asarray(p), jnp.asarray(r), jnp.asarray(t))
        _close_rel(got, want)
    # a round trip
    _close(tcam.camera_to_world_frame(tcam.world_to_camera_frame(_t(p), _t(r), _t(t)),
                                      _t(r), _t(t)), p)
    img = (rs.rand(17, 3) * np.array([200, 200, 50]) + np.array([400, 400, 4000])).astype(
        np.float32)
    box = np.array([100.0, 120.0, 420.0, 480.0], np.float32)
    got = tcam.image_to_camera_frame(_t(img), _t(box), cx=512.0, cy=500.0, fx=1100.0,
                                     fy=1105.0, root_depth=4000.0)
    want = jcam.image_to_camera_frame(jnp.asarray(img), jnp.asarray(box), cx=512.0, cy=500.0,
                                      fx=1100.0, fy=1105.0, root_depth=4000.0)
    _close_rel(got, want)


# ------------------------------------------------------------ gradient field
def _gf_scene(seed=0, b=6):
    rs = np.random.RandomState(seed)
    key3d = (rs.randn(b, 17, 3) * 0.3).astype(np.float32)
    k = np.zeros((b, 3, 3), np.float32)
    k[:, 0, 0] = k[:, 1, 1] = 1100.0
    k[:, 0, 2] = k[:, 1, 2] = 480.0
    k[:, 2, 2] = 1.0
    key2d = (rs.rand(b, 17, 2) * 1000.0).astype(np.float32)
    conf = (rs.rand(b, 17) * 1.3).astype(np.float32)
    t_fix = np.array([[[0.2, -0.1, 3.5]]], np.float32).repeat(b, 0)
    return key2d, key3d, k, conf, t_fix


@pytest.mark.parametrize("with_conf", [True, False])
def test_gradient_field_deterministic_matches_jax(with_conf):
    key2d, key3d, k, conf, t_fix = _gf_scene()
    c_j = jnp.asarray(conf) if with_conf else None
    c_t = _t(conf) if with_conf else None
    rays = np.asarray(jcam.backproject_rays(jnp.asarray(key2d), jnp.asarray(k)))
    _close(tgf.solve_translation(_t(rays), _t(key3d), c_t),
           jgf.solve_translation(jnp.asarray(rays), jnp.asarray(key3d), c_j), atol=1e-5,
           rtol=1e-5)
    for t in (None, t_fix):
        g_t, tt = tgf.gradient_field(_t(key2d), _t(key3d), _t(k), None if t is None else _t(t),
                                     conf=c_t)
        g_j, tj = jgf.gradient_field(jnp.asarray(key2d), jnp.asarray(key3d), jnp.asarray(k),
                                     None if t is None else jnp.asarray(t), conf=c_j)
        _close(g_t, g_j, atol=1e-5, rtol=1e-5)
        _close(tt, tj, atol=1e-5, rtol=1e-5)
    _close(tgf.reprojection_residual(_t(key2d), _t(key3d), _t(k)),
           jgf.reprojection_residual(jnp.asarray(key2d), jnp.asarray(key3d), jnp.asarray(k)),
           atol=0, rtol=1e-6)


@pytest.mark.parametrize("noise_type", ["gaussian", "uniform"])
def test_gradient_field_noise_matches_jax_with_shared_draws(noise_type, monkeypatch):
    key2d, key3d, k, conf, _ = _gf_scene(1)
    gen = torch.Generator().manual_seed(3)
    draw = torch.randn(key3d.shape, generator=gen).numpy()
    monkeypatch.setattr(jax.random, "normal",
                        lambda key, shape, dtype=jnp.float32: jnp.asarray(draw, dtype))
    g_t, t_t = tgf.gradient_field(_t(key2d), _t(key3d), _t(k), conf=_t(conf),
                                  noise_type=noise_type,
                                  generator=torch.Generator().manual_seed(3))
    g_j, _ = jgf.gradient_field(jnp.asarray(key2d), jnp.asarray(key3d), jnp.asarray(k),
                                conf=jnp.asarray(conf), noise_type=noise_type,
                                rng=jax.random.PRNGKey(0))
    _close(g_t, g_j, atol=1e-5, rtol=1e-5)
    # the noise's moments: gaussian scaled by T, "uniform" is randn - 0.5
    clean, _ = tgf.gradient_field(_t(key2d), _t(key3d), _t(k), conf=_t(conf))
    many = [tgf.gradient_field(_t(key2d), _t(key3d), _t(k), conf=_t(conf),
                               noise_type=noise_type,
                               generator=torch.Generator().manual_seed(s))[0] - clean
            for s in range(40)]
    z = torch.stack(many) / tgf.NOISE_STD
    if noise_type == "gaussian":
        z = z / t_t
    else:
        z = z + 0.5
    assert abs(z.mean().item()) < 0.02 and abs(z.std().item() - 1.0) < 0.02


def test_gradient_field_rejects_unknown_noise():
    key2d, key3d, k, _, _ = _gf_scene()
    with pytest.raises(ValueError, match="unknown noise_type"):
        tgf.gradient_field(_t(key2d), _t(key3d), _t(k), noise_type="laplace")
    for noise_type in ("gaussian", "uniform"):  # no global, unseeded draws
        with pytest.raises(ValueError, match="give one"):
            tgf.gradient_field(_t(key2d), _t(key3d), _t(k), noise_type=noise_type)


# ------------------------------------------------------------ small helpers
def test_small_helpers_match_jax():
    rs = np.random.RandomState(0)
    flat = {"a.b": rs.randn(3).astype(np.float32), "a.c.d": rs.randn(2, 2).astype(np.float32),
            "e": rs.randn(4).astype(np.float32)}
    tree = tckpt.flat_to_tree(flat, "cpu")
    jtree = jckpt.flat_to_tree(flat)
    assert tckpt.tree_to_flat(tree).keys() == jckpt.tree_to_flat(jtree).keys()
    for key, value in tckpt.tree_to_flat(tree).items():
        np.testing.assert_array_equal(value.numpy(), np.asarray(jckpt.tree_to_flat(jtree)[key]))
    zero = tnn.zero_module(tree)
    jzero = jnn.zero_module(jtree)
    for key, value in tckpt.tree_to_flat(zero).items():
        np.testing.assert_array_equal(value.numpy(), np.asarray(jckpt.tree_to_flat(jzero)[key]))
        assert value.dtype == tree["a"]["b"].dtype
    x = _t(flat["a.c.d"])
    np.testing.assert_array_equal(tckpt.to_flattened_numpy(x), jckpt.to_flattened_numpy(
        jnp.asarray(flat["a.c.d"])))
    back = tckpt.from_flattened_numpy(tckpt.to_flattened_numpy(x), (2, 2), device="cpu")
    assert torch.equal(back, x)


class _DS:
    def __init__(self, n):
        self.n = n

    def __len__(self):
        return self.n


@pytest.mark.parametrize("n,world", [(10, 4), (17, 3), (8, 8), (5, 2)])
def test_distributed_eval_sampler_matches_jax(n, world):
    for rank in range(world):
        for shuffle in (False, True):
            t = tsharding.DistributedEvalSampler(_DS(n), num_replicas=world, rank=rank,
                                                 shuffle=shuffle, seed=3)
            j = jsharding.DistributedEvalSampler(_DS(n), num_replicas=world, rank=rank,
                                                 shuffle=shuffle, seed=3)
            for epoch in (0, 5):
                t.set_epoch(epoch)
                j.set_epoch(epoch)
                assert list(t) == list(j) and len(t) == len(j)
    with pytest.raises(ValueError, match="Invalid rank"):
        tsharding.DistributedEvalSampler(_DS(n), num_replicas=world, rank=world)


# ----------------------------------------------------------------- serving
@pytest.fixture(scope="module")
def jax_estimators():
    """JAX's serving on the trained fixture (fp32, a short schedule), one
    estimator per (hypo, use_ema)."""
    config = os.path.join(REPO, "examples", "quickstart_config.py")
    return {(hypo, ema): jserving.ZeDOEstimator.from_torch_checkpoint(
        tbt.CHECKPOINT, tbt.CLUSTERS, config_path=config, hypo=hypo, dtype="fp32",
        use_ema=ema, batch_bucket=8).with_schedule(60, ipo_iterations=40)
        for hypo, ema in ((1, False), (None, True))}


ERR_PX = 1e-4


@pytest.mark.parametrize("hypo,use_ema", [(1, False), (None, True)])
@pytest.mark.parametrize("seed", [0, 7])
def test_serving_hypo_ema_seed_match_jax(jax_estimators, hypo, use_ema, seed, monkeypatch):
    # the estimator's seed reaches the solve as a generator built anew on
    # every predict, as JAX's predict builds PRNGKey(seed) on every call
    drawn = []
    solve = tpipeline.solve_jit

    def recording_solve(*args, generator=None, **kwargs):
        drawn.append((generator.initial_seed(), generator.get_state().clone()))
        return solve(*args, generator=generator, **kwargs)

    monkeypatch.setattr(tpipeline, "solve_jit", recording_solve)
    family = np.load(os.path.join(tbt.FIXTURE, "family.npz"))
    _, k, px = tbt.make_scenes(family, 6)
    config = presets.optim_config("h36m")
    config.model.update(hidden_dim=256, embed_dim=128)
    test = ZeDOEstimator.from_torch_checkpoint(
        tbt.CHECKPOINT, tbt.CLUSTERS, config=config, hypo=hypo, dtype="fp32", use_ema=use_ema,
        batch_bucket=8, device="cpu").with_schedule(60, ipo_iterations=40)
    test.seed = seed
    jest = jax_estimators[(hypo, use_ema)]
    jest.seed = seed
    assert len(test.clusters) == len(jest.clusters) == (hypo or 2)
    got, want = test.predict(px, k), jest.predict(px, k)
    np.testing.assert_allclose(got["poses"], want["poses"], atol=1e-4)
    np.testing.assert_array_equal(test.predict(px, k)["poses"], got["poses"])
    fresh = torch.Generator().manual_seed(seed).get_state()
    assert len(drawn) == 2
    for initial_seed, state in drawn:
        assert initial_seed == seed and torch.equal(state, fresh)
    # the ranking: each hypothesis's reprojection error (px) agrees within
    # ERR_PX, so the best agrees wherever the best two are further apart than
    # twice that (a closer pair is a tie within the packages' rounding)
    err_t, err_j = got["reprojection_error"], want["reprojection_error"]
    np.testing.assert_allclose(err_t, err_j, atol=ERR_PX, rtol=0)
    srt = np.sort(err_j, axis=1)
    decisive = srt[:, 1] - srt[:, 0] > 2 * ERR_PX if srt.shape[1] > 1 else np.ones(6, bool)
    assert decisive.sum() >= 3
    np.testing.assert_array_equal(got["best"][decisive], want["best"][decisive])


def test_serving_config_names_and_refusals():
    est = ZeDOEstimator.from_torch_checkpoint(
        tbt.CHECKPOINT, tbt.CLUSTERS, preset=presets.h36m(hidden_dim=256, embed_dim=128),
        dtype="fp32", use_ema=True, device="cpu")
    ema = tckpt.load_torch_checkpoint(tbt.CHECKPOINT, est.model_cfg, "cpu")["ema_params"]
    assert torch.equal(est.params["post_dense"]["weight"], ema["post_dense"]["weight"])
    assert est.seed == 0
    with pytest.raises(ValueError, match="not both"):
        ZeDOEstimator.from_torch_checkpoint(tbt.CHECKPOINT, tbt.CLUSTERS,
                                            preset=presets.h36m(), config="h36m", device="cpu")
    # a configs/optim path, as the CLIs' --config takes it: the file's settings
    # at the published widths
    by_path = ZeDOEstimator.from_torch_checkpoint(
        tbt.CHECKPOINT, tbt.CLUSTERS, device="cpu",
        config=os.path.join("configs", "optim", "concat_pose_optimization_pw3d.py"))
    assert by_path.model_cfg.hidden_dim == 1024
    assert by_path.zcfg.ipo.t_norm == presets.optim_config("3dpw").ZeDO.IPO_T == 8
    # config_path, JAX's name: any config file, its widths and schedule
    by_file = ZeDOEstimator.from_torch_checkpoint(
        tbt.CHECKPOINT, tbt.CLUSTERS, device="cpu", dtype="fp32",
        config_path=os.path.join(REPO, "examples", "quickstart_config.py"))
    assert (by_file.model_cfg, by_file.zcfg) == (est.model_cfg, est.zcfg)
    with pytest.raises(ValueError, match="not both"):
        ZeDOEstimator.from_torch_checkpoint(tbt.CHECKPOINT, tbt.CLUSTERS, config="h36m",
                                            config_path="h36m", device="cpu")
    with pytest.raises(ValueError, match="give a preset"):
        ZeDOEstimator.from_torch_checkpoint(tbt.CHECKPOINT, tbt.CLUSTERS, config="nope",
                                            device="cpu")


# ------------------------------------------------------------------- tools
def test_make_clusters_bit_equal_to_jax(tmp_path):
    jtool = _jax_tool("make_clusters")
    poses = np.random.RandomState(0).randn(300, 17, 3).astype(np.float32)
    for s, seed in ((5, 0), (3, 11), (1, 0)):
        got = make_clusters.make_clusters(poses, s, seed=seed)
        want = jtool.make_clusters(poses, s, seed=seed)
        assert got.dtype == want.dtype and got.tobytes() == want.tobytes(), (s, seed)
    src = tmp_path / "poses.npy"
    np.save(src, poses)
    out = make_clusters.main([str(src), str(tmp_path / "c.npy"), "4", "--seed", "2"])
    assert np.load(tmp_path / "c.npy").tobytes() == jtool.make_clusters(poses, 4, 2).tobytes()
    assert out.shape == (4, 17, 3)


def test_make_clusters_reads_a_dataset(tmp_path, capsys):
    items = [{"joint_3d_camera": np.random.RandomState(i).randn(17, 3) * 300 + [0, 0, 4000],
              "joint_3d_image": np.random.RandomState(i).rand(17, 3) * 1000,
              "camera_param": {"fx": np.array(1145.0), "fy": np.array(1144.0),
                               "cx": np.array(512.0), "cy": np.array(515.0)},
              "image_path": f"img_{i}.jpg", "action": 2 + (i % 15)} for i in range(40)]
    os.makedirs(tmp_path / "data" / "h36m")
    with open(tmp_path / "data" / "h36m" / "h36m_train.pkl", "wb") as f:
        pickle.dump(items, f)
    out = make_clusters.main(["--dataset", "h36m", "--data_dir", str(tmp_path / "data"),
                              str(tmp_path / "c3.npy"), "3"])
    assert out.shape == (3, 17, 3) and np.isfinite(out).all()
    np.testing.assert_array_equal(out[:, 0], 0.0)
    assert "wrote (3, 17, 3) clusters" in capsys.readouterr().out


def test_make_trained_fixture_seeded_files_and_checkpoint(tmp_path, monkeypatch):
    monkeypatch.setattr(make_trained_fixture, "TRAIN_STEPS", 200)
    res = make_trained_fixture.main(["--out", str(tmp_path), "--device", "cpu"])
    assert res["loss_last_100"] < make_trained_fixture.LOSS_DROP * res["loss_first_100"]
    fixture = tbt.FIXTURE
    for name in ("data/h36m/h36m_test.pkl", "clusters/h36m_cluster1.npy",
                 "clusters/h36m_cluster2.npy"):
        with open(os.path.join(fixture, name), "rb") as a, open(tmp_path / name, "rb") as b:
            assert a.read() == b.read(), name
    committed, ours = np.load(os.path.join(fixture, "family.npz")), np.load(tmp_path / "family.npz")
    for key in ("mu", "u", "gt", "init_mm", "hidden", "embed", "n_blocks", "fx", "cx", "t_vec"):
        assert committed[key].tobytes() == ours[key].tobytes(), key
    assert float(ours["mpjpe_mm"]) == pytest.approx(res["mpjpe_mm"])
    # the .pth is the reference's layout: JAX's loader reads the port's weights
    path = str(tmp_path / "checkpoint" / "checkpoint_trained.pth")
    cfg = make_trained_fixture.model_config()
    port = tckpt.load_torch_checkpoint(path, cfg, "cpu")
    jcfg = jscore_mlp.ScoreMLPConfig(hidden_dim=256, embed_dim=128, n_blocks=2, dropout=0.0)
    jax_ckpt = jckpt.load_torch_checkpoint(path, jcfg)
    for which in ("params", "ema_params"):
        flat_t = tckpt.tree_to_flat(port[which])
        flat_j = jckpt.tree_to_flat(jax_ckpt[which])
        assert flat_t.keys() == flat_j.keys()
        for key, value in flat_t.items():
            np.testing.assert_array_equal(value.numpy(), np.asarray(flat_j[key]), err_msg=key)
    assert not torch.equal(port["params"]["post_dense"]["weight"],
                           port["ema_params"]["post_dense"]["weight"])
    assert jax_ckpt["step"] == port["step"] == 200
    assert torch.load(path, weights_only=False)["ema"]["num_updates"] == 200
    with pytest.raises(SystemExit):
        make_trained_fixture.main([])  # --out is required


def test_bench_serving_prints_its_lines(capsys):
    res = bench_serving.main(["--device", "cpu", "--reps", "1", "--bucket", "32", "--oil", "20",
                              "--ipo", "10"])
    lines = [ln for ln in capsys.readouterr().out.splitlines() if ln.startswith("reuse=")]
    assert len(lines) == len(res) == 6
    pattern = r"reuse=[12] N=\s*\d+ S=5: p50\s+[\d.]+ ms  p95\s+[\d.]+ ms  \([\d.]+ poses/s\)"
    assert all(re.fullmatch(pattern, ln) for ln in lines), lines
    assert [(r["reuse"], r["n"]) for r in res] == [(1, 1), (1, 16), (1, 32), (2, 1), (2, 16),
                                                   (2, 32)]
    assert {r["rows"] for r in res} == {160} and {r["oil_iterations"] for r in res} == {20}
    assert bench_serving.request_sizes(256) == [1, 16, 256]
    assert bench_serving.request_sizes(32) == [1, 16, 32]


def test_quickstart_runs_on_the_cpu():
    out = subprocess.run([sys.executable, "-m", "zedo_tpu_torch.examples.quickstart",
                          "--device", "cpu"], capture_output=True, text=True, cwd=REPO, env=_env(),
                         timeout=300)
    assert out.returncode == 0, out.stderr
    assert "solved MPJPE" in out.stdout and "python -m zedo_tpu_torch.run.opt_main" in out.stdout
    assert "TPU" not in out.stdout and "v5e" not in out.stdout
    smoke = _smoke()
    solved = float(re.search(r"solved MPJPE ([\d.]+) mm", out.stdout).group(1))
    served = float(re.search(r"reprojection error\) MPJPE ([\d.]+) mm", out.stdout).group(1))
    # one decimal printed; the port on the CPU against JAX's on the CPU
    assert abs(solved - smoke.JAX_QUICKSTART_MM["solved"]) < smoke.FIXTURE_TOL_MM
    assert abs(served - smoke.JAX_QUICKSTART_MM["served"]) < smoke.FIXTURE_TOL_MM


def test_chip_smoke_quickstart_reference():
    """chip_smoke.py holds the quickstart on the card to the JAX quickstart's
    MPJPE on the CPU, root-centred; recompute those values."""
    from zedo_tpu import bench_trained as jbt
    from zedo_tpu.diffusion.sampling import PCSampler
    from zedo_tpu.diffusion.sde import SubVPSDE
    from zedo_tpu.zeroshot import ipo as jipo
    from zedo_tpu.zeroshot import oil as joil
    from zedo_tpu.zeroshot import pipeline as jpipe

    smoke = _smoke()
    cfg, params, family = jbt.load_fixture()
    gt, k, px = jbt.make_scenes(family, quickstart.N_SCENES)
    clusters = jbt.make_hypothesis_clusters(family, s=quickstart.HYPO)
    sde = SubVPSDE(beta_min=0.1, beta_max=20.0, n=300, t_max=0.1)
    sampler = PCSampler(sde=sde, predictor="euler_maruyama", corrector="none",
                        probability_flow=True, denoise=True, eps=0.01)
    zcfg = jpipe.ZeDOConfig(
        ipo=jipo.IPOConfig(iterations=200, keypoint_list=(0, 1, 4), rot_axes="z", t_norm=3.0),
        oil=joil.OILConfig(iterations=300, sampling_eps=0.01))
    res = jpipe.solve_jit(params, cfg, sde, sampler, zcfg, jnp.asarray(clusters),
                          jnp.asarray(px), None, jnp.asarray(k), rng=jax.random.PRNGKey(0),
                          precision=jax.lax.Precision.HIGHEST)
    solved = tbt.best_mpjpe(np.asarray(res.poses, np.float32), gt)
    est = jserving.ZeDOEstimator.from_torch_checkpoint(
        tbt.CHECKPOINT, tbt.CLUSTERS,
        config_path=os.path.join(REPO, "examples", "quickstart_config.py"), dtype="fp32",
        batch_bucket=32).low_latency()
    n = quickstart.SERVE_POSES
    out = est.predict(px[:n], k[:n])
    served = tbt.best_mpjpe(out["poses"][np.arange(n), out["best"]][:, None], gt[:n])
    np.testing.assert_allclose([solved, served], [smoke.JAX_QUICKSTART_MM["solved"],
                                                  smoke.JAX_QUICKSTART_MM["served"]], rtol=1e-5)


# --------------------------------------------------------------- visualize
def test_save_pose_grid_writes_a_png(tmp_path):
    family = np.load(os.path.join(tbt.FIXTURE, "family.npz"))
    gt, _, px = tbt.make_scenes(family, 3)
    path = visualize.save_pose_grid(str(tmp_path / "grid.png"), gt, poses_2d=px, gts_3d=gt,
                                    cols=2)
    with open(path, "rb") as f:
        assert f.read(8) == b"\x89PNG\r\n\x1a\n"
    assert os.path.getsize(path) > 1000


_NO_MATPLOTLIB = """
import sys
sys.modules["matplotlib"] = None  # import matplotlib raises ImportError
import numpy as np
from zedo_tpu_torch.utils import visualize
try:
    visualize.save_pose_grid("x.png", np.zeros((1, 17, 3)))
except ImportError as e:
    print("RAISED", e)
"""


def test_visualize_imports_without_matplotlib(tmp_path):
    out = subprocess.run([sys.executable, "-c", _NO_MATPLOTLIB], capture_output=True, text=True,
                         cwd=tmp_path, env=_env(), timeout=120)
    assert out.returncode == 0, out.stderr
    assert "RAISED" in out.stdout and "matplotlib" in out.stdout


# ------------------------------------------------- entry points need CUDA
def test_new_entry_points_need_cuda_unless_told_cpu(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("checks the behaviour of a machine without CUDA")
    for main, argv in ((bench_serving.main, []), (quickstart.main, []),
                       (make_trained_fixture.main, ["--out", str(tmp_path)])):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            main(argv)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        ZeDOEstimator.from_torch_checkpoint(tbt.CHECKPOINT, tbt.CLUSTERS, config="h36m")
